// Fused decode append+attend: the KV cache serviced as a 1W+1R memory in
// one traversal (the paper's claim C1 on the serving path).
//
// Replaces the TPU kernel src/repro/kernels/kv_multiport.py:_kernel
// (pallas_call in fused_append_attend, num_kv_splits=1). The TPU walks a
// sequential (batch, tiles) grid bounded by the batch's longest row; here
// each (row, kv-head) pair loops over ITS row's live positions only, so no
// host sync or batch-max bound is needed.
//
// What bounds it on an H100: bytes. Each row reads its live K and V once
// (2 * (len+1) * Hkv * D elements) and does 4 * H * (len+1) * D flops on
// them, about one flop per byte for f32 caches — far below the card's
// ridge point. One block per (row, kv head) is 16 blocks on 132 SMs for
// tinyllama's 4 kv heads and 4 rows: one SM's load bandwidth per row walks
// the whole context in series.
//
// Design: one launch, a thread block cluster of C blocks per (row, kv
// head) (grid (C, Hkv, B), cluster (C, 1, 1); C <= 8, the portable size,
// chosen on the host from the staged tile count and the card's cluster
// fit; C = 1 is an ordinary launch that divides its own sums).
// Block r of the cluster takes bank r of C of the row's live keys, in
// whole seq_tiles (decode_attend.cuh:bank_range, the split-KV partition),
// and streams it through decode_attend.cuh's cp.async ring. Each block leaves its
// unnormalized (acc, m, l) for its G heads in its own shared memory; after
// cluster.sync() rank 0 reads the peers' states through distributed shared
// memory, merges them in bank order with split-KV stage 2's running-max
// rescale and guards, divides by max(l, 1e-30) and writes q's dtype. A
// second cluster.sync() keeps every peer's shared memory alive until rank 0
// has read it. Every block reaches both barriers: a dead row or an empty
// bank runs an empty key range (m = -inf, l = 0, acc = 0, weight 0 in the
// merge), so a dead row outputs zeros. The W port writes only the appended
// row, from the one block whose bank holds p; that block's loader copies
// row p from new_k/new_v, so no block reads position p from the cache.
// Contract kept from the TPU kernel: f32 accumulation, alpha =
// exp(m_prev - m_new) guarded while m_prev is -inf, the 1e-30 floor on the
// denominator, and a dead row (cache_len < 0) writes nothing, outputs
// zeros and services 0 tiles. The tile count is written by rank 0 of the
// kv-head-0 cluster.
#include <cooperative_groups.h>

#include "decode_attend.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace repro::decode;

constexpr int MAX_CLUSTER = 8;  // the portable cluster size

// A lone block's output: the owners of each head's l put it in shared
// memory, then each thread writes its own sums over it (the merge of one
// state, which leaves acc and l as they are).
template <typename TQ>
__device__ __forceinline__ void normalize(const State& st, float* l,
                                          TQ* o, int G, int D) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int t = 0; t < MAX_SOFT; ++t) {
    const int h = warp + NWARPS * t;
    if (h >= G) break;
    if (lane == 0) l[h] = st.l[t];
  }
  __syncthreads();
  const int nr = THREADS / D, pd = tid % D, pr = tid / D;
  if (tid >= nr * D) return;
#pragma unroll
  for (int t = 0; t < MAX_ACC; ++t) {
    const int h = pr + nr * t;
    if (h >= G) break;
    o[h * D + pd] = repro::from_f32<TQ>(st.acc[t] / fmaxf(l[h], 1e-30f));
  }
}

template <typename TQ, typename TC>
__global__ void __launch_bounds__(THREADS, 1)
    decode_kernel(const TQ* __restrict__ q, TC* __restrict__ ck,
                  TC* __restrict__ cv, const TC* __restrict__ nk,
                  const TC* __restrict__ nv, const int32_t* __restrict__ lens,
                  TQ* __restrict__ out, int32_t* __restrict__ tiles, int S,
                  int Hkv, int G, int D, int seq_tile, int n_tiles,
                  int length_mask, float scale, int pitch, int fixed,
                  int stage_bytes, int stages, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  // the cluster spans grid x; C == 1 is an ordinary launch, no cluster
  const int C = gridDim.x, r = blockIdx.x;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int H = Hkv * G;

  const int p = lens[b];
  if (hk == 0 && r == 0 && threadIdx.x == 0)
    tiles[b] = serviced_tiles(p, seq_tile, n_tiles, length_mask);
  int lo, hi;
  bank_range(p, r, C, seq_tile, n_tiles, S, lo, hi);
  const TC* nkr = nk + ((size_t)b * Hkv + hk) * D;
  const TC* nvr = nv + ((size_t)b * Hkv + hk) * D;
  if (p >= lo && p < hi) append_row(ck, cv, nkr, nvr, b, hk, p, S, Hkv, D);
  State st;
  attend(smem, q + ((size_t)b * H + (size_t)hk * G) * D, ck, cv, nkr, nvr,
         b, hk, p, lo, hi, S, Hkv, G, D, scale, pitch, fixed, stage_bytes,
         stages, vec != 0, st);

  // the state goes where q and the scores were: every thread is past them
  float* acc = (float*)smem;                              // [G][D]
  float* stats = (float*)(smem + scores_offset(G, D));    // [G][2]
  TQ* o = out + ((size_t)b * H + (size_t)hk * G) * D;
  __syncthreads();
  if (C == 1) {  // no peers: each thread divides its own sums
    normalize(st, stats, o, G, D);
    return;
  }
  store_state(st, acc, stats, G, D);
  cg::this_cluster().sync();  // every rank's state is written and visible
  if (r == 0) {
    for (int i = threadIdx.x; i < G * D; i += THREADS) {
      const int g = i / D;
      float m[MAX_CLUSTER], l[MAX_CLUSTER], a[MAX_CLUSTER];
#pragma unroll
      for (int s = 0; s < MAX_CLUSTER; ++s) {  // every remote read in flight
        if (s >= C) break;
        const float* ps = cg::this_cluster().map_shared_rank(stats, s);
        const float* pa = cg::this_cluster().map_shared_rank(acc, s);
        m[s] = ps[g * 2];
        l[s] = ps[g * 2 + 1];
        a[s] = pa[i];
      }
      float m_run = -INFINITY, l_run = 0.f, a_run = 0.f;
#pragma unroll
      for (int s = 0; s < MAX_CLUSTER; ++s) {
        if (s >= C) break;
        merge(m_run, l_run, a_run, m[s], l[s], a[s]);
      }
      o[i] = repro::from_f32<TQ>(a_run / fmaxf(l_run, 1e-30f));
    }
  }
  cg::this_cluster().sync();  // the peers' shared memory outlives rank 0's
                              // reads
}

cudaLaunchConfig_t config(const Geometry& g, int C, int B, int Hkv,
                          cudaStream_t st, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, Hkv, B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = g.smem;
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename TQ, typename TC>
int launch(void* q, void* ck, void* cv, void* nk, void* nv, void* lens,
           void* out, void* tiles, int B, int S, int Hkv, int G, int D,
           int seq_tile, int n_tiles, int length_mask, float scale, int C,
           cudaStream_t st) {
  const Geometry g = geometry(G, D, (int)sizeof(TC));
  if (g.stages < 2) return (int)cudaErrorInvalidValue;
  const int vec = vector_rows(ck, cv, nk, nv, D, (int)sizeof(TC));
  auto kern = decode_kernel<TQ, TC>;
  cudaError_t err = repro::allow_smem(kern, g.smem);
  if (err != cudaSuccess) return (int)err;
#define REPRO_ARGS (const TQ*)q, (TC*)ck, (TC*)cv, (const TC*)nk, \
      (const TC*)nv, (const int32_t*)lens, (TQ*)out, (int32_t*)tiles, S, Hkv, \
      G, D, seq_tile, n_tiles, length_mask, scale, g.pitch, g.fixed, \
      g.stage_bytes, g.stages, vec
  if (C == 1) {  // a cluster of one block: an ordinary launch costs less
    kern<<<dim3(1, Hkv, B), THREADS, g.smem, st>>>(REPRO_ARGS);
    return (int)cudaGetLastError();
  }
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(g, C, B, Hkv, st, attr);
  err = cudaLaunchKernelEx(&cfg, kern, REPRO_ARGS);
#undef REPRO_ARGS
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename TQ, typename TC>
int fit(int G, int D, int C, int* clusters) {
  const Geometry g = geometry(G, D, (int)sizeof(TC));
  auto kern = decode_kernel<TQ, TC>;
  cudaError_t err = repro::allow_smem(kern, g.smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(g, C, 1, 1, 0, attr);
  return (int)cudaOccupancyMaxActiveClusters(clusters, kern, &cfg);
}

}  // namespace

// q/out [B, Hkv*G, D] (q_dtype); caches [B, S, Hkv, D] (cache_dtype, updated
// in place); new_k/new_v [B, Hkv, D] (cache_dtype); lens/tiles [B] int32.
// n_tiles is the staged tile count (the traversal never passes
// n_tiles * seq_tile positions); C the cluster size, 1..8.
extern "C" int kv_decode_append_attend(void* q, void* ck, void* cv, void* nk,
                                       void* nv, void* lens, void* out,
                                       void* tiles, int B, int S, int Hkv,
                                       int G, int D, int seq_tile, int n_tiles,
                                       int length_mask, float scale, int C,
                                       int q_dtype, int cache_dtype,
                                       void* stream) {
  if (bad_geometry(B, Hkv, G, D, seq_tile) || C < 1 || C > MAX_CLUSTER ||
      Hkv > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define REPRO_ARGS q, ck, cv, nk, nv, lens, out, tiles, B, S, Hkv, G, D, \
                   seq_tile, n_tiles, length_mask, scale, C, st
  if (q_dtype == REPRO_F32 && cache_dtype == REPRO_F32)
    return launch<float, float>(REPRO_ARGS);
  if (q_dtype == REPRO_BF16 && cache_dtype == REPRO_F32)
    return launch<__nv_bfloat16, float>(REPRO_ARGS);
  if (q_dtype == REPRO_F32 && cache_dtype == REPRO_BF16)
    return launch<float, __nv_bfloat16>(REPRO_ARGS);
  if (q_dtype == REPRO_BF16 && cache_dtype == REPRO_BF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(REPRO_ARGS);
#undef REPRO_ARGS
  return (int)cudaErrorInvalidValue;
}

// How many clusters of C blocks of the kernel for G heads of D dims can be
// resident at once on this card (cudaOccupancyMaxActiveClusters), into
// *clusters.
extern "C" int kv_decode_cluster_fit(int G, int D, int C, int q_dtype,
                                     int cache_dtype, int* clusters) {
  if (bad_geometry(1, 1, G, D, 1) || C < 1 || C > MAX_CLUSTER)
    return (int)cudaErrorInvalidValue;
  if (q_dtype == REPRO_F32 && cache_dtype == REPRO_F32)
    return fit<float, float>(G, D, C, clusters);
  if (q_dtype == REPRO_BF16 && cache_dtype == REPRO_F32)
    return fit<__nv_bfloat16, float>(G, D, C, clusters);
  if (q_dtype == REPRO_F32 && cache_dtype == REPRO_BF16)
    return fit<float, __nv_bfloat16>(G, D, C, clusters);
  if (q_dtype == REPRO_BF16 && cache_dtype == REPRO_BF16)
    return fit<__nv_bfloat16, __nv_bfloat16>(G, D, C, clusters);
  return (int)cudaErrorInvalidValue;
}
