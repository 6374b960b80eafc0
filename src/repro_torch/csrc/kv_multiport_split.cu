// Split-KV decode: the fused append+attend of kv_multiport.cu with each
// row's live keys spread over num_kv_splits parallel chains (stage 1), and
// the LSE combine of the chains' partial softmax states (stage 2).
//
// Replaces the TPU kernels src/repro/kernels/kv_multiport.py:_split_kernel
// (stage 1) and :_combine_kernel (stage 2). The TPU could only emulate the
// split on its sequential (batch, tiles) grid, one bank of scratch per
// split. Here the grid is (row, kv-head, split) and truly parallel: stage
// 1 launches B * Hkv * ns blocks. The serial kernel (kv_multiport.cu) runs
// the same partition and the same merge inside one launch, a cluster of
// blocks per (row, kv head) merging through distributed shared memory.
//
// What bounds stage 1 on an H100: bytes. It reads each live K/V row once
// (about one flop per byte for f32 caches) and writes ns f32 partials per
// head. Stage 2 reads the partials once and writes the output: latency
// (below).
//
// Stage 1, block (b, hk, s): the bank partition is the TPU kernel's, per
// row (decode_attend.cuh:bank_range): bank s owns the keys
// [s * per_split * seq_tile, (s + 1) * per_split * seq_tile) (the last bank
// everything above), cut at the row's live end. The block streams that
// range through decode_attend.cuh's cp.async ring (the serial kernel's R
// port too) and writes the unnormalized (acc, m, l); an empty bank writes
// acc = 0, m = -inf, l = 0. The W port belongs to the one block whose range
// holds p: it writes the appended row, and its loader copies row p from
// new_k/new_v instead of the cache, so no other block reads position p and
// blocks need no order. A dead row (p < 0) writes nothing and leaves every
// bank empty. Block (hk 0, split 0) writes the serviced-tile count with the
// serial kernel's formula.
//
// Stage 2 is latency, not bytes: it moves ns * (D + 2) floats per (row,
// head), a few kilobytes, so its time is its launch plus the chain of
// L2 round trips each thread waits on. One thread owns VEC = 4
// consecutive dims of one (row, head) (VEC = 1 where D % 4 != 0 or a
// pointer is off its vector boundary), so the grid spreads B * H * D /
// VEC threads over the SMs. A thread issues the loads of a chunk of
// COMBINE_CHUNK banks -- a float2 (m, l) and a VEC-wide slice of acc each,
// all through L2 (ld.global.cg) -- before it merges any of them, then
// merges them in bank order with decode_attend.cuh's merge weights, so
// the sums are those of a bank-by-bank walk bit for bit. It divides by
// max(l, 1e-30) and writes q's dtype; a row whose banks are all empty
// (m = -inf) gives zeros.
//
// Stage 2 is launched with cudaLaunchAttributeProgrammaticStreamSerialization
// behind stage 1: its launch is processed while stage 1 runs, its blocks
// do their index math and wait in grid_dependency_wait() before they read
// or write global memory, so stage 2's launch overlaps stage 1's tail
// instead of following its drain. Stage 1 never calls
// griddepcontrol.launch_dependents: stage 2's blocks then start as stage
// 1's blocks exit. Calling it at stage 1's start let stage 2's waiting
// blocks slow stage 1; calling it after store_state bought nothing
// (PERF.md). Stage 2 runs blocks of COMBINE_THREADS (128, the
// fastest of 32 to 256 on an H100).
#include "decode_attend.cuh"

namespace {

using namespace repro::decode;

constexpr int COMBINE_CHUNK = 8;    // banks loaded before a merge step
constexpr int COMBINE_THREADS = 128;

template <typename TQ, typename TC>
__global__ void __launch_bounds__(THREADS, 1)
    split_kernel(const TQ* __restrict__ q, TC* __restrict__ ck,
                 TC* __restrict__ cv, const TC* __restrict__ nk,
                 const TC* __restrict__ nv, const int32_t* __restrict__ lens,
                 float* __restrict__ acc_out, float* __restrict__ stats_out,
                 int32_t* __restrict__ tiles, int S, int Hkv, int G, int D,
                 int seq_tile, int n_tiles, int length_mask, int ns,
                 float scale, int pitch, int fixed, int stage_bytes,
                 int stages, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x, hk = blockIdx.y, s = blockIdx.z;
  const int H = Hkv * G;
  const size_t head0 = ((size_t)b * ns + s) * H + (size_t)hk * G;

  const int p = lens[b];
  if (hk == 0 && s == 0 && threadIdx.x == 0)
    tiles[b] = serviced_tiles(p, seq_tile, n_tiles, length_mask);
  int lo, hi;
  bank_range(p, s, ns, seq_tile, n_tiles, S, lo, hi);
  const TC* nkr = nk + ((size_t)b * Hkv + hk) * D;
  const TC* nvr = nv + ((size_t)b * Hkv + hk) * D;
  if (p >= lo && p < hi) append_row(ck, cv, nkr, nvr, b, hk, p, S, Hkv, D);
  State st;
  attend(smem, q + ((size_t)b * H + (size_t)hk * G) * D, ck, cv, nkr, nvr,
         b, hk, p, lo, hi, S, Hkv, G, D, scale, pitch, fixed, stage_bytes,
         stages, vec != 0, st);
  store_state(st, acc_out + head0 * D, stats_out + head0 * 2, G, D);
}

// VEC floats from p: one 16-byte (or 4-byte) load through L2
template <int VEC>
__device__ __forceinline__ void load_cg(const float* p, float* x) {
  if constexpr (VEC == 4) {
    const float4 v = __ldcg((const float4*)p);
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  } else {
    x[0] = __ldcg(p);
  }
}

template <typename TQ, int VEC>
__global__ void __launch_bounds__(COMBINE_THREADS)
    combine_kernel(const float* __restrict__ acc,
                   const float* __restrict__ stats, TQ* __restrict__ out,
                   int H, int D, int ns, int total) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int per_head = D / VEC;
  const int bh = t / per_head;                  // b * H + h
  const int dd = (t - bh * per_head) * VEC;
  const int b = bh / H, h = bh - b * H;
  const size_t bank0 = (size_t)b * ns * H + h;  // [B, ns, H] row of bank 0
  const float2* st = (const float2*)stats + bank0;
  const float* ap = acc + bank0 * D + dd;
  const size_t a_step = (size_t)H * D;
  repro::grid_dependency_wait();  // stage 1's partials written and visible

  float m_run = -INFINITY, l_run = 0.f, a_run[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) a_run[v] = 0.f;
  for (int s0 = 0; s0 < ns; s0 += COMBINE_CHUNK) {
    float2 ml[COMBINE_CHUNK];
    float a[COMBINE_CHUNK][VEC];
#pragma unroll
    for (int i = 0; i < COMBINE_CHUNK; ++i) {
      if (s0 + i < ns) {
        ml[i] = __ldcg(st + (size_t)(s0 + i) * H);
        load_cg<VEC>(ap + (s0 + i) * a_step, a[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < COMBINE_CHUNK; ++i) {
      if (s0 + i < ns) {
        float alpha, beta;
        merge_weights(m_run, ml[i].x, alpha, beta);
#pragma unroll
        for (int v = 0; v < VEC; ++v)
          a_run[v] = rescale(a_run[v], alpha, a[i][v], beta);
        l_run = rescale(l_run, alpha, ml[i].y, beta);
      }
    }
  }
  struct alignas(sizeof(TQ) * VEC) Pack {
    TQ x[VEC];
  } o;
#pragma unroll
  for (int v = 0; v < VEC; ++v)
    o.x[v] = repro::from_f32<TQ>(a_run[v] / fmaxf(l_run, 1e-30f));
  *(Pack*)(out + (size_t)bh * D + dd) = o;
}

template <typename TQ, int VEC>
int launch_combine(const float* acc, const float* stats, void* out, int H,
                   int D, int ns, int total, cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((total + COMBINE_THREADS - 1) / COMBINE_THREADS);
  cfg.blockDim = dim3(COMBINE_THREADS);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, combine_kernel<TQ, VEC>,
                                             acc, stats, (TQ*)out, H, D, ns,
                                             total);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename TQ, typename TC>
int launch_split(void* q, void* ck, void* cv, void* nk, void* nv, void* lens,
                 void* acc, void* stats, void* tiles, int B, int S, int Hkv,
                 int G, int D, int seq_tile, int n_tiles, int length_mask,
                 int ns, float scale, cudaStream_t st) {
  const Geometry g = geometry(G, D, (int)sizeof(TC));
  if (g.stages < 2) return (int)cudaErrorInvalidValue;
  const int vec = vector_rows(ck, cv, nk, nv, D, (int)sizeof(TC));
  auto kern = split_kernel<TQ, TC>;
  cudaError_t err = repro::allow_smem(kern, g.smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(B, Hkv, ns), THREADS, g.smem, st>>>(
      (const TQ*)q, (TC*)ck, (TC*)cv, (const TC*)nk, (const TC*)nv,
      (const int32_t*)lens, (float*)acc, (float*)stats, (int32_t*)tiles, S,
      Hkv, G, D, seq_tile, n_tiles, length_mask, ns, scale, g.pitch, g.fixed,
      g.stage_bytes, g.stages, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// Stage 1. q [B, Hkv*G, D] (q_dtype); caches [B, S, Hkv, D] (cache_dtype,
// updated in place); new_k/new_v [B, Hkv, D] (cache_dtype); lens/tiles [B]
// int32; acc [B, ns, Hkv*G, D] and stats [B, ns, Hkv*G, 2] (m, l) f32
// partials, written in full. n_tiles is the staged tile count.
extern "C" int kv_decode_split_partial(void* q, void* ck, void* cv, void* nk,
                                       void* nv, void* lens, void* acc,
                                       void* stats, void* tiles, int B, int S,
                                       int Hkv, int G, int D, int seq_tile,
                                       int n_tiles, int length_mask, int ns,
                                       float scale, int q_dtype,
                                       int cache_dtype, void* stream) {
  if (bad_geometry(B, Hkv, G, D, seq_tile) || ns < 1 || ns > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define REPRO_ARGS q, ck, cv, nk, nv, lens, acc, stats, tiles, B, S, Hkv, G, \
                   D, seq_tile, n_tiles, length_mask, ns, scale, st
  if (q_dtype == REPRO_F32 && cache_dtype == REPRO_F32)
    return launch_split<float, float>(REPRO_ARGS);
  if (q_dtype == REPRO_BF16 && cache_dtype == REPRO_F32)
    return launch_split<__nv_bfloat16, float>(REPRO_ARGS);
  if (q_dtype == REPRO_F32 && cache_dtype == REPRO_BF16)
    return launch_split<float, __nv_bfloat16>(REPRO_ARGS);
  if (q_dtype == REPRO_BF16 && cache_dtype == REPRO_BF16)
    return launch_split<__nv_bfloat16, __nv_bfloat16>(REPRO_ARGS);
#undef REPRO_ARGS
  return (int)cudaErrorInvalidValue;
}

// Stage 2. acc [B, ns, H, D] and stats [B, ns, H, 2] f32 as stage 1 wrote
// them (stats 8-byte aligned); out [B, H, D] (out_dtype). Launched as
// the programmatic dependent of the kernel before it on the stream.
extern "C" int kv_decode_split_combine(void* acc, void* stats, void* out,
                                       int B, int H, int D, int ns,
                                       int out_dtype, void* stream) {
  if (B <= 0 || H <= 0 || D <= 0 || ns < 1 || (uintptr_t)stats % 8 ||
      (size_t)B * H * D > 0x7fffffff ||
      (out_dtype != REPRO_F32 && out_dtype != REPRO_BF16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t out_vec = out_dtype == REPRO_F32 ? 16 : 8;
  const bool vec4 = D % 4 == 0 && (uintptr_t)acc % 16 == 0 &&
                    (uintptr_t)out % out_vec == 0;
  const int total = B * H * D / (vec4 ? 4 : 1);
#define REPRO_ARGS (const float*)acc, (const float*)stats, out, H, D, ns, \
                   total, st
  if (out_dtype == REPRO_F32)
    return vec4 ? launch_combine<float, 4>(REPRO_ARGS)
                : launch_combine<float, 1>(REPRO_ARGS);
  return vec4 ? launch_combine<__nv_bfloat16, 4>(REPRO_ARGS)
              : launch_combine<__nv_bfloat16, 1>(REPRO_ARGS);
#undef REPRO_ARGS
}

// Stage 1's shared-memory geometry for G heads of D dims over a cache of
// esize-byte elements: out = {row pitch in bytes, ring stages, dynamic
// shared memory in bytes}. What kv_multiport.split_geometry mirrors.
extern "C" int kv_decode_split_geometry(int G, int D, int esize, int* out) {
  if (G <= 0 || G > 32 || D <= 0 || D > 128 || (esize != 2 && esize != 4))
    return (int)cudaErrorInvalidValue;
  const Geometry g = geometry(G, D, esize);
  out[0] = g.pitch;
  out[1] = g.stages;
  out[2] = g.smem;
  return 0;
}
