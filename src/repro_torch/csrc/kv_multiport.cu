// Fused decode append+attend: the KV cache serviced as a 1W+1R memory in
// one traversal (the paper's claim C1 on the serving path).
//
// Replaces the TPU kernel src/repro/kernels/kv_multiport.py:_kernel
// (pallas_call in fused_append_attend, num_kv_splits=1). The TPU walks a
// sequential (batch, tiles) grid bounded by the batch's longest row; here
// every (row, kv-head) pair is its own block and loops over ITS row's live
// positions only, so no host sync or batch-max bound is needed.
//
// What bounds it on an H100: bytes. Each row reads its live K and V once
// (2 * (len+1) * Hkv * D elements) and does 4 * H * (len+1) * D flops on
// them, about one flop per byte for f32 caches — far below the card's
// ridge point.
//
// Design: block (b, hk) holds its G query heads in shared memory and
// streams its kv head's K/V through shared memory in chunks of 32 keys
// (one key per lane). Warp w owns heads w, w+8, ...: scores are lane-local
// dot products, the online-softmax max and sum are warp shuffles, and each
// lane accumulates D/32 output dims in registers (f32 throughout). The W
// port writes only the appended row, and the block is the sole writer of
// the columns it reads; it overlays new_k/new_v on the chunk it holds in
// shared memory, so its scores never depend on the global write landing
// first. Contract kept from the TPU kernel: f32 accumulation,
// alpha = exp(m_prev - m_new) guarded while m_prev is -inf, the 1e-30 floor
// on the denominator, and a dead row (cache_len < 0) writes nothing,
// outputs zeros and services 0 tiles. The tile count is written by the
// kv-head-0 block.
#include "common.cuh"

namespace {

constexpr int KC = 32;       // keys per shared-memory chunk: one per lane
constexpr int NWARPS = 8;
constexpr int THREADS = NWARPS * 32;
constexpr int MAXHPW = 4;    // heads per warp: G <= 32
constexpr int MAXDL = 4;     // dims per lane: D <= 128

template <typename TQ, typename TC>
__global__ void decode_kernel(const TQ* __restrict__ q, TC* __restrict__ ck,
                              TC* __restrict__ cv,
                              const TC* __restrict__ nk,
                              const TC* __restrict__ nv,
                              const int32_t* __restrict__ lens,
                              TQ* __restrict__ out, int32_t* __restrict__ tiles,
                              int S, int Hkv, int G, int D, int seq_tile,
                              int n_tiles, int length_mask, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, hk = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int H = Hkv * G, DP = D + 1;  // padded K/V rows: conflict-free
  float* qs = smem;                   // [G][D]
  float* ks = qs + G * D;             // [KC][DP]
  float* vs = ks + KC * DP;           // [KC][DP]
  float* ps = vs + KC * DP;           // [NWARPS][KC]

  const int p = lens[b];
  TQ* o = out + ((size_t)b * H + (size_t)hk * G) * D;
  if (p < 0) {  // dead row: no write, zero output, zero tiles
    for (int i = tid; i < G * D; i += THREADS) o[i] = repro::from_f32<TQ>(0.f);
    if (hk == 0 && tid == 0) tiles[b] = 0;
    return;
  }
  if (hk == 0 && tid == 0)
    tiles[b] = length_mask ? min((p + seq_tile) / seq_tile, n_tiles) : n_tiles;

  const int limit = min(n_tiles * seq_tile, S);  // staged positions
  const size_t rstride = (size_t)Hkv * D;
  const TC* nkr = nk + ((size_t)b * Hkv + hk) * D;
  const TC* nvr = nv + ((size_t)b * Hkv + hk) * D;
  // W port: the appended row lands at p, in this block's columns only
  if (p < limit) {
    const size_t at = ((size_t)b * S + p) * rstride + (size_t)hk * D;
    for (int i = tid; i < D; i += THREADS) {
      ck[at + i] = nkr[i];
      cv[at + i] = nvr[i];
    }
  }
  const TQ* qb = q + ((size_t)b * H + (size_t)hk * G) * D;
  for (int i = tid; i < G * D; i += THREADS) qs[i] = repro::to_f32(qb[i]);

  float m[MAXHPW], l[MAXHPW], acc[MAXHPW][MAXDL];
#pragma unroll
  for (int h = 0; h < MAXHPW; ++h) {
    m[h] = -INFINITY;
    l[h] = 0.f;
#pragma unroll
    for (int i = 0; i < MAXDL; ++i) acc[h][i] = 0.f;
  }
  const int end = min(p + 1, limit);  // R port: keys [0, end)
  __syncthreads();

  for (int k0 = 0; k0 < end; k0 += KC) {
    for (int i = tid; i < KC * D; i += THREADS) {
      const int j = i / D, dd = i - j * D, pos = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (pos < end) {
        if (pos == p) {  // W->R visibility through shared memory
          kx = repro::to_f32(nkr[dd]);
          vx = repro::to_f32(nvr[dd]);
        } else {
          const size_t at = ((size_t)b * S + pos) * rstride + (size_t)hk * D + dd;
          kx = repro::to_f32(ck[at]);
          vx = repro::to_f32(cv[at]);
        }
      }
      ks[j * DP + dd] = kx;
      vs[j * DP + dd] = vx;
    }
    __syncthreads();
    const bool valid = k0 + lane < end;
#pragma unroll
    for (int h = 0; h < MAXHPW; ++h) {
      const int g = warp + h * NWARPS;
      if (g >= G) break;  // warp-uniform
      float s = -INFINITY;
      if (valid) {
        float dot = 0.f;
        const float* qr = qs + g * D;
        const float* kr = ks + lane * DP;
        for (int dd = 0; dd < D; ++dd) dot = fmaf(qr[dd], kr[dd], dot);
        s = dot * scale;
      }
      const float m_new = fmaxf(m[h], repro::warp_max(s));
      const float alpha = (m[h] == -INFINITY) ? 0.f : expf(m[h] - m_new);
      const float pr = valid ? expf(s - m_new) : 0.f;
      l[h] = l[h] * alpha + repro::warp_sum(pr);
      ps[warp * KC + lane] = pr;
      __syncwarp();
#pragma unroll
      for (int i = 0; i < MAXDL; ++i) {
        const int dd = lane + 32 * i;
        if (dd < D) {
          float a = acc[h][i] * alpha;
          for (int j = 0; j < KC; ++j) a = fmaf(ps[warp * KC + j], vs[j * DP + dd], a);
          acc[h][i] = a;
        }
      }
      __syncwarp();
      m[h] = m_new;
    }
    __syncthreads();
  }

#pragma unroll
  for (int h = 0; h < MAXHPW; ++h) {
    const int g = warp + h * NWARPS;
    if (g >= G) break;
    const float den = fmaxf(l[h], 1e-30f);
#pragma unroll
    for (int i = 0; i < MAXDL; ++i) {
      const int dd = lane + 32 * i;
      if (dd < D) o[g * D + dd] = repro::from_f32<TQ>(acc[h][i] / den);
    }
  }
}

template <typename TQ, typename TC>
int launch(void* q, void* ck, void* cv, void* nk, void* nv, void* lens,
           void* out, void* tiles, int B, int S, int Hkv, int G, int D,
           int seq_tile, int n_tiles, int length_mask, float scale,
           cudaStream_t st) {
  const size_t smem = sizeof(float) * (G * D + 2 * KC * (D + 1) + NWARPS * KC);
  auto kern = decode_kernel<TQ, TC>;
  cudaError_t err = repro::allow_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(B, Hkv), THREADS, smem, st>>>(
      (const TQ*)q, (TC*)ck, (TC*)cv, (const TC*)nk, (const TC*)nv,
      (const int32_t*)lens, (TQ*)out, (int32_t*)tiles, S, Hkv, G, D, seq_tile,
      n_tiles, length_mask, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q/out [B, Hkv*G, D] (q_dtype); caches [B, S, Hkv, D] (cache_dtype, updated
// in place); new_k/new_v [B, Hkv, D] (cache_dtype); lens/tiles [B] int32.
// n_tiles is the staged tile count (the traversal never passes
// n_tiles * seq_tile positions).
extern "C" int kv_decode_append_attend(void* q, void* ck, void* cv, void* nk,
                                       void* nv, void* lens, void* out,
                                       void* tiles, int B, int S, int Hkv,
                                       int G, int D, int seq_tile, int n_tiles,
                                       int length_mask, float scale,
                                       int q_dtype, int cache_dtype,
                                       void* stream) {
  if (B <= 0 || Hkv <= 0 || G <= 0 || G > NWARPS * MAXHPW || D <= 0 ||
      D > 32 * MAXDL || seq_tile <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define REPRO_ARGS q, ck, cv, nk, nv, lens, out, tiles, B, S, Hkv, G, D, \
                   seq_tile, n_tiles, length_mask, scale, st
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
