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
// Design: block (b, hk) runs the shared R-port loop of decode_attend.cuh
// over its row's keys [0, cache_len] and normalizes. The W port writes
// only the appended row, and the block is the sole writer of the columns
// it reads; the loop overlays new_k/new_v on the chunk it holds in shared
// memory, so its scores never depend on the global write landing first.
// Contract kept from the TPU kernel: f32 accumulation, alpha =
// exp(m_prev - m_new) guarded while m_prev is -inf, the 1e-30 floor on the
// denominator, and a dead row (cache_len < 0) writes nothing, outputs
// zeros and services 0 tiles. The tile count is written by the kv-head-0
// block.
#include "decode_attend.cuh"

namespace {

using namespace repro::decode;

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
  const int H = Hkv * G;

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
  const TC* nkr = nk + ((size_t)b * Hkv + hk) * D;
  const TC* nvr = nv + ((size_t)b * Hkv + hk) * D;
  if (p < limit) append_row(ck, cv, nkr, nvr, b, hk, p, S, Hkv, D);
  const TQ* qb = q + ((size_t)b * H + (size_t)hk * G) * D;
  State st;
  attend(smem, qb, ck, cv, nkr, nvr, b, hk, p, 0, min(p + 1, limit), S, Hkv,
         G, D, scale, st);  // R port: keys [0, min(p + 1, limit))

#pragma unroll
  for (int h = 0; h < MAXHPW; ++h) {
    const int g = warp + h * NWARPS;
    if (g >= G) break;
    const float den = fmaxf(st.l[h], 1e-30f);
#pragma unroll
    for (int i = 0; i < MAXDL; ++i) {
      const int dd = lane + 32 * i;
      if (dd < D) o[g * D + dd] = repro::from_f32<TQ>(st.acc[h][i] / den);
    }
  }
}

template <typename TQ, typename TC>
int launch(void* q, void* ck, void* cv, void* nk, void* nv, void* lens,
           void* out, void* tiles, int B, int S, int Hkv, int G, int D,
           int seq_tile, int n_tiles, int length_mask, float scale,
           cudaStream_t st) {
  const size_t smem = smem_bytes(G, D);
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
  if (bad_geometry(B, Hkv, G, D, seq_tile)) return (int)cudaErrorInvalidValue;
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
