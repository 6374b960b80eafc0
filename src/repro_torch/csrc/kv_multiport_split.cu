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
// What bounds them on an H100: bytes. Stage 1 reads each live K/V row once
// (about one flop per byte for f32 caches) and writes ns f32 partials per
// head; stage 2 reads the partials once and writes the output.
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
// Stage 2, block (b, hk): threads over the G x D outputs walk the ns banks
// in order with decode_attend.cuh's merge (the TPU kernel's guards), then
// divide by max(l, 1e-30) and write q's dtype. A fully dead row gives
// zeros.
#include "decode_attend.cuh"

namespace {

using namespace repro::decode;

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

template <typename TQ>
__global__ void combine_kernel(const float* __restrict__ acc,
                              const float* __restrict__ stats,
                              TQ* __restrict__ out, int Hkv, int G, int D,
                              int ns) {
  const int b = blockIdx.x, hk = blockIdx.y;
  const int H = Hkv * G;
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
    const int g = i / D, dd = i - g * D, h = hk * G + g;
    float m_run = -INFINITY, l_run = 0.f, a_run = 0.f;
    for (int si = 0; si < ns; ++si) {
      const size_t row = ((size_t)b * ns + si) * H + h;
      merge(m_run, l_run, a_run, stats[row * 2], stats[row * 2 + 1],
            acc[row * D + dd]);
    }
    out[((size_t)b * H + h) * D + dd] =
        repro::from_f32<TQ>(a_run / fmaxf(l_run, 1e-30f));
  }
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

// Stage 2. acc/stats as written by stage 1; out [B, Hkv*G, D] (out_dtype).
extern "C" int kv_decode_split_combine(void* acc, void* stats, void* out,
                                       int B, int Hkv, int G, int D, int ns,
                                       int out_dtype, void* stream) {
  if (B <= 0 || Hkv <= 0 || G <= 0 || D <= 0 || ns < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(B, Hkv);
  const int threads = G * D < 256 ? G * D : 256;
  if (out_dtype == REPRO_F32)
    combine_kernel<float><<<grid, threads, 0, st>>>(
        (const float*)acc, (const float*)stats, (float*)out, Hkv, G, D, ns);
  else if (out_dtype == REPRO_BF16)
    combine_kernel<__nv_bfloat16><<<grid, threads, 0, st>>>(
        (const float*)acc, (const float*)stats, (__nv_bfloat16*)out, Hkv, G,
        D, ns);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
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
