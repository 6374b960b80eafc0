// Fused chunked-prefill append+attend: one chunk of C prompt rows per
// sequence, the KV cache serviced as a 1W+1R memory in one traversal.
//
// Replaces the TPU kernel src/repro/kernels/kv_prefill_chunk.py:_kernel
// (pallas_call in fused_chunk_append_attend). The TPU routes the chunk's
// rows into each cache tile with a one-hot matmul and walks a sequential
// (batch, tiles) grid; here the W port is an indexed store and every
// (row, kv-head, query-row block) is its own block looping over its row's
// live positions.
//
// What bounds it on an H100: bytes at the main path's shapes. A row reads
// its live K/V once ((offset + chunk_len) * Hkv * D * 2 elements) and does
// 4 * C * H * live * D flops: with C = 16 query rows per head the arithmetic
// intensity is ~16 flops per f32 byte, still under the ridge point of the
// f32 CUDA cores' 67 TFLOP/s against 3.35 TB/s.
//
// Design: block (b, hk, z) holds up to RB = 64 of its C*G query rows
// (row r = chunk row r / G, head r % G) in shared memory together with
// their f32 accumulators, and streams its kv head's K/V through shared
// memory in chunks of 32 keys (one key per lane). Warp w owns rows w, w+8,
// ...; the online-softmax max and sum are warp shuffles and each lane
// updates D/32 accumulator dims. The W port: block z == 0 stores the chunk
// rows rel in [0, chunk_len) at offset + rel. Every block overlays those
// rows on the K/V chunk it holds in shared memory, so W->R visibility needs
// no ordering between blocks (the query rows are split across z). Padded
// rows (rel >= chunk_len) attend as position offset; a dead row
// (offset < 0) writes nothing, outputs zeros and services 0 tiles.
#include "common.cuh"

namespace {

constexpr int KC = 32;        // keys per shared-memory chunk: one per lane
constexpr int NWARPS = 8;
constexpr int THREADS = NWARPS * 32;
constexpr int RB = 64;        // query rows per block
constexpr int RPW = RB / NWARPS;
constexpr int MAXDL = 4;      // dims per lane: D <= 128

template <typename TQ, typename TC>
__global__ void chunk_kernel(const TQ* __restrict__ q, TC* __restrict__ ck,
                             TC* __restrict__ cv, const TC* __restrict__ nk,
                             const TC* __restrict__ nv,
                             const int32_t* __restrict__ offs,
                             const int32_t* __restrict__ clens,
                             TQ* __restrict__ out,
                             int32_t* __restrict__ tiles, int S, int C,
                             int Hkv, int G, int D, int seq_tile, int n_tiles,
                             float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, hk = blockIdx.y, z = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int H = Hkv * G, R = C * G, DP = D + 1;
  const int r0 = z * RB, nrows = min(RB, R - r0);
  float* qs = smem;               // [RB][D]
  float* acc = qs + RB * D;       // [RB][D]
  float* ks = acc + RB * D;       // [KC][DP]
  float* vs = ks + KC * DP;       // [KC][DP]
  float* ps = vs + KC * DP;       // [NWARPS][KC]

  const int off = offs[b], cl = clens[b];
  // out/q row r of this block: chunk row c = r / G, head hk * G + r % G
  auto qrow = [&](int r) -> size_t {
    const int c = r / G, g = r - c * G;
    return (((size_t)b * C + c) * H + (size_t)hk * G + g) * D;
  };
  if (off < 0) {  // dead row
    for (int i = tid; i < nrows * D; i += THREADS)
      out[qrow(r0 + i / D) + i % D] = repro::from_f32<TQ>(0.f);
    if (hk == 0 && z == 0 && tid == 0) tiles[b] = 0;
    return;
  }
  const int qmax = off + max(cl - 1, 0);  // last position any row attends
  if (hk == 0 && z == 0 && tid == 0)
    tiles[b] = min((qmax + seq_tile) / seq_tile, n_tiles);

  const int limit = min(n_tiles * seq_tile, S);
  const size_t rstride = (size_t)Hkv * D;
  const TC* nkb = nk + (size_t)b * C * rstride + (size_t)hk * D;
  const TC* nvb = nv + (size_t)b * C * rstride + (size_t)hk * D;
  // W port: the chunk's rows, in this kv head's columns (one z-block only)
  if (z == 0) {
    const int nw = max(0, min(cl, limit - off));
    for (int i = tid; i < nw * D; i += THREADS) {
      const int rel = i / D, dd = i - rel * D;
      const size_t at = ((size_t)b * S + off + rel) * rstride + (size_t)hk * D + dd;
      ck[at] = nkb[(size_t)rel * rstride + dd];
      cv[at] = nvb[(size_t)rel * rstride + dd];
    }
  }
  for (int i = tid; i < RB * D; i += THREADS) {
    const int r = i / D;
    qs[i] = r < nrows ? repro::to_f32(q[qrow(r0 + r) + i % D]) : 0.f;
    acc[i] = 0.f;
  }
  float m[RPW], l[RPW];
  int qpos[RPW];
#pragma unroll
  for (int k = 0; k < RPW; ++k) {
    m[k] = -INFINITY;
    l[k] = 0.f;
    const int r = warp + k * NWARPS, c = (r0 + r) / G;
    qpos[k] = (r < nrows) ? (c < cl ? off + c : off) : -1;
  }
  const int end = min(qmax + 1, limit);  // R port: keys [0, end)
  __syncthreads();

  for (int k0 = 0; k0 < end; k0 += KC) {
    for (int i = tid; i < KC * D; i += THREADS) {
      const int j = i / D, dd = i - j * D, pos = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (pos < end) {
        const int rel = pos - off;
        if (rel >= 0 && rel < cl) {  // W->R visibility through shared memory
          kx = repro::to_f32(nkb[(size_t)rel * rstride + dd]);
          vx = repro::to_f32(nvb[(size_t)rel * rstride + dd]);
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
    const int pos = k0 + lane;
#pragma unroll
    for (int k = 0; k < RPW; ++k) {
      const int r = warp + k * NWARPS;
      if (qpos[k] < k0) continue;  // padding row or chunk wholly masked
      const bool valid = pos < end && pos <= qpos[k];
      float s = -INFINITY;
      if (valid) {
        float dot = 0.f;
        const float* qr = qs + r * D;
        const float* kr = ks + lane * DP;
        for (int dd = 0; dd < D; ++dd) dot = fmaf(qr[dd], kr[dd], dot);
        s = dot * scale;
      }
      const float m_new = fmaxf(m[k], repro::warp_max(s));
      const float alpha = (m[k] == -INFINITY) ? 0.f : expf(m[k] - m_new);
      const float pr = valid ? expf(s - m_new) : 0.f;
      l[k] = l[k] * alpha + repro::warp_sum(pr);
      ps[warp * KC + lane] = pr;
      __syncwarp();
      float* ar = acc + r * D;
#pragma unroll
      for (int i = 0; i < MAXDL; ++i) {
        const int dd = lane + 32 * i;
        if (dd < D) {
          float a = ar[dd] * alpha;
          for (int j = 0; j < KC; ++j) a = fmaf(ps[warp * KC + j], vs[j * DP + dd], a);
          ar[dd] = a;
        }
      }
      __syncwarp();
      m[k] = m_new;
    }
    __syncthreads();
  }

#pragma unroll
  for (int k = 0; k < RPW; ++k) {
    const int r = warp + k * NWARPS;
    if (r >= nrows) continue;
    const float den = fmaxf(l[k], 1e-30f);
    const float* ar = acc + r * D;
    TQ* orow = out + qrow(r0 + r);
    for (int dd = lane; dd < D; dd += 32) orow[dd] = repro::from_f32<TQ>(ar[dd] / den);
  }
}

template <typename TQ, typename TC>
int launch(void* q, void* ck, void* cv, void* nk, void* nv, void* offs,
           void* clens, void* out, void* tiles, int B, int S, int C, int Hkv,
           int G, int D, int seq_tile, int n_tiles, float scale,
           cudaStream_t st) {
  const size_t smem =
      sizeof(float) * (2 * RB * D + 2 * KC * (D + 1) + NWARPS * KC);
  auto kern = chunk_kernel<TQ, TC>;
  cudaError_t err = repro::allow_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  const int zblocks = (C * G + RB - 1) / RB;
  kern<<<dim3(B, Hkv, zblocks), THREADS, smem, st>>>(
      (const TQ*)q, (TC*)ck, (TC*)cv, (const TC*)nk, (const TC*)nv,
      (const int32_t*)offs, (const int32_t*)clens, (TQ*)out,
      (int32_t*)tiles, S, C, Hkv, G, D, seq_tile, n_tiles, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q/out [B, C, Hkv*G, D] (q_dtype); caches [B, S, Hkv, D] (cache_dtype,
// updated in place); new_k/new_v [B, C, Hkv, D] (cache_dtype);
// offset/chunk_len/tiles [B] int32. n_tiles is the staged tile count.
extern "C" int kv_chunk_append_attend(void* q, void* ck, void* cv, void* nk,
                                      void* nv, void* offs, void* clens,
                                      void* out, void* tiles, int B, int S,
                                      int C, int Hkv, int G, int D,
                                      int seq_tile, int n_tiles, float scale,
                                      int q_dtype, int cache_dtype,
                                      void* stream) {
  if (B <= 0 || C <= 0 || Hkv <= 0 || G <= 0 || D <= 0 || D > 32 * MAXDL ||
      seq_tile <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define REPRO_ARGS q, ck, cv, nk, nv, offs, clens, out, tiles, B, S, C, Hkv, \
                   G, D, seq_tile, n_tiles, scale, st
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
