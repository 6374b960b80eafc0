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
// What bounds it on an H100: operations at the long path's call. A block
// holds 64 of a kv head's C*G query rows and reads the row's live K/V once
// per block; at C = 128 over a 2K context the f32 pairs take 0.081 ms at the
// CUDA cores' 67 TFLOP/s and the bytes 0.02 ms. At the short path's C = 16
// it is bytes and launch latency.
//
// Design: block (b, hk, z) owns BM = 64 of the C*G query rows of kv head hk
// (row r = chunk row r / G of head hk * G + r % G), so each K/V tile in
// shared memory serves all G query heads, and runs the register-tiled f32
// engine of attend_tile.cuh: 64-key tiles, a 16 x 16 thread grid with
// 4 x 4 score and 4 x D/16 output micro-tiles, online softmax over 16-lane
// shuffles. K/V rows come in as
// 16-byte loads, one key per lane, so the transposed k^T stores hit
// distinct banks. Row positions: qpos = offset + rel for rel < chunk_len;
// padded rows attend as position offset. A block's keys are [0, min(its
// last qpos + 1, n_tiles * seq_tile)); only tiles that reach past its first
// row's position, its key end or its missing rows mask per element. The W
// port: block z == 0 stores the chunk rows rel in [0, chunk_len) at
// offset + rel, and every block overlays those rows from new_k/new_v on the
// K/V tile it holds, so W->R visibility needs no ordering between blocks.
// A dead row (offset < 0) writes nothing, outputs zeros and services 0
// tiles. Sums are f32 (the serving engine's caches are f32) and the
// denominator has a floor of 1e-30.
#include "attend_tile.cuh"

namespace {

using namespace repro::tile;

// 4 consecutive cache elements as f32 (16 bytes of f32, 8 of bf16)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

template <typename TQ, typename TC, int DP>
__global__ void __launch_bounds__(THREADS)
chunk_kernel(const TQ* __restrict__ q, TC* __restrict__ ck,
             TC* __restrict__ cv, const TC* __restrict__ nk,
             const TC* __restrict__ nv, const int32_t* __restrict__ offs,
             const int32_t* __restrict__ clens, TQ* __restrict__ out,
             int32_t* __restrict__ tiles, int S, int C, int Hkv, int G, int D,
             int seq_tile, int n_tiles, float scale, int vec) {
  constexpr int DT = DP / TX;       // output dims per thread
  constexpr int VS = vstride<DP>();
  extern __shared__ __align__(16) float smem[];
  const Smem<DP> sm(smem);
  const int b = blockIdx.x, hk = blockIdx.y, z = blockIdx.z;
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int H = Hkv * G, R = C * G;
  const int r0 = z * BM, nrows = min(BM, R - r0);

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
  for (int i = tid; i < BM * DP; i += THREADS) {
    const int r = i / DP, d = i - r * DP;
    sm.qt[d * BMP + r] = (r < nrows && d < D)
                             ? repro::to_f32(q[qrow(r0 + r) + d]) : 0.f;
  }
  auto pos_of = [&](int c) { return c < cl ? off + c : off; };
  Rows<DP> st;
  st.init();
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = ty * RM + i;
    st.qpos[i] = r < nrows ? pos_of((r0 + r) / G) : -1;
  }
  // the block's chunk rows c_lo..c_hi: the largest and smallest position
  const int c_lo = r0 / G, c_hi = (r0 + nrows - 1) / G;
  const int hi = min(c_hi, cl - 1);
  const int qlast = hi >= c_lo ? off + hi : off;
  const int qfirst = c_hi < cl ? off + c_lo : off;
  const int kend = min(qlast + 1, limit);  // R port: keys [0, kend)

  for (int k0 = 0; k0 < kend; k0 += BN) {
    __syncthreads();  // the previous tile's p^T and v are consumed
    if (vec) {  // 16-byte loads, one key per lane
      for (int i = tid; i < BN * (DP / 4); i += THREADS) {
        const int j = i % BN, d = (i / BN) * 4, pos = k0 + j;
        float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
        if (pos < kend && d < D) {
          const int rel = pos - off;
          const bool fresh = rel >= 0 && rel < cl;  // W->R in shared memory
          const size_t at = fresh ? (size_t)rel * rstride + d
                                  : ((size_t)b * S + pos) * rstride + (size_t)hk * D + d;
          kx = load4((fresh ? nkb : ck) + at);
          vx = load4((fresh ? nvb : cv) + at);
        }
        sm.kt[(d + 0) * BNP + j] = kx.x;
        sm.kt[(d + 1) * BNP + j] = kx.y;
        sm.kt[(d + 2) * BNP + j] = kx.z;
        sm.kt[(d + 3) * BNP + j] = kx.w;
        *reinterpret_cast<float4*>(sm.vs + j * VS + d) = vx;
      }
    } else {
      for (int i = tid; i < BN * DP; i += THREADS) {
        const int j = i % BN, d = i / BN, pos = k0 + j;
        float kx = 0.f, vx = 0.f;
        if (pos < kend && d < D) {
          const int rel = pos - off;
          const bool fresh = rel >= 0 && rel < cl;
          const size_t at = fresh ? (size_t)rel * rstride + d
                                  : ((size_t)b * S + pos) * rstride + (size_t)hk * D + d;
          kx = repro::to_f32((fresh ? nkb : ck)[at]);
          vx = repro::to_f32((fresh ? nvb : cv)[at]);
        }
        sm.kt[d * BNP + j] = kx;
        sm.vs[j * VS + d] = vx;
      }
    }
    __syncthreads();
    const bool masked = k0 + BN - 1 > qfirst || k0 + BN > kend || nrows < BM;
    attend(sm, st, tx, ty, k0, kend, true, masked, scale);
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    if (st.qpos[i] < 0) continue;
    TQ* orow = out + qrow(r0 + ty * RM + i);
#pragma unroll
    for (int dd = 0; dd < DT; ++dd) {
      const int d = tx * DT + dd;
      if (d < D) orow[d] = repro::from_f32<TQ>(st.out(i, dd));
    }
  }
}

template <typename TQ, typename TC, int DP>
int launch(void* q, void* ck, void* cv, void* nk, void* nv, void* offs,
           void* clens, void* out, void* tiles, int B, int S, int C, int Hkv,
           int G, int D, int seq_tile, int n_tiles, float scale,
           cudaStream_t st) {
  auto kern = chunk_kernel<TQ, TC, DP>;
  constexpr size_t smem = smem_bytes<DP>();
  cudaError_t err = repro::allow_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  const int zblocks = (C * G + BM - 1) / BM;
  // 4-element loads need D % 4 == 0 and 16-byte aligned cache bases
  const uintptr_t bases = (uintptr_t)ck | (uintptr_t)cv | (uintptr_t)nk |
                          (uintptr_t)nv;
  const int vec = D % 4 == 0 && bases % 16 == 0;
  kern<<<dim3(B, Hkv, zblocks), THREADS, smem, st>>>(
      (const TQ*)q, (TC*)ck, (TC*)cv, (const TC*)nk, (const TC*)nv,
      (const int32_t*)offs, (const int32_t*)clens, (TQ*)out,
      (int32_t*)tiles, S, C, Hkv, G, D, seq_tile, n_tiles, scale, vec);
  return (int)cudaGetLastError();
}

template <typename TQ, typename TC>
int launch_d(void* q, void* ck, void* cv, void* nk, void* nv, void* offs,
             void* clens, void* out, void* tiles, int B, int S, int C,
             int Hkv, int G, int D, int seq_tile, int n_tiles, float scale,
             cudaStream_t st) {
#define REPRO_ARGS q, ck, cv, nk, nv, offs, clens, out, tiles, B, S, C, Hkv, \
                   G, D, seq_tile, n_tiles, scale, st
  // D <= 16 pads to 32, as B5's instantiations do
  if (D <= 32) return launch<TQ, TC, 32>(REPRO_ARGS);
  if (D <= 64) return launch<TQ, TC, 64>(REPRO_ARGS);
  return launch<TQ, TC, 128>(REPRO_ARGS);
#undef REPRO_ARGS
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
  if (B <= 0 || C <= 0 || Hkv <= 0 || G <= 0 || D <= 0 || D > 128 ||
      seq_tile <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define REPRO_ARGS q, ck, cv, nk, nv, offs, clens, out, tiles, B, S, C, Hkv, \
                   G, D, seq_tile, n_tiles, scale, st
  if (q_dtype == REPRO_F32 && cache_dtype == REPRO_F32)
    return launch_d<float, float>(REPRO_ARGS);
  if (q_dtype == REPRO_BF16 && cache_dtype == REPRO_F32)
    return launch_d<__nv_bfloat16, float>(REPRO_ARGS);
  if (q_dtype == REPRO_F32 && cache_dtype == REPRO_BF16)
    return launch_d<float, __nv_bfloat16>(REPRO_ARGS);
  if (q_dtype == REPRO_BF16 && cache_dtype == REPRO_BF16)
    return launch_d<__nv_bfloat16, __nv_bfloat16>(REPRO_ARGS);
#undef REPRO_ARGS
  return (int)cudaErrorInvalidValue;
}
