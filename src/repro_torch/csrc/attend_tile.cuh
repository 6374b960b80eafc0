// The f32 register-tiled attention engine of B2's chunked prefill
// (kv_prefill_chunk.cu), and of nothing else: B5's f32 route
// (flash_attention.cu) has its own tensor-core engine.
//
// A block of 256 threads owns BM = 64 query rows and walks its keys in
// tiles of BN = 64. The caller fills q^T once and, per tile, k^T and v in
// shared memory (its own layouts and W-port overlays), then calls attend().
// The threads form a 16 x 16 grid: thread (ty, tx) computes the scores of
// rows ty*4..+3 against keys tx*4..+3 of the tile from q^T and k^T (two
// 16-byte shared loads per 16 FMAs), keeps the online-softmax max and sum
// of its 4 rows (reduced over the 16 tx lanes by shuffles), writes p^T to
// shared memory and accumulates p @ v into its 4 rows x DP/16 dims. All
// arithmetic is f32; the caller masks per element only on tiles that can
// hold a masked key (a diagonal tile, the ragged tail, missing rows).
#pragma once

#include "common.cuh"

namespace repro {
namespace tile {

constexpr int BM = 64;            // query rows per block
constexpr int BN = 64;            // keys per shared-memory tile
constexpr int TX = 16, TY = 16;   // thread grid
constexpr int THREADS = TX * TY;
constexpr int RM = BM / TY;       // rows per thread
constexpr int CN = BN / TX;       // keys per thread in a score tile
constexpr int BMP = BM + 4;       // padded row strides: 16-byte aligned
constexpr int BNP = BN + 4;
static_assert(RM == 4 && CN == 4, "the inner loops move 4 rows / 4 keys as one float4");

// v rows are padded by 4 floats so a key-per-lane float4 store spreads
// over the banks; the p @ v loop reads a row contiguously either way.
template <int DP>
__host__ __device__ constexpr int vstride() { return DP + 4; }

template <int DP>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(float) *
         (DP * BMP + DP * BNP + BN * vstride<DP>() + BN * BMP);
}

// Views of the dynamic shared memory: q^T [DP][BMP], k^T [DP][BNP],
// v [BN][DP + 4], p^T [BN][BMP].
template <int DP>
struct Smem {
  float *qt, *kt, *vs, *pt;
  __device__ explicit Smem(float* base)
      : qt(base),
        kt(base + DP * BMP),
        vs(base + DP * BMP + DP * BNP),
        pt(base + DP * BMP + DP * BNP + BN * vstride<DP>()) {}
};

// One thread's 4 rows: their positions (-1: no row, never stored), the
// online-softmax max m and denominator l, and DP/16 output dims each.
template <int DP>
struct Rows {
  static constexpr int DT = DP / TX;
  int qpos[RM];
  float m[RM], l[RM], acc[RM][DT];

  __device__ void init() {
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      m[i] = -INFINITY;
      l[i] = 0.f;
#pragma unroll
      for (int dd = 0; dd < DT; ++dd) acc[i][dd] = 0.f;
    }
  }

  // the output of row i, dim tx * DT + dd (denominator floored at 1e-30)
  __device__ float out(int i, int dd) const {
    return acc[i][dd] / fmaxf(l[i], 1e-30f);
  }
};

// One key tile [k0, k0 + BN), already in sm.kt / sm.vs (the caller synced
// after filling them; keys at or past kend hold zeros). A key is kept for a
// row when qpos >= 0, key < kend and (causal) key <= qpos; `masked` false
// promises that every key of the tile is kept for every row. Ends with the
// p^T tile consumed up to the caller's next sync.
template <int DP>
__device__ __forceinline__ void attend(const Smem<DP>& sm, Rows<DP>& st,
                                       int tx, int ty, int k0, int kend,
                                       bool causal, bool masked,
                                       float scale) {
  constexpr int DT = DP / TX;
  constexpr int VS = vstride<DP>();
  float s[RM][CN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < CN; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < DP; ++d) {
    const float4 qa = *reinterpret_cast<const float4*>(sm.qt + d * BMP + ty * RM);
    const float4 ka = *reinterpret_cast<const float4*>(sm.kt + d * BNP + tx * CN);
    const float qv[RM] = {qa.x, qa.y, qa.z, qa.w};
    const float kv[CN] = {ka.x, ka.y, ka.z, ka.w};
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < CN; ++j) {
      const int key = k0 + tx * CN + j;
      const bool ok = !masked || (st.qpos[i] >= 0 && key < kend &&
                                  (!causal || key <= st.qpos[i]));
      s[i][j] = ok ? s[i][j] * scale : -INFINITY;
      mx = fmaxf(mx, s[i][j]);
    }
    for (int o = TX / 2; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float m_new = fmaxf(st.m[i], mx);
    const float alpha = (st.m[i] == -INFINITY) ? 0.f : expf(st.m[i] - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < CN; ++j) {
      s[i][j] = (s[i][j] == -INFINITY) ? 0.f : expf(s[i][j] - m_new);
      sum += s[i][j];
    }
    for (int o = TX / 2; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    st.l[i] = st.l[i] * alpha + sum;
    st.m[i] = m_new;
#pragma unroll
    for (int dd = 0; dd < DT; ++dd) st.acc[i][dd] *= alpha;
  }
#pragma unroll
  for (int j = 0; j < CN; ++j)
    *reinterpret_cast<float4*>(sm.pt + (tx * CN + j) * BMP + ty * RM) =
        make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
  __syncthreads();

  const int nk = min(BN, kend - k0);
  for (int j = 0; j < nk; ++j) {
    const float4 pa = *reinterpret_cast<const float4*>(sm.pt + j * BMP + ty * RM);
    const float p[RM] = {pa.x, pa.y, pa.z, pa.w};
    float vv[DT];
    const float* vr = sm.vs + j * VS + tx * DT;
    if constexpr (DT % 4 == 0) {
#pragma unroll
      for (int u = 0; u < DT; u += 4) {
        const float4 va = *reinterpret_cast<const float4*>(vr + u);
        vv[u] = va.x; vv[u + 1] = va.y; vv[u + 2] = va.z; vv[u + 3] = va.w;
      }
    } else {
#pragma unroll
      for (int u = 0; u < DT; ++u) vv[u] = vr[u];
    }
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int dd = 0; dd < DT; ++dd)
        st.acc[i][dd] = fmaf(p[i], vv[dd], st.acc[i][dd]);
  }
}

}  // namespace tile
}  // namespace repro
