// The decode R port of one (row, kv-head) block, shared by the serial
// decode kernel (kv_multiport.cu) and stage 1 of split-KV decode
// (kv_multiport_split.cu).
//
// A block holds its kv head's G query heads in shared memory and streams
// the keys of one range [lo, hi) of its row through shared memory in
// chunks of 32 (one key per lane). Warp w owns heads w, w+8, ...: scores
// are lane-local dot products, the online-softmax max and sum are warp
// shuffles, and each lane accumulates D/32 output dims in registers (f32
// throughout). The appended row (position p) is overlaid from new_k/new_v
// in shared memory, so the scores never depend on the global write of the
// W port landing first; only the block that owns p may read it.
#pragma once

#include "common.cuh"

namespace repro {
namespace decode {

constexpr int KC = 32;       // keys per shared-memory chunk: one per lane
constexpr int NWARPS = 8;
constexpr int THREADS = NWARPS * 32;
constexpr int MAXHPW = 4;    // heads per warp: G <= 32
constexpr int MAXDL = 4;     // dims per lane: D <= 128

inline size_t smem_bytes(int G, int D) {
  return sizeof(float) * (G * D + 2 * KC * (D + 1) + NWARPS * KC);
}

// Online-softmax state of the heads a lane's warp owns: running max m,
// denominator l and the D/32 output dims acc of this lane, per head.
struct State {
  float m[MAXHPW], l[MAXHPW], acc[MAXHPW][MAXDL];
};

// W port: the appended row lands at p, in kv head hk's columns only.
template <typename TC>
__device__ __forceinline__ void append_row(TC* ck, TC* cv, const TC* nkr,
                                           const TC* nvr, int b, int hk,
                                           int p, int S, int Hkv, int D) {
  const size_t at = ((size_t)b * S + p) * Hkv * D + (size_t)hk * D;
  for (int i = threadIdx.x; i < D; i += THREADS) {
    ck[at + i] = nkr[i];
    cv[at + i] = nvr[i];
  }
}

// R port over keys [lo, hi) of row b, kv head hk; qb points at the block's
// G query heads. Leaves m = -inf, l = 0, acc = 0 for an empty range.
template <typename TQ, typename TC>
__device__ __forceinline__ void attend(float* smem, const TQ* qb,
                                       const TC* ck, const TC* cv,
                                       const TC* nkr, const TC* nvr, int b,
                                       int hk, int p, int lo, int hi, int S,
                                       int Hkv, int G, int D, float scale,
                                       State& st) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int DP = D + 1;               // padded K/V rows: conflict-free
  float* qs = smem;                   // [G][D]
  float* ks = qs + G * D;             // [KC][DP]
  float* vs = ks + KC * DP;           // [KC][DP]
  float* ps = vs + KC * DP;           // [NWARPS][KC]
  const size_t rstride = (size_t)Hkv * D;

  for (int i = tid; i < G * D; i += THREADS) qs[i] = to_f32(qb[i]);
#pragma unroll
  for (int h = 0; h < MAXHPW; ++h) {
    st.m[h] = -INFINITY;
    st.l[h] = 0.f;
#pragma unroll
    for (int i = 0; i < MAXDL; ++i) st.acc[h][i] = 0.f;
  }
  __syncthreads();

  for (int k0 = lo; k0 < hi; k0 += KC) {
    for (int i = tid; i < KC * D; i += THREADS) {
      const int j = i / D, dd = i - j * D, pos = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (pos < hi) {
        if (pos == p) {  // W->R visibility through shared memory
          kx = to_f32(nkr[dd]);
          vx = to_f32(nvr[dd]);
        } else {
          const size_t at = ((size_t)b * S + pos) * rstride + (size_t)hk * D + dd;
          kx = to_f32(ck[at]);
          vx = to_f32(cv[at]);
        }
      }
      ks[j * DP + dd] = kx;
      vs[j * DP + dd] = vx;
    }
    __syncthreads();
    const bool valid = k0 + lane < hi;
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
      const float m_new = fmaxf(st.m[h], warp_max(s));
      const float alpha = (st.m[h] == -INFINITY) ? 0.f : expf(st.m[h] - m_new);
      const float pr = valid ? expf(s - m_new) : 0.f;
      st.l[h] = st.l[h] * alpha + warp_sum(pr);
      ps[warp * KC + lane] = pr;
      __syncwarp();
#pragma unroll
      for (int i = 0; i < MAXDL; ++i) {
        const int dd = lane + 32 * i;
        if (dd < D) {
          float a = st.acc[h][i] * alpha;
          for (int j = 0; j < KC; ++j) a = fmaf(ps[warp * KC + j], vs[j * DP + dd], a);
          st.acc[h][i] = a;
        }
      }
      __syncwarp();
      st.m[h] = m_new;
    }
    __syncthreads();
  }
}

inline bool bad_geometry(int B, int Hkv, int G, int D, int seq_tile) {
  return B <= 0 || Hkv <= 0 || G <= 0 || G > NWARPS * MAXHPW || D <= 0 ||
         D > 32 * MAXDL || seq_tile <= 0;
}

}  // namespace decode
}  // namespace repro
