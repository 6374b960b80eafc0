// The decode R port shared by the serial fused decode (kv_multiport.cu,
// one cluster of blocks per (row, kv head)) and stage 1 of split-KV decode
// (kv_multiport_split.cu, one block per (row, kv head, bank)): the W port
// (append_row), the key partition of a row into banks (bank_range), and
// one block's online-softmax pass over a contiguous key range [lo, hi)
// (attend), which streams the range through a ring of shared-memory stages.
//
// The ring: up to MAX_STAGES stages of KS keys, each K [KS][pitch] then
// V [KS][pitch] in the cache dtype, filled by 16-byte cp.async copies
// (cp.async.cg, commit/wait groups; rows past the range zero-filled), so
// the next stages' loads are in flight while one stage computes. A row
// whose bytes are not a multiple of 16, or a pointer off a 16-byte
// boundary, takes an element-wise loader into the same ring. The appended
// row (position p) is copied from new_k/new_v instead of the cache, so no
// block reads position p from global memory and blocks need no order.
//
// Each stage is computed by the whole block in three phases: scores
// (thread (j, r) scores key j for heads r, r + 4, ..., each one sequential
// fmaf chain over d = 0..D-1, four 16-byte shared-memory reads in flight),
// the online softmax (warp w owns heads w, w + 8, ...: stage max, guarded
// rescale alpha, probabilities), and P.V (thread (d, r) holds dim d of the
// stage's 64 V rows in registers and accumulates it into heads r,
// r + THREADS/D, ..., so each V element is read from shared memory once;
// a partial last stage walks its live rows only).
// The pass leaves the block's unnormalized (m, l, acc) in registers; an
// empty range leaves m = -inf, l = 0, acc = 0. All sums are f32.
#pragma once

#include "common.cuh"

namespace repro {
namespace decode {

constexpr int KS = 64;                  // keys per ring stage
constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int MAX_STAGES = 4;
constexpr int SP = KS + 4;              // score row pitch (floats)
constexpr int KROWS = THREADS / KS;     // thread rows of the score phase
constexpr int MAX_SCORES = 32 / KROWS;  // heads a thread scores (G <= 32)
constexpr int MAX_SOFT = 32 / NWARPS;   // heads a warp normalizes
constexpr int MAX_ACC = 16;             // heads a thread accumulates (D <= 128)
constexpr int SMEM_LIMIT = 232448;      // a block's dynamic shared memory

// Shared memory of one block: q [G][D] f32, scores [G][SP] f32, alpha [32]
// f32, then the ring of stages; pitch = the row's bytes rounded up to 16,
// plus 16.
struct Geometry {
  int pitch, fixed, stage_bytes, stages, smem;
};

inline Geometry geometry(int G, int D, int esize) {
  Geometry g;
  g.pitch = (D * esize + 15) / 16 * 16 + 16;
  g.fixed = (G * D * 4 + 15) / 16 * 16 + G * SP * 4 + 32 * 4;
  g.stage_bytes = 2 * KS * g.pitch;
  g.stages = (SMEM_LIMIT - g.fixed) / g.stage_bytes;
  if (g.stages > MAX_STAGES) g.stages = MAX_STAGES;
  g.smem = g.fixed + g.stages * g.stage_bytes;
  return g;
}

// The q region holds G * D floats, rounded up to 16 bytes; the scores
// follow it.
__host__ __device__ inline int scores_offset(int G, int D) {
  return (G * D * 4 + 15) / 16 * 16;
}

inline bool bad_geometry(int B, int Hkv, int G, int D, int seq_tile) {
  return B <= 0 || Hkv <= 0 || G <= 0 || G > NWARPS * MAX_SOFT || D <= 0 ||
         D > 128 || seq_tile <= 0;
}

// Online-softmax state of a block: m and l of the heads this thread's warp
// owns (heads warp, warp + NWARPS, ...), and the P.V sums this thread owns
// (dim tid % D of heads tid / D, tid / D + THREADS / D, ...).
struct State {
  float m[MAX_SOFT], l[MAX_SOFT], acc[MAX_ACC];
};

// Keys [lo, hi) of bank s of ns for a row with append position p: the TPU
// kernel's bank partition, per row: row_tiles = ceil((p + 1) / seq_tile),
// per_split = max(ceil(row_tiles / ns), 1), and tile t feeds bank
// min(t / per_split, ns - 1); cut at the row's live end. Empty for a dead
// row (p < 0).
__device__ __forceinline__ void bank_range(int p, int s, int ns,
                                           int seq_tile, int n_tiles, int S,
                                           int& lo, int& hi) {
  lo = hi = 0;
  if (p < 0) return;
  const int end = min(p + 1, min(n_tiles * seq_tile, S));
  const int row_tiles = (p + seq_tile) / seq_tile;
  const int per_split = max((row_tiles + ns - 1) / ns, 1);
  const int span = per_split * seq_tile;
  lo = min(s * span, end);
  hi = (s == ns - 1) ? end : min((s + 1) * span, end);
}

// The serviced-tile count of a row, as the TPU kernel counts it.
__device__ __forceinline__ int serviced_tiles(int p, int seq_tile,
                                              int n_tiles, int length_mask) {
  if (p < 0) return 0;
  return length_mask ? min((p + seq_tile) / seq_tile, n_tiles) : n_tiles;
}

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

// Whether K/V rows load as 16-byte cp.async copies: every row a whole
// number of 16 bytes and every base pointer on a 16-byte boundary.
inline int vector_rows(const void* ck, const void* cv, const void* nk,
                       const void* nv, int D, int esize) {
  const uintptr_t ptrs = (uintptr_t)ck | (uintptr_t)cv | (uintptr_t)nk |
                         (uintptr_t)nv;
  return (D * esize) % 16 == 0 && ptrs % 16 == 0;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  const int n = valid ? 16 : 0;  // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `pending` committed groups are still in flight.
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending >= 2)
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  else if (pending == 1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// K and V rows of keys [k0, k0 + KS) into one ring stage; row p comes from
// new_k/new_v (the W->R overlay), rows at or past hi read as zeros.
template <typename TC>
__device__ __forceinline__ void load_stage(
    unsigned char* ks, unsigned char* vs, const TC* ck, const TC* cv,
    const TC* nkr, const TC* nvr, int b, int hk, int p, int k0, int hi,
    int S, int Hkv, int D, int pitch, bool vec) {
  const size_t rstride = (size_t)Hkv * D;
  const size_t col = (size_t)hk * D;
  if (vec) {
    const int chunks = D * (int)sizeof(TC) / 16;
    for (int i = threadIdx.x; i < KS * chunks; i += THREADS) {
      const int j = i / chunks, c = i - j * chunks, pos = k0 + j;
      const bool valid = pos < hi;
      const TC *kr, *vr;
      if (valid && pos == p) {
        kr = nkr;
        vr = nvr;
      } else {
        const size_t at = ((size_t)b * S + (valid ? pos : k0)) * rstride + col;
        kr = ck + at;
        vr = cv + at;
      }
      cp_async16(ks + j * pitch + c * 16, (const unsigned char*)kr + c * 16,
                 valid);
      cp_async16(vs + j * pitch + c * 16, (const unsigned char*)vr + c * 16,
                 valid);
    }
  } else {
    for (int i = threadIdx.x; i < KS * D; i += THREADS) {
      const int j = i / D, d = i - j * D, pos = k0 + j;
      TC kx = from_f32<TC>(0.f), vx = kx;
      if (pos < hi) {
        if (pos == p) {
          kx = nkr[d];
          vx = nvr[d];
        } else {
          const size_t at = ((size_t)b * S + pos) * rstride + col + d;
          kx = ck[at];
          vx = cv[at];
        }
      }
      ((TC*)(ks + j * pitch))[d] = kx;
      ((TC*)(vs + j * pitch))[d] = vx;
    }
  }
}

// row[d .. d + 3] as floats (d a multiple of 4, the row 8-byte aligned)
__device__ __forceinline__ float4 load4(const float* row, int d) {
  return *(const float4*)(row + d);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* row, int d) {
  const uint2 raw = *(const uint2*)(row + d);
  const float2 a = __bfloat1622float2(*(const __nv_bfloat162*)&raw.x);
  const float2 c = __bfloat1622float2(*(const __nv_bfloat162*)&raw.y);
  return make_float4(a.x, a.y, c.x, c.y);
}

// R port over keys [lo, hi) of row b, kv head hk; qb points at the block's
// G query heads; smem is the block's dynamic shared memory laid out as
// geometry() says. Ends with every copy landed; the q and score regions
// may still be read by other threads until the caller's next barrier.
template <typename TQ, typename TC>
__device__ __forceinline__ void attend(
    unsigned char* smem, const TQ* qb, const TC* ck, const TC* cv,
    const TC* nkr, const TC* nvr, int b, int hk, int p, int lo, int hi,
    int S, int Hkv, int G, int D, float scale, int pitch, int fixed,
    int stage_bytes, int stages, bool vec, State& st) {
  float* qs = (float*)smem;                            // [G][D]
  float* sp = (float*)(smem + scores_offset(G, D));    // [G][SP]
  float* al = sp + G * SP;                             // [32]
  unsigned char* ring = smem + fixed;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  for (int i = tid; i < G * D; i += THREADS) qs[i] = to_f32(qb[i]);

#pragma unroll
  for (int t = 0; t < MAX_SOFT; ++t) {
    st.m[t] = -INFINITY;
    st.l[t] = 0.f;
  }
#pragma unroll
  for (int t = 0; t < MAX_ACC; ++t) st.acc[t] = 0.f;
  const int nr = THREADS / D;  // head rows of the P.V phase
  const int pd = tid % D, pr = tid / D;
  const bool pv_thread = tid < nr * D;
  const int jr = tid % KS, hr = tid / KS;

  auto k_stage = [&](int i) { return ring + (i % stages) * stage_bytes; };
  const int n_st = (hi - lo + KS - 1) / KS;  // 0 for an empty range
  for (int i = 0; i < stages - 1; ++i) {
    if (i < n_st)
      load_stage(k_stage(i), k_stage(i) + KS * pitch, ck, cv, nkr, nvr, b,
                 hk, p, lo + i * KS, hi, S, Hkv, D, pitch, vec);
    cp_async_commit();
  }
  for (int i = 0; i < n_st; ++i) {
    cp_async_wait(stages - 2);  // stage i has landed
    __syncthreads();            // ... for every thread; stage i-1 is done
    const int nxt = i + stages - 1;
    if (nxt < n_st)
      load_stage(k_stage(nxt), k_stage(nxt) + KS * pitch, ck, cv, nkr, nvr,
                 b, hk, p, lo + nxt * KS, hi, S, Hkv, D, pitch, vec);
    cp_async_commit();
    const int k0 = lo + i * KS;
    const TC* kst = (const TC*)k_stage(i);
    const TC* vst = (const TC*)(k_stage(i) + KS * pitch);
    const int pe = pitch / (int)sizeof(TC);  // row pitch in elements

    // scores: thread (jr, hr) scores key jr for heads hr, hr + KROWS, ...
    {
      float dot[MAX_SCORES];
#pragma unroll
      for (int t = 0; t < MAX_SCORES; ++t) dot[t] = 0.f;
      const bool valid = k0 + jr < hi;
      const TC* kr = kst + jr * pe;
      if (valid && D % 4 == 0) {
#pragma unroll
        for (int t = 0; t < MAX_SCORES; ++t) {
          const int h = hr + KROWS * t;
          if (h >= G) break;
          const float* qr = qs + h * D;
          float a = 0.f;
#pragma unroll 4
          for (int d = 0; d < D; d += 4) {
            const float4 k4 = load4(kr, d);
            const float4 q4 = *(const float4*)(qr + d);
            a = fmaf(q4.x, k4.x, a);
            a = fmaf(q4.y, k4.y, a);
            a = fmaf(q4.z, k4.z, a);
            a = fmaf(q4.w, k4.w, a);
          }
          dot[t] = a;
        }
      } else if (valid) {
        for (int d = 0; d < D; ++d) {
          const float kx = to_f32(kr[d]);
#pragma unroll
          for (int t = 0; t < MAX_SCORES; ++t) {
            const int h = hr + KROWS * t;
            if (h >= G) break;
            dot[t] = fmaf(qs[h * D + d], kx, dot[t]);
          }
        }
      }
#pragma unroll
      for (int t = 0; t < MAX_SCORES; ++t) {
        const int h = hr + KROWS * t;
        if (h >= G) break;
        sp[h * SP + jr] = valid ? dot[t] * scale : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax: warp w owns heads w, w + NWARPS, ...
#pragma unroll
    for (int t = 0; t < MAX_SOFT; ++t) {
      const int h = warp + NWARPS * t;
      if (h >= G) break;  // warp-uniform
      float* row = sp + h * SP;
      const float s0 = row[lane], s1 = row[lane + 32];
      const float m_new = fmaxf(st.m[t], warp_max(fmaxf(s0, s1)));
      const float alpha = (st.m[t] == -INFINITY) ? 0.f : expf(st.m[t] - m_new);
      const float p0 = k0 + lane < hi ? expf(s0 - m_new) : 0.f;
      const float p1 = k0 + lane + 32 < hi ? expf(s1 - m_new) : 0.f;
      st.l[t] = st.l[t] * alpha + warp_sum(p0 + p1);
      row[lane] = p0;
      row[lane + 32] = p1;
      if (lane == 0) al[h] = alpha;
      st.m[t] = m_new;
    }
    __syncthreads();

    // P.V: thread (pd, pr) accumulates dim pd of heads pr, pr + nr, ...;
    // a range's last, partial stage walks its live keys only (a short row's
    // one stage holds a handful)
    if (pv_thread && hi - k0 < KS) {
      const int live = hi - k0;
      for (int t = 0; t < MAX_ACC; ++t) {
        const int h = pr + nr * t;
        if (h >= G) break;
        const float* prow = sp + h * SP;
        float a = st.acc[t] * al[h];
        for (int j = 0; j < live; ++j)
          a = fmaf(prow[j], to_f32(vst[j * pe + pd]), a);
        st.acc[t] = a;
      }
    } else if (pv_thread) {
      float vr[KS];  // this thread's dim of the stage's V rows
#pragma unroll
      for (int j = 0; j < KS; ++j) vr[j] = to_f32(vst[j * pe + pd]);
#pragma unroll
      for (int t = 0; t < MAX_ACC; ++t) {
        const int h = pr + nr * t;
        if (h >= G) break;
        const float* prow = sp + h * SP;
        float a = st.acc[t] * al[h];
#pragma unroll
        for (int j = 0; j < KS; j += 4) {
          const float4 p4 = *(const float4*)(prow + j);
          a = fmaf(p4.x, vr[j], a);
          a = fmaf(p4.y, vr[j + 1], a);
          a = fmaf(p4.z, vr[j + 2], a);
          a = fmaf(p4.w, vr[j + 3], a);
        }
        st.acc[t] = a;
      }
    }
  }
  cp_async_wait(0);
}

// The block's (m, l, acc) into stats [G][2] (m, l) and acc [G][D], f32:
// global partials (split-KV stage 1) or the block's own shared memory (the
// serial kernel's cluster merge).
__device__ __forceinline__ void store_state(const State& st, float* acc,
                                            float* stats, int G, int D) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int t = 0; t < MAX_SOFT; ++t) {
    const int h = warp + NWARPS * t;
    if (h >= G) break;
    if (lane == 0) {
      stats[h * 2] = st.m[t];
      stats[h * 2 + 1] = st.l[t];
    }
  }
  const int nr = THREADS / D, pd = tid % D, pr = tid / D;
  if (tid < nr * D) {
#pragma unroll
    for (int t = 0; t < MAX_ACC; ++t) {
      const int h = pr + nr * t;
      if (h >= G) break;
      acc[h * D + pd] = st.acc[t];
    }
  }
}

// jnp.isfinite for the merge guards: false for +-inf and NaN
__device__ __forceinline__ bool is_finite(float x) {
  return x > -INFINITY && x < INFINITY;
}

// The weights of one step of the LSE merge of bank states in bank order
// (the TPU kernel's combine): the running max rescale with its guards
// (safe = m_new or 0 when both are empty; alpha, beta = 0 for an empty
// side), so exp(-inf - -inf) never appears. m_run becomes the new max.
__device__ __forceinline__ void merge_weights(float& m_run, float m_s,
                                              float& alpha, float& beta) {
  const float m_new = fmaxf(m_run, m_s);
  const float safe = is_finite(m_new) ? m_new : 0.f;
  alpha = is_finite(m_run) ? expf(m_run - safe) : 0.f;
  beta = is_finite(m_s) ? expf(m_s - safe) : 0.f;
  m_run = m_new;
}

// run * alpha + x * beta: the update of l and of every acc dim, one
// expression so that each takes the same rounding wherever it is merged
__device__ __forceinline__ float rescale(float run, float alpha, float x,
                                         float beta) {
  return run * alpha + x * beta;
}

// One merge step of one acc dim and its row's (m, l).
__device__ __forceinline__ void merge(float& m_run, float& l_run,
                                      float& a_run, float m_s, float l_s,
                                      float a_s) {
  float alpha, beta;
  merge_weights(m_run, m_s, alpha, beta);
  a_run = rescale(a_run, alpha, a_s, beta);
  l_run = rescale(l_run, alpha, l_s, beta);
}

}  // namespace decode
}  // namespace repro
