// Split-KV decode: the fused append+attend of kv_multiport.cu with each
// row's live keys spread over num_kv_splits parallel chains (stage 1), and
// the LSE combine of the chains' partial softmax states (stage 2).
//
// Replaces the TPU kernels src/repro/kernels/kv_multiport.py:_split_kernel
// (stage 1) and :_combine_kernel (stage 2). The TPU could only emulate the
// split on its sequential (batch, tiles) grid, one bank of scratch per
// split. Here the grid is (row, kv-head, split) and truly parallel: the
// serial kernel launches B * Hkv blocks whatever the context length
// (16 for tinyllama's 4 kv heads and 4 rows, on a 132-SM card), stage 1
// launches B * Hkv * ns.
//
// What bounds them on an H100: bytes. Stage 1 reads each live K/V row once
// (about one flop per byte for f32 caches) and writes ns f32 partials per
// head; stage 2 reads the partials once and writes the output.
//
// Stage 1, block (b, hk, s): the bank partition is the TPU kernel's, per
// row: row_tiles = ceil((p + 1) / seq_tile), per_split =
// max(ceil(row_tiles / ns), 1), and tile t feeds bank
// min(t / per_split, ns - 1). Bank s therefore owns the keys
// [s * per_split * seq_tile, (s + 1) * per_split * seq_tile) (the last bank
// everything above), cut at the row's live end. The block streams that
// range through a ring of up to MAX_STAGES shared-memory stages of KS keys,
// filled by 16-byte cp.async copies (cp.async.cg, commit/wait groups;
// rows past the range zero-filled), so the next stages' loads are in
// flight while one stage computes. A row whose bytes are not a multiple of
// 16, or a pointer off a 16-byte boundary, takes an element-wise loader
// into the same ring. Each stage is computed by the whole block in three
// phases: scores (thread (j, r) scores key j for heads r, r + 4, ..., each
// one sequential fmaf chain over d = 0..D-1 as in the serial kernel, four
// 16-byte shared-memory reads in flight), the online softmax (warp w owns
// heads w, w + 8, ...: stage max, guarded rescale alpha, probabilities),
// and P.V (thread (d, r) holds dim d of the stage's 64 V rows in registers
// and accumulates it into heads r, r + THREADS/D, ..., so each V element
// is read from shared memory once). The block then
// writes the unnormalized (acc, m, l); an empty bank writes acc = 0,
// m = -inf, l = 0. The W port belongs to the one block whose range holds
// p: it writes the appended row, and its loader copies row p from
// new_k/new_v instead of the cache, so no other block reads position p and
// blocks need no order. A dead row (p < 0) writes nothing and leaves every
// bank empty. Block (hk 0, split 0) writes the serviced-tile count with the
// serial kernel's formula.
//
// Stage 2, block (b, hk): threads over the G x D outputs walk the ns banks
// in order with the running-max rescale and the TPU kernel's guards
// (safe = m_new or 0 when both are empty; alpha, beta = 0 for an empty
// side), so exp(-inf - -inf) never appears; then divide by max(l, 1e-30)
// and write q's dtype. A fully dead row gives zeros.
#include "decode_attend.cuh"

namespace {

using repro::decode::append_row;
using repro::decode::bad_geometry;

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
// f32, then the ring of stages, each K [KS][pitch] then V [KS][pitch] in
// the cache dtype; pitch = the row's bytes rounded up to 16, plus 16.
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
      TC kx = repro::from_f32<TC>(0.f), vx = kx;
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
  float* qs = (float*)smem;                                   // [G][D]
  float* sp = (float*)(smem + (G * D * 4 + 15) / 16 * 16);    // [G][SP]
  float* al = sp + G * SP;                                    // [32]
  unsigned char* ring = smem + fixed;
  const int b = blockIdx.x, hk = blockIdx.y, s = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int H = Hkv * G;
  const size_t head0 = ((size_t)b * ns + s) * H + (size_t)hk * G;
  float* pa = acc_out + head0 * D;     // [G][D] of bank s
  float* pm = stats_out + head0 * 2;   // [G][(m, l)] of bank s

  const int p = lens[b];
  if (hk == 0 && s == 0 && tid == 0)
    tiles[b] = p < 0 ? 0
               : length_mask ? min((p + seq_tile) / seq_tile, n_tiles)
                             : n_tiles;
  const int limit = min(n_tiles * seq_tile, S);  // staged positions
  const int end = p < 0 ? 0 : min(p + 1, limit);
  int lo = 0, hi = 0;
  if (p >= 0) {
    const int row_tiles = (p + seq_tile) / seq_tile;
    const int per_split = max((row_tiles + ns - 1) / ns, 1);
    const int span = per_split * seq_tile;
    lo = min(s * span, end);
    hi = (s == ns - 1) ? end : min((s + 1) * span, end);
  }

  const TC* nkr = nk + ((size_t)b * Hkv + hk) * D;
  const TC* nvr = nv + ((size_t)b * Hkv + hk) * D;
  if (p >= lo && p < hi) append_row(ck, cv, nkr, nvr, b, hk, p, S, Hkv, D);
  const TQ* qb = q + ((size_t)b * H + (size_t)hk * G) * D;
  for (int i = tid; i < G * D; i += THREADS) qs[i] = repro::to_f32(qb[i]);

  float m[MAX_SOFT], l[MAX_SOFT], acc[MAX_ACC];
#pragma unroll
  for (int t = 0; t < MAX_SOFT; ++t) {
    m[t] = -INFINITY;
    l[t] = 0.f;
  }
#pragma unroll
  for (int t = 0; t < MAX_ACC; ++t) acc[t] = 0.f;
  const int nr = THREADS / D;  // head rows of the P.V phase
  const int pd = tid % D, pr = tid / D;
  const bool pv_thread = tid < nr * D;
  const int jr = tid % KS, hr = tid / KS;

  auto k_stage = [&](int i) { return ring + (i % stages) * stage_bytes; };
  const int n_st = (hi - lo + KS - 1) / KS;  // 0 for an empty bank
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
          const float kx = repro::to_f32(kr[d]);
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
      const float m_new = fmaxf(m[t], repro::warp_max(fmaxf(s0, s1)));
      const float alpha = (m[t] == -INFINITY) ? 0.f : expf(m[t] - m_new);
      const float p0 = k0 + lane < hi ? expf(s0 - m_new) : 0.f;
      const float p1 = k0 + lane + 32 < hi ? expf(s1 - m_new) : 0.f;
      l[t] = l[t] * alpha + repro::warp_sum(p0 + p1);
      row[lane] = p0;
      row[lane + 32] = p1;
      if (lane == 0) al[h] = alpha;
      m[t] = m_new;
    }
    __syncthreads();

    // P.V: thread (pd, pr) accumulates dim pd of heads pr, pr + nr, ...
    if (pv_thread) {
      float vr[KS];  // this thread's dim of the stage's V rows
#pragma unroll
      for (int j = 0; j < KS; ++j) vr[j] = repro::to_f32(vst[j * pe + pd]);
#pragma unroll
      for (int t = 0; t < MAX_ACC; ++t) {
        const int h = pr + nr * t;
        if (h >= G) break;
        const float* prow = sp + h * SP;
        float a = acc[t] * al[h];
#pragma unroll
        for (int j = 0; j < KS; j += 4) {
          const float4 p4 = *(const float4*)(prow + j);
          a = fmaf(p4.x, vr[j], a);
          a = fmaf(p4.y, vr[j + 1], a);
          a = fmaf(p4.z, vr[j + 2], a);
          a = fmaf(p4.w, vr[j + 3], a);
        }
        acc[t] = a;
      }
    }
  }
  cp_async_wait(0);

#pragma unroll
  for (int t = 0; t < MAX_SOFT; ++t) {
    const int h = warp + NWARPS * t;
    if (h >= G) break;
    if (lane == 0) {
      pm[h * 2] = m[t];
      pm[h * 2 + 1] = l[t];
    }
  }
  if (pv_thread) {
#pragma unroll
    for (int t = 0; t < MAX_ACC; ++t) {
      const int h = pr + nr * t;
      if (h >= G) break;
      pa[h * D + pd] = acc[t];
    }
  }
}

// jnp.isfinite for the stage-2 guards: false for +-inf and NaN
__device__ __forceinline__ bool finite(float x) {
  return x > -INFINITY && x < INFINITY;
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
      const float m_s = stats[row * 2], l_s = stats[row * 2 + 1];
      const float a_s = acc[row * D + dd];
      const float m_new = fmaxf(m_run, m_s);
      const float safe = finite(m_new) ? m_new : 0.f;
      const float alpha = finite(m_run) ? expf(m_run - safe) : 0.f;
      const float beta = finite(m_s) ? expf(m_s - safe) : 0.f;
      a_run = a_run * alpha + a_s * beta;
      l_run = l_run * alpha + l_s * beta;
      m_run = m_new;
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
  const uintptr_t ptrs = (uintptr_t)ck | (uintptr_t)cv | (uintptr_t)nk |
                         (uintptr_t)nv;
  const int vec = (D * (int)sizeof(TC)) % 16 == 0 && ptrs % 16 == 0;
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
