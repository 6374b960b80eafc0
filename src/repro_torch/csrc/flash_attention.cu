// Causal (or full) GQA flash-attention forward over whole sequences: the
// f32 route. Scores on the CUDA cores in f32 FMA, P V on the tensor cores
// in 3xTF32.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:_kernel
// (pallas_call in flash_attention). The TPU walks a sequential grid
// (b, kv-head, query tile, key tile) and carries the running max, sum and
// accumulator in VMEM scratch across the key-tile steps; here the key-tile
// dimension is a loop inside the block and the running state stays in
// registers.
//
// What bounds it on an H100: operations. Causal attention at
// q [B, H, S, D] does 4 * B * H * D * S^2 / 2 flops on 2 * B * (H + Hkv) * S
// * D elements: at S = 2048, D = 64 that is ~800 flops per f32 byte, far
// above the ridge. This kernel takes the calls that stay off the bf16
// tensor-core kernel (flash_attention_tc.cu): f32, bf16 q over f32 k/v,
// and a head dim that is not a multiple of 8; kernels/flash_attention.py
// picks the route.
//
// The f32 contract (2e-5 against the plain version) decides the units.
// The softmax turns an error e in a score into a relative error e in its
// weight, so at scores of tens (q and k 3-4x N(0, 1)) the few units of
// 2^-24 by which any other summation order differs from the plain
// version's move the output by several 1e-5. So each score is one f32 FMA
// chain from zero over the head dims in order, as the plain version's
// matmul sums it, on the CUDA cores. P V is well conditioned (weights in
// [0, 1]) and takes the tensor cores in 3xTF32: plain TF32 keeps about
// three digits, so with x = hi + lo, hi = tf32(x), lo = tf32(x - hi)
// (cvt.rna's rounding, done as two integer ops), p * v ~ p_lo * v_hi +
// p_hi * v_lo + p_hi * v_hi on mma.sync.m16n8k8; the tensor cores' own f32
// sums round toward zero, so each tile's P V is one chain of MMAs from
// zero per output tile, added into O in f32 with round to nearest. Its
// bound: the scores' half of the operations at the CUDA cores' f32 peak
// (67 TFLOP/s), which the tensor cores' 3 x the other half at 495 TFLOP/s
// can overlap.
//
// Design: block (z, hk, b) owns BM query rows of its kv head's group, where
// row r of the group is position r / G of head hk * G + r % G, so one K/V
// tile in shared memory serves all G query heads (the reuse the TPU kernel
// got from its [G, Tq, D] block): 8 warps of two 16-row slabs (BM = 256)
// over 64-key tiles, or at D > 64 4 warps of one slab over 32-key tiles.
// Q sits in shared memory in f32; each K and V tile comes in f32 through a
// cp.async double buffer (an element-wise loader for bf16 k/v, rows that
// are not a whole number of 16 bytes, or unaligned bases), and V is split
// once for the block into hi and lo planes, so no warp repeats the split.
// A lane computes its scores in the m16n8 accumulator layout of its slabs:
// rows gq and gq + 8 of each slab, keys 8n + 2tq and + 1 of the tile, one
// 16-byte K load feeding both slabs' rows (the CUDA cores' work is bound
// by shared-memory loads, so a lane takes as many rows as its registers
// hold). The online softmax runs in that layout (each row's max over the
// four lanes of a quad, the sum kept per lane and reduced once at the end),
// and P is split in registers and fed as the A operand of O += P V: keys
// 2tq and 2tq + 1 of each 8-key step are A columns tq and tq + 4, V's rows
// taken in the same order. Causal blocks stop at their last row's position
// (the TPU's tile skip), a warp skips tiles wholly past its rows, and only
// tiles that cross a slab's diagonal, the ragged key tail or missing rows
// mask per element; blocks are launched longest first. A tile takes two
// block barriers: landed (the next tile's copies start), split. The
// denominator has a floor of 1e-30 and the output is cast to q's dtype.
#include "common.cuh"


namespace {

constexpr int MAXD = 128;

// Tiles for head dims padded to DP: NWARPS warps of SL 16-row slabs, BM
// query rows of the group per block, BN keys per tile. Shared memory in
// floats: Q [BM][P], then two stages of K, V hi and V lo [BN][P]. P = DP + 4
// makes a warp's 16-byte Q and K loads (8 rows, or 4 keys two apart) and
// its 4-byte V fragment loads hit distinct banks. DP 128 takes one slab a
// warp, 64 rows and 32 keys.
template <int DP>
struct Geo {
  static constexpr int SL = DP <= 64 ? 2 : 1;
  static constexpr int NWARPS = DP <= 64 ? 8 : 4;
  static constexpr int BM = 16 * SL * NWARPS;
  static constexpr int BN = DP <= 64 ? 64 : 32;
  static constexpr int THREADS = NWARPS * 32;
  static constexpr int NT = BN / 8;       // n8 score tiles per key tile
  static constexpr int P = DP + 4;
  static constexpr int STAGE = 3 * BN * P;
  static constexpr size_t SMEM = sizeof(float) * (BM * P + 2 * STAGE);
};

// cvt.rna.tf32.f32 for a finite x, as integer ops: round the 13 dropped
// mantissa bits to nearest, ties away from zero (adding half a unit to the
// magnitude carries into the kept bits); the same bits, fewer instructions
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo, both TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b in 3xTF32: the two cross terms first, then hi * hi
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&a_hi)[4],
                                     const uint32_t (&a_lo)[4], uint2 b_hi,
                                     uint2 b_lo) {
  mma(d, a_lo, b_hi.x, b_hi.y);
  mma(d, a_hi, b_lo.x, b_lo.y);
  mma(d, a_hi, b_hi.x, b_hi.y);
}

// e^x for x <= 0 (0 for x = -inf): 2^(x log2 e) by ex2.approx (2^-22
// relative). x = s - m is near 0 for the keys that carry the weight, so
// rounding x log2 e costs them little, where 2^(s log2 e - m log2 e) would
// round at the scale of s.
__device__ __forceinline__ float exp_neg(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  const int n = valid ? 16 : 0;  // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n)
               : "memory");
}

// K and V rows of keys [k0, k0 + BN) as f32 into a stage's K and V hi
// planes; keys at or past Sk read as zeros. vec: 16-byte cp.async copies
// (f32 rows of a whole number of 16 bytes on aligned bases), else
// element-wise loads.
template <typename TK, int DP>
__device__ __forceinline__ void load_tile(float* ks, float* vs, const TK* k,
                                          const TK* v, size_t kv0, int k0,
                                          int Sk, int D, bool vec) {
  using G = Geo<DP>;
  if constexpr (sizeof(TK) == 4) {
    if (vec) {
      const int chunks = D / 4;
      for (int i = threadIdx.x; i < G::BN * chunks; i += G::THREADS) {
        const int j = i / chunks, c = i - j * chunks, pos = k0 + j;
        const bool valid = pos < Sk;
        const size_t at = kv0 + (size_t)(valid ? pos : 0) * D + c * 4;
        cp_async16(ks + j * G::P + c * 4, k + at, valid);
        cp_async16(vs + j * G::P + c * 4, v + at, valid);
      }
      return;
    }
  }
  for (int i = threadIdx.x; i < G::BN * D; i += G::THREADS) {
    const int j = i / D, d = i - j * D, pos = k0 + j;
    float kx = 0.f, vx = 0.f;
    if (pos < Sk) {
      kx = repro::to_f32(k[kv0 + (size_t)pos * D + d]);
      vx = repro::to_f32(v[kv0 + (size_t)pos * D + d]);
    }
    ks[j * G::P + d] = kx;
    vs[j * G::P + d] = vx;
  }
}

// Split a landed V tile once for the whole block: the f32 values in the hi
// plane become their TF32 hi parts, the lo plane gets the rest.
template <int DP>
__device__ __forceinline__ void split_v(float* vs) {
  using G = Geo<DP>;
  constexpr int C4 = DP / 4;
  for (int i = threadIdx.x; i < G::BN * C4; i += G::THREADS) {
    const int j = i / C4, c = (i - j * C4) * 4;
    float* hi = vs + j * G::P + c;
    float* lo = hi + G::BN * G::P;
    const float4 x = *(const float4*)hi;
    uint4 h, l;
    split(x.x, h.x, l.x);
    split(x.y, h.y, l.y);
    split(x.z, h.z, l.z);
    split(x.w, h.w, l.w);
    *(uint4*)hi = h;
    *(uint4*)lo = l;
  }
}

template <typename TQ, typename TK, int DP>
__global__ void __launch_bounds__(Geo<DP>::THREADS)
flash_kernel(const TQ* __restrict__ q, const TK* __restrict__ k,
             const TK* __restrict__ v, TQ* __restrict__ out, int Sq, int Sk,
             int Hkv, int G, int D, float scale, int causal, int vec) {
  using Gm = Geo<DP>;
  constexpr int BM = Gm::BM, BN = Gm::BN, NT = Gm::NT, THREADS = Gm::THREADS;
  constexpr int P = Gm::P, DT = DP / 8, SL = Gm::SL;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                    // [BM][P]
  float* stage0 = smem + BM * P;       // K; V hi, V lo

  const int z = gridDim.x - 1 - blockIdx.x;  // longest causal blocks first
  const int hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane >> 2, tq = lane & 3;
  const int R = Sq * G, r0 = z * BM, H = Hkv * G;
  auto row_at = [&](int r) -> size_t {  // q/out offset of group row r
    const int pos = r / G, g = r - pos * G;
    return (((size_t)b * H + (size_t)hk * G + g) * Sq + pos) * D;
  };
  const size_t kv0 = ((size_t)b * Hkv + hk) * Sk * D;
  auto k_at = [&](int i) { return stage0 + (i & 1) * Gm::STAGE; };
  auto v_at = [&](int i) { return k_at(i) + BN * P; };

  // head dims past D stay zero in both stages' K and V hi planes (the
  // copies never reach them; the split writes V lo)
  for (int i = tid; i < 2 * BN * (DP - D); i += THREADS) {
    const int row = i / (DP - D), d = D + i - row * (DP - D);
    k_at(row / BN)[(row % BN) * P + d] = 0.f;
    v_at(row / BN)[(row % BN) * P + d] = 0.f;
  }
  const int qhi = (min(R, r0 + BM) - 1) / G;
  const int kend = causal ? min(Sk, qhi + 1) : Sk;
  const int ntile = (kend + BN - 1) / BN;
  load_tile<TK, DP>(k_at(0), v_at(0), k, v, kv0, 0, Sk, D, vec != 0);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int i = tid; i < BM * DP; i += THREADS) {
    const int r = i / DP, d = i - r * DP;
    qs[r * P + d] = (r0 + r < R && d < D) ? repro::to_f32(q[row_at(r0 + r) + d])
                                          : 0.f;
  }

  // slab j of this warp: group rows w0[j] .. + 16; this lane's rows in it
  // are gq and gq + 8 (position -1 past the group)
  int w0[SL], w_lo[SL], w_hi[SL], qa[SL], qb[SL];
#pragma unroll
  for (int j = 0; j < SL; ++j) {
    w0[j] = r0 + (warp * SL + j) * 16;
    w_lo[j] = w0[j] / G;
    w_hi[j] = w0[j] < R ? (min(R, w0[j] + 16) - 1) / G : -1;
    const int ra = w0[j] + gq, rb = ra + 8;
    qa[j] = ra < R ? ra / G : -1;
    qb[j] = rb < R ? rb / G : -1;
  }
  int w_last = -1;  // the warp's latest position
#pragma unroll
  for (int j = 0; j < SL; ++j) w_last = max(w_last, w_hi[j]);
  const float* q_lane = qs + (warp * SL * 16 + gq) * P;

  float o[SL][DT][4];
  float m_a[SL], m_b[SL], l_a[SL], l_b[SL];
#pragma unroll
  for (int j = 0; j < SL; ++j) {
#pragma unroll
    for (int dn = 0; dn < DT; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][dn][e] = 0.f;
    m_a[j] = m_b[j] = -INFINITY;
    l_a[j] = l_b[j] = 0.f;
  }

  for (int it = 0; it < ntile; ++it) {
    const int k0 = it * BN;
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");  // tile it landed
    __syncthreads();  // ... for every thread; tile it - 1 is consumed, Q is
                      // written
    if (it + 1 < ntile) {  // in flight while tile it is split and computed
      load_tile<TK, DP>(k_at(it + 1), v_at(it + 1), k, v, kv0, k0 + BN, Sk, D,
                        vec != 0);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    split_v<DP>(v_at(it));
    __syncthreads();
    if (w_last < 0 || (causal && k0 > w_last)) continue;  // no row reaches k0
    const float* ks = k_at(it);
    const uint32_t* vh = (const uint32_t*)v_at(it);
    const uint32_t* vl = vh + BN * P;

    // S = Q K^T on the CUDA cores, each score one f32 FMA chain from 0 over
    // the head dims in order, in the m16n8 accumulator layout: s[j][n]
    // holds keys k0 + 8n + 2tq and + 1 of slab j's rows a (elements 0, 1)
    // and b (2, 3)
    float s[SL][NT][4];
#pragma unroll
    for (int j = 0; j < SL; ++j)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][n][e] = 0.f;
#pragma unroll 2
    for (int d = 0; d < DP; d += 4) {
      if (d >= D) break;
      float4 x[SL][2];
#pragma unroll
      for (int j = 0; j < SL; ++j) {
        x[j][0] = *(const float4*)(q_lane + j * 16 * P + d);
        x[j][1] = *(const float4*)(q_lane + (j * 16 + 8) * P + d);
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float4 kx = *(const float4*)(ks + (n * 8 + 2 * tq + e) * P + d);
#pragma unroll
          for (int j = 0; j < SL; ++j) {
            float sa = s[j][n][e], sb = s[j][n][e + 2];
            const float4 xa = x[j][0], xb = x[j][1];
            sa = fmaf(xa.x, kx.x, sa);
            sb = fmaf(xb.x, kx.x, sb);
            sa = fmaf(xa.y, kx.y, sa);
            sb = fmaf(xb.y, kx.y, sb);
            sa = fmaf(xa.z, kx.z, sa);
            sb = fmaf(xb.z, kx.z, sb);
            sa = fmaf(xa.w, kx.w, sa);
            sb = fmaf(xb.w, kx.w, sb);
            s[j][n][e] = sa;
            s[j][n][e + 2] = sb;
          }
        }
    }

#pragma unroll
    for (int j = 0; j < SL; ++j) {
      // a slab with no row at or past k0 (or none at all) sits this tile out
      if (w_hi[j] < 0 || (causal && k0 > w_hi[j])) continue;

      // online softmax on the accumulator
      const bool masked = (causal && k0 + BN - 1 > w_lo[j]) || k0 + BN > Sk ||
                          w0[j] + 16 > R;
      float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + n * 8 + 2 * tq + e;
          const bool ok_a = !masked || (qa[j] >= 0 && key < Sk &&
                                        (!causal || key <= qa[j]));
          const bool ok_b = !masked || (qb[j] >= 0 && key < Sk &&
                                        (!causal || key <= qb[j]));
          s[j][n][e] = ok_a ? s[j][n][e] * scale : -INFINITY;
          s[j][n][e + 2] = ok_b ? s[j][n][e + 2] * scale : -INFINITY;
          mx_a = fmaxf(mx_a, s[j][n][e]);
          mx_b = fmaxf(mx_b, s[j][n][e + 2]);
        }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
      }
      const float mn_a = fmaxf(m_a[j], mx_a), mn_b = fmaxf(m_b[j], mx_b);
      const float al_a = (m_a[j] == -INFINITY) ? 0.f : exp_neg(m_a[j] - mn_a);
      const float al_b = (m_b[j] == -INFINITY) ? 0.f : exp_neg(m_b[j] - mn_b);
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& pa = s[j][n][e];
          float& pb = s[j][n][e + 2];
          pa = (pa == -INFINITY) ? 0.f : exp_neg(pa - mn_a);
          pb = (pb == -INFINITY) ? 0.f : exp_neg(pb - mn_b);
          sum_a += pa;
          sum_b += pb;
        }
      l_a[j] = l_a[j] * al_a + sum_a;
      l_b[j] = l_b[j] * al_b + sum_b;
      m_a[j] = mn_a;
      m_b[j] = mn_b;

      // O = alpha O + P V in 3xTF32, the tile's 8-key steps one chain of
      // MMAs from zero per output tile, added into O in f32: keys 2tq and
      // 2tq + 1 of each 8-key step are this lane's A columns tq and tq + 4
      float pv[DT][4];
#pragma unroll
      for (int dn = 0; dn < DT; ++dn)
#pragma unroll
        for (int e = 0; e < 4; ++e) pv[dn][e] = 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t ph[4], pl[4];
        split(s[j][n][0], ph[0], pl[0]);
        split(s[j][n][2], ph[1], pl[1]);
        split(s[j][n][1], ph[2], pl[2]);
        split(s[j][n][3], ph[3], pl[3]);
        const int at = (n * 8 + 2 * tq) * P + gq;
#pragma unroll
        for (int dn = 0; dn < DT; ++dn) {
          const int a0 = at + dn * 8;
          mma3(pv[dn], ph, pl, make_uint2(vh[a0], vh[a0 + P]),
               make_uint2(vl[a0], vl[a0 + P]));
        }
      }
#pragma unroll
      for (int dn = 0; dn < DT; ++dn) {
        o[j][dn][0] = fmaf(o[j][dn][0], al_a, pv[dn][0]);
        o[j][dn][1] = fmaf(o[j][dn][1], al_a, pv[dn][1]);
        o[j][dn][2] = fmaf(o[j][dn][2], al_b, pv[dn][2]);
        o[j][dn][3] = fmaf(o[j][dn][3], al_b, pv[dn][3]);
      }
    }
  }

#pragma unroll
  for (int j = 0; j < SL; ++j) {
    float la = l_a[j], lb = l_b[j];
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      la += __shfl_xor_sync(0xffffffffu, la, off);
      lb += __shfl_xor_sync(0xffffffffu, lb, off);
    }
    const float inv_a = 1.f / fmaxf(la, 1e-30f);
    const float inv_b = 1.f / fmaxf(lb, 1e-30f);
    const int ra = w0[j] + gq, rb = ra + 8;
#pragma unroll
    for (int dn = 0; dn < DT; ++dn)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = dn * 8 + 2 * tq + e;
        if (d >= D) continue;
        if (qa[j] >= 0)
          out[row_at(ra) + d] = repro::from_f32<TQ>(o[j][dn][e] * inv_a);
        if (qb[j] >= 0)
          out[row_at(rb) + d] = repro::from_f32<TQ>(o[j][dn][e + 2] * inv_b);
      }
  }
}

template <typename TQ, typename TK, int DP>
int launch(void* q, void* k, void* v, void* out, int B, int Hkv, int G,
           int Sq, int Sk, int D, float scale, int causal, cudaStream_t st) {
  auto kern = flash_kernel<TQ, TK, DP>;
  constexpr size_t smem = Geo<DP>::SMEM;
  cudaError_t err = repro::allow_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  const int vec = sizeof(TK) == 4 && D % 4 == 0 &&
                  ((uintptr_t)k | (uintptr_t)v) % 16 == 0;
  constexpr int BM = Geo<DP>::BM;
  const int nz = (Sq * G + BM - 1) / BM;
  kern<<<dim3(nz, Hkv, B), Geo<DP>::THREADS, smem, st>>>(
      (const TQ*)q, (const TK*)k, (const TK*)v, (TQ*)out, Sq, Sk, Hkv, G, D,
      scale, causal, vec);
  return (int)cudaGetLastError();
}

template <typename TQ, typename TK>
int launch_d(void* q, void* k, void* v, void* out, int B, int Hkv, int G,
             int Sq, int Sk, int D, float scale, int causal, cudaStream_t st) {
#define REPRO_ARGS q, k, v, out, B, Hkv, G, Sq, Sk, D, scale, causal, st
  if (D <= 32) return launch<TQ, TK, 32>(REPRO_ARGS);
  if (D <= 64) return launch<TQ, TK, 64>(REPRO_ARGS);
  return launch<TQ, TK, 128>(REPRO_ARGS);
#undef REPRO_ARGS
}

}  // namespace

// q/out [B, Hkv*G, Sq, D] (q_dtype); k/v [B, Hkv, Sk, D] (kv_dtype), all
// contiguous. causal: mask qpos >= kpos, both counted from 0 (top-left
// aligned when Sq != Sk).
extern "C" int flash_attention(void* q, void* k, void* v, void* out, int B,
                               int Hkv, int G, int Sq, int Sk, int D,
                               float scale, int causal, int q_dtype,
                               int kv_dtype, void* stream) {
  if (B <= 0 || Hkv <= 0 || G <= 0 || Sq <= 0 || Sk <= 0 || D <= 0 ||
      D > MAXD || Hkv > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define REPRO_ARGS q, k, v, out, B, Hkv, G, Sq, Sk, D, scale, causal, st
  if (q_dtype == REPRO_F32 && kv_dtype == REPRO_F32)
    return launch_d<float, float>(REPRO_ARGS);
  if (q_dtype == REPRO_BF16 && kv_dtype == REPRO_F32)
    return launch_d<__nv_bfloat16, float>(REPRO_ARGS);
  if (q_dtype == REPRO_F32 && kv_dtype == REPRO_BF16)
    return launch_d<float, __nv_bfloat16>(REPRO_ARGS);
  if (q_dtype == REPRO_BF16 && kv_dtype == REPRO_BF16)
    return launch_d<__nv_bfloat16, __nv_bfloat16>(REPRO_ARGS);
#undef REPRO_ARGS
  return (int)cudaErrorInvalidValue;
}
