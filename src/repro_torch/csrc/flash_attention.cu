// Causal (or full) GQA flash-attention forward over whole sequences.
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
// above the ridge of either the f32 CUDA cores (67 TFLOP/s) or the bf16
// tensor cores (989 TFLOP/s) against 3.35 TB/s. This first kernel does its
// arithmetic as f32 FMA on the CUDA cores (no wgmma yet).
//
// Design: block (z, hk, b) owns BM = 64 query rows of its kv head's group,
// where row r of the group is position r / G of head hk * G + r % G, so one
// K/V tile in shared memory serves all G query heads (the reuse the TPU
// kernel got from its [G, Tq, D] block). Its 256 threads form a 16 x 16
// grid: thread (ty, tx) computes the scores of rows ty*4..+3 against keys
// tx*4..+3 of each 64-key tile from q^T and k^T in shared memory (two
// 16-byte loads per 16 FMAs), keeps the online-softmax max and sum of its 4
// rows (reduced over the 16 tx lanes by shuffles), writes p^T to shared
// memory and accumulates p @ v into its 4 rows x D/16 dims. Causal blocks
// stop at their last row's position (the TPU's tile skip) and mask per
// element only on tiles that cross the diagonal; blocks are launched
// longest first. k and v are read in f32, sums are f32, the denominator has
// a floor of 1e-30 and the output is cast to q's dtype.
#include "common.cuh"

namespace {

constexpr int BM = 64;            // query rows per block
constexpr int BN = 64;            // keys per shared-memory tile
constexpr int TX = 16, TY = 16;   // thread grid
constexpr int THREADS = TX * TY;
constexpr int RM = BM / TY;       // rows per thread
constexpr int CN = BN / TX;       // keys per thread in a score tile
constexpr int BMP = BM + 4;       // padded row strides: 16-byte aligned
constexpr int BNP = BN + 4;
constexpr int MAXD = 128;
static_assert(RM == 4 && CN == 4, "the inner loops move 4 rows / 4 keys as one float4");

template <int DP>
constexpr size_t smem_bytes() {
  return sizeof(float) * (DP * BMP + DP * BNP + BN * DP + BN * BMP);
}

template <typename TQ, typename TK, int DP>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const TQ* __restrict__ q, const TK* __restrict__ k,
             const TK* __restrict__ v, TQ* __restrict__ out, int Sq, int Sk,
             int Hkv, int G, int D, float scale, int causal) {
  constexpr int DT = DP / TX;       // output dims per thread
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                 // [DP][BMP] q^T of the block's rows
  float* kt = qt + DP * BMP;        // [DP][BNP] k^T of the key tile
  float* vs = kt + DP * BNP;        // [BN][DP]  the value tile
  float* pt = vs + BN * DP;         // [BN][BMP] p^T of the score tile

  const int z = gridDim.x - 1 - blockIdx.x;  // longest causal blocks first
  const int hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int R = Sq * G, r0 = z * BM, H = Hkv * G;
  auto row_at = [&](int r) -> size_t {  // q/out offset of group row r
    const int pos = r / G, g = r - pos * G;
    return (((size_t)b * H + (size_t)hk * G + g) * Sq + pos) * D;
  };
  const size_t kv0 = ((size_t)b * Hkv + hk) * Sk * D;

  for (int i = tid; i < BM * DP; i += THREADS) {
    const int r = i / DP, d = i - r * DP;
    qt[d * BMP + r] = (r0 + r < R && d < D) ? repro::to_f32(q[row_at(r0 + r) + d])
                                            : 0.f;
  }
  int qpos[RM];
  float m[RM], l[RM], acc[RM][DT];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = r0 + ty * RM + i;
    qpos[i] = r < R ? r / G : -1;     // -1: past the group's last row
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int dd = 0; dd < DT; ++dd) acc[i][dd] = 0.f;
  }
  const int qlo = r0 / G, qhi = (min(R, r0 + BM) - 1) / G;
  const int kend = causal ? min(Sk, qhi + 1) : Sk;

  for (int k0 = 0; k0 < kend; k0 += BN) {
    __syncthreads();  // the previous tile's p^T and v are consumed
    for (int i = tid; i < BN * DP; i += THREADS) {
      const int j = i / DP, d = i - j * DP, pos = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (pos < Sk && d < D) {
        kx = repro::to_f32(k[kv0 + (size_t)pos * D + d]);
        vx = repro::to_f32(v[kv0 + (size_t)pos * D + d]);
      }
      kt[d * BNP + j] = kx;
      vs[j * DP + d] = vx;
    }
    __syncthreads();

    float s[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DP; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(qt + d * BMP + ty * RM);
      const float4 ka = *reinterpret_cast<const float4*>(kt + d * BNP + tx * CN);
      const float qv[RM] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[CN] = {ka.x, ka.y, ka.z, ka.w};
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // the per-element mask: tiles that cross the diagonal, the ragged key
    // tail, and the rows past the group's end
    const bool masked = (causal && k0 + BN - 1 > qlo) || k0 + BN > Sk ||
                        r0 + BM > R;
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int key = k0 + tx * CN + j;
        const bool ok = !masked || (qpos[i] >= 0 && key < Sk &&
                                    (!causal || key <= qpos[i]));
        s[i][j] = ok ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      for (int o = TX / 2; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = (m[i] == -INFINITY) ? 0.f : expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        s[i][j] = (s[i][j] == -INFINITY) ? 0.f : expf(s[i][j] - m_new);
        sum += s[i][j];
      }
      for (int o = TX / 2; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int dd = 0; dd < DT; ++dd) acc[i][dd] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < CN; ++j)
      *reinterpret_cast<float4*>(pt + (tx * CN + j) * BMP + ty * RM) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    const int nk = min(BN, kend - k0);
    for (int j = 0; j < nk; ++j) {
      const float4 pa = *reinterpret_cast<const float4*>(pt + j * BMP + ty * RM);
      const float p[RM] = {pa.x, pa.y, pa.z, pa.w};
      float vv[DT];
      const float* vr = vs + j * DP + tx * DT;
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
        for (int dd = 0; dd < DT; ++dd) acc[i][dd] = fmaf(p[i], vv[dd], acc[i][dd]);
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    if (qpos[i] < 0) continue;
    const float den = fmaxf(l[i], 1e-30f);
    TQ* orow = out + row_at(r0 + ty * RM + i);
#pragma unroll
    for (int dd = 0; dd < DT; ++dd) {
      const int d = tx * DT + dd;
      if (d < D) orow[d] = repro::from_f32<TQ>(acc[i][dd] / den);
    }
  }
}

template <typename TQ, typename TK, int DP>
int launch(void* q, void* k, void* v, void* out, int B, int Hkv, int G,
           int Sq, int Sk, int D, float scale, int causal, cudaStream_t st) {
  auto kern = flash_kernel<TQ, TK, DP>;
  constexpr size_t smem = smem_bytes<DP>();
  cudaError_t err = repro::allow_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  const int nz = (Sq * G + BM - 1) / BM;
  kern<<<dim3(nz, Hkv, B), THREADS, smem, st>>>(
      (const TQ*)q, (const TK*)k, (const TK*)v, (TQ*)out, Sq, Sk, Hkv, G, D,
      scale, causal);
  return (int)cudaGetLastError();
}

template <typename TQ, typename TK>
int launch_d(void* q, void* k, void* v, void* out, int B, int Hkv, int G,
             int Sq, int Sk, int D, float scale, int causal, cudaStream_t st) {
#define REPRO_ARGS q, k, v, out, B, Hkv, G, Sq, Sk, D, scale, causal, st
  // D <= 16 pads to 32: a 16-wide instantiation spilled 4 bytes (ptxas)
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
      D > MAXD)
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
