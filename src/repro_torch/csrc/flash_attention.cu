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
// tensor cores (989 TFLOP/s) against 3.35 TB/s. This kernel does its
// arithmetic as f32 FMA on the CUDA cores and takes the calls that stay off
// the tensor cores: f32 (TF32 keeps about three digits, the f32 contract is
// 2e-5), bf16 q over f32 k/v, and a head dim that is not a multiple of 8
// (TMA's 16-byte row stride). bf16 q, k and v go to the tensor-core kernel
// (flash_attention_tc.cu); kernels/flash_attention.py picks the route.
//
// Design: block (z, hk, b) owns BM = 64 query rows of its kv head's group,
// where row r of the group is position r / G of head hk * G + r % G, so one
// K/V tile in shared memory serves all G query heads (the reuse the TPU
// kernel got from its [G, Tq, D] block). The register-tiled f32 engine of
// attend_tile.cuh (shared with B2's chunked prefill) computes each 64-key
// tile: a 16 x 16 thread grid with 4 x 4 score and 4 x D/16 output
// micro-tiles, online softmax over 16-lane shuffles. Causal blocks stop at
// their last row's position (the TPU's tile skip) and mask per element only
// on tiles that cross the diagonal; blocks are launched longest first. k
// and v are read in f32, sums are f32, the denominator has a floor of 1e-30
// and the output is cast to q's dtype.
#include "attend_tile.cuh"

namespace {

using namespace repro::tile;
constexpr int MAXD = 128;

template <typename TQ, typename TK, int DP>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const TQ* __restrict__ q, const TK* __restrict__ k,
             const TK* __restrict__ v, TQ* __restrict__ out, int Sq, int Sk,
             int Hkv, int G, int D, float scale, int causal) {
  constexpr int DT = DP / TX;       // output dims per thread
  constexpr int VS = vstride<DP>();
  extern __shared__ __align__(16) float smem[];
  const Smem<DP> sm(smem);

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
    sm.qt[d * BMP + r] = (r0 + r < R && d < D)
                             ? repro::to_f32(q[row_at(r0 + r) + d]) : 0.f;
  }
  Rows<DP> st;
  st.init();
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = r0 + ty * RM + i;
    st.qpos[i] = r < R ? r / G : -1;   // -1: past the group's last row
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
      sm.kt[d * BNP + j] = kx;
      sm.vs[j * VS + d] = vx;
    }
    __syncthreads();
    // the per-element mask: tiles that cross the diagonal, the ragged key
    // tail, and the rows past the group's end
    const bool masked = (causal && k0 + BN - 1 > qlo) || k0 + BN > Sk ||
                        r0 + BM > R;
    attend(sm, st, tx, ty, k0, kend, causal != 0, masked, scale);
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    if (st.qpos[i] < 0) continue;
    TQ* orow = out + row_at(r0 + ty * RM + i);
#pragma unroll
    for (int dd = 0; dd < DT; ++dd) {
      const int d = tx * DT + dd;
      if (d < D) orow[d] = repro::from_f32<TQ>(st.out(i, dd));
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
