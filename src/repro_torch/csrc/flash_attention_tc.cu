// bf16 causal (or full) GQA flash-attention forward on Hopper's tensor
// cores: TMA loads, an mbarrier ring and wgmma.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:_kernel
// (pallas_call in flash_attention) for bf16 q, k and v with a head dim that
// is a multiple of 8 and at most 128; every other dtype mix stays on the
// CUDA-core kernel (flash_attention.cu). kernels/flash_attention.py picks
// the route from dtypes and D before the launch.
//
// What bounds it on an H100: operations. At q [2, 32, 2048, 64] causal it
// does 34.4 GFLOP on 38 MB: 0.035 ms at the bf16 tensor cores' 989
// TFLOP/s, 0.011 ms of bytes at 3.35 TB/s. Only wgmma reaches that rate,
// and the softmax's exponentials (16 per SM per clock) cost about as much
// as the two products of a 64 x 128 tile, so the design keeps the tensor
// cores fed from shared memory and the softmax in registers.
//
// Design. CTA (z, b, h) owns BM = 64 query rows of head h: one consumer
// warpgroup (128 threads) computes, one producer warp issues TMA.
// - Q [64, DP] is loaded once by TMA; K and V tiles of BN keys stream
//   through a ring of STAGES = 2 stages handed over by full/empty
//   mbarriers (the producer waits on "empty", sets the expected bytes on
//   "full" and issues the copies; the consumers wait on "full" and arrive on
//   "empty" once both products have read the stage).
// - Shared tiles are rows of 64 bf16 (128 bytes) in TMA's 128-byte swizzle,
//   the layout the wgmma descriptors name; a head dim of 128 is two such
//   64-column atoms per tile (two boxes), one up to 64 is one box whose
//   columns past D are TMA's zero fill. Rows past Sq or Sk are zero filled
//   too, so a ragged tail computes on zeros and is masked or never stored.
// - S = Q K^T is wgmma m64nBNk16 with A and B K-major in shared memory
//   (the descriptor advances 32 bytes per 16-wide k step inside an atom),
//   the f32 accumulator in registers.
// - The online softmax runs on the accumulator fragment: thread (warp w,
//   lane l) holds rows 16w + l/4 and +8, columns 8n + 2(l%4) + {0, 1}; a
//   row's max is reduced over the quad of 4 lanes that share it, its sum
//   stays per thread until the epilogue. exp2 on log2(e)-scaled scores;
//   the alpha guard for an all-masked history and the 1e-30 floor stay.
// - P is cast to bf16 in registers, where the accumulator fragment of
//   columns 16k..16k+15 is exactly the A fragment of k step k, and
//   O += P V is wgmma with A from registers and V the MN-major B operand
//   (transpose bit) in shared memory.
// - Causal: the key loop (producer and consumers alike) stops at the tile
//   holding the block's last row; only tiles that cross the diagonal or the
//   ragged key tail mask per element (top-left aligned, qpos >= kpos).
//   Blocks launch longest first, and the H heads of one query block launch
//   together, so the G heads of a kv head re-read its K/V tiles from L2.
// - The epilogue divides by l and stores bf16 pairs straight from the
//   fragment.
// Later work, not here: warp specialisation with setmaxnreg, two consumer
// warpgroups in ping-pong (one's softmax under the other's products),
// clusters with TMA multicast of K/V to the G heads, a TMA store epilogue.
//
// Traps, and how they are handled: cuTensorMapEncodeTiled lives in libcuda,
// which the build does not link, so it is looked up at run time (dlopen of
// the already loaded libcuda.so.1); the tensor maps are built in
// the C entry point from the pointers and shapes (ctypes passes only
// pointers and ints) and go in as __grid_constant__ parameters; TMA needs
// 16-byte row strides, hence D % 8 == 0, and 16-byte aligned bases, which
// the wrapper guarantees; register fences keep the compiler from moving
// accumulator reads across wgmma.wait_group; a wait that never completes
// traps rather than hanging the card. None of them failed a test on the
// card; -Xptxas -v reports no spills for either instantiation.
#include <cuda.h>
#include <dlfcn.h>

#include "common.cuh"

namespace {

constexpr int BM = 64;                     // query rows per CTA (wgmma M)
constexpr int STAGES = 2;                  // K/V ring depth
constexpr int CONSUMERS = 128;             // one warpgroup
constexpr int THREADS = CONSUMERS + 32;    // + the producer warp
constexpr int ATOM_COLS = 64;              // bf16 columns per 128-byte row
constexpr float LOG2E = 1.4426950408889634f;

// Tile geometry of one padded head dim (64 or 128); kernels/
// flash_attention.py:tc_geometry mirrors it.
template <int DP>
struct Geo {
  static constexpr int BN = DP == 64 ? 128 : 64;      // keys per tile
  static constexpr int ATOMS = DP / ATOM_COLS;
  static constexpr int Q_BYTES = BM * DP * 2;
  static constexpr int KV_BYTES = BN * DP * 2;        // one K or V tile
  static constexpr int BAR_BYTES = 8 * (2 * STAGES + 1);
  // 1024 bytes of slack to align the swizzled tiles to 1024
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES + BAR_BYTES;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// Spins until the phase of parity `parity` has completed. A wait that
// never completes (a lost copy) traps after ~2^26 tries instead of hanging
// the card; the launch then fails and the wrapper raises.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    if (tries == (1u << 26)) __trap();
  }
}

// One box of a 3-d tensor map (coordinates innermost first) into shared
// memory, completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (16-byte units).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving accesses of accumulator registers across
// the wgmma fence / wait that guards them.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// two f32 as bf16x2: lo in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t u;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(u) : "f"(hi), "f"(lo));
  return u;
}

// D[64 x 64] (+)= A[64 x 16] . B[16 x 64], A and B K-major in shared
// memory; scale_d 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 64] (+)= A[64 x 16] . B[16 x 64], A in registers (bf16x2), B
// MN-major in shared memory (the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// D[64 x 128] (+)= A[64 x 16] . B[16 x 128], A and B K-major in shared
// memory; scale_d 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 128] (+)= A[64 x 16] . B[16 x 128], A in registers (bf16x2), B
// MN-major in shared memory (the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db,
                                         int scale_d) {
  if constexpr (N == 64) wgmma_ss_n64(d, da, db, scale_d);
  else wgmma_ss_n128(d, da, db, scale_d);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, db, 1);
  else wgmma_rs_n128(d, a, db, 1);
}

// q/out [B, H, Sq, D] and k/v [B, Hkv, Sk, D] bf16 as 3-d tensor maps
// [B*H, Sq, D] and [B*Hkv, Sk, D]; grid (z, b, h) flattened with h fastest.
template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                __nv_bfloat16* __restrict__ out, int B, int H, int G, int Sq,
                int Sk, int D, float scale_log2, int causal) {
  using Gm = Geo<DP>;
  constexpr int BN = Gm::BN, ATOMS = Gm::ATOMS;
  constexpr int ROW = ATOM_COLS * 2;       // bytes per swizzled row
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sq = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sk = sq + Gm::Q_BYTES;                    // [STAGES][KV_BYTES]
  uint8_t* sv = sk + STAGES * Gm::KV_BYTES;          // [STAGES][KV_BYTES]
  uint64_t* full = reinterpret_cast<uint64_t*>(sv + STAGES * Gm::KV_BYTES);
  uint64_t* empty = full + STAGES;
  uint64_t* qbar = empty + STAGES;

  const int nz = (Sq + BM - 1) / BM;
  const int h = blockIdx.x % H, b = (blockIdx.x / H) % B;
  const int z = nz - 1 - (int)(blockIdx.x / (H * B));  // longest first
  const int m0 = z * BM, hk = h / G;
  const int kend = causal ? min(Sk, min(Sq, m0 + BM)) : Sk;
  const int ntiles = (kend + BN - 1) / BN;
  const int tid = threadIdx.x;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {  // the producer warp: one lane issues every copy
    if (tid == CONSUMERS) {
      const int bq = b * H + h, bkv = b * (H / G) + hk;
      mbar_expect_tx(qbar, Gm::Q_BYTES);
#pragma unroll
      for (int a = 0; a < ATOMS; ++a)
        tma_load(sq + a * BM * ROW, &tm_q, qbar, a * ATOM_COLS, m0, bq);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % STAGES;
        if (t >= STAGES) mbar_wait(&empty[s], (t / STAGES - 1) & 1);
        mbar_expect_tx(&full[s], 2 * Gm::KV_BYTES);
#pragma unroll
        for (int a = 0; a < ATOMS; ++a) {
          tma_load(sk + s * Gm::KV_BYTES + a * BN * ROW, &tm_k, &full[s],
                   a * ATOM_COLS, t * BN, bkv);
          tma_load(sv + s * Gm::KV_BYTES + a * BN * ROW, &tm_v, &full[s],
                   a * ATOM_COLS, t * BN, bkv);
        }
      }
    }
    return;
  }

  // the consumer warpgroup
  const int warp = tid / 32, lane = tid % 32, c = lane % 4;
  const int row0 = m0 + warp * 16 + lane / 4;  // this thread's rows: +0, +8
  float o[DP / 2], s[BN / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) s[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const uint32_t q_addr = smem_u32(sq);
  mbar_wait(qbar, 0);

  for (int t = 0; t < ntiles; ++t) {
    const int st = t % STAGES;
    mbar_wait(&full[st], (t / STAGES) & 1);
    const uint32_t k_addr = smem_u32(sk + st * Gm::KV_BYTES);
    const uint32_t v_addr = smem_u32(sv + st * Gm::KV_BYTES);

    // S = Q K^T: 16-wide k steps, 32 bytes apart inside a 128-byte atom
    fence_regs<BN / 2>(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t at = (kk / 4) * ROW, in = (kk % 4) * 32;
      wgmma_ss<BN>(s, sw128_desc(q_addr + at * BM + in, 16, 8 * ROW),
                   sw128_desc(k_addr + at * BN + in, 16, 8 * ROW), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<BN / 2>(s);

    // online softmax on the fragment: s[4n + 2i + j] is row row0 + 8i,
    // key k0 + 8n + 2c + j
    const int k0 = t * BN;
    const bool masked = (causal && k0 + BN - 1 > m0) || k0 + BN > Sk;
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qpos = row0 + 8 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < BN / 8; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float& x = s[4 * n + 2 * i + j];
          const int key = k0 + 8 * n + 2 * c + j;
          const bool ok = !masked || (key < Sk && (!causal || key <= qpos));
          x = ok ? x * scale_log2 : -INFINITY;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx);
      alpha[i] = (m[i] == -INFINITY) ? 0.f : exp2f(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < BN / 8; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float& x = s[4 * n + 2 * i + j];
          x = (x == -INFINITY) ? 0.f : exp2f(x - m_new);
          sum += x;
        }
      l[i] = l[i] * alpha[i] + sum;  // this thread's columns; quad-summed last
      m[i] = m_new;
    }
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        o[4 * n + 2 * i] *= alpha[i];
        o[4 * n + 2 * i + 1] *= alpha[i];
      }

    // P as bf16: the fragment of keys 16k..16k+15 is the A fragment of k
    // step k
    uint32_t pa[BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
    // O += P V: V MN-major, 8-key groups 8 rows apart, the second 64-column
    // atom (D = 128) BN rows on
    fence_regs<DP / 2>(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      wgmma_rs<DP>(o, pa[kk], sw128_desc(v_addr + kk * 16 * ROW, BN * ROW,
                                         8 * ROW));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<DP / 2>(o);
    mbar_arrive(&empty[st]);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  const size_t obase = ((size_t)b * H + h) * Sq;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    __nv_bfloat16* orow = out + (obase + row) * D;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int col = 8 * n + 2 * c;
      if (col < D)
        *reinterpret_cast<uint32_t*>(orow + col) =
            pack_bf16(o[4 * n + 2 * i] / den, o[4 * n + 2 * i + 1] / den);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the libcuda the process already has loaded
// (the build links only the CUDA runtime).
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib ? reinterpret_cast<EncodeTiled>(
                     dlsym(lib, "cuTensorMapEncodeTiled"))
               : nullptr;
  }();
  return fn;
}

// [n, rows, D] bf16 as a tensor map of [1, box_rows, 64] boxes in 128-byte
// swizzle; out-of-bounds elements read as zeros.
bool tensor_map(CUtensorMap* map, void* ptr, int n, int rows, int D,
                int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows, (cuuint64_t)n};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)rows * D * 2};
  const cuuint32_t box[3] = {ATOM_COLS, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, ptr, dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DP>
int launch(void* q, void* k, void* v, void* out, int B, int Hkv, int G,
           int Sq, int Sk, int D, float scale, int causal, cudaStream_t st) {
  using Gm = Geo<DP>;
  if (encode_tiled() == nullptr) return (int)cudaErrorSharedObjectSymbolNotFound;
  const int H = Hkv * G;
  CUtensorMap mq, mk, mv;
  if (!tensor_map(&mq, q, B * H, Sq, D, BM) ||
      !tensor_map(&mk, k, B * Hkv, Sk, D, Gm::BN) ||
      !tensor_map(&mv, v, B * Hkv, Sk, D, Gm::BN))
    return (int)cudaErrorInvalidValue;
  auto kern = flash_tc_kernel<DP>;
  cudaError_t err = repro::allow_smem(kern, Gm::SMEM);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)((Sq + BM - 1) / BM) * B * H;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kern<<<(unsigned)blocks, THREADS, Gm::SMEM, st>>>(
      mq, mk, mv, (__nv_bfloat16*)out, B, H, G, Sq, Sk, D, scale * LOG2E,
      causal);
  return (int)cudaGetLastError();
}

}  // namespace

// q/out [B, Hkv*G, Sq, D], k/v [B, Hkv, Sk, D], all bf16, contiguous and
// 16-byte aligned; D % 8 == 0, D <= 128. causal: mask qpos >= kpos, both
// counted from 0 (top-left aligned when Sq != Sk).
extern "C" int flash_attention_tc(void* q, void* k, void* v, void* out, int B,
                                  int Hkv, int G, int Sq, int Sk, int D,
                                  float scale, int causal, void* stream) {
  if (B <= 0 || Hkv <= 0 || G <= 0 || Sq <= 0 || Sk <= 0 || D <= 0 ||
      D > 128 || D % 8 != 0)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) % 16)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = (cudaStream_t)stream;
  if (D <= 64)
    return launch<64>(q, k, v, out, B, Hkv, G, Sq, Sk, D, scale, causal, st);
  return launch<128>(q, k, v, out, B, Hkv, G, Sq, Sk, D, scale, causal, st);
}

// Dynamic shared memory of the instantiation a head dim takes (bytes).
extern "C" int flash_attention_tc_smem_bytes(int D) {
  return D <= 64 ? Geo<64>::SMEM : Geo<128>::SMEM;
}
