// Pool step: one macro-cycle of the banked N-port memory in one launch.
//
// Replaces the TPU kernel src/repro/kernels/multiport_sram.py:_kernel
// (pallas_call in multiport_sram_step), which walks storage banks on the
// grid and decodes addresses with one-hot matmuls. Here it is a
// gather/scatter.
//
// What bounds it on an H100: bytes. A write lane reads its payload row and
// writes the addressed word; a read lane reads the addressed word and
// writes its output row; a masked-off read lane writes a zero row. There is
// no arithmetic. The pool storage itself (8192 words x 11264 f32 for full
// tinyllama) is only touched at the addressed words.
//
// Design: one persistent cooperative launch per traversal, sized to fill
// every SM (occupancy x SM count). The ports are serviced one after the
// other; inside a port, each warp takes (lane, 128-vector segment of the
// row) work items grid-stride, reads the lane's address and mask once per
// item, and moves the segment as 4 independent vector loads per thread
// (16 bytes each where the row and the pointers allow it, else the widest
// of 8, 4 or 2 bytes that does). Lanes of one port are spread over every
// block: write lanes were deduplicated (last wins) by the wrapper, so no
// two lanes of a port touch the same word, and a grid barrier
// (cooperative_groups::this_grid().sync()) between two ports of which one
// writes keeps the service order: port p is complete everywhere before
// port p + 1 starts (W->R, R->W and W->W order). Two reads in a row need no
// barrier. Storage is read around L1 (ld.global.cg), so a word written by
// another SM before the barrier is never served stale. Only read slots get
// an output row; write slots read their own payload pointer and write
// nothing else. Elements move as raw bits, so the step is exact for any 2-
// or 4-byte dtype.
#include <cooperative_groups.h>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int MAX_SLOTS = 4;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;            // independent vector moves per thread
constexpr int SEG = 32 * UNROLL;     // vectors per work item

// The write slots' payload rows [q, row_vecs], by write-slot index.
struct Payloads {
  const void* p[MAX_SLOTS];
};

template <typename V>
__global__ void __launch_bounds__(THREADS)
    multiport_sram_kernel(V* __restrict__ storage,
                          const int32_t* __restrict__ addr,
                          const uint8_t* __restrict__ mask, Payloads payload,
                          V* __restrict__ reads, int row_vecs, int n_ports,
                          int q, int write_bits) {
  const long warps = (long)gridDim.x * WARPS;
  const long warp = (long)blockIdx.x * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int segs = (row_vecs + SEG - 1) / SEG;
  const long items = (long)q * segs;
  const V zero{};
  int w_slot = 0, r_slot = 0;
  for (int p = 0; p < n_ports; ++p) {
    const bool is_write = (write_bits >> p) & 1;
    const bool was_write = p > 0 && ((write_bits >> (p - 1)) & 1);
    if (p > 0 && (is_write || was_write)) cg::this_grid().sync();
    const int32_t* pa = addr + (size_t)p * q;
    const uint8_t* pm = mask + (size_t)p * q;
    // picked without indexing the parameter array: no local-memory copy
    const void* pw = w_slot == 0   ? payload.p[0]
                     : w_slot == 1 ? payload.p[1]
                     : w_slot == 2 ? payload.p[2]
                                   : payload.p[3];
    const V* pd = is_write ? (const V*)pw : nullptr;
    V* pr = is_write ? nullptr : reads + (size_t)r_slot * q * row_vecs;
    for (long it = warp; it < items; it += warps) {
      const int l = (int)(it / segs);
      const int c0 = (int)(it - (long)l * segs) * SEG + lane;
      const bool on = __ldg(pm + l) != 0;
      const size_t lrow = (size_t)l * row_vecs;
      if (is_write) {
        if (!on) continue;
        const size_t srow = (size_t)__ldg(pa + l) * row_vecs;
        V buf[UNROLL];
#pragma unroll
        for (int k = 0; k < UNROLL; ++k) {
          const int c = c0 + 32 * k;
          if (c < row_vecs) buf[k] = __ldcs(pd + lrow + c);
        }
#pragma unroll
        for (int k = 0; k < UNROLL; ++k) {
          const int c = c0 + 32 * k;
          if (c < row_vecs) storage[srow + c] = buf[k];
        }
      } else if (on) {
        const size_t srow = (size_t)__ldg(pa + l) * row_vecs;
        V buf[UNROLL];
#pragma unroll
        for (int k = 0; k < UNROLL; ++k) {
          const int c = c0 + 32 * k;
          if (c < row_vecs) buf[k] = __ldcg(storage + srow + c);
        }
#pragma unroll
        for (int k = 0; k < UNROLL; ++k) {
          const int c = c0 + 32 * k;
          if (c < row_vecs) __stcs(pr + lrow + c, buf[k]);
        }
      } else {
#pragma unroll
        for (int k = 0; k < UNROLL; ++k) {
          const int c = c0 + 32 * k;
          if (c < row_vecs) __stcs(pr + lrow + c, zero);  // masked-off read
        }
      }
    }
    if (is_write)
      ++w_slot;
    else
      ++r_slot;
  }
}

// Blocks of one kernel that fit on the card at once: the cooperative
// launch's largest grid. Kept per vector width after the first query.
template <typename V>
cudaError_t resident_blocks(int* out) {
  static int cached = 0;
  if (cached > 0) {
    *out = cached;
    return cudaSuccess;
  }
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, multiport_sram_kernel<V>, THREADS, 0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  cached = per_sm * sms;
  *out = cached;
  return cudaSuccess;
}

template <typename V>
int launch(void* storage, const void* addr, const void* mask, Payloads pay,
           void* reads, int row_vecs, int n_ports, int q, int write_bits,
           cudaStream_t st) {
  int most = 0;
  cudaError_t err = resident_blocks<V>(&most);
  if (err != cudaSuccess) return (int)err;
  const long segs = (row_vecs + SEG - 1) / SEG;
  const long need = ((long)q * segs + WARPS - 1) / WARPS;
  const int blocks = (int)(need < most ? need : most);
  V* s = (V*)storage;
  const int32_t* a = (const int32_t*)addr;
  const uint8_t* m = (const uint8_t*)mask;
  V* r = (V*)reads;
  void* args[] = {&s, &a, &m, &pay, &r, &row_vecs, &n_ports, &q, &write_bits};
  err = cudaLaunchCooperativeKernel((const void*)multiport_sram_kernel<V>,
                                    dim3(blocks), dim3(THREADS), args, 0, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// storage [num_words, width] (updated in place); addr/mask [n_ports, q];
// data0..data3 the write slots' payloads [q, width] in slot order (unused
// ones null); reads [n_reads, q, width], one row block per read slot in
// slot order. Ports are packed in service order; bit p of write_bits marks
// slot p as a write port. Masked-on addresses must lie in [0, num_words).
extern "C" int multiport_sram_step(void* storage, const void* addr,
                                   const void* mask, const void* data0,
                                   const void* data1, const void* data2,
                                   const void* data3, void* reads, int width,
                                   int n_ports, int q, int write_bits,
                                   int elem_bytes, void* stream) {
  if (width <= 0 || n_ports <= 0 || n_ports > MAX_SLOTS || q <= 0 ||
      (elem_bytes != 2 && elem_bytes != 4))
    return (int)cudaErrorInvalidValue;
  const Payloads pay = {{data0, data1, data2, data3}};
  const int n_writes = __builtin_popcount(write_bits & ((1 << n_ports) - 1));
  // the widest move that divides the row and every pointer's alignment
  const size_t row_bytes = (size_t)width * elem_bytes;
  uintptr_t align = (uintptr_t)storage | (uintptr_t)row_bytes;
  if (n_writes < n_ports) align |= (uintptr_t)reads;
  for (int i = 0; i < n_writes; ++i) align |= (uintptr_t)pay.p[i];
  int vec = 16;
  while (vec > elem_bytes && (align % vec)) vec /= 2;
  const int row_vecs = (int)(row_bytes / vec);
  cudaStream_t st = (cudaStream_t)stream;
  switch (vec) {
    case 16:
      return launch<uint4>(storage, addr, mask, pay, reads, row_vecs, n_ports,
                           q, write_bits, st);
    case 8:
      return launch<uint2>(storage, addr, mask, pay, reads, row_vecs, n_ports,
                           q, write_bits, st);
    case 4:
      return launch<unsigned int>(storage, addr, mask, pay, reads, row_vecs,
                                  n_ports, q, write_bits, st);
    default:
      return launch<unsigned short>(storage, addr, mask, pay, reads, row_vecs,
                                    n_ports, q, write_bits, st);
  }
}
