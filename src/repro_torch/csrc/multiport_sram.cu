// Pool step: one macro-cycle of the banked N-port memory in one launch.
//
// Replaces the TPU kernel src/repro/kernels/multiport_sram.py:_kernel
// (pallas_call in multiport_sram_step), which walks storage banks on the
// grid and decodes addresses with one-hot matmuls. Here it is a
// gather/scatter.
//
// What bounds it on an H100: bytes. Each enabled port moves Q words of W
// elements (a write reads its payload and writes storage, a read reads
// storage and writes its output row); there is no arithmetic. The pool
// storage itself (8192 words x 11264 f32 for full tinyllama) is only
// touched at the addressed words.
//
// Design: the grid runs over COLS-wide column tiles of the word, and every
// block walks the packed ports in service order, with __syncthreads()
// between ports. A block owns the same columns of EVERY word, so the
// priority order and same-cycle W->R visibility are block-local and need no
// ordering between blocks. Inside one port the lanes are spread over the
// block's warps: write lanes were deduplicated (last wins) by the wrapper,
// so no two lanes of a port write the same word. Lanes are never split
// across blocks, which would let a write in one block race a read of the
// same word in another. Elements are moved as raw bits, so the step is
// exact for any 2- or 4-byte dtype.
#include "common.cuh"

namespace {

constexpr int COLS = 128;     // word columns per block
constexpr int THREADS = 256;  // 8 warps; each warp walks every 8th lane
constexpr int GROUPS = THREADS / 32;

template <typename T>
__global__ void multiport_sram_kernel(T* __restrict__ storage,
                                      const int32_t* __restrict__ addr,
                                      const uint8_t* __restrict__ mask,
                                      const T* __restrict__ data,
                                      T* __restrict__ reads, int width,
                                      int n_ports, int q, int write_bits) {
  const int c0 = blockIdx.x * COLS;
  const int group = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int p = 0; p < n_ports; ++p) {
    const bool is_write = (write_bits >> p) & 1;
    const int32_t* pa = addr + (size_t)p * q;
    const uint8_t* pm = mask + (size_t)p * q;
    const T* pd = data + (size_t)p * q * width;
    T* pr = reads + (size_t)p * q * width;
    for (int l = group; l < q; l += GROUPS) {
      const bool on = pm[l] != 0;
      const size_t row = (size_t)pa[l] * width;
      const size_t lrow = (size_t)l * width;
#pragma unroll
      for (int k = 0; k < COLS / 32; ++k) {
        const int c = c0 + lane + 32 * k;
        if (c >= width) break;
        if (is_write) {
          if (on) storage[row + c] = pd[lrow + c];
          pr[lrow + c] = T(0);  // a write slot's read output is zeros
        } else {
          pr[lrow + c] = on ? storage[row + c] : T(0);
        }
      }
    }
    __syncthreads();  // port p fully serviced before port p+1 starts
  }
}

}  // namespace

// storage [num_words, width] (updated in place); addr/mask [n_ports, q];
// data/reads [n_ports, q, width]. Ports are packed in service order;
// bit p of write_bits marks slot p as a write port. Masked-on addresses
// must lie in [0, num_words).
extern "C" int multiport_sram_step(void* storage, const void* addr,
                                   const void* mask, const void* data,
                                   void* reads, int width, int n_ports, int q,
                                   int write_bits, int elem_bytes,
                                   void* stream) {
  if (width <= 0 || n_ports <= 0 || q <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((width + COLS - 1) / COLS);
  cudaStream_t st = (cudaStream_t)stream;
  if (elem_bytes == 4) {
    multiport_sram_kernel<uint32_t><<<grid, THREADS, 0, st>>>(
        (uint32_t*)storage, (const int32_t*)addr, (const uint8_t*)mask,
        (const uint32_t*)data, (uint32_t*)reads, width, n_ports, q,
        write_bits);
  } else if (elem_bytes == 2) {
    multiport_sram_kernel<uint16_t><<<grid, THREADS, 0, st>>>(
        (uint16_t*)storage, (const int32_t*)addr, (const uint8_t*)mask,
        (const uint16_t*)data, (uint16_t*)reads, width, n_ports, q,
        write_bits);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
