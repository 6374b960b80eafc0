// An empty kernel, launched through the same ctypes path as every kernel of
// the port: its device time per launch, queued as the others are timed, is
// the floor under every kernel's time on this card. It replaces no TPU
// kernel and runs on no path; chip_smoke.py times it beside the kernels.
#include "common.cuh"

namespace {

__global__ void empty_kernel() {}

}  // namespace

extern "C" int launch_floor(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
