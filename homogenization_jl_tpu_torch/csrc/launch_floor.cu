// The launch floor: an empty kernel, launched through the same ctypes
// launcher as every CUDA kernel of the port (csrc/build.py::launch).
//
// Replaces no TPU kernel and runs on no path. chip_smoke.py times it (per
// call with CUDA events, and its device time from torch.profiler) as the
// least time any launch-bound kernel of the port can take: K6, K7 and K17
// do microseconds of work or less, so their times are held against this
// floor beside their byte bounds.

#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

extern "C" int hz_launch_floor(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
