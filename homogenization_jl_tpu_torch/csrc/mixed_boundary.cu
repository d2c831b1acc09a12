// K15: the mixed-precision boundary of iterative-refinement PCG.
//
// Replaces the casts of homogenization_jl_tpu/solver/multigrid.py::
// _mixed_pcg_impls's preconditioner (:1612-1623) and the inner-dtype
// multiplicity table of mixed_precision_setup (:1587-1598), which XLA
// fuses into passes on the TPU:
//
//   downcast_scale:  out = float(c) * s     (c = combine(r), the float64
//                    residual at the assembled scale; s = 1/multiplicity,
//                    stored in float32)
//   downcast:        out = float(c)         (the table itself, once)
//   upcast:          out = double(z)        (the float32 V-cycle's result)
//
// It runs after whichever combine the outer solver uses (K2, K8 or K11),
// so one kernel serves every combine kind.
//
// Bound on the H100: bytes. At the finest main-path level (E * n = 190.5M
// entries) downcast_scale reads 8 + 4 and writes 4 bytes per entry,
// 3.05 GB, 0.91 ms at 3.35 TB/s; upcast reads 4 and writes 8, 2.29 GB,
// 0.68 ms. Design: one thread per entry, no reuse to exploit; the cast
// rounds to nearest even (__double2float_rn, as PyTorch's ``.to()``) and
// the product is rounded on its own (__fmul_rn), so each entry gives the
// bits of its plain form (ops/mixed.py).

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
downcast_scale_kernel(const double* __restrict__ c, const float* __restrict__ s,
                      float* __restrict__ out, long long N) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= N) return;
  const float v = __double2float_rn(c[i]);
  out[i] = s == nullptr ? v : __fmul_rn(v, s[i]);
}

__global__ void __launch_bounds__(THREADS)
upcast_kernel(const float* __restrict__ z, double* __restrict__ out, long long N) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i < N) out[i] = static_cast<double>(z[i]);
}

unsigned blocks_of(long long N) { return static_cast<unsigned>((N + THREADS - 1) / THREADS); }

}  // namespace

// c: N doubles; s: N floats or NULL (then out = float(c)); out: N floats.
// Returns cudaGetLastError().
extern "C" int hz_downcast_scale(const void* c, const void* s, void* out, long long N,
                                 void* stream) {
  if (N > 0)
    downcast_scale_kernel<<<blocks_of(N), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const double*>(c), static_cast<const float*>(s), static_cast<float*>(out),
        N);
  return static_cast<int>(cudaGetLastError());
}

// z: N floats; out: N doubles. Returns cudaGetLastError().
extern "C" int hz_upcast(const void* z, void* out, long long N, void* stream) {
  if (N > 0)
    upcast_kernel<<<blocks_of(N), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(z), static_cast<double*>(out), N);
  return static_cast<int>(cudaGetLastError());
}
