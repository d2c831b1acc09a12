// K17: the st1 field's two elementwise passes around the FFTs.
//
// Replaces the expressions of homogenization_jl_tpu/utils/fft_field.py::
// generate_field that XLA fuses on the TPU:
//
//   spectral_filter: out = F / (1 + |k|)^p      (:30-44; F the complex64
//                    half spectrum [D0, D1, L] of a real grid, |k|^2 from
//                    the indices under the reference's folded convention,
//                    coord(m, i) = abs(abs(i - m - 1) - m): the two leading
//                    axes fold around their Nyquist index, the last, the
//                    rfft axis, runs 0..L-1)
//   exp_abs:         out = exp(alpha |f|)       (:46)
//
// Bound on the H100: the launch. At st1's 32^3 grid the filter moves 0.28
// MB and the exp 0.26 MB, under a microsecond at 3.35 TB/s, while one
// launch takes microseconds of device time and more of the host's. So the
// design is the cheapest launch: one thread per entry, the offset decoded
// into (i0, i1, i2) in 32-bit arithmetic (the wrapper holds the entries
// below 2^31), F read once and a fresh output written (no copy of F first),
// and the C entries go through the ctypes launcher (csrc/build.py), the
// port's cheapest. |k|^2 is a sum of squares of integers, exact in float32
// in any order; sqrtf, powf, expf and the quotient are the CUDA math
// library's correctly rounded or full-range forms (no fast math), so the
// passes follow the plain forms (utils/fft_field.py) to a few ulp.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float folded(int i, int D) {
  const int h = D / 2;
  return static_cast<float>(abs(abs(i - h) - h));
}

__global__ void __launch_bounds__(THREADS)
spectral_filter_kernel(const float2* __restrict__ F, float2* __restrict__ out, int total, int D0,
                       int D1, int L, float p) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= total) return;
  const int t = i / L;
  const int i2 = i - t * L;
  const int i0 = t / D1;
  const int i1 = t - i0 * D1;
  const float k0 = folded(i0, D0), k1 = folded(i1, D1), k2 = static_cast<float>(i2);
  const float kk = __fadd_rn(__fadd_rn(__fmul_rn(k0, k0), __fmul_rn(k1, k1)), __fmul_rn(k2, k2));
  const float den = powf(__fadd_rn(1.0f, sqrtf(kk)), p);
  const float2 f = F[i];
  out[i] = make_float2(__fdiv_rn(f.x, den), __fdiv_rn(f.y, den));
}

__global__ void __launch_bounds__(THREADS)
exp_abs_kernel(const float* __restrict__ f, float* __restrict__ out, int N, float alpha) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i < N) out[i] = expf(__fmul_rn(alpha, fabsf(f[i])));
}

unsigned blocks(int N) { return static_cast<unsigned>((N + THREADS - 1) / THREADS); }

}  // namespace

// F, out: complex64 [D0, D1, L] (out must not alias F); total = D0 D1 L
// below 2^31; p rounded to float32. Returns cudaGetLastError().
extern "C" int hz_spectral_filter(const void* F, void* out, int total, int D0, int D1, int L,
                                  double p, void* stream) {
  if (total > 0)
    spectral_filter_kernel<<<blocks(total), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float2*>(F), static_cast<float2*>(out), total, D0, D1, L,
        static_cast<float>(p));
  return static_cast<int>(cudaGetLastError());
}

// f, out: float32 [N] (out must not alias f), N below 2^31; alpha rounded to
// float32. Returns cudaGetLastError().
extern "C" int hz_exp_abs(const void* f, void* out, int N, double alpha, void* stream) {
  if (N > 0)
    exp_abs_kernel<<<blocks(N), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(f), static_cast<float*>(out), N, static_cast<float>(alpha));
  return static_cast<int>(cudaGetLastError());
}
