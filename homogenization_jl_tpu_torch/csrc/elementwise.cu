// K18: the state-sized elementwise passes of the solver.
//
// Replaces the elementwise expressions of homogenization_jl_tpu/solver/
// multigrid.py and ops/interfaces.py that XLA fuses into passes on the TPU,
// where the port would otherwise run PyTorch's own elementwise kernels:
//
//   mask:         out = x * m                      (ops/interfaces.py:58
//                 apply_mask; the mask constraint, the smoothers' b * bm)
//   mul:          out = a * b                      (the Lanczos matvec's
//                 dinv * y, solver/multigrid.py:580)
//   lanczos:      out = (u - alpha v) - beta w     (the three-term update,
//                 :610; alpha, beta device scalars; without w, the first
//                 step's u - alpha v, which is the bits of the JAX form's
//                 (u - alpha v) - beta * 0 from a zero v_prev)
//   div_nz:       out = v / (s == 0 ? 1 : s)       (the normalizations,
//                 :604, :612; s a device scalar)
//   inv_positive: out = d > 0 ? 1 / d : 0          (the Jacobi inverse,
//                 :575, :690)
//   diagonal:     out[e, m] = sum_p c[e, p] dref[p, m]  (the assembled
//                 diagonal before its combine, einsum at :541-548)
//
// Bound on the H100: bytes. At the finest level (E * n = 190.5M values,
// 0.76 GB per float32 state) the mask moves 1.71 GB (0.51 ms at 3.35 TB/s),
// the three-term update 3.05 GB. Design: one thread per entry, no reuse to
// exploit; every product, sum and quotient rounded on its own (the _rn
// intrinsics: nothing is contracted into an FMA), so each entry gives the
// bits of its plain PyTorch form (ops/elementwise.py). The diagonal sums
// its P pieces in piece order from +0, as the plain form's loop does; XLA's
// einsum may order them otherwise. ``out`` may alias the first operand.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }

__device__ __forceinline__ long long entry() {
  return (long long)blockIdx.x * THREADS + threadIdx.x;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
mask_kernel(const T* x, const bool* __restrict__ m, T* out, long long N) {
  const long long i = entry();
  if (i < N) out[i] = mul_rn(x[i], T(m[i]));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
mul_kernel(const T* a, const T* b, T* out, long long N) {
  const long long i = entry();
  if (i < N) out[i] = mul_rn(a[i], b[i]);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
lanczos_kernel(const T* u, const T* v, const T* w, const T* __restrict__ alpha,
               const T* __restrict__ beta, T* out, long long N) {
  const long long i = entry();
  if (i >= N) return;
  const T y = sub_rn(u[i], mul_rn(*alpha, v[i]));
  out[i] = w == nullptr ? y : sub_rn(y, mul_rn(*beta, w[i]));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
div_nz_kernel(const T* v, const T* __restrict__ s, T* out, long long N) {
  const long long i = entry();
  if (i >= N) return;
  const T d = *s;
  out[i] = div_rn(v[i], d == T(0) ? T(1) : d);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
inv_positive_kernel(const T* d, T* out, long long N) {
  const long long i = entry();
  if (i >= N) return;
  const T v = d[i];
  out[i] = v > T(0) ? div_rn(T(1), v) : T(0);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
diagonal_kernel(const T* __restrict__ c, const T* __restrict__ dref, T* __restrict__ out,
                long long E, int P, int n) {
  const long long i = entry();
  if (i >= E * n) return;
  const long long e = i / n;
  const int m = (int)(i - e * n);
  T acc = T(0);
  for (int p = 0; p < P; ++p) acc = add_rn(acc, mul_rn(c[e * P + p], dref[(long long)p * n + m]));
  out[i] = acc;
}

unsigned blocks(long long N) { return static_cast<unsigned>((N + THREADS - 1) / THREADS); }

template <typename T>
T* p(void* q) { return static_cast<T*>(q); }
template <typename T>
const T* p(const void* q) { return static_cast<const T*>(q); }

}  // namespace

// dtype: 0 = float32, 1 = float64. N entries each (the diagonal: E * n);
// masks are bool; alpha, beta and s are one value each on the device; w
// may be NULL. ``out`` may alias x / a / u / v / d. Each returns
// cudaGetLastError().
extern "C" int hz_ew_mask(int dtype, const void* x, const void* m, void* out, long long N,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N > 0) {
    if (dtype == 0)
      mask_kernel<float><<<blocks(N), THREADS, 0, st>>>(p<float>(x), p<bool>(m), p<float>(out), N);
    else
      mask_kernel<double><<<blocks(N), THREADS, 0, st>>>(p<double>(x), p<bool>(m), p<double>(out), N);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hz_ew_mul(int dtype, const void* a, const void* b, void* out, long long N,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N > 0) {
    if (dtype == 0)
      mul_kernel<float><<<blocks(N), THREADS, 0, st>>>(p<float>(a), p<float>(b), p<float>(out), N);
    else
      mul_kernel<double><<<blocks(N), THREADS, 0, st>>>(p<double>(a), p<double>(b), p<double>(out), N);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hz_ew_lanczos(int dtype, const void* u, const void* v, const void* w,
                             const void* alpha, const void* beta, void* out, long long N,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N > 0) {
    if (dtype == 0)
      lanczos_kernel<float><<<blocks(N), THREADS, 0, st>>>(
          p<float>(u), p<float>(v), p<float>(w), p<float>(alpha), p<float>(beta), p<float>(out), N);
    else
      lanczos_kernel<double><<<blocks(N), THREADS, 0, st>>>(
          p<double>(u), p<double>(v), p<double>(w), p<double>(alpha), p<double>(beta),
          p<double>(out), N);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hz_ew_div_nz(int dtype, const void* v, const void* s, void* out, long long N,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N > 0) {
    if (dtype == 0)
      div_nz_kernel<float><<<blocks(N), THREADS, 0, st>>>(p<float>(v), p<float>(s), p<float>(out), N);
    else
      div_nz_kernel<double><<<blocks(N), THREADS, 0, st>>>(p<double>(v), p<double>(s), p<double>(out), N);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hz_ew_inv_positive(int dtype, const void* d, void* out, long long N,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N > 0) {
    if (dtype == 0)
      inv_positive_kernel<float><<<blocks(N), THREADS, 0, st>>>(p<float>(d), p<float>(out), N);
    else
      inv_positive_kernel<double><<<blocks(N), THREADS, 0, st>>>(p<double>(d), p<double>(out), N);
  }
  return static_cast<int>(cudaGetLastError());
}

// c: [E, P], dref: [P, n], out: [E, n] (must not alias c or dref).
extern "C" int hz_ew_diagonal(int dtype, const void* c, const void* dref, void* out, long long E,
                              int P, int n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long N = E * n;
  if (N > 0) {
    if (dtype == 0)
      diagonal_kernel<float><<<blocks(N), THREADS, 0, st>>>(p<float>(c), p<float>(dref),
                                                            p<float>(out), E, P, n);
    else
      diagonal_kernel<double><<<blocks(N), THREADS, 0, st>>>(p<double>(c), p<double>(dref),
                                                             p<double>(out), E, P, n);
  }
  return static_cast<int>(cudaGetLastError());
}
