// K13: the per-shift update of multishift CG, one pass over [n_shifts, N].
//
// Replaces the body of homogenization_jl_tpu/solver/cg.py::multishift_cg
// (:118-136) after the Lanczos step: the per-shift scalar recurrence of the
// root-free LDL' factorization of the shifted tridiagonal matrix, and the
// state updates that XLA fuses into one pass over the shift-batched arrays
// on the TPU:
//
//   D_curr = k == 0 ? t_curr + s : (t_curr + s) - t_prev^2 / D_prev'
//   y      = k == 0 ? y / D_curr : y * (-t_prev / D_curr)
//   W[s]   = k == 0 ? v          : v - W[s] * (t_prev / D_prev')
//   xs[s]  = xs[s] + W[s] * y[s]
//
// with D_prev' = (D_prev == 0 ? 1 : D_prev), t_curr and t_prev the Lanczos
// scalars (0-d device tensors: nothing reaches the host) and v the current
// Lanczos vector.
//
// Bound on the H100: bytes. At BASELINE config 4's state (N = 48,000 x 969
// float64 values, 3 shifts) a step reads v once and W, xs per shift and
// writes W, xs per shift: (1 + 4 * 3) * 0.372 GB = 4.84 GB, 1.44 ms at
// 3.35 TB/s.
//
// Design, two launches: one block of n_shifts threads computes D_curr, y
// and the W coefficient t_prev / D_prev' into fresh buffers (the wrapper
// allocates them per step, so no block reads a D or y that another
// writes); then one thread per entry reads
// v once and updates every shift's W and xs in place. Every product, sum
// and quotient is rounded on its own (the _rn intrinsics: nothing is
// contracted into an FMA), so the kernel gives the bits of its plain form
// (ops/multishift.py). At k == 0 W and xs are not read: W = v and
// xs = 0 + W y, the JAX form's broadcast start and zero xs.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_SHIFTS = 32;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }

template <typename T>
__global__ void ms_scalars_kernel(const T* __restrict__ shifts, const T* __restrict__ t_curr,
                                  const T* __restrict__ t_prev, const T* __restrict__ D_prev,
                                  const T* __restrict__ y_prev, T* __restrict__ D_curr,
                                  T* __restrict__ y_curr, T* __restrict__ coef, int ns,
                                  int first) {
  const int s = threadIdx.x;
  if (s >= ns) return;
  const T tc = *t_curr;
  const T tp = *t_prev;
  const T dp = D_prev[s];
  const T dps = dp == T(0) ? T(1) : dp;
  const T base = add_rn(tc, shifts[s]);
  const T D = first ? base : sub_rn(base, div_rn(mul_rn(tp, tp), dps));
  D_curr[s] = D;
  y_curr[s] = first ? div_rn(y_prev[s], D) : mul_rn(y_prev[s], div_rn(-tp, D));
  coef[s] = div_rn(tp, dps);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ms_update_kernel(const T* __restrict__ v, T* __restrict__ W, T* __restrict__ xs,
                 const T* __restrict__ coef, const T* __restrict__ y, int ns, long long N,
                 int first) {
  __shared__ T sc[MAX_SHIFTS];
  __shared__ T sy[MAX_SHIFTS];
  if (threadIdx.x < ns) {
    sc[threadIdx.x] = coef[threadIdx.x];
    sy[threadIdx.x] = y[threadIdx.x];
  }
  __syncthreads();
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= N) return;
  const T vi = v[i];
  for (int s = 0; s < ns; ++s) {
    const long long o = (long long)s * N + i;
    const T w = first ? vi : sub_rn(vi, mul_rn(W[o], sc[s]));
    W[o] = w;
    xs[o] = add_rn(first ? T(0) : xs[o], mul_rn(w, sy[s]));
  }
}

template <typename T>
void launch_step(const void* v, void* W, void* xs, const void* shifts, const void* t_curr,
                 const void* t_prev, const void* D_prev, const void* y_prev, void* D_curr,
                 void* y_curr, void* coef, int ns, long long N, int first, cudaStream_t st) {
  ms_scalars_kernel<T><<<1, MAX_SHIFTS, 0, st>>>(
      static_cast<const T*>(shifts), static_cast<const T*>(t_curr),
      static_cast<const T*>(t_prev), static_cast<const T*>(D_prev),
      static_cast<const T*>(y_prev), static_cast<T*>(D_curr), static_cast<T*>(y_curr),
      static_cast<T*>(coef), ns, first);
  if (N > 0)
    ms_update_kernel<T><<<static_cast<unsigned>((N + THREADS - 1) / THREADS), THREADS, 0, st>>>(
        static_cast<const T*>(v), static_cast<T*>(W), static_cast<T*>(xs),
        static_cast<const T*>(coef), static_cast<const T*>(y_curr), ns, N, first);
}

}  // namespace

// dtype: 0 = float32, 1 = float64. v: [N]; W, xs: [ns, N], updated in place
// (not read when first != 0); shifts, D_prev, y_prev, D_curr, y_curr, coef:
// [ns]; t_curr, t_prev: one value each; all on the device. D_curr / y_curr
// must not alias D_prev / y_prev. 1 <= ns <= 32. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for ns out of range.
extern "C" int hz_multishift_step(int dtype, const void* v, void* W, void* xs,
                                  const void* shifts, const void* t_curr, const void* t_prev,
                                  const void* D_prev, const void* y_prev, void* D_curr,
                                  void* y_curr, void* coef, int ns, long long N, int first,
                                  void* stream) {
  if (ns < 1 || ns > MAX_SHIFTS) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch_step<float>(v, W, xs, shifts, t_curr, t_prev, D_prev, y_prev, D_curr, y_curr, coef,
                       ns, N, first, st);
  else
    launch_step<double>(v, W, xs, shifts, t_curr, t_prev, D_prev, y_prev, D_curr, y_curr, coef,
                        ns, N, first, st);
  return static_cast<int>(cudaGetLastError());
}
