// K10: the updates of the CG smoothers, with alpha and beta read from the
// device.
//
// Replaces the update expressions of homogenization_jl_tpu/solver/
// multigrid.py::_smooth_cg (:779-784) and ::_smooth_cg_exact (:833-840),
// which XLA fuses into elementwise passes on the TPU:
//
//   cg_step:       alpha = safe_div(num, den);  x += alpha p;  r -= alpha Ap
//   cg_direction:  beta = safe_div(num, den);   out = rc + beta p
//
// and the same cg_step for V-cycle-preconditioned CG (solver/multigrid.py::
// pcg, :1210-1222): x += alpha p, and r - alpha Ap into r or, for the
// flexible beta that reads the old residual once more, into a new buffer
// ``r_out`` with r kept;
// with safe_div(num, den) = den == 0 ? 0 : num / den (the JAX _safe_div:
// once a smoother has converged exactly, the next step is a no-op). num and
// den are 0-d device tensors, the outputs of kernel K5: no host read of
// alpha or beta, so a smoothing step queues without a synchronisation.
//
// Bound on the H100: bytes. At the finest level (E * n = 190.5M f32 values)
// cg_step reads x, r, p, Ap and writes x, r: 6 x 0.76 GB, 1.36 ms at
// 3.35 TB/s; cg_direction moves 3 x 0.76 GB, 0.68 ms. Design: one thread per
// entry, in place (out may be rc or p), and every product and sum rounded on
// its own (the _rn intrinsics: nothing is fused into an FMA), so the kernel
// gives the bits of the plain form's x + alpha * p. With ``x_zero`` x is not
// read and receives 0 + alpha p: the first step of a smooth from a zero
// iterate, whose buffer is then never zeroed (the JAX form's zeros_like,
// which XLA folds into this first use).
//
// K16's forms (hz_cg_step_half, hz_cg_direction_half): the direction p
// stored narrower than the state (``direction_dtype`` of _smooth_cg_exact,
// :822-841: p = store(rc + beta load(p)), x += alpha load(p)). cg_step
// widens p exactly as it loads it; cg_direction computes rc + beta p in the
// state type and rounds it to the storage type at the store (to nearest
// even, a float64 through float32 as PyTorch's ``.to()``), or with no p
// stores rc itself, the first direction store(rc). Their plain forms
// (ops/cg.py) are the state-type forms on p cast up, then the cast down:
// the same bits.

#include <cuda_runtime.h>

#include "widen.cuh"

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

template <typename T>
__device__ __forceinline__ T safe_div(const T* num, const T* den) {
  const T d = *den;
  return d == T(0) ? T(0) : div_rn(*num, d);
}

// r_out receives r - alpha Ap (r itself when r_out is r: in place)
template <typename T, typename TP = T>
__global__ void __launch_bounds__(THREADS)
cg_step_kernel(T* __restrict__ x, const T* r, const TP* __restrict__ p,
               const T* __restrict__ Ap, const T* __restrict__ num,
               const T* __restrict__ den, T* r_out, int x_zero, long long N) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= N) return;
  const T alpha = safe_div(num, den);
  x[i] = add_rn(x_zero ? T(0) : x[i], mul_rn(alpha, T(hz::widen(p[i]))));
  if (r != nullptr) r_out[i] = sub_rn(r[i], mul_rn(alpha, Ap[i]));
}

// out may alias rc or p (each entry is read before it is written); with a
// storage type TP narrower than T, out and p are TP and p may be NULL (out
// = rc, rounded)
template <typename T, typename TP = T>
__global__ void __launch_bounds__(THREADS)
cg_direction_kernel(TP* out, const T* rc, const TP* p, const T* __restrict__ num,
                    const T* __restrict__ den, long long N) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= N) return;
  if (p == nullptr) {
    out[i] = hz::narrow<TP>(rc[i]);
    return;
  }
  const T beta = safe_div(num, den);
  out[i] = hz::narrow<TP>(add_rn(rc[i], mul_rn(beta, T(hz::widen(p[i])))));
}

template <typename T, typename TP>
void launch_step_half(void* x, void* r, const void* p, const void* Ap, const void* num,
                      const void* den, void* r_out, int x_zero, long long N,
                      cudaStream_t st) {
  const unsigned blocks = static_cast<unsigned>((N + THREADS - 1) / THREADS);
  cg_step_kernel<T, TP><<<blocks, THREADS, 0, st>>>(
      static_cast<T*>(x), static_cast<const T*>(r), static_cast<const TP*>(p),
      static_cast<const T*>(Ap), static_cast<const T*>(num), static_cast<const T*>(den),
      static_cast<T*>(r_out), x_zero, N);
}

template <typename T, typename TP>
void launch_direction_half(void* out, const void* rc, const void* p, const void* num,
                           const void* den, long long N, cudaStream_t st) {
  const unsigned blocks = static_cast<unsigned>((N + THREADS - 1) / THREADS);
  cg_direction_kernel<T, TP><<<blocks, THREADS, 0, st>>>(
      static_cast<TP*>(out), static_cast<const T*>(rc), static_cast<const TP*>(p),
      static_cast<const T*>(num), static_cast<const T*>(den), N);
}

}  // namespace

// dtype: 0 = float32, 1 = float64. x, p, Ap: N values; r: N values or NULL
// (then only x is updated); num, den: one value each; r_out: N values or
// NULL (then r is updated in place); x_zero: x is taken as zero, not read.
// Returns cudaGetLastError().
extern "C" int hz_cg_step(int dtype, void* x, void* r, const void* p, const void* Ap,
                          const void* num, const void* den, void* r_out, int x_zero,
                          long long N, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>((N + THREADS - 1) / THREADS);
  if (r_out == nullptr) r_out = r;
  if (N > 0) {
    if (dtype == 0)
      cg_step_kernel<float><<<blocks, THREADS, 0, st>>>(
          static_cast<float*>(x), static_cast<const float*>(r), static_cast<const float*>(p),
          static_cast<const float*>(Ap), static_cast<const float*>(num),
          static_cast<const float*>(den), static_cast<float*>(r_out), x_zero, N);
    else
      cg_step_kernel<double><<<blocks, THREADS, 0, st>>>(
          static_cast<double*>(x), static_cast<const double*>(r), static_cast<const double*>(p),
          static_cast<const double*>(Ap), static_cast<const double*>(num),
          static_cast<const double*>(den), static_cast<double*>(r_out), x_zero, N);
  }
  return static_cast<int>(cudaGetLastError());
}

// out, rc, p: N values (out may be rc or p); num, den: one value each.
extern "C" int hz_cg_direction(int dtype, void* out, const void* rc, const void* p,
                               const void* num, const void* den, long long N, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>((N + THREADS - 1) / THREADS);
  if (N > 0) {
    if (dtype == 0)
      cg_direction_kernel<float><<<blocks, THREADS, 0, st>>>(
          static_cast<float*>(out), static_cast<const float*>(rc),
          static_cast<const float*>(p), static_cast<const float*>(num),
          static_cast<const float*>(den), N);
    else
      cg_direction_kernel<double><<<blocks, THREADS, 0, st>>>(
          static_cast<double*>(out), static_cast<const double*>(rc),
          static_cast<const double*>(p), static_cast<const double*>(num),
          static_cast<const double*>(den), N);
  }
  return static_cast<int>(cudaGetLastError());
}

// K16: as hz_cg_step with p stored in ptype (0 = float32 under float64,
// 2 = bfloat16, 3 = float16); dtype is the state's (x, r, Ap, num, den,
// r_out). Returns cudaGetLastError(), or cudaErrorInvalidValue for a pair it
// does not take.
extern "C" int hz_cg_step_half(int dtype, int ptype, void* x, void* r, const void* p,
                               const void* Ap, const void* num, const void* den, void* r_out,
                               int x_zero, long long N, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (r_out == nullptr) r_out = r;
  if (N <= 0) return static_cast<int>(cudaGetLastError());
  if (dtype == hz::F32 && ptype == hz::BF16)
    launch_step_half<float, __nv_bfloat16>(x, r, p, Ap, num, den, r_out, x_zero, N, st);
  else if (dtype == hz::F32 && ptype == hz::F16)
    launch_step_half<float, __half>(x, r, p, Ap, num, den, r_out, x_zero, N, st);
  else if (dtype == hz::F64 && ptype == hz::F32)
    launch_step_half<double, float>(x, r, p, Ap, num, den, r_out, x_zero, N, st);
  else if (dtype == hz::F64 && ptype == hz::BF16)
    launch_step_half<double, __nv_bfloat16>(x, r, p, Ap, num, den, r_out, x_zero, N, st);
  else if (dtype == hz::F64 && ptype == hz::F16)
    launch_step_half<double, __half>(x, r, p, Ap, num, den, r_out, x_zero, N, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// K16: out (ptype) = rc + beta p (p: ptype, may alias out, or NULL: out =
// rc), rounded at the store; dtype is the state's (rc, num, den).
extern "C" int hz_cg_direction_half(int dtype, int ptype, void* out, const void* rc,
                                    const void* p, const void* num, const void* den,
                                    long long N, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N <= 0) return static_cast<int>(cudaGetLastError());
  if (dtype == hz::F32 && ptype == hz::BF16)
    launch_direction_half<float, __nv_bfloat16>(out, rc, p, num, den, N, st);
  else if (dtype == hz::F32 && ptype == hz::F16)
    launch_direction_half<float, __half>(out, rc, p, num, den, N, st);
  else if (dtype == hz::F64 && ptype == hz::F32)
    launch_direction_half<double, float>(out, rc, p, num, den, N, st);
  else if (dtype == hz::F64 && ptype == hz::BF16)
    launch_direction_half<double, __nv_bfloat16>(out, rc, p, num, den, N, st);
  else if (dtype == hz::F64 && ptype == hz::F16)
    launch_direction_half<double, __half>(out, rc, p, num, den, N, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
