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
// 3.05 GB, 0.91 ms at 3.35 TB/s; downcast and upcast move 12 bytes per
// entry, 2.29 GB, 0.68 ms.
//
// Design: one pair of entries per thread, a double2 (16 bytes) on the
// float64 side and a float2 on the float32 side, so every load and store
// of a warp covers one contiguous span. Four entries per thread (a float4
// beside two double2) leave each double2 instruction of a warp on every
// other 16 bytes, and its upcast ran slower than this, its downcasts no
// faster; two to eight pairs per thread, streaming cache hints and an L2
// prefetch hint did no better either (development runs on the H100, not
// recorded). An odd N's last entry runs scalar in the same launch. An
// operand whose address does not allow the vectors (a view at an odd
// offset) sends the whole call down the scalar path: one thread per
// entry. Rounding stays per entry: the cast rounds to nearest even
// (__double2float_rn, as PyTorch's ``.to()``) and the product is rounded
// on its own (__fmul_rn), so each entry gives the bits of its plain form
// (ops/mixed.py).

#include <cuda_runtime.h>

#include "fixed_sum.cuh"

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float down(double c, const float* s, long long i) {
  const float v = __double2float_rn(c);
  return s == nullptr ? v : __fmul_rn(v, s[i]);
}

// thread p takes the pair [2p, 2p + 2); (odd N) block 0's first thread
// also takes entry N - 1
__global__ void __launch_bounds__(THREADS)
downcast_vec_kernel(const double* __restrict__ c, const float* __restrict__ s,
                    float* __restrict__ out, long long N) {
  const long long p = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (p < (N >> 1)) {
    const double2 a = reinterpret_cast<const double2*>(c)[p];
    float2 o = make_float2(__double2float_rn(a.x), __double2float_rn(a.y));
    if (s != nullptr) {
      const float2 sv = reinterpret_cast<const float2*>(s)[p];
      o = make_float2(__fmul_rn(o.x, sv.x), __fmul_rn(o.y, sv.y));
    }
    reinterpret_cast<float2*>(out)[p] = o;
  }
  if (p == 0 && (N & 1)) out[N - 1] = down(c[N - 1], s, N - 1);
}

__global__ void __launch_bounds__(THREADS)
upcast_vec_kernel(const float* __restrict__ z, double* __restrict__ out, long long N) {
  const long long p = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (p < (N >> 1)) {
    const float2 v = reinterpret_cast<const float2*>(z)[p];
    reinterpret_cast<double2*>(out)[p] = make_double2(v.x, v.y);
  }
  if (p == 0 && (N & 1)) out[N - 1] = static_cast<double>(z[N - 1]);
}

// The scalar path (an operand the vectors cannot take): one thread per entry.
__global__ void __launch_bounds__(THREADS)
downcast_scalar_kernel(const double* __restrict__ c, const float* __restrict__ s,
                       float* __restrict__ out, long long N) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i < N) out[i] = down(c[i], s, i);
}

__global__ void __launch_bounds__(THREADS)
upcast_scalar_kernel(const float* __restrict__ z, double* __restrict__ out, long long N) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i < N) out[i] = static_cast<double>(z[i]);
}

// the vectors' alignment: 16 bytes for the float64 side, 8 for the float32
bool vectors_fit(const void* c64, const void* a32, const void* b32) {
  const auto u = [](const void* p) { return reinterpret_cast<unsigned long long>(p); };
  return hz::aligned16(c64) && u(a32) % 8 == 0 && u(b32) % 8 == 0;
}

unsigned scalar_blocks(long long N) { return static_cast<unsigned>((N + THREADS - 1) / THREADS); }

// at least one block, so that block 0 takes the last entry when N = 1
unsigned vector_blocks(long long N) {
  const long long b = ((N >> 1) + THREADS - 1) / THREADS;
  return static_cast<unsigned>(b > 0 ? b : 1);
}

}  // namespace

// c: N doubles; s: N floats or NULL (then out = float(c)); out: N floats.
// Returns cudaGetLastError().
extern "C" int hz_downcast_scale(const void* c, const void* s, void* out, long long N,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const double* cp = static_cast<const double*>(c);
  const float* sp = static_cast<const float*>(s);
  float* op = static_cast<float*>(out);
  if (N > 0) {
    if (vectors_fit(c, s, out))
      downcast_vec_kernel<<<vector_blocks(N), THREADS, 0, st>>>(cp, sp, op, N);
    else
      downcast_scalar_kernel<<<scalar_blocks(N), THREADS, 0, st>>>(cp, sp, op, N);
  }
  return static_cast<int>(cudaGetLastError());
}

// z: N floats; out: N doubles. Returns cudaGetLastError().
extern "C" int hz_upcast(const void* z, void* out, long long N, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* zp = static_cast<const float*>(z);
  double* op = static_cast<double*>(out);
  if (N > 0) {
    if (vectors_fit(out, z, z))
      upcast_vec_kernel<<<vector_blocks(N), THREADS, 0, st>>>(zp, op, N);
    else
      upcast_scalar_kernel<<<scalar_blocks(N), THREADS, 0, st>>>(zp, op, N);
  }
  return static_cast<int>(cudaGetLastError());
}
