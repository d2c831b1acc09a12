// K5: the solver's dots, with the first-copy mask and a diagonal scale
// fused, summed in a fixed order.
//
// Replaces the jnp.vdot calls of homogenization_jl_tpu/solver/multigrid.py
// that XLA lowers on the TPU: _vdot (:510), _pcg_rnorm (:1177),
// residual_norm (:1484), the first-copy dots of _smooth_cg_exact (:821,
// :838) and the Lanczos ddot (:600). Each is
//
//   out = sum_i a_i * (s_i * b_i) * [m_i]
//
// with the bool mask m and the scale s optional; the JAX forms write the
// masked and scaled temporaries (a * w, d * b) to device memory first.
//
// Bound on the H100: bytes. At the finest level (E * n = 190.5M f32 values)
// one operand is 0.76 GB, 0.227 ms at 3.35 TB/s; a mask adds 0.19 GB.
//
// Design, two launches and no atomics, so two launches give the same bits
// (the solver's stopping tests and the CG smoothers' alpha and beta read
// these scalars):
//   1. RED_BLOCKS blocks; block b sums the contiguous chunk [b * chunk,
//      (b + 1) * chunk) with chunk = ceil(N / RED_BLOCKS): thread t keeps a
//      running sum of entries t, t + RED_THREADS, ... (coalesced; UNROLL
//      loads in flight, added in index order), then the block adds its
//      threads in a fixed tree.
//   2. One block adds the RED_BLOCKS block sums the same way.
// Products and sums use the round-to-nearest intrinsics, so no multiply is
// fused into an add: the plain form (ops/dots.py) takes the same steps and
// gives the same bits.
//
// K16's dot (hz_masked_dot_half): the operand a stored narrower than the
// state (the half-width direction p of _smooth_cg_exact's vdot(load(p),
// A p), :838), widened exactly as it is loaded: the bits of the state-type
// dot on a cast up.

#include <cuda_runtime.h>

#include "widen.cuh"

namespace {

constexpr int RED_BLOCKS = 264;  // fixed grid, so the order is fixed too
constexpr int RED_THREADS = 256;
constexpr int UNROLL = 8;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

template <typename T, typename TA, bool MASK, bool SCALE>
__device__ __forceinline__ T term(const TA* __restrict__ a, const T* __restrict__ b,
                                  const bool* __restrict__ m, const T* __restrict__ s,
                                  long long i) {
  T bi = b[i];
  if (SCALE) bi = mul_rn(s[i], bi);
  const T v = mul_rn(T(hz::widen(a[i])), bi);
  if (MASK) return m[i] ? v : T(0);
  return v;
}

// fixed-order tree over the block's RED_THREADS values in sh[]; the sum
// ends in sh[0]
template <typename T>
__device__ __forceinline__ void block_tree(T* sh) {
  for (int st = RED_THREADS / 2; st > 0; st >>= 1) {
    __syncthreads();
    if (threadIdx.x < st) sh[threadIdx.x] = add_rn(sh[threadIdx.x], sh[threadIdx.x + st]);
  }
  __syncthreads();
}

template <typename T, typename TA, bool MASK, bool SCALE>
__global__ void __launch_bounds__(RED_THREADS)
dot_blocks_kernel(const TA* __restrict__ a, const T* __restrict__ b,
                  const bool* __restrict__ m, const T* __restrict__ s, long long N,
                  T* __restrict__ blocksum) {
  __shared__ T sh[RED_THREADS];
  const long long chunk = (N + RED_BLOCKS - 1) / RED_BLOCKS;
  const long long lo = blockIdx.x * chunk;
  const long long hi = lo + chunk < N ? lo + chunk : N;
  T acc = T(0);
  long long i = lo + threadIdx.x;
  for (; i + (UNROLL - 1) * RED_THREADS < hi; i += UNROLL * RED_THREADS) {
    T v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) v[u] = term<T, TA, MASK, SCALE>(a, b, m, s, i + u * RED_THREADS);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) acc = add_rn(acc, v[u]);
  }
  for (; i < hi; i += RED_THREADS) acc = add_rn(acc, term<T, TA, MASK, SCALE>(a, b, m, s, i));
  sh[threadIdx.x] = acc;
  block_tree(sh);
  if (threadIdx.x == 0) blocksum[blockIdx.x] = sh[0];
}

template <typename T>
__global__ void __launch_bounds__(RED_THREADS)
dot_final_kernel(const T* __restrict__ blocksum, T* __restrict__ out) {
  __shared__ T sh[RED_THREADS];
  T acc = T(0);
  for (int j = threadIdx.x; j < RED_BLOCKS; j += RED_THREADS) acc = add_rn(acc, blocksum[j]);
  sh[threadIdx.x] = acc;
  block_tree(sh);
  if (threadIdx.x == 0) out[0] = sh[0];
}

template <typename T, typename TA = T>
void launch_dot(const void* a, const void* b, const void* m, const void* s,
                void* blocksum, void* out, long long N, cudaStream_t stream) {
  const TA* aa = static_cast<const TA*>(a);
  const T* bb = static_cast<const T*>(b);
  const bool* mm = static_cast<const bool*>(m);
  const T* ss = static_cast<const T*>(s);
  T* bs = static_cast<T*>(blocksum);
  if (m && s)
    dot_blocks_kernel<T, TA, true, true><<<RED_BLOCKS, RED_THREADS, 0, stream>>>(aa, bb, mm, ss, N, bs);
  else if (m)
    dot_blocks_kernel<T, TA, true, false><<<RED_BLOCKS, RED_THREADS, 0, stream>>>(aa, bb, mm, ss, N, bs);
  else if (s)
    dot_blocks_kernel<T, TA, false, true><<<RED_BLOCKS, RED_THREADS, 0, stream>>>(aa, bb, mm, ss, N, bs);
  else
    dot_blocks_kernel<T, TA, false, false><<<RED_BLOCKS, RED_THREADS, 0, stream>>>(aa, bb, mm, ss, N, bs);
  dot_final_kernel<T><<<1, RED_THREADS, 0, stream>>>(bs, static_cast<T*>(out));
}

}  // namespace

// dtype: 0 = float32, 1 = float64. a, b: N values; mask: N bools or NULL;
// scale: N values or NULL; blocksum: RED_BLOCKS values of scratch; out: one
// value. Returns cudaGetLastError().
extern "C" int hz_masked_dot(int dtype, const void* a, const void* b, const void* mask,
                             const void* scale, void* blocksum, void* out, long long N,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch_dot<float>(a, b, mask, scale, blocksum, out, N, st);
  else
    launch_dot<double>(a, b, mask, scale, blocksum, out, N, st);
  return static_cast<int>(cudaGetLastError());
}

// dtype: 0 = float32, 1 = float64 (b, scale, blocksum, out); atype: the
// stored type of a, 0 = float32 (under float64 only), 2 = bfloat16,
// 3 = float16. Otherwise as hz_masked_dot. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a pair it does not take.
extern "C" int hz_masked_dot_half(int dtype, int atype, const void* a, const void* b,
                                  const void* mask, const void* scale, void* blocksum,
                                  void* out, long long N, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == hz::F32 && atype == hz::BF16)
    launch_dot<float, __nv_bfloat16>(a, b, mask, scale, blocksum, out, N, st);
  else if (dtype == hz::F32 && atype == hz::F16)
    launch_dot<float, __half>(a, b, mask, scale, blocksum, out, N, st);
  else if (dtype == hz::F64 && atype == hz::F32)
    launch_dot<double, float>(a, b, mask, scale, blocksum, out, N, st);
  else if (dtype == hz::F64 && atype == hz::BF16)
    launch_dot<double, __nv_bfloat16>(a, b, mask, scale, blocksum, out, N, st);
  else if (dtype == hz::F64 && atype == hz::F16)
    launch_dot<double, __half>(a, b, mask, scale, blocksum, out, N, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
