// K5: the solver's dots, with the first-copy mask and a diagonal scale
// fused, summed in the port's fixed order (fixed_sum.cuh).
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
// Design: one launch of SUM_BLOCKS blocks in the fixed order of
// fixed_sum.cuh (the last block adds the block sums), so two launches give
// the same bits, which the solver's stopping tests and the CG smoothers'
// alpha and beta rely on. A thread reads its vectors with 16-byte loads of
// a, b and s (8 or 4 bytes for a narrower a, 4 or 2 bytes of mask), UNROLL
// vectors in flight, and adds their entries in index order. The blocks
// sweep the operands together, tile by tile (a grid-stride order): one
// contiguous chunk per block, 2,112 streams of HBM pages at once, ran
// slower than torch.dot at the main-path shape. When a base pointer is not
// aligned to its vector (a row-block view of a sharded state), the same
// kernel reads every entry alone, in the same order: the same bits.
// Products and sums use the round-to-nearest intrinsics, so no multiply is
// fused into an add: the plain form (ops/dots.py) takes the same steps and
// gives the same bits.
//
// K16's dot (hz_masked_dot_half): the operand a stored narrower than the
// state (the half-width direction p of _smooth_cg_exact's vdot(load(p),
// A p), :838), widened exactly as it is loaded: the bits of the state-type
// dot on a cast up.

#include <cuda_runtime.h>

#include "fixed_sum.cuh"
#include "widen.cuh"

namespace {

constexpr int UNROLL = 4;  // vectors in flight per thread and operand

// the V products of the vector at entry i (in range)
template <typename T, typename TA, bool MASK, bool SCALE, bool VEC>
__device__ __forceinline__ void vec_terms(const TA* __restrict__ a, const T* __restrict__ b,
                                          const bool* __restrict__ m, const T* __restrict__ s,
                                          long long i, T (&v)[hz::sum_vec<T>()]) {
  constexpr int V = hz::sum_vec<T>();
  TA av[V];
  T bv[V], sv[V];
  bool mv[V];
  if (VEC) {
    hz::load_vec<V>(a + i, av);
    hz::load_vec<V>(b + i, bv);
    if (SCALE) hz::load_vec<V>(s + i, sv);
    if (MASK) hz::load_vec<V>(m + i, mv);
  } else {
#pragma unroll
    for (int l = 0; l < V; ++l) {
      av[l] = a[i + l];
      bv[l] = b[i + l];
      if (SCALE) sv[l] = s[i + l];
      if (MASK) mv[l] = m[i + l];
    }
  }
#pragma unroll
  for (int l = 0; l < V; ++l) {
    const T bi = SCALE ? hz::mul_rn(sv[l], bv[l]) : bv[l];
    const T p = hz::mul_rn(T(hz::widen(av[l])), bi);
    v[l] = (!MASK || mv[l]) ? p : T(0);
  }
}

template <typename T, typename TA, bool MASK, bool SCALE, bool VEC>
__global__ void __launch_bounds__(hz::SUM_THREADS)
masked_dot_kernel(const TA* __restrict__ a, const T* __restrict__ b, const bool* __restrict__ m,
                  const T* __restrict__ s, long long N, unsigned char* scratch,
                  T* __restrict__ out) {
  constexpr int V = hz::sum_vec<T>();
  constexpr long long STEP = hz::sum_stride<T>();
  T acc[1] = {T(0)};
  long long i = hz::sum_first<T>();
  for (; i + (UNROLL - 1) * STEP + V <= N; i += UNROLL * STEP) {
    T v[UNROLL][V];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      vec_terms<T, TA, MASK, SCALE, VEC>(a, b, m, s, i + u * STEP, v[u]);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
#pragma unroll
      for (int l = 0; l < V; ++l) acc[0] = hz::add_rn(acc[0], v[u][l]);
  }
  for (; i < N; i += STEP) {
    T v[V];
    if (i + V <= N) {
      vec_terms<T, TA, MASK, SCALE, VEC>(a, b, m, s, i, v);
    } else {  // the last vector, cut at N
#pragma unroll
      for (int l = 0; l < V; ++l) {
        v[l] = T(0);
        if (i + l < N) {
          const T bi = SCALE ? hz::mul_rn(s[i + l], b[i + l]) : b[i + l];
          const T p = hz::mul_rn(T(hz::widen(a[i + l])), bi);
          v[l] = (!MASK || m[i + l]) ? p : T(0);
        }
      }
    }
#pragma unroll
    for (int l = 0; l < V; ++l) acc[0] = hz::add_rn(acc[0], v[l]);
  }
  hz::sum_finish<T, 1>(acc, scratch, [&](const T (&r)[1]) { out[0] = r[0]; });
}

template <typename T, typename TA, bool MASK, bool SCALE>
void launch_form(const TA* a, const T* b, const bool* m, const T* s, long long N,
                 unsigned char* scratch, T* out, cudaStream_t st) {
  constexpr int V = hz::sum_vec<T>();
  // every tile starts on a whole vector: the base pointers decide
  const bool vec = hz::aligned16(b) && (!SCALE || hz::aligned16(s)) &&
                   (reinterpret_cast<unsigned long long>(a) % (V * sizeof(TA))) == 0 &&
                   (!MASK || (reinterpret_cast<unsigned long long>(m) % V) == 0);
  if (vec)
    masked_dot_kernel<T, TA, MASK, SCALE, true>
        <<<hz::SUM_BLOCKS, hz::SUM_THREADS, 0, st>>>(a, b, m, s, N, scratch, out);
  else
    masked_dot_kernel<T, TA, MASK, SCALE, false>
        <<<hz::SUM_BLOCKS, hz::SUM_THREADS, 0, st>>>(a, b, m, s, N, scratch, out);
}

template <typename T, typename TA = T>
void launch_dot(const void* a, const void* b, const void* m, const void* s, void* scratch,
                void* out, long long N, cudaStream_t stream) {
  const TA* aa = static_cast<const TA*>(a);
  const T* bb = static_cast<const T*>(b);
  const bool* mm = static_cast<const bool*>(m);
  const T* ss = static_cast<const T*>(s);
  unsigned char* sc = static_cast<unsigned char*>(scratch);
  T* o = static_cast<T*>(out);
  if (m && s)
    launch_form<T, TA, true, true>(aa, bb, mm, ss, N, sc, o, stream);
  else if (m)
    launch_form<T, TA, true, false>(aa, bb, mm, ss, N, sc, o, stream);
  else if (s)
    launch_form<T, TA, false, true>(aa, bb, mm, ss, N, sc, o, stream);
  else
    launch_form<T, TA, false, false>(aa, bb, mm, ss, N, sc, o, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = float64. a, b: N values; mask: N bools or NULL;
// scale: N values or NULL; scratch: SUM_SCRATCH_BYTES of the current
// stream's fixed-sum scratch (fixed_sum.cuh); out: one value. Returns
// cudaGetLastError().
extern "C" int hz_masked_dot(int dtype, const void* a, const void* b, const void* mask,
                             const void* scale, void* scratch, void* out, long long N,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch_dot<float>(a, b, mask, scale, scratch, out, N, st);
  else
    launch_dot<double>(a, b, mask, scale, scratch, out, N, st);
  return static_cast<int>(cudaGetLastError());
}

// dtype: 0 = float32, 1 = float64 (b, scale, out); atype: the stored type
// of a, 0 = float32 (under float64 only), 2 = bfloat16, 3 = float16.
// Otherwise as hz_masked_dot. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a pair it does not take.
extern "C" int hz_masked_dot_half(int dtype, int atype, const void* a, const void* b,
                                  const void* mask, const void* scale, void* scratch,
                                  void* out, long long N, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == hz::F32 && atype == hz::BF16)
    launch_dot<float, __nv_bfloat16>(a, b, mask, scale, scratch, out, N, st);
  else if (dtype == hz::F32 && atype == hz::F16)
    launch_dot<float, __half>(a, b, mask, scale, scratch, out, N, st);
  else if (dtype == hz::F64 && atype == hz::F32)
    launch_dot<double, float>(a, b, mask, scale, scratch, out, N, st);
  else if (dtype == hz::F64 && atype == hz::BF16)
    launch_dot<double, __nv_bfloat16>(a, b, mask, scale, scratch, out, N, st);
  else if (dtype == hz::F64 && atype == hz::F16)
    launch_dot<double, __half>(a, b, mask, scale, scratch, out, N, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
