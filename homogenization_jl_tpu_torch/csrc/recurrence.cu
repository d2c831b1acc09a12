// K14: the device work of the multishift recurrence's driver, parts (a)
// and (c); part (b), the M-inner product, is a mode of K9 (integrals.cu).
//
// Replaces the elementwise and basis passes of homogenization_jl_tpu/models/
// multishift.py::homogenization_multishift that XLA lowers on the TPU:
//
// (a) jacobi_cg_step: one Jacobi-preconditioned CG step of the mass solves
//     (multishift.py:173-178 through solver/cg.py:67-87, precond = d * r):
//
//       alpha = safe_div(num, den);  x += alpha p;  r -= alpha Ap;
//       z = d * r;  rz = sum_i [w_i] r_i z_i;  rs = sum_i [w_i] r_i r_i
//
//     with the first-copy mask w, so each DOF counts once. The two sums are
//     taken in the port's fixed order (fixed_sum.cuh), K5's, so they are
//     the bits of K5's dot(r, z, w) and dot(r, r, w) on the updated r and z,
//     and two runs give the same bits. The direction p = z + beta p that follows is K10's
//     cg_direction. As K10's cg_step, it takes ``r_out`` (r_out = r - alpha
//     Ap, r kept) and ``x_zero`` (x = 0 + alpha p, x unread): the first step
//     of a solve from zero then reads b as r, and x, r need no zero pass.
// (c) basis_combine: out[k] = sum_j Y[k, j] V[j] for K + 1 coefficient rows
//     in one read of the Lanczos basis V [m, N] (the one-pass mode's einsum,
//     multishift.py:245); basis_accumulate: sums[k] += Y[k, j] v_j for all k
//     in one pass over v_j (the two-pass mode, :257-260). Both add the terms
//     in basis order from the first product, so the two modes give the same
//     bits on the same basis.
//
// Bound on the H100: bytes. (a) at BASELINE config 4's state (N = 48,000 x
// 969 = 46.5M float64 values) reads x, p, r, Ap, d and the bool mask and
// writes x, r, z: 65 B per entry, 3.02 GB, 0.90 ms at 3.35 TB/s. (c) with m
// = 120 reads 44.6 GB of basis, 13.3 ms.
//
// Design: (a) runs on K5's grid and order (fixed_sum.cuh: SUM_BLOCKS
// blocks sweeping the state tile by tile, a thread's vector of 16 bytes in
// each of its block's tiles, 16-byte loads and stores when every operand
// is aligned, entry by entry in the same order when not); the elementwise updates ride along, so r and z are
// read for the dots while still in registers, and the last block to finish
// adds the block sums: one launch. (c) one thread per entry, up to MAXK running sums in
// registers, V read with neighbouring threads on neighbouring addresses;
// the wrapper splits more rows into launches of MAXK. Every product and sum
// is rounded on its own (the _rn intrinsics), so each entry gives the bits
// of the plain forms (ops/recurrence.py).

#include <cuda_runtime.h>

#include "fixed_sum.cuh"

namespace {

using hz::add_rn;
using hz::div_rn;
using hz::mul_rn;
using hz::sub_rn;

constexpr int THREADS = 256;
constexpr int MAXK = 8;

template <typename T, bool VEC>
__global__ void __launch_bounds__(hz::SUM_THREADS)
jacobi_cg_kernel(T* __restrict__ x, const T* r, T* r_out, const T* __restrict__ p,
                 const T* __restrict__ Ap, const T* __restrict__ d, const bool* __restrict__ w,
                 const T* __restrict__ num, const T* __restrict__ den, T* __restrict__ z,
                 int x_zero, long long N, unsigned char* scratch, T* __restrict__ rz,
                 T* __restrict__ rs) {
  constexpr int V = hz::sum_vec<T>();
  const T dd = *den;
  const T alpha = dd == T(0) ? T(0) : div_rn(*num, dd);
  T acc[2] = {T(0), T(0)};  // rz, rs
  // the entry's update; its two dot terms
  auto entry = [&](T xj, T rj0, T pj, T Apj, T dj, bool mj, T& xo, T& ro, T& zo, T& trz,
                   T& trs) {
    xo = add_rn(x_zero ? T(0) : xj, mul_rn(alpha, pj));
    ro = sub_rn(rj0, mul_rn(alpha, Apj));
    zo = mul_rn(dj, ro);
    trz = mj ? mul_rn(ro, zo) : T(0);
    trs = mj ? mul_rn(ro, ro) : T(0);
  };
  for (long long i = hz::sum_first<T>(); i < N; i += hz::sum_stride<T>()) {
    if (VEC && i + V <= N) {
      T xv[V], rv[V], pv[V], av[V], dv[V], xo[V], ro[V], zo[V], trz[V], trs[V];
      bool mv[V];
      if (!x_zero) hz::load_vec<V>(x + i, xv);
      hz::load_vec<V>(r + i, rv);
      hz::load_vec<V>(p + i, pv);
      hz::load_vec<V>(Ap + i, av);
      hz::load_vec<V>(d + i, dv);
      if (w != nullptr) hz::load_vec<V>(w + i, mv);
#pragma unroll
      for (int l = 0; l < V; ++l)
        entry(x_zero ? T(0) : xv[l], rv[l], pv[l], av[l], dv[l], w == nullptr || mv[l], xo[l],
              ro[l], zo[l], trz[l], trs[l]);
      hz::store_vec<V>(x + i, xo);
      hz::store_vec<V>(r_out + i, ro);
      hz::store_vec<V>(z + i, zo);
#pragma unroll
      for (int l = 0; l < V; ++l) {
        acc[0] = add_rn(acc[0], trz[l]);
        acc[1] = add_rn(acc[1], trs[l]);
      }
    } else {
#pragma unroll
      for (int l = 0; l < V; ++l) {
        const long long j = i + l;
        if (j >= N) break;
        T xo, ro, zo, trz, trs;
        entry(x_zero ? T(0) : x[j], r[j], p[j], Ap[j], d[j], w == nullptr || w[j], xo, ro, zo,
              trz, trs);
        x[j] = xo;
        r_out[j] = ro;
        z[j] = zo;
        acc[0] = add_rn(acc[0], trz);
        acc[1] = add_rn(acc[1], trs);
      }
    }
  }
  hz::sum_finish<T, 2>(acc, scratch, [&](const T (&v)[2]) {
    rz[0] = v[0];
    rs[0] = v[1];
  });
}

// out[k, i] = sum_j Y[k * ldy + j] V[j, i], k < K (<= MAXK), j < m
template <typename T>
__global__ void __launch_bounds__(THREADS)
basis_combine_kernel(const T* __restrict__ V, const T* __restrict__ Y, int ldy,
                     T* __restrict__ out, int m, int K, long long N) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= N) return;
  T acc[MAXK];
  const T v0 = V[i];
#pragma unroll
  for (int k = 0; k < MAXK; ++k)
    if (k < K) acc[k] = mul_rn(Y[(long long)k * ldy], v0);
  for (int j = 1; j < m; ++j) {
    const T vj = V[(long long)j * N + i];
#pragma unroll
    for (int k = 0; k < MAXK; ++k)
      if (k < K) acc[k] = add_rn(acc[k], mul_rn(Y[(long long)k * ldy + j], vj));
  }
#pragma unroll
  for (int k = 0; k < MAXK; ++k)
    if (k < K) out[(long long)k * N + i] = acc[k];
}

// sums[k, i] = c[k * ldc] v[i] (first) or sums[k, i] + c[k * ldc] v[i], k < K
template <typename T>
__global__ void __launch_bounds__(THREADS)
basis_accumulate_kernel(const T* __restrict__ v, const T* __restrict__ c, int ldc,
                        T* __restrict__ sums, int K, long long N, int first) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= N) return;
  const T vi = v[i];
  for (int k = 0; k < K; ++k) {
    const long long o = (long long)k * N + i;
    const T t = mul_rn(c[(long long)k * ldc], vi);
    sums[o] = first ? t : add_rn(sums[o], t);
  }
}

unsigned blocks(long long N) { return static_cast<unsigned>((N + THREADS - 1) / THREADS); }

template <typename T>
T* p(void* q) { return static_cast<T*>(q); }
template <typename T>
const T* p(const void* q) { return static_cast<const T*>(q); }

template <typename T>
void launch_jacobi(void* x, const void* r, void* r_out, const void* pp, const void* Ap,
                   const void* d, const void* w, const void* num, const void* den, void* z,
                   void* scratch, void* rz, void* rs, int x_zero, long long N, cudaStream_t st) {
  constexpr int V = hz::sum_vec<T>();
  const bool vec = hz::aligned16(x) && hz::aligned16(r) && hz::aligned16(r_out) &&
                   hz::aligned16(pp) && hz::aligned16(Ap) && hz::aligned16(d) &&
                   hz::aligned16(z) &&
                   (w == nullptr || reinterpret_cast<unsigned long long>(w) % V == 0);
  unsigned char* sc = static_cast<unsigned char*>(scratch);
  if (vec)
    jacobi_cg_kernel<T, true><<<hz::SUM_BLOCKS, hz::SUM_THREADS, 0, st>>>(
        p<T>(x), p<T>(r), p<T>(r_out), p<T>(pp), p<T>(Ap), p<T>(d), p<bool>(w), p<T>(num),
        p<T>(den), p<T>(z), x_zero, N, sc, p<T>(rz), p<T>(rs));
  else
    jacobi_cg_kernel<T, false><<<hz::SUM_BLOCKS, hz::SUM_THREADS, 0, st>>>(
        p<T>(x), p<T>(r), p<T>(r_out), p<T>(pp), p<T>(Ap), p<T>(d), p<bool>(w), p<T>(num),
        p<T>(den), p<T>(z), x_zero, N, sc, p<T>(rz), p<T>(rs));
}

}  // namespace

// dtype: 0 = float32, 1 = float64. x, r, p, Ap, d, z: [N] (x updated in
// place, or written unread when x_zero != 0; z written; none may alias
// another); r_out: [N], receives r - alpha Ap (r itself or NULL: in place;
// else it aliases none of the others); w: bool [N] or NULL (every entry
// counts); num, den: one value each; scratch: the current stream's
// fixed-sum scratch (fixed_sum.cuh); rz, rs: one value each. Returns cudaGetLastError().
extern "C" int hz_jacobi_cg_step(int dtype, void* x, void* r, const void* pp, const void* Ap,
                                 const void* d, const void* w, const void* num,
                                 const void* den, void* z, void* scratch, void* rz, void* rs,
                                 void* r_out, int x_zero, long long N, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  void* ro = r_out == nullptr ? r : r_out;
  if (dtype == 0)
    launch_jacobi<float>(x, r, ro, pp, Ap, d, w, num, den, z, scratch, rz, rs, x_zero, N, st);
  else
    launch_jacobi<double>(x, r, ro, pp, Ap, d, w, num, den, z, scratch, rz, rs, x_zero, N, st);
  return static_cast<int>(cudaGetLastError());
}

// V: [m, N]; Y: K rows of stride ldy (m coefficients each, on the device);
// out: [K, N], must not alias V. 1 <= K <= MAXK, m >= 1.
extern "C" int hz_basis_combine(int dtype, const void* V, const void* Y, int ldy, void* out,
                                int m, int K, long long N, void* stream) {
  if (K < 1 || K > MAXK || m < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N > 0) {
    if (dtype == 0)
      basis_combine_kernel<float><<<blocks(N), THREADS, 0, st>>>(p<float>(V), p<float>(Y), ldy,
                                                                 p<float>(out), m, K, N);
    else
      basis_combine_kernel<double><<<blocks(N), THREADS, 0, st>>>(p<double>(V), p<double>(Y),
                                                                  ldy, p<double>(out), m, K, N);
  }
  return static_cast<int>(cudaGetLastError());
}

// v: [N]; c: K coefficients of stride ldc (on the device); sums: [K, N],
// updated in place (written without a read when first != 0). K >= 1.
extern "C" int hz_basis_accumulate(int dtype, const void* v, const void* c, int ldc, void* sums,
                                   int K, long long N, int first, void* stream) {
  if (K < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N > 0) {
    if (dtype == 0)
      basis_accumulate_kernel<float><<<blocks(N), THREADS, 0, st>>>(
          p<float>(v), p<float>(c), ldc, p<float>(sums), K, N, first);
    else
      basis_accumulate_kernel<double><<<blocks(N), THREADS, 0, st>>>(
          p<double>(v), p<double>(c), ldc, p<double>(sums), K, N, first);
  }
  return static_cast<int>(cudaGetLastError());
}
