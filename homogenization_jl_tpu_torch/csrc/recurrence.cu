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
//     taken in kernel K5's fixed order (csrc/dots.cu: RED_BLOCKS contiguous
//     chunks, RED_THREADS strided running sums in each, a fixed tree in each
//     block and one more over the block sums), so they are the bits of K5's
//     dot(r, z, w) and dot(r, r, w) on the updated r and z, and two runs give
//     the same bits. The direction p = z + beta p that follows is K10's
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
// Design: (a) runs on K5's grid (RED_BLOCKS blocks of RED_THREADS threads,
// each thread striding through its block's chunk), which fixes the order
// of the sums; the elementwise updates ride along, so r and z are read
// for the dots while still in registers. A second launch of one block adds
// the block sums. (c) one thread per entry, up to MAXK running sums in
// registers, V read with neighbouring threads on neighbouring addresses;
// the wrapper splits more rows into launches of MAXK. Every product and sum
// is rounded on its own (the _rn intrinsics), so each entry gives the bits
// of the plain forms (ops/recurrence.py).

#include <cuda_runtime.h>

namespace {

constexpr int RED_BLOCKS = 264;  // K5's grid (csrc/dots.cu)
constexpr int RED_THREADS = 256;
constexpr int UNROLL = 4;
constexpr int THREADS = 256;
constexpr int MAXK = 8;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }

// K5's block tree (csrc/dots.cu) over two arrays at once
template <typename T>
__device__ __forceinline__ void block_tree2(T* a, T* b) {
  for (int st = RED_THREADS / 2; st > 0; st >>= 1) {
    __syncthreads();
    if (threadIdx.x < st) {
      a[threadIdx.x] = add_rn(a[threadIdx.x], a[threadIdx.x + st]);
      b[threadIdx.x] = add_rn(b[threadIdx.x], b[threadIdx.x + st]);
    }
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(RED_THREADS)
jacobi_cg_blocks_kernel(T* __restrict__ x, const T* r, T* r_out, const T* __restrict__ p,
                        const T* __restrict__ Ap, const T* __restrict__ d,
                        const bool* __restrict__ w, const T* __restrict__ num,
                        const T* __restrict__ den, T* __restrict__ z, int x_zero, long long N,
                        T* __restrict__ blocksum) {
  __shared__ T sh_rz[RED_THREADS];
  __shared__ T sh_rs[RED_THREADS];
  const T dd = *den;
  const T alpha = dd == T(0) ? T(0) : div_rn(*num, dd);
  const long long chunk = (N + RED_BLOCKS - 1) / RED_BLOCKS;
  const long long lo = blockIdx.x * chunk;
  const long long hi = lo + chunk < N ? lo + chunk : N;
  T acc_rz = T(0), acc_rs = T(0);
  long long i = lo + threadIdx.x;
  auto entry = [&](long long j, T& trz, T& trs) {
    x[j] = add_rn(x_zero ? T(0) : x[j], mul_rn(alpha, p[j]));
    const T rj = sub_rn(r[j], mul_rn(alpha, Ap[j]));
    r_out[j] = rj;
    const T zj = mul_rn(d[j], rj);
    z[j] = zj;
    const bool m = w == nullptr || w[j];
    trz = m ? mul_rn(rj, zj) : T(0);
    trs = m ? mul_rn(rj, rj) : T(0);
  };
  for (; i + (UNROLL - 1) * RED_THREADS < hi; i += UNROLL * RED_THREADS) {
    T trz[UNROLL], trs[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) entry(i + u * RED_THREADS, trz[u], trs[u]);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      acc_rz = add_rn(acc_rz, trz[u]);
      acc_rs = add_rn(acc_rs, trs[u]);
    }
  }
  for (; i < hi; i += RED_THREADS) {
    T trz, trs;
    entry(i, trz, trs);
    acc_rz = add_rn(acc_rz, trz);
    acc_rs = add_rn(acc_rs, trs);
  }
  sh_rz[threadIdx.x] = acc_rz;
  sh_rs[threadIdx.x] = acc_rs;
  block_tree2(sh_rz, sh_rs);
  if (threadIdx.x == 0) {
    blocksum[blockIdx.x] = sh_rz[0];
    blocksum[RED_BLOCKS + blockIdx.x] = sh_rs[0];
  }
}

template <typename T>
__global__ void __launch_bounds__(RED_THREADS)
jacobi_cg_final_kernel(const T* __restrict__ blocksum, T* __restrict__ rz,
                       T* __restrict__ rs) {
  __shared__ T sh_rz[RED_THREADS];
  __shared__ T sh_rs[RED_THREADS];
  T a = T(0), b = T(0);
  for (int j = threadIdx.x; j < RED_BLOCKS; j += RED_THREADS) {
    a = add_rn(a, blocksum[j]);
    b = add_rn(b, blocksum[RED_BLOCKS + j]);
  }
  sh_rz[threadIdx.x] = a;
  sh_rs[threadIdx.x] = b;
  block_tree2(sh_rz, sh_rs);
  if (threadIdx.x == 0) {
    rz[0] = sh_rz[0];
    rs[0] = sh_rs[0];
  }
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
                   void* blocksum, void* rz, void* rs, int x_zero, long long N, cudaStream_t st) {
  jacobi_cg_blocks_kernel<T><<<RED_BLOCKS, RED_THREADS, 0, st>>>(
      p<T>(x), p<T>(r), p<T>(r_out), p<T>(pp), p<T>(Ap), p<T>(d), p<bool>(w), p<T>(num),
      p<T>(den), p<T>(z), x_zero, N, p<T>(blocksum));
  jacobi_cg_final_kernel<T><<<1, RED_THREADS, 0, st>>>(p<T>(blocksum), p<T>(rz), p<T>(rs));
}

}  // namespace

// dtype: 0 = float32, 1 = float64. x, r, p, Ap, d, z: [N] (x updated in
// place, or written unread when x_zero != 0; z written; none may alias
// another); r_out: [N], receives r - alpha Ap (r itself or NULL: in place;
// else it aliases none of the others); w: bool [N] or NULL (every entry
// counts); num, den: one value each; blocksum: [2 * RED_BLOCKS] scratch;
// rz, rs: one value each. Returns cudaGetLastError().
extern "C" int hz_jacobi_cg_step(int dtype, void* x, void* r, const void* pp, const void* Ap,
                                 const void* d, const void* w, const void* num,
                                 const void* den, void* z, void* blocksum, void* rz, void* rs,
                                 void* r_out, int x_zero, long long N, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  void* ro = r_out == nullptr ? r : r_out;
  if (dtype == 0)
    launch_jacobi<float>(x, r, ro, pp, Ap, d, w, num, den, z, blocksum, rz, rs, x_zero, N, st);
  else
    launch_jacobi<double>(x, r, ro, pp, Ap, d, w, num, den, z, blocksum, rz, rs, x_zero, N, st);
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
