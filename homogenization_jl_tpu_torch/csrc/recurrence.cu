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
// writes x, r, z: 65 B per entry, 3.02 GB, 0.90 ms at 3.35 TB/s. (c)
// basis_combine with m = 120 and K + 1 = 3 reads 44.6 GB of basis and
// writes 1.1 GB, 13.66 ms; basis_accumulate reads v and the K sums and
// writes the K sums, (2K + 1) N entries, 56 B per entry at K = 3.
//
// Design: (a) runs on K5's grid and order (fixed_sum.cuh: SUM_BLOCKS
// blocks sweeping the state tile by tile, a thread's vector of 16 bytes in
// each of its block's tiles, 16-byte loads and stores when every operand
// is aligned, entry by entry in the same order when not); the elementwise updates ride along, so r and z are
// read for the dots while still in registers, and the last block to finish
// adds the block sums: one launch. (c) is a stream through the basis, so
// what bounds it is the bytes in flight: one 8-byte load per thread behind
// a chain of adds (the first design, 80% of the bound) keeps too few. Now
// each thread owns one vector of 16 bytes (2 float64 or 4 float32 entries)
// and issues the loads of UNROLL basis rows before their adds, so 128 bytes a
// thread are in flight; the K coefficient rows are staged once per block in
// shared memory, and a grid of a few blocks per SM walks the column tiles.
// When an operand or a basis row is not 16-byte aligned (N not a multiple
// of the vector, a view at an odd offset) the same kernel runs entry by
// entry. basis_accumulate takes the same vectors and issues the loads of
// all its running sums before the adds. Every product and sum is rounded
// on its own (the _rn intrinsics) and each sum starts from its first
// product and adds the rest in basis order, so each entry gives the bits of
// the plain forms (ops/recurrence.py) and the two modes agree bit for bit.

#include <cuda_runtime.h>

#include "fixed_sum.cuh"

namespace {

using hz::add_rn;
using hz::div_rn;
using hz::mul_rn;
using hz::sub_rn;

constexpr int THREADS = 256;
constexpr int MAXK = 8;
// shared memory one combine block may take for its coefficient rows
constexpr size_t COMBINE_SMEM_MAX = 227 * 1024;

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

// rows of V whose loads go out before their adds
constexpr int UNROLL = 8;
template <typename T, bool VEC>
__host__ __device__ constexpr int vec_of() {
  return VEC ? 16 / static_cast<int>(sizeof(T)) : 1;
}

template <typename T, int W>
__device__ __forceinline__ void load_w(const T* __restrict__ q, T (&v)[W]) {
  if constexpr (W == 1)
    v[0] = *q;
  else
    hz::load_vec<W>(q, v);
}

template <typename T, int W>
__device__ __forceinline__ void store_w(T* __restrict__ q, const T (&v)[W]) {
  if constexpr (W == 1)
    *q = v[0];
  else
    hz::store_vec<W>(q, v);
}

// out[k, i] = sum_j Y[k * ldy + j] V[j, i], k < K (<= MAXK), j < m: the
// block stages Y in shared memory ([K, m], dynamic), then walks the tiles
// blockIdx.x, blockIdx.x + gridDim.x, ... of THREADS vectors each
template <typename T, int K, bool VEC>
__global__ void __launch_bounds__(THREADS)
basis_combine_kernel(const T* __restrict__ V, const T* __restrict__ Y, int ldy,
                     T* __restrict__ out, int m, long long N) {
  constexpr int W = vec_of<T, VEC>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* ys = reinterpret_cast<T*>(smem);
  for (int s = threadIdx.x; s < K * m; s += THREADS) {
    const int k = s / m;
    ys[s] = Y[(long long)k * ldy + (s - k * m)];
  }
  __syncthreads();
  const long long tiles = (N + (long long)THREADS * W - 1) / ((long long)THREADS * W);
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long i = (tile * THREADS + threadIdx.x) * W;
    if (i >= N) continue;
    T acc[K][W];
    {
      T v0[W];
      load_w<T, W>(V + i, v0);
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int l = 0; l < W; ++l) acc[k][l] = mul_rn(ys[k * m], v0[l]);
    }
    int j = 1;
    for (; j + UNROLL <= m; j += UNROLL) {
      T vv[UNROLL][W];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) load_w<T, W>(V + (long long)(j + u) * N + i, vv[u]);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const T y = ys[k * m + j + u];
#pragma unroll
          for (int l = 0; l < W; ++l) acc[k][l] = add_rn(acc[k][l], mul_rn(y, vv[u][l]));
        }
    }
    for (; j < m; ++j) {
      T vj[W];
      load_w<T, W>(V + (long long)j * N + i, vj);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const T y = ys[k * m + j];
#pragma unroll
        for (int l = 0; l < W; ++l) acc[k][l] = add_rn(acc[k][l], mul_rn(y, vj[l]));
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) store_w<T, W>(out + (long long)k * N + i, acc[k]);
  }
}

// sums[k, i] = c[k * ldc] v[i] (first) or sums[k, i] + c[k * ldc] v[i],
// k < K, one vector i per thread; the loads of the running sums of a group
// of ACC_GROUP rows go out before their adds
constexpr int ACC_GROUP = 4;
template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
basis_accumulate_kernel(const T* __restrict__ v, const T* __restrict__ c, int ldc,
                        T* __restrict__ sums, int K, long long N, int first) {
  constexpr int W = vec_of<T, VEC>();
  const long long i = ((long long)blockIdx.x * THREADS + threadIdx.x) * W;
  if (i >= N) return;
  T vi[W];
  load_w<T, W>(v + i, vi);
  for (int k0 = 0; k0 < K; k0 += ACC_GROUP) {
    T s[ACC_GROUP][W];
#pragma unroll
    for (int g = 0; g < ACC_GROUP; ++g)
      if (!first && k0 + g < K) load_w<T, W>(sums + (long long)(k0 + g) * N + i, s[g]);
#pragma unroll
    for (int g = 0; g < ACC_GROUP; ++g) {
      if (k0 + g >= K) break;
      const T ck = c[(long long)(k0 + g) * ldc];
      T o[W];
#pragma unroll
      for (int l = 0; l < W; ++l) {
        const T t = mul_rn(ck, vi[l]);
        o[l] = first ? t : add_rn(s[g][l], t);
      }
      store_w<T, W>(sums + (long long)(k0 + g) * N + i, o);
    }
  }
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (count <= 0) count = 1;
  }
  return count;
}

// a grid of at most `per_sm` blocks per SM, never more than the work
unsigned grid_of(long long tiles, int per_sm) {
  const long long most = (long long)sm_count() * per_sm;
  return static_cast<unsigned>(tiles < most ? (tiles > 0 ? tiles : 1) : most);
}

template <typename T, int K, bool VEC>
int launch_combine_k(const void* V, const void* Y, int ldy, void* out, int m, long long N,
                     cudaStream_t st) {
  auto kern = basis_combine_kernel<T, K, VEC>;
  const size_t smem = sizeof(T) * K * (size_t)m;
  if (smem > COMBINE_SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS, smem);
  constexpr long long TILE = (long long)THREADS * vec_of<T, VEC>();
  kern<<<grid_of((N + TILE - 1) / TILE, per_sm > 0 ? per_sm : 1), THREADS, smem, st>>>(
      static_cast<const T*>(V), static_cast<const T*>(Y), ldy, static_cast<T*>(out), m, N);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool VEC>
int launch_combine_vec(const void* V, const void* Y, int ldy, void* out, int m, int K,
                       long long N, cudaStream_t st) {
  switch (K) {
    case 1: return launch_combine_k<T, 1, VEC>(V, Y, ldy, out, m, N, st);
    case 2: return launch_combine_k<T, 2, VEC>(V, Y, ldy, out, m, N, st);
    case 3: return launch_combine_k<T, 3, VEC>(V, Y, ldy, out, m, N, st);
    case 4: return launch_combine_k<T, 4, VEC>(V, Y, ldy, out, m, N, st);
    case 5: return launch_combine_k<T, 5, VEC>(V, Y, ldy, out, m, N, st);
    case 6: return launch_combine_k<T, 6, VEC>(V, Y, ldy, out, m, N, st);
    case 7: return launch_combine_k<T, 7, VEC>(V, Y, ldy, out, m, N, st);
    default: return launch_combine_k<T, 8, VEC>(V, Y, ldy, out, m, N, st);
  }
}

// every basis row and output row starts 16-byte aligned
bool rows_aligned(const void* a, const void* b, long long N, int es) {
  return hz::aligned16(a) && hz::aligned16(b) && (N * es) % 16 == 0;
}

template <typename T>
int launch_combine(const void* V, const void* Y, int ldy, void* out, int m, int K, long long N,
                   cudaStream_t st) {
  if (rows_aligned(V, out, N, sizeof(T)))
    return launch_combine_vec<T, true>(V, Y, ldy, out, m, K, N, st);
  return launch_combine_vec<T, false>(V, Y, ldy, out, m, K, N, st);
}

template <typename T>
void launch_accumulate(const void* v, const void* c, int ldc, void* sums, int K, long long N,
                       int first, cudaStream_t st) {
  const bool vec = rows_aligned(v, sums, N, sizeof(T));
  const long long W = vec ? 16 / sizeof(T) : 1;
  const unsigned grid = static_cast<unsigned>((N + THREADS * W - 1) / (THREADS * W));
  if (vec)
    basis_accumulate_kernel<T, true><<<grid, THREADS, 0, st>>>(
        static_cast<const T*>(v), static_cast<const T*>(c), ldc, static_cast<T*>(sums), K, N,
        first);
  else
    basis_accumulate_kernel<T, false><<<grid, THREADS, 0, st>>>(
        static_cast<const T*>(v), static_cast<const T*>(c), ldc, static_cast<T*>(sums), K, N,
        first);
}

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
// out: [K, N], must not alias V. 1 <= K <= MAXK, m >= 1, K m coefficients
// of at most COMBINE_SMEM_MAX bytes (ops/recurrence.py splits the rows).
extern "C" int hz_basis_combine(int dtype, const void* V, const void* Y, int ldy, void* out,
                                int m, int K, long long N, void* stream) {
  if (K < 1 || K > MAXK || m < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N > 0) {
    const int err = dtype == 0 ? launch_combine<float>(V, Y, ldy, out, m, K, N, st)
                               : launch_combine<double>(V, Y, ldy, out, m, K, N, st);
    if (err != 0) return err;
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
      launch_accumulate<float>(v, c, ldc, sums, K, N, first, st);
    else
      launch_accumulate<double>(v, c, ldc, sums, K, N, first, st);
  }
  return static_cast<int>(cudaGetLastError());
}
