// K4: the grid transfers, prolongation and restriction, in gather form.
//
// Replaces homogenization_jl_tpu/ops/transfer.py::prolong_add (:18) and
// ::restrict (:23), dense einsums with the per-level prolongation P [n_f,
// n_c] that XLA lowers to matrix products on the TPU:
//
//   prolong_add:  out[e, f] = x_f[e, f] + sum_c P[f, c] x_c[e, c]
//   restrict:     out[e, c] = sum_f r[e, f] P[f, c]
//
// P is an identity prefix plus half/half midpoint rows: at most two nonzeros
// per fine row. The tables, built on the host from P (ops/transfer.py), list
// them: for prolong_add each fine row's (column, weight) pairs, column -1
// for an unused slot; for restrict P^T in CSR form, each coarse column's
// fine rows in ascending order.
//
// Bound on the H100: bytes. At the finest level (E = 196,608, n_f = 969,
// n_c = 165, f32) restrict reads 0.76 GB and writes 0.13 GB, 0.266 ms at
// 3.35 TB/s; prolong_add moves 1.65 GB, 0.494 ms. The dense product does
// 2 n_c (or 2 n_f) operations per output where the gather does at most 2
// (or the column's count).
//
// Design: a block takes G consecutive elements. Their input rows are one
// contiguous span, copied into shared memory with coalesced loads, so the
// table's gathers hit shared memory and not device memory; the block's
// outputs are one contiguous span too, written coalesced, one thread per
// output. Products and sums are rounded on their own (no FMA), and each
// output sums its terms in table order from the first term: with P's
// weights 1 and 1/2 every product is exact, so prolong_add gives the bits
// of the dense product.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// copy the block's g input rows (one contiguous span of g * n_in values)
template <typename T>
__device__ __forceinline__ void stage(T* sm, const T* __restrict__ src, int count) {
  for (int i = threadIdx.x; i < count; i += THREADS) sm[i] = src[i];
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
prolong_add_kernel(const T* xf, const T* __restrict__ xc, T* out,
                   const int* __restrict__ cols, const T* __restrict__ wts, int E, int nf,
                   int nc, int G) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const long long e0 = (long long)blockIdx.x * G;
  const int g = (int)(E - e0 < G ? E - e0 : G);
  stage(sm, xc + e0 * nc, g * nc);
  const long long base = e0 * nf;
  for (int o = threadIdx.x; o < g * nf; o += THREADS) {
    const int el = o / nf;
    const int f = o - el * nf;
    const T* row = sm + el * nc;
    const int c0 = cols[2 * f], c1 = cols[2 * f + 1];
    T s = T(0);
    if (c0 >= 0) s = mul_rn(wts[2 * f], row[c0]);
    if (c1 >= 0) s = add_rn(s, mul_rn(wts[2 * f + 1], row[c1]));
    // out may be xf itself: each entry is read before it is written
    out[base + o] = xf != nullptr ? add_rn(xf[base + o], s) : s;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
restrict_kernel(const T* __restrict__ r, T* __restrict__ out,
                const int* __restrict__ colptr, const int* __restrict__ rows,
                const T* __restrict__ wts, int E, int nf, int nc, int G) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const long long e0 = (long long)blockIdx.x * G;
  const int g = (int)(E - e0 < G ? E - e0 : G);
  stage(sm, r + e0 * nf, g * nf);
  const long long base = e0 * nc;
  for (int o = threadIdx.x; o < g * nc; o += THREADS) {
    const int el = o / nc;
    const int c = o - el * nc;
    const T* row = sm + el * nf;
    const int j0 = colptr[c], j1 = colptr[c + 1];
    T s = T(0);
    if (j0 < j1) s = mul_rn(wts[j0], row[rows[j0]]);
    for (int j = j0 + 1; j < j1; ++j) s = add_rn(s, mul_rn(wts[j], row[rows[j]]));
    out[base + o] = s;
  }
}

template <typename T>
int launch_prolong(const void* xf, const void* xc, void* out, const int* cols, const void* wts,
                   int E, int nf, int nc, int G, cudaStream_t st) {
  const unsigned blocks = static_cast<unsigned>((E + G - 1) / G);
  const size_t smem = sizeof(T) * (size_t)G * nc;
  prolong_add_kernel<T><<<blocks, THREADS, smem, st>>>(
      static_cast<const T*>(xf), static_cast<const T*>(xc), static_cast<T*>(out), cols,
      static_cast<const T*>(wts), E, nf, nc, G);
  return 0;
}

template <typename T>
int launch_restrict(const void* r, void* out, const int* colptr, const int* rows,
                    const void* wts, int E, int nf, int nc, int G, cudaStream_t st) {
  const unsigned blocks = static_cast<unsigned>((E + G - 1) / G);
  const size_t smem = sizeof(T) * (size_t)G * nf;
  restrict_kernel<T><<<blocks, THREADS, smem, st>>>(
      static_cast<const T*>(r), static_cast<T*>(out), colptr, rows, static_cast<const T*>(wts),
      E, nf, nc, G);
  return 0;
}

}  // namespace

// dtype: 0 = float32, 1 = float64. xf: [E, nf] or NULL (then out = x_c P^T);
// xc: [E, nc]; out: [E, nf], may be xf; cols: [nf, 2] int32; wts: [nf, 2];
// G elements per block (G * nc values of shared memory, at most 48 KB).
// Returns cudaGetLastError().
extern "C" int hz_prolong_add(int dtype, const void* xf, const void* xc, void* out,
                              const void* cols, const void* wts, int E, int nf, int nc, int G,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (E > 0) {
    const int* c = static_cast<const int*>(cols);
    if (dtype == 0)
      launch_prolong<float>(xf, xc, out, c, wts, E, nf, nc, G, st);
    else
      launch_prolong<double>(xf, xc, out, c, wts, E, nf, nc, G, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// r: [E, nf]; out: [E, nc]; colptr: [nc + 1] int32; rows, wts: [nnz] (rows
// int32, ascending within each column); G elements per block (G * nf values
// of shared memory, at most 48 KB). Returns cudaGetLastError().
extern "C" int hz_restrict(int dtype, const void* r, void* out, const void* colptr,
                           const void* rows, const void* wts, int E, int nf, int nc, int G,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (E > 0) {
    const int* cp = static_cast<const int*>(colptr);
    const int* rw = static_cast<const int*>(rows);
    if (dtype == 0)
      launch_restrict<float>(r, out, cp, rw, wts, E, nf, nc, G, st);
    else
      launch_restrict<double>(r, out, cp, rw, wts, E, nf, nc, G, st);
  }
  return static_cast<int>(cudaGetLastError());
}
