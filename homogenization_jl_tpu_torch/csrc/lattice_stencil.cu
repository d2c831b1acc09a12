// K6: the level-0 operator as a lattice stencil on a full-box base.
//
// Replaces homogenization_jl_tpu/ops/stencil.py::lattice_weights (:126),
// ::lattice_apply (:148), ::lattice_assemble (:162) and
// ::lattice_distribute (:181), which the JAX package builds from shifted
// slice-adds (scatter-adds into [n+1]^d grids) that XLA lowers on the TPU.
//
// On a lexicographic (n+1)^d node lattice the assembled base P1 operator is
//   y[a] = sum_k W[k, a] * u[a + delta_k]      (K = 15 in 3D, 7 in 2D),
// with W built from the per-element coefficients: every (type t, local i,
// local j) entry adds sum_p coeff[e(t, q), p] * stack0[p, i, j] to
// W[k(t,i,j), q + corner[t][i]] for every cube q.
//
// Bound on the H100: at the main path's 33^3 lattice every array is under
// 5 MB (W is 15 x 35,937), so all four entries live in L2 and a call costs
// about one launch; the coarse PCG loop around them is launch bound.
//
// Design: gather form, one thread per output, no atomics. Where the JAX
// form scatter-adds a slab per entry, each output here walks the same
// entries in the same order and adds the ones that land on it, so every
// run gives the same bits (lattice_assemble gives the plain form's bits:
// the same additions in the same order). The small static tables (lattice
// corners of each simplex type's local nodes, the K offsets, the entry
// list) travel by value as a __grid_constant__ kernel parameter: constant
// memory, read by every thread of a warp at one address (a broadcast).
//
// Element order: type-major (e = t * n^d + q) or cube-major (e = q * ept +
// t); q is the lattice-lexicographic cube index (x slowest).

#include <cuda_runtime.h>

#include <cstring>

namespace {

struct LatticeTab {
  int dim, n, ept, type_major, K, ne;
  int corner[6][4][3];  // corner[t][i] in {0,1}^dim (padded to 3 axes)
  int delta[27][3];     // delta_k in {-1,0,1}^dim
  int ent[96][4];       // (t, i, j, k) in the order of the JAX entry list
};
static_assert(sizeof(LatticeTab) == 543 * sizeof(int), "table layout");

constexpr int kThreads = 256;

__device__ __forceinline__ void node_coords(long long a, int dim, int n1,
                                            int c[3]) {
  c[0] = c[1] = c[2] = 0;
  for (int k = dim - 1; k >= 0; --k) {
    c[k] = (int)(a % n1);
    a /= n1;
  }
}

__device__ __forceinline__ long long cubes(const LatticeTab& tb) {
  long long nd = 1;
  for (int k = 0; k < tb.dim; ++k) nd *= tb.n;
  return nd;
}

// element index of simplex type t in cube q (q inside the box)
__device__ __forceinline__ long long elem_of(const LatticeTab& tb, int t,
                                             const int q[3]) {
  long long cube = 0;
  for (int k = 0; k < tb.dim; ++k) cube = cube * tb.n + q[k];
  return tb.type_major ? (long long)t * cubes(tb) + cube
                       : cube * tb.ept + t;
}

// W[k, a]: thread per (k, a)
template <typename T>
__global__ void weights_kernel(const T* __restrict__ coeff,
                               const T* __restrict__ stack0,
                               T* __restrict__ W, int P, long long N,
                               const __grid_constant__ LatticeTab tb) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)tb.K * N) return;
  const int k = (int)(idx / N);
  const long long a = idx - (long long)k * N;
  int c[3];
  node_coords(a, tb.dim, tb.n + 1, c);
  const int d1 = tb.dim + 1;
  T acc = T(0);
  for (int e = 0; e < tb.ne; ++e) {
    if (tb.ent[e][3] != k) continue;
    const int t = tb.ent[e][0], i = tb.ent[e][1], j = tb.ent[e][2];
    int q[3] = {0, 0, 0};
    bool ok = true;
    for (int ax = 0; ax < tb.dim; ++ax) {
      q[ax] = c[ax] - tb.corner[t][i][ax];
      ok = ok && q[ax] >= 0 && q[ax] < tb.n;
    }
    if (!ok) continue;
    const T* ce = coeff + elem_of(tb, t, q) * P;
    T s = T(0);
    for (int p = 0; p < P; ++p) s += ce[p] * stack0[(p * d1 + i) * d1 + j];
    acc += s;
  }
  W[idx] = acc;
}

// y[a] = m[a] * sum_k W[k, a] u[a + delta_k]; out = y or b - y
template <typename T>
__global__ void apply_kernel(const T* __restrict__ u, const T* __restrict__ W,
                             const unsigned char* __restrict__ m,
                             const T* __restrict__ b, T* __restrict__ out,
                             long long N, const __grid_constant__ LatticeTab tb) {
  const long long a = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (a >= N) return;
  const int n1 = tb.n + 1;
  int c[3];
  node_coords(a, tb.dim, n1, c);
  long long stride[3] = {0, 0, 0};
  long long s = 1;
  for (int ax = tb.dim - 1; ax >= 0; --ax) {
    stride[ax] = s;
    s *= n1;
  }
  T acc = T(0);
  for (int k = 0; k < tb.K; ++k) {
    bool ok = true;
    long long off = 0;
    for (int ax = 0; ax < tb.dim; ++ax) {
      const int dl = tb.delta[k][ax];
      const int v = c[ax] + dl;
      ok = ok && v >= 0 && v < n1;
      off += dl * stride[ax];
    }
    if (ok) acc += W[(long long)k * N + a] * u[a + off];
  }
  if (m != nullptr) acc = acc * T(m[a]);
  out[a] = (b != nullptr) ? b[a] - acc : acc;
}

// out[a] = sum over (t, i), in that order, of y[e(t, a - corner[t][i]), i]
template <typename T>
__global__ void assemble_kernel(const T* __restrict__ y, T* __restrict__ out,
                                long long N,
                                const __grid_constant__ LatticeTab tb) {
  const long long a = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (a >= N) return;
  int c[3];
  node_coords(a, tb.dim, tb.n + 1, c);
  const int d1 = tb.dim + 1;
  T acc = T(0);
  for (int t = 0; t < tb.ept; ++t) {
    for (int i = 0; i < d1; ++i) {
      int q[3] = {0, 0, 0};
      bool ok = true;
      for (int ax = 0; ax < tb.dim; ++ax) {
        q[ax] = c[ax] - tb.corner[t][i][ax];
        ok = ok && q[ax] >= 0 && q[ax] < tb.n;
      }
      if (ok) acc += y[elem_of(tb, t, q) * d1 + i];
    }
  }
  out[a] = acc;
}

// out[e, i] = u[q(e) + corner[t(e)][i]]: thread per (e, i)
template <typename T>
__global__ void distribute_kernel(const T* __restrict__ u, T* __restrict__ out,
                                  long long total,
                                  const __grid_constant__ LatticeTab tb) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int d1 = tb.dim + 1;
  const long long e = idx / d1;
  const int i = (int)(idx - e * d1);
  const long long nd = cubes(tb);
  int t;
  long long cube;
  if (tb.type_major) {
    t = (int)(e / nd);
    cube = e - (long long)t * nd;
  } else {
    t = (int)(e % tb.ept);
    cube = e / tb.ept;
  }
  int q[3] = {0, 0, 0};
  for (int k = tb.dim - 1; k >= 0; --k) {
    q[k] = (int)(cube % tb.n);
    cube /= tb.n;
  }
  long long node = 0;
  for (int ax = 0; ax < tb.dim; ++ax)
    node = node * (tb.n + 1) + q[ax] + tb.corner[t][i][ax];
  out[idx] = u[node];
}

LatticeTab unpack(const int* tab) {
  LatticeTab tb;
  std::memcpy(&tb, tab, sizeof(tb));
  return tb;
}

long long lattice_nodes(const LatticeTab& tb) {
  long long N = 1;
  for (int k = 0; k < tb.dim; ++k) N *= tb.n + 1;
  return N;
}

long long elements(const LatticeTab& tb) {
  long long E = tb.ept;
  for (int k = 0; k < tb.dim; ++k) E *= tb.n;
  return E;
}

unsigned blocks(long long total) {
  return (unsigned)((total + kThreads - 1) / kThreads);
}

}  // namespace

// dtype: 0 = float32, 1 = float64. tab: the host int32 table built by
// ops/stencil.py::kernel_table. Each returns cudaGetLastError().
extern "C" int hz_lattice_weights(int dtype, const void* coeff,
                                  const void* stack0, void* W, int P,
                                  const int* tab, void* stream) {
  const LatticeTab tb = unpack(tab);
  const long long N = lattice_nodes(tb);
  const long long total = (long long)tb.K * N;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (total > 0) {
    if (dtype == 0)
      weights_kernel<float><<<blocks(total), kThreads, 0, s>>>(
          static_cast<const float*>(coeff), static_cast<const float*>(stack0),
          static_cast<float*>(W), P, N, tb);
    else
      weights_kernel<double><<<blocks(total), kThreads, 0, s>>>(
          static_cast<const double*>(coeff),
          static_cast<const double*>(stack0), static_cast<double*>(W), P, N,
          tb);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hz_lattice_apply(int dtype, const void* u, const void* W,
                                const void* m, const void* b, void* out,
                                const int* tab, void* stream) {
  const LatticeTab tb = unpack(tab);
  const long long N = lattice_nodes(tb);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned char* mm = static_cast<const unsigned char*>(m);
  if (N > 0) {
    if (dtype == 0)
      apply_kernel<float><<<blocks(N), kThreads, 0, s>>>(
          static_cast<const float*>(u), static_cast<const float*>(W), mm,
          static_cast<const float*>(b), static_cast<float*>(out), N, tb);
    else
      apply_kernel<double><<<blocks(N), kThreads, 0, s>>>(
          static_cast<const double*>(u), static_cast<const double*>(W), mm,
          static_cast<const double*>(b), static_cast<double*>(out), N, tb);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hz_lattice_assemble(int dtype, const void* y, void* out,
                                   const int* tab, void* stream) {
  const LatticeTab tb = unpack(tab);
  const long long N = lattice_nodes(tb);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N > 0) {
    if (dtype == 0)
      assemble_kernel<float><<<blocks(N), kThreads, 0, s>>>(
          static_cast<const float*>(y), static_cast<float*>(out), N, tb);
    else
      assemble_kernel<double><<<blocks(N), kThreads, 0, s>>>(
          static_cast<const double*>(y), static_cast<double*>(out), N, tb);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hz_lattice_distribute(int dtype, const void* u, void* out,
                                     const int* tab, void* stream) {
  const LatticeTab tb = unpack(tab);
  const long long total = elements(tb) * (tb.dim + 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (total > 0) {
    if (dtype == 0)
      distribute_kernel<float><<<blocks(total), kThreads, 0, s>>>(
          static_cast<const float*>(u), static_cast<float*>(out), total, tb);
    else
      distribute_kernel<double><<<blocks(total), kThreads, 0, s>>>(
          static_cast<const double*>(u), static_cast<double*>(out), total,
          tb);
  }
  return static_cast<int>(cudaGetLastError());
}
