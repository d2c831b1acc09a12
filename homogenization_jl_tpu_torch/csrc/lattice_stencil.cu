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
// about one launch; the coarse PCG loop around them is launch bound, and
// the host's part of a call (ops/stencil.py) is what the loop waits on.
//
// Design: gather form, one thread per output, no atomics. Where the JAX
// form scatter-adds a slab per entry, each output here walks the same
// entries in the same order and adds the ones that land on it, so every
// run gives the same bits (lattice_assemble gives the plain form's bits:
// the same additions in the same order). The small static tables (lattice
// corners of each simplex type's local nodes, the K offsets, the entry
// list) travel by value as a __grid_constant__ kernel parameter: constant
// memory, read by every thread of a warp at one address (a broadcast). The
// host packs the table once per stencil (ops/stencil.py::kernel_table).
//
// apply, the entry the coarse loop calls most: 32-bit node indices (the
// wrapper holds K * N < 2^31), coordinates from one 32-bit div/mod chain,
// and a small table of its own (the K offsets, flat and per axis). An
// interior node walks its K neighbours at their flat offsets with no
// bounds test; a boundary node tests each neighbour's coordinates. Both
// issue their 2K loads before the adds when K is the 3D split's 15 or the
// 2D split's 7: nearly every warp of 32 nodes holds a boundary node of a
// row of n + 1, so most warps run both walks. Both add
// W[k, a] * u[a + delta_k] in k order from zero with the round-to-nearest
// intrinsics (no multiply fused into an add), then the mask and b - y
// likewise: lattice_apply_plain's operations in its order, so the bits of
// the plain form.
//
// Element order: type-major (e = t * n^d + q) or cube-major (e = q * ept +
// t); q is the lattice-lexicographic cube index (x slowest).
//
// Plane window (the slab form of homogenization_jl_tpu/parallel/slab.py:
// 149-229): weights, assemble and distribute take the element rows of the
// planes of cubes [x0, x0 + planes) only (q and n^d above then count the
// window's cubes). Weights and assemble write the whole lattice: the
// window's partial, zero where no window cube lands, which the ranks'
// partials then sum to the whole (parallel/group.py); distribute reads the
// window's nodes. x0 = 0, planes = n is the whole box.

#include <cuda_runtime.h>

#include <cstring>

namespace {

struct LatticeTab {
  int dim, n, ept, type_major, K, ne;
  int corner[6][4][3];  // corner[t][i] in {0,1}^dim (padded to 3 axes)
  int delta[27][3];     // delta_k in {-1,0,1}^dim
  int ent[96][4];       // (t, i, j, k) in the order of the JAX entry list
  int off[27];          // flat lattice offset of delta_k
};
static_assert(sizeof(LatticeTab) == 570 * sizeof(int), "table layout");

// what apply reads: dim, n + 1, K, N, and the K offsets
struct ApplyTab {
  int dim, n1, K, N;
  int off[27];
  int delta[27][3];
};

constexpr int kThreads = 256;
// apply: 128 threads a block, so that the 33^3 lattice spreads over every SM
constexpr int kApplyThreads = 128;

__device__ __forceinline__ void node_coords(long long a, int dim, int n1,
                                            int c[3]) {
  c[0] = c[1] = c[2] = 0;
  for (int k = dim - 1; k >= 0; --k) {
    c[k] = (int)(a % n1);
    a /= n1;
  }
}

// cubes of the window's planes
__device__ __forceinline__ long long cubes(const LatticeTab& tb, int planes) {
  long long nd = planes;
  for (int k = 1; k < tb.dim; ++k) nd *= tb.n;
  return nd;
}

// element row of simplex type t in cube q, q[0] counted from the window's
// first plane (q inside the window)
__device__ __forceinline__ long long elem_of(const LatticeTab& tb, int t,
                                             const int q[3], int planes) {
  long long cube = 0;
  for (int k = 0; k < tb.dim; ++k) cube = cube * tb.n + q[k];
  return tb.type_major ? (long long)t * cubes(tb, planes) + cube
                       : cube * tb.ept + t;
}

// cube q[] of the window (q[0] local) whose corner offset from lattice node
// c is corner[t][i]; false when it lies outside the window
__device__ __forceinline__ bool window_cube(const LatticeTab& tb, const int c[3],
                                            int t, int i, int x0, int planes,
                                            int q[3]) {
  bool ok = true;
  for (int ax = 0; ax < tb.dim; ++ax) {
    q[ax] = c[ax] - tb.corner[t][i][ax] - (ax == 0 ? x0 : 0);
    ok = ok && q[ax] >= 0 && q[ax] < (ax == 0 ? planes : tb.n);
  }
  return ok;
}

// W[k, a]: thread per (k, a)
template <typename T>
__global__ void weights_kernel(const T* __restrict__ coeff,
                               const T* __restrict__ stack0,
                               T* __restrict__ W, int P, long long N,
                               int x0, int planes,
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
    if (!window_cube(tb, c, t, i, x0, planes, q)) continue;
    const T* ce = coeff + elem_of(tb, t, q, planes) * P;
    T s = T(0);
    for (int p = 0; p < P; ++p) s += ce[p] * stack0[(p * d1 + i) * d1 + j];
    acc += s;
  }
  W[idx] = acc;
}

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }

// a node's sum over its K neighbours, every load issued before the adds,
// which run in k order from zero. Interior nodes (GUARD false) read every
// neighbour at its flat offset; boundary nodes test each neighbour's
// coordinates and skip the ones off the lattice.
template <typename T, int K, bool GUARD>
__device__ __forceinline__ T walk(const T* __restrict__ u, const T* __restrict__ W, int a,
                                  const int (&c)[3], const ApplyTab& tb) {
  T w[K], x[K];
  bool ok[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    ok[k] = true;
    if (GUARD) {
      for (int ax = 0; ax < tb.dim; ++ax) {
        const int v = c[ax] + tb.delta[k][ax];
        ok[k] = ok[k] && v >= 0 && v < tb.n1;
      }
    }
    w[k] = ok[k] ? W[k * tb.N + a] : T(0);
    x[k] = ok[k] ? u[a + tb.off[k]] : T(0);
  }
  T acc = T(0);
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (ok[k]) acc = add_rn(acc, mul_rn(w[k], x[k]));
  return acc;
}

// the same for any K, one neighbour at a time
template <typename T>
__device__ __forceinline__ T walk_any(const T* __restrict__ u, const T* __restrict__ W, int a,
                                      const int (&c)[3], bool interior, const ApplyTab& tb) {
  T acc = T(0);
  for (int k = 0; k < tb.K; ++k) {
    bool ok = true;
    for (int ax = 0; !interior && ax < tb.dim; ++ax) {
      const int v = c[ax] + tb.delta[k][ax];
      ok = ok && v >= 0 && v < tb.n1;
    }
    if (ok) acc = add_rn(acc, mul_rn(W[k * tb.N + a], u[a + tb.off[k]]));
  }
  return acc;
}

// y[a] = m[a] * sum_k W[k, a] u[a + delta_k]; out = y or b - y
template <typename T>
__global__ void __launch_bounds__(kApplyThreads)
apply_kernel(const T* __restrict__ u, const T* __restrict__ W,
             const unsigned char* __restrict__ m, const T* __restrict__ b,
             T* __restrict__ out, const __grid_constant__ ApplyTab tb) {
  const int a = blockIdx.x * kApplyThreads + threadIdx.x;
  if (a >= tb.N) return;
  const int n1 = tb.n1;
  int c[3] = {0, 0, 0};
  int r = a;
  for (int ax = tb.dim - 1; ax > 0; --ax) {
    const int q = r / n1;
    c[ax] = r - q * n1;
    r = q;
  }
  c[0] = r;
  bool interior = true;
  for (int ax = 0; ax < tb.dim; ++ax) interior = interior && c[ax] > 0 && c[ax] < n1 - 1;
  T acc;
  if (tb.K == 15)  // the 3D split's 15-point stencil
    acc = interior ? walk<T, 15, false>(u, W, a, c, tb) : walk<T, 15, true>(u, W, a, c, tb);
  else if (tb.K == 7)  // the 2D split's 7-point stencil
    acc = interior ? walk<T, 7, false>(u, W, a, c, tb) : walk<T, 7, true>(u, W, a, c, tb);
  else
    acc = walk_any(u, W, a, c, interior, tb);
  if (m != nullptr) acc = mul_rn(acc, T(m[a]));
  out[a] = (b != nullptr) ? sub_rn(b[a], acc) : acc;
}

// out[a] = sum over (t, i), in that order, of y[e(t, a - corner[t][i]), i]
template <typename T>
__global__ void assemble_kernel(const T* __restrict__ y, T* __restrict__ out,
                                long long N, int x0, int planes,
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
      if (window_cube(tb, c, t, i, x0, planes, q))
        acc += y[elem_of(tb, t, q, planes) * d1 + i];
    }
  }
  out[a] = acc;
}

// out[e, i] = u[q(e) + corner[t(e)][i]]: thread per (e, i)
template <typename T>
__global__ void distribute_kernel(const T* __restrict__ u, T* __restrict__ out,
                                  long long total, int x0, int planes,
                                  const __grid_constant__ LatticeTab tb) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int d1 = tb.dim + 1;
  const long long e = idx / d1;
  const int i = (int)(idx - e * d1);
  const long long nd = cubes(tb, planes);
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
  q[0] += x0;
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

long long elements(const LatticeTab& tb, int planes) {
  long long E = (long long)tb.ept * planes;
  for (int k = 1; k < tb.dim; ++k) E *= tb.n;
  return E;
}

unsigned blocks(long long total) {
  return (unsigned)((total + kThreads - 1) / kThreads);
}

}  // namespace

// dtype: 0 = float32, 1 = float64. tab: the host int32 table packed once
// per stencil by ops/stencil.py::kernel_table. x0, planes: the plane window (0 and n for
// the whole box). Each returns cudaGetLastError().
extern "C" int hz_lattice_weights(int dtype, const void* coeff,
                                  const void* stack0, void* W, int P, int x0,
                                  int planes, const int* tab, void* stream) {
  const LatticeTab tb = unpack(tab);
  const long long N = lattice_nodes(tb);
  const long long total = (long long)tb.K * N;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (total > 0) {
    if (dtype == 0)
      weights_kernel<float><<<blocks(total), kThreads, 0, s>>>(
          static_cast<const float*>(coeff), static_cast<const float*>(stack0),
          static_cast<float*>(W), P, N, x0, planes, tb);
    else
      weights_kernel<double><<<blocks(total), kThreads, 0, s>>>(
          static_cast<const double*>(coeff),
          static_cast<const double*>(stack0), static_cast<double*>(W), P, N,
          x0, planes, tb);
  }
  return static_cast<int>(cudaGetLastError());
}

// apply: cudaErrorInvalidValue when K * N does not fit 32 bits (the
// wrapper refuses such a lattice first).
extern "C" int hz_lattice_apply(int dtype, const void* u, const void* W,
                                const void* m, const void* b, void* out,
                                const int* tab, void* stream) {
  const LatticeTab* full = reinterpret_cast<const LatticeTab*>(tab);
  const long long N = lattice_nodes(*full);
  if (N * full->K >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  ApplyTab tb;
  tb.dim = full->dim;
  tb.n1 = full->n + 1;
  tb.K = full->K;
  tb.N = static_cast<int>(N);
  std::memcpy(tb.off, full->off, sizeof(tb.off));
  std::memcpy(tb.delta, full->delta, sizeof(tb.delta));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned char* mm = static_cast<const unsigned char*>(m);
  if (N > 0) {
    if (dtype == 0)
      apply_kernel<float><<<static_cast<unsigned>((N + kApplyThreads - 1) / kApplyThreads), kApplyThreads, 0, s>>>(
          static_cast<const float*>(u), static_cast<const float*>(W), mm,
          static_cast<const float*>(b), static_cast<float*>(out), tb);
    else
      apply_kernel<double><<<static_cast<unsigned>((N + kApplyThreads - 1) / kApplyThreads), kApplyThreads, 0, s>>>(
          static_cast<const double*>(u), static_cast<const double*>(W), mm,
          static_cast<const double*>(b), static_cast<double*>(out), tb);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hz_lattice_assemble(int dtype, const void* y, void* out,
                                   int x0, int planes, const int* tab,
                                   void* stream) {
  const LatticeTab tb = unpack(tab);
  const long long N = lattice_nodes(tb);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N > 0) {
    if (dtype == 0)
      assemble_kernel<float><<<blocks(N), kThreads, 0, s>>>(
          static_cast<const float*>(y), static_cast<float*>(out), N, x0,
          planes, tb);
    else
      assemble_kernel<double><<<blocks(N), kThreads, 0, s>>>(
          static_cast<const double*>(y), static_cast<double*>(out), N, x0,
          planes, tb);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hz_lattice_distribute(int dtype, const void* u, void* out,
                                     int x0, int planes, const int* tab,
                                     void* stream) {
  const LatticeTab tb = unpack(tab);
  const long long total = elements(tb, planes) * (tb.dim + 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (total > 0) {
    if (dtype == 0)
      distribute_kernel<float><<<blocks(total), kThreads, 0, s>>>(
          static_cast<const float*>(u), static_cast<float*>(out), total, x0,
          planes, tb);
    else
      distribute_kernel<double><<<blocks(total), kThreads, 0, s>>>(
          static_cast<const double*>(u), static_cast<double*>(out), total,
          x0, planes, tb);
  }
  return static_cast<int>(cudaGetLastError());
}
