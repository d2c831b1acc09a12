// K8: gather-form interface combine on a general (non-box) base mesh.
//
// Replaces homogenization_jl_tpu/ops/interfaces.py::combine_gather_rows
// (an owner-row gather, a masked M-way sum and a rebuild gather that XLA
// lowers on the TPU), the combine of the driver's reference-order
// ("ordered") geometry, whose prefix-sliced bases are not lexicographic
// boxes and so cannot take kernel K2.
//
// Each interface class (faces, edges, corners) spans the columns
// [c0, c0 + L*W) of every element row: L local cells of W DOFs each. Its
// tables: for each of G groups (one per shared or boundary cell) the owners
// oe/ol [G, M] (element, local cell; padded) with a validity flag om [G, M],
// and for each (element, local cell) its group gmap [E, L]. The combine
// writes to every copy of a group the sum of its owners' values.
//
// Bound on the H100: memory. Each output entry is written once and reads at
// most M owner values, which its group's other copies read again (from L1 or
// L2); the bytes the function must move are x read once, the output written
// once and the tables.
//
// Design: one thread per (element, column) entry of the output. Head columns
// (< i0, element interiors) pass through. A tail thread finds its class by
// column, its group through gmap, and sums the group's valid owners in table
// order from +0. No atomics and no scatter: every copy of a group adds the
// same values in the same order, so all copies come out bitwise equal, and
// the plain PyTorch form (ops/interfaces.py) adds them in the same order too.
// With ``mask`` (bool [E, n_local]) the store multiplies by it: the mask
// constraint after the combine in the same pass.

#include <cuda_runtime.h>

namespace {

struct GatherClass {
  const int* oe;
  const int* ol;
  const bool* om;
  const int* gmap;
  int c0, L, W, M;
};

struct GatherDesc {
  GatherClass cls[3];
  int ncls;
};

template <typename T>
__global__ void gather_combine_kernel(const T* __restrict__ x,
                                      T* __restrict__ out,
                                      const bool* __restrict__ mask,
                                      long long total, int n_local, int i0,
                                      const __grid_constant__ GatherDesc desc) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const long long e = idx / n_local;
  const int j = (int)(idx - e * n_local);
  T v;
  if (j < i0) {
    v = x[idx];
  } else {
    int c = 0;
    while (c + 1 < desc.ncls && j >= desc.cls[c].c0 + desc.cls[c].L * desc.cls[c].W) ++c;
    const GatherClass& g = desc.cls[c];
    const int jj = j - g.c0;
    const int l = jj / g.W;
    const int w = jj - l * g.W;
    const long long grp = g.gmap[e * g.L + l];
    v = T(0);
    for (int m = 0; m < g.M; ++m) {
      const long long q = grp * g.M + m;
      if (g.om[q])
        v += x[(long long)g.oe[q] * n_local + g.c0 + g.ol[q] * g.W + w];
    }
  }
  out[idx] = mask ? v * T(mask[idx]) : v;
}

template <typename T>
void launch_gather(const void* x, void* out, const void* mask, long long E,
                   int n_local, int i0, const GatherDesc& desc,
                   cudaStream_t stream) {
  const long long total = E * n_local;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  gather_combine_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out),
      static_cast<const bool*>(mask), total, n_local, i0, desc);
}

}  // namespace

// dtype: 0 = float32, 1 = float64. ``cls`` (host) holds ncls (1-3) records of
// 8 int64: c0, L, W, M, then the device pointers oe, ol, om, gmap (int32,
// int32, bool, int32). The classes must tile [i0, n_local) in this order.
// mask may be NULL; out must not alias x. Returns cudaGetLastError().
extern "C" int hz_gather_combine(int dtype, const void* x, void* out,
                                 const void* mask, long long E, int n_local,
                                 int i0, int ncls, const long long* cls,
                                 void* stream) {
  if (ncls < 1 || ncls > 3) return static_cast<int>(cudaErrorInvalidValue);
  GatherDesc desc{};
  desc.ncls = ncls;
  for (int c = 0; c < ncls; ++c) {
    const long long* r = cls + 8 * c;
    desc.cls[c].c0 = (int)r[0];
    desc.cls[c].L = (int)r[1];
    desc.cls[c].W = (int)r[2];
    desc.cls[c].M = (int)r[3];
    desc.cls[c].oe = reinterpret_cast<const int*>(r[4]);
    desc.cls[c].ol = reinterpret_cast<const int*>(r[5]);
    desc.cls[c].om = reinterpret_cast<const bool*>(r[6]);
    desc.cls[c].gmap = reinterpret_cast<const int*>(r[7]);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch_gather<float>(x, out, mask, E, n_local, i0, desc, s);
  else
    launch_gather<double>(x, out, mask, E, n_local, i0, desc, s);
  return static_cast<int>(cudaGetLastError());
}
