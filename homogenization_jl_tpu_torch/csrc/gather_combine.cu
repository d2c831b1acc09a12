// K8: gather-form interface combine on a general (non-box) base mesh.
//
// Replaces homogenization_jl_tpu/ops/interfaces.py::combine_gather_rows
// (an owner-row gather, a masked M-way sum and a rebuild gather that XLA
// lowers on the TPU), the combine of the driver's reference-order
// ("ordered") geometry, whose prefix-sliced bases are not lexicographic
// boxes and so cannot take kernel K2.
//
// Each interface class (faces, edges, corners) spans the columns
// [c0, c0 + L*W) of every element row: L local cells of W DOFs each, and
// G groups (one per shared or boundary cell). The combine writes to every
// copy of a group the sum of its owners' values. Its table (built by
// ops/interfaces.py::build_gather_tables): for each group its owners, M
// slots of one integer each, the offset in x of the owner's cell (element
// * n_local + c0 + local cell * W), -1 for a padding slot; int32 when the
// state and the groups' entries count below 2^31, int64 otherwise. The
// host checks that every cell of every row is a valid owner of exactly
// one group, so the groups' stores cover the tail once.
//
// Bound on the H100: memory. The bytes the function must move are x read
// once, the output written once, the mask and the owner table.
//
// The first design (one thread per output entry) ran at 4.2x that bound,
// by instructions and latency: each thread did a 64-bit division, a class
// search and a division by W, then walked gmap, the owner slots and x one
// dependent load after another, and every output entry re-read all of its
// group's owners, so x's reads grew as the sum of M^2 over the groups.
//
// Design: group-major. One thread per (group, column w of the cell): the
// W threads of a group are neighbours, so each owner's run of W entries
// is read by consecutive lanes. A thread loads its group's owner slots
// (two for a face, OWNER_BATCH at a time for an edge or a corner), then
// all of their values of x, then adds the valid ones in table order from
// +0, and stores the sum to every valid owner's copy (times the mask at
// the store; a face's two mask bytes are loaded with its values). So x is
// read once and the output written once, with no atomics: every copy of a
// group gets the same value, and the plain PyTorch form
// (ops/interfaces.py), which adds the same owners in the same order, gives
// the same bits. The head columns (< i0, element interiors) are copied in
// the same launch by a warp per row, in 16-byte vectors (row_head.cuh, as
// K2 does). The grid is the head's blocks, then each class's. Groups
// sorted by their first owner row, and two to eight (group, column) slots
// per thread, ran slower (development runs on the H100, not recorded).

#include <cuda_runtime.h>

#include "fixed_sum.cuh"
#include "row_head.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int OWNER_BATCH = 4;  // owner loads of a thread in flight before their adds
constexpr int FACE_OWNERS = 2;  // a face's owners: a batch of this size takes them

struct GatherClass {
  const void* own;  // [G, M] owner offsets (int32 or int64; -1: padding)
  long long G;
  long long first_block;  // the class's first block in the grid
  int W, M;
};

struct GatherDesc {
  GatherClass cls[3];
  int ncls;
  long long head_blocks;
};

// The groups of one class: thread (group, w) sums the valid owners' entry
// w in table order from +0 and stores the sum to each of them. Owners go
// B at a time, their slots first, then their values of x (and, when all
// of a group's owners fit in one batch, their mask bytes), then the adds;
// a group of at most B owners stores from the registers it loaded.
template <typename T, typename I, int B>
__device__ __forceinline__ void combine_groups(const T* __restrict__ x, T* __restrict__ out,
                                               const bool* __restrict__ mask,
                                               const GatherClass& g, long long block) {
  const I t = static_cast<I>(block - g.first_block) * THREADS + static_cast<I>(threadIdx.x);
  if (t >= static_cast<I>(g.G) * g.W) return;
  const I grp = t / g.W;
  const I w = t - grp * g.W;
  const I* __restrict__ own = static_cast<const I*>(g.own) + grp * g.M;
  const bool one = g.M <= B;
  I off[B];
  T v[B];
  bool mv[B];
#pragma unroll
  for (int q = 0; q < B; ++q) off[q] = I(-1);
  T acc = T(0);
  for (int m0 = 0; m0 < g.M; m0 += B) {
#pragma unroll
    for (int q = 0; q < B; ++q) off[q] = m0 + q < g.M ? __ldg(own + m0 + q) : I(-1);
#pragma unroll
    for (int q = 0; q < B; ++q)
      if (off[q] >= 0) {
        v[q] = x[off[q] + w];
        mv[q] = mask == nullptr || !one || mask[off[q] + w];
      }
#pragma unroll
    for (int q = 0; q < B; ++q)
      if (off[q] >= 0) acc += v[q];
  }
  if (one) {
#pragma unroll
    for (int q = 0; q < B; ++q)
      if (off[q] >= 0) out[off[q] + w] = mask ? acc * T(mv[q]) : acc;
  } else {
    for (int m = 0; m < g.M; ++m) {
      const I o = __ldg(own + m);
      if (o >= 0) out[o + w] = mask ? acc * T(mask[o + w]) : acc;
    }
  }
}

template <typename T, typename I, bool VEC>
__global__ void __launch_bounds__(THREADS)
gather_combine_kernel(const T* __restrict__ x, T* __restrict__ out,
                      const bool* __restrict__ mask, int E, int n_local, int i0,
                      const __grid_constant__ GatherDesc desc) {
  const long long b = blockIdx.x;
  if (b < desc.head_blocks) {
    const int e = static_cast<int>(b) * WARPS + static_cast<int>(threadIdx.x >> 5);
    if (e < E)
      hz::copy_head<T, VEC>(x, out, mask, static_cast<long long>(e) * n_local, i0,
                            threadIdx.x & 31, 32);
    return;
  }
  int c = 0;
  while (c + 1 < desc.ncls && b >= desc.cls[c + 1].first_block) ++c;
  const GatherClass& g = desc.cls[c];
  if (g.M <= FACE_OWNERS)
    combine_groups<T, I, FACE_OWNERS>(x, out, mask, g, b);
  else
    combine_groups<T, I, OWNER_BATCH>(x, out, mask, g, b);
}

template <typename T, typename I>
int launch_gather(const void* x, void* out, const void* mask, long long E, int n_local,
                  int i0, int ncls, const long long* cls, cudaStream_t stream) {
  if (ncls < 1 || ncls > 3 || E >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  GatherDesc desc{};
  desc.ncls = ncls;
  desc.head_blocks = i0 > 0 ? (E + WARPS - 1) / WARPS : 0;
  long long blocks = desc.head_blocks;
  for (int c = 0; c < ncls; ++c) {
    const long long* r = cls + 4 * c;
    GatherClass& g = desc.cls[c];
    g.W = static_cast<int>(r[0]);
    g.M = static_cast<int>(r[1]);
    g.G = r[2];
    g.own = reinterpret_cast<const void*>(r[3]);
    g.first_block = blocks;
    blocks += (g.G * g.W + THREADS - 1) / THREADS;
  }
  if (blocks >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0) return 0;
  constexpr int VW = 16 / sizeof(T);
  const bool vec = hz::aligned16(x) && hz::aligned16(out) &&
                   (mask == nullptr || reinterpret_cast<unsigned long long>(mask) % VW == 0);
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  const bool* mp = static_cast<const bool*>(mask);
  const unsigned grid = static_cast<unsigned>(blocks);
  if (vec)
    gather_combine_kernel<T, I, true><<<grid, THREADS, 0, stream>>>(xp, op, mp, (int)E, n_local,
                                                                    i0, desc);
  else
    gather_combine_kernel<T, I, false><<<grid, THREADS, 0, stream>>>(xp, op, mp, (int)E, n_local,
                                                                     i0, desc);
  return 0;
}

}  // namespace

// dtype: 0 = float32, 1 = float64; itype: the owner tables' 0 = int32,
// 1 = int64. ``cls`` (host) holds ncls (1-3) records of 4 int64: W, M, G,
// then the device address of the class's owner table [G, M]. mask may be
// NULL; out must not alias x. Returns cudaGetLastError().
extern "C" int hz_gather_combine(int dtype, int itype, const void* x, void* out,
                                 const void* mask, long long E, int n_local, int i0, int ncls,
                                 const long long* cls, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (dtype == 0)
    err = itype == 0 ? launch_gather<float, int>(x, out, mask, E, n_local, i0, ncls, cls, s)
                     : launch_gather<float, long long>(x, out, mask, E, n_local, i0, ncls, cls, s);
  else
    err = itype == 0 ? launch_gather<double, int>(x, out, mask, E, n_local, i0, ncls, cls, s)
                     : launch_gather<double, long long>(x, out, mask, E, n_local, i0, ncls, cls,
                                                        s);
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}
