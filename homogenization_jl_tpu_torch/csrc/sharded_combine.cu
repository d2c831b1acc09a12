// K12: the cross-shard fix-up of the gather-sharded combine.
//
// Replaces the fix-up of homogenization_jl_tpu/parallel/sharding.py::
// ShardedMultigridSolver._combine (:376-405), which XLA lowers on the TPU
// as a gather, a segment_sum, a psum and a scatter. K12 is three steps on
// each rank's block of element rows:
//   1. the intra-shard combine: kernel K8 (csrc/gather_combine.cu) on the
//      shard's owner tables (owners outside the shard masked out), which
//      leaves partial sums on the copies of groups that cross shards;
//   2. hz_cross_partial: the level's [G] partial vector zeroed, then
//      partial[gid[l]] = the sum of x.flat[perm[j]] over
//      j in [start[l], start[l+1]), for each group l of the shard, its
//      copies in the host table's order, from +0; the group's sum over the
//      ranks is then SlabGroup.sum (an all_gather added in rank order,
//      outside this file);
//   3. hz_cross_scatter: out.flat[idx[j]] = total[grp[j]] (times the bool
//      mask at the store when one is given: the mask constraint after the
//      combine, as K8's store does), over the shard's cross slots.
//
// Bound on the H100: bytes, and few of them: the cross slots are the
// shards' shared surface (O(surface) of the O(volume) state), read once and
// written once, with their int32 tables; the [G] partial vector, the one
// array of the level's size (it is the exchange format), is written once.
//
// Design: the first design ran one thread per cross group of the whole
// level (most of them with no slot on the shard) over an int64 start
// array of the level's size, and scattered in group order, so neighbouring
// threads wrote scattered sectors. Now: the partial vector is zeroed by a
// memset on the stream, one thread per group of the shard (ascending
// global ids, a CSR start over the slots presorted by group, stable) sums
// in the host table's order (K7's segment-sum pattern: no atomics, so every
// run and every rank adds the same values in the same order), and one
// thread per slot in flat-address order scatters, so neighbouring threads
// write neighbouring entries of out and read neighbouring mask bytes; the
// memset gives the groups with no slot here their +0. Every
// copy of a cross DOF receives the same total, so all copies come out
// bitwise equal, as K8's do. The plain PyTorch forms (ops/sharded.py) add
// in the same order and give the same bits.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
cross_partial_kernel(const T* __restrict__ x, const int* __restrict__ perm,
                     const int* __restrict__ start, const int* __restrict__ gid,
                     T* __restrict__ partial, int n_local_groups) {
  const int l = blockIdx.x * THREADS + threadIdx.x;
  if (l >= n_local_groups) return;
  const int hi = __ldg(start + l + 1);
  T acc = T(0);
  for (int j = __ldg(start + l); j < hi; ++j) acc += x[__ldg(perm + j)];
  partial[__ldg(gid + l)] = acc;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
cross_scatter_kernel(T* __restrict__ out, const T* __restrict__ total,
                     const int* __restrict__ idx, const int* __restrict__ grp,
                     const bool* __restrict__ mask, int n_slots) {
  const int j = blockIdx.x * THREADS + threadIdx.x;
  if (j >= n_slots) return;
  const int o = __ldg(idx + j);
  const T v = total[__ldg(grp + j)];
  out[o] = mask ? v * T(mask[o]) : v;
}

unsigned blocks(long long n) { return static_cast<unsigned>((n + THREADS - 1) / THREADS); }

}  // namespace

// dtype: 0 = float32, 1 = float64; perm, start, gid int32; partial
// [n_groups], every entry written. Returns the memset's error or
// cudaGetLastError().
extern "C" int hz_cross_partial(int dtype, const void* x, const void* perm, const void* start,
                                const void* gid, void* partial, long long n_groups,
                                long long n_local_groups, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_local_groups >= (1ll << 31) || n_local_groups > n_groups)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t es = dtype == 0 ? sizeof(float) : sizeof(double);
  if (n_groups > 0) {
    const cudaError_t err = cudaMemsetAsync(partial, 0, n_groups * es, st);  // +0 in both types
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int* pp = static_cast<const int*>(perm);
  const int* ss = static_cast<const int*>(start);
  const int* gg = static_cast<const int*>(gid);
  const int nl = static_cast<int>(n_local_groups);
  if (nl > 0) {
    if (dtype == 0)
      cross_partial_kernel<float><<<blocks(nl), THREADS, 0, st>>>(
          static_cast<const float*>(x), pp, ss, gg, static_cast<float*>(partial), nl);
    else
      cross_partial_kernel<double><<<blocks(nl), THREADS, 0, st>>>(
          static_cast<const double*>(x), pp, ss, gg, static_cast<double*>(partial), nl);
  }
  return static_cast<int>(cudaGetLastError());
}

// dtype as above; idx, grp int32 (idx ascending); mask bool or NULL.
// Returns cudaGetLastError().
extern "C" int hz_cross_scatter(int dtype, void* out, const void* total, const void* idx,
                                const void* grp, const void* mask, long long n_slots,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_slots >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const int* ii = static_cast<const int*>(idx);
  const int* gg = static_cast<const int*>(grp);
  const bool* mm = static_cast<const bool*>(mask);
  const int ns = static_cast<int>(n_slots);
  if (ns > 0) {
    if (dtype == 0)
      cross_scatter_kernel<float><<<blocks(ns), THREADS, 0, st>>>(
          static_cast<float*>(out), static_cast<const float*>(total), ii, gg, mm, ns);
    else
      cross_scatter_kernel<double><<<blocks(ns), THREADS, 0, st>>>(
          static_cast<double*>(out), static_cast<const double*>(total), ii, gg, mm, ns);
  }
  return static_cast<int>(cudaGetLastError());
}
