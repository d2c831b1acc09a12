// K12: the cross-shard fix-up of the gather-sharded combine.
//
// Replaces the fix-up of homogenization_jl_tpu/parallel/sharding.py::
// ShardedMultigridSolver._combine (:376-405), which XLA lowers on the TPU
// as a gather, a segment_sum, a psum and a scatter. K12 is three steps on
// each rank's block of element rows:
//   1. the intra-shard combine: kernel K8 (csrc/gather_combine.cu) on the
//      shard's owner tables (owners outside the shard masked out), which
//      leaves partial sums on the copies of groups that cross shards;
//   2. hz_cross_partial: partial[g] = sum of x.flat[perm[j]] over
//      j in [start[g], start[g+1]), the shard's copies of cross group g in
//      the table's order, from +0; the group's sum over the ranks is then
//      SlabGroup.sum (an all_gather added in rank order, outside this file);
//   3. hz_cross_scatter: out.flat[idx[j]] = total[grp[j]] (times the bool
//      mask at the store when one is given: the mask constraint after the
//      combine, as K8's store does), over the shard's cross slots.
//
// Bound on the H100: bytes, and little of them: the cross slots are the
// shards' shared surface (O(surface) of the O(volume) state), read once and
// written once, with the tables; steps 2 and 3 cost about two launches.
//
// Design: one thread per group in step 2, summing in the presorted order of
// the host table (K7's segment-sum pattern: no atomics, so every run and
// every rank adds the same values in the same order), and one thread per
// slot in step 3 (each slot is written once). Every copy of a cross DOF
// receives the same total, so all copies come out bitwise equal, as K8's
// do. The plain PyTorch forms (ops/sharded.py) add in the same order and
// give the same bits.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
cross_partial_kernel(const T* __restrict__ x, const long long* __restrict__ perm,
                     const long long* __restrict__ start, T* __restrict__ partial,
                     long long n_groups) {
  const long long g = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (g >= n_groups) return;
  T acc = T(0);
  const long long hi = start[g + 1];
  for (long long j = start[g]; j < hi; ++j) acc += x[perm[j]];
  partial[g] = acc;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
cross_scatter_kernel(T* __restrict__ out, const T* __restrict__ total,
                     const long long* __restrict__ idx, const long long* __restrict__ grp,
                     const bool* __restrict__ mask, long long n_slots) {
  const long long j = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (j >= n_slots) return;
  const long long o = idx[j];
  const T v = total[grp[j]];
  out[o] = mask ? v * T(mask[o]) : v;
}

unsigned blocks(long long n) { return static_cast<unsigned>((n + THREADS - 1) / THREADS); }

}  // namespace

// dtype: 0 = float32, 1 = float64; perm, start, idx, grp int64; mask bool
// or NULL. Each returns cudaGetLastError().
extern "C" int hz_cross_partial(int dtype, const void* x, const void* perm, const void* start,
                                void* partial, long long n_groups, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long* pp = static_cast<const long long*>(perm);
  const long long* ss = static_cast<const long long*>(start);
  if (n_groups > 0) {
    if (dtype == 0)
      cross_partial_kernel<float><<<blocks(n_groups), THREADS, 0, st>>>(
          static_cast<const float*>(x), pp, ss, static_cast<float*>(partial), n_groups);
    else
      cross_partial_kernel<double><<<blocks(n_groups), THREADS, 0, st>>>(
          static_cast<const double*>(x), pp, ss, static_cast<double*>(partial), n_groups);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hz_cross_scatter(int dtype, void* out, const void* total, const void* idx,
                                const void* grp, const void* mask, long long n_slots,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long* ii = static_cast<const long long*>(idx);
  const long long* gg = static_cast<const long long*>(grp);
  const bool* mm = static_cast<const bool*>(mask);
  if (n_slots > 0) {
    if (dtype == 0)
      cross_scatter_kernel<float><<<blocks(n_slots), THREADS, 0, st>>>(
          static_cast<float*>(out), static_cast<const float*>(total), ii, gg, mm, n_slots);
    else
      cross_scatter_kernel<double><<<blocks(n_slots), THREADS, 0, st>>>(
          static_cast<double*>(out), static_cast<const double*>(total), ii, gg, mm, n_slots);
  }
  return static_cast<int>(cudaGetLastError());
}
