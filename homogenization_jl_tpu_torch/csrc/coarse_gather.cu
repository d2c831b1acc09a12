// K7: the gathers and segment sums of the coarse solves.
//
// Replaces, in homogenization_jl_tpu: ops/interfaces.py::copy_to_base (:67,
// a scatter-add) and ::distribute (:79, a gather); solver/multigrid.py::
// _to_global (:861, a presorted gather + sorted segment_sum), the two
// transfers of aux_correct (:966 r[node_map] * mask, :980
// x_a.flat[aux_first_flat] * m) and the interior gathers of
// _coarse_solve_inv (:853). XLA lowers them on the TPU.
//
// Two entry points:
//   segment_sum:  out[s] = sum_{j in [start[s], start[s+1])} vals[perm[j]]
//   gather_scale: out[i] = src[idx[i]] * mask[i]     (mask optional, bool)
//
// Bound on the H100: at the main path's sizes (786,432 values onto 35,937
// nodes; 245,760 aux slots) each call moves a few MB, so it costs about one
// launch.
//
// Design: one thread per output, no atomics. The segment sum adds a
// segment's values left to right from +0 in the presorted order (the order
// of ops/interfaces.py::build_segment_tables, a stable argsort of the
// keys), so its result never depends on the launch -- a scatter-add with
// atomics (torch's index_add_ on CUDA) leaves the order to the hardware and
// made the coarse right-hand side differ from run to run. The plain
// PyTorch form makes the same additions in the same order: the two agree
// bit for bit. Indices are int32 or int64 (``itype``); values float32 or
// float64 (``dtype``).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T, typename I>
__global__ void segment_sum_kernel(const T* __restrict__ vals,
                                   const I* __restrict__ perm,
                                   const I* __restrict__ start,
                                   T* __restrict__ out, long long nseg) {
  const long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= nseg) return;
  T acc = T(0);
  const I hi = start[s + 1];
  for (I j = start[s]; j < hi; ++j) acc += vals[perm[j]];
  out[s] = acc;
}

template <typename T, typename I>
__global__ void gather_scale_kernel(const T* __restrict__ src,
                                    const I* __restrict__ idx,
                                    const unsigned char* __restrict__ mask,
                                    T* __restrict__ out, long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  T v = src[idx[i]];
  if (mask != nullptr) v = v * T(mask[i]);
  out[i] = v;
}

unsigned blocks(long long total) {
  return (unsigned)((total + kThreads - 1) / kThreads);
}

template <typename T, typename I>
void segment_sum(const void* vals, const void* perm, const void* start,
                 void* out, long long nseg, cudaStream_t s) {
  segment_sum_kernel<T, I><<<blocks(nseg), kThreads, 0, s>>>(
      static_cast<const T*>(vals), static_cast<const I*>(perm),
      static_cast<const I*>(start), static_cast<T*>(out), nseg);
}

template <typename T, typename I>
void gather_scale(const void* src, const void* idx, const void* mask,
                  void* out, long long total, cudaStream_t s) {
  gather_scale_kernel<T, I><<<blocks(total), kThreads, 0, s>>>(
      static_cast<const T*>(src), static_cast<const I*>(idx),
      static_cast<const unsigned char*>(mask), static_cast<T*>(out), total);
}

}  // namespace

// dtype: 0 = float32, 1 = float64; itype: 0 = int32, 1 = int64.
// Each returns cudaGetLastError().
extern "C" int hz_segment_sum(int dtype, int itype, const void* vals,
                              const void* perm, const void* start, void* out,
                              long long nseg, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nseg > 0) {
    if (dtype == 0 && itype == 0)
      segment_sum<float, int>(vals, perm, start, out, nseg, s);
    else if (dtype == 0)
      segment_sum<float, long long>(vals, perm, start, out, nseg, s);
    else if (itype == 0)
      segment_sum<double, int>(vals, perm, start, out, nseg, s);
    else
      segment_sum<double, long long>(vals, perm, start, out, nseg, s);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hz_gather_scale(int dtype, int itype, const void* src,
                               const void* idx, const void* mask, void* out,
                               long long total, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (total > 0) {
    if (dtype == 0 && itype == 0)
      gather_scale<float, int>(src, idx, mask, out, total, s);
    else if (dtype == 0)
      gather_scale<float, long long>(src, idx, mask, out, total, s);
    else if (itype == 0)
      gather_scale<double, int>(src, idx, mask, out, total, s);
    else
      gather_scale<double, long long>(src, idx, mask, out, total, s);
  }
  return static_cast<int>(cudaGetLastError());
}
