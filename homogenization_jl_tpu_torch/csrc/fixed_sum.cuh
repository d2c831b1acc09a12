// The port's one fixed summation order, shared by every kernel whose sums
// the solver reads on the host or compares across runs: K5's dots
// (dots.cu), K9's element sums (integrals.cu, passes 2-3) and K14a's two
// dots (recurrence.cu). The plain form is ops/dots.py::fixed_order_sum.
//
// The order depends on N (and on the sum's dtype through V) alone: not on
// the card, its SM count, or the operands' alignment.
//   * V = 16 / sizeof(T) entries make one vector (4 in float32, 2 in
//     float64), SUM_THREADS vectors one tile (a round of the block's
//     threads); tile j holds the entries [j * S, (j + 1) * S), S =
//     SUM_THREADS * V, so every tile starts 16-byte aligned when the
//     operands' base pointers are;
//   * SUM_BLOCKS blocks take the tiles in turn: block b the tiles b, b +
//     SUM_BLOCKS, b + 2 SUM_BLOCKS, ... (all blocks sweep the operands
//     together, as a grid-stride loop does);
//   * thread t takes vector t of each of its block's tiles and adds the
//     entries, tile after tile and in index order within a vector, to a
//     running sum that starts at +0 (entries past N add nothing);
//   * the block adds its threads' sums in a fixed pairwise tree (level s
//     adds thread i + s into thread i, s = 128, ..., 1);
//   * each block stores its sum in its slot of a scratch buffer, fences, and
//     takes a ticket; the block that draws the last ticket adds the
//     SUM_BLOCKS slots (thread t: slots t, t + SUM_THREADS, ... from +0, then
//     the same tree), writes the result and resets the ticket. Which block
//     comes last does not change a bit: the slots' order is fixed.
// One launch, no atomics on the values: two launches give the same bits.
// Every product and sum is rounded on its own (the _rn intrinsics below),
// so no multiply is fused into an add and the plain form, which takes the
// same steps, gives the same bits.
//
// The scratch (SUM_SCRATCH_BYTES: the slots, then the ticket) is allocated
// and zeroed once per (device, stream) by the wrappers (ops/dots.py::
// sum_scratch). Each launch leaves the ticket at 0 for the next launch on
// its stream. Two streams sharing one buffer would race: a block of one
// launch could draw another launch's last ticket and add slots that are
// still being written.

#pragma once

#include <cuda_runtime.h>

#include <cstring>

namespace hz {

constexpr int SUM_BLOCKS = 1056;  // 8 blocks of 256 threads per SM on 132 SMs
constexpr int SUM_THREADS = 256;
// at most two sums per launch (K14a's rz and rs), slots of at most 8 bytes
constexpr int SUM_MAX_SUMS = 2;
constexpr long long SUM_TICKET_OFFSET = static_cast<long long>(SUM_MAX_SUMS) * SUM_BLOCKS * 8;
constexpr long long SUM_SCRATCH_BYTES = SUM_TICKET_OFFSET + 16;

template <typename T>
__host__ __device__ constexpr int sum_vec() {
  return 16 / static_cast<int>(sizeof(T));
}

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }

// this thread's first entry, and the stride to its next vector (one
// sweep of every block's tile)
template <typename T>
__device__ __forceinline__ long long sum_first() {
  return (static_cast<long long>(blockIdx.x) * SUM_THREADS + threadIdx.x) * sum_vec<T>();
}
template <typename T>
__host__ __device__ constexpr long long sum_stride() {
  return static_cast<long long>(SUM_BLOCKS) * SUM_THREADS * sum_vec<T>();
}

// V values of type X from p (aligned to V * sizeof(X) bytes) in one load
template <int BYTES>
struct RawVec;
template <>
struct RawVec<16> {
  using type = uint4;
};
template <>
struct RawVec<8> {
  using type = uint2;
};
template <>
struct RawVec<4> {
  using type = unsigned int;
};
template <>
struct RawVec<2> {
  using type = unsigned short;
};

template <int V, typename X>
__device__ __forceinline__ void load_vec(const X* __restrict__ p, X (&out)[V]) {
  using R = typename RawVec<V * sizeof(X)>::type;
  const R r = *reinterpret_cast<const R*>(p);
  memcpy(out, &r, sizeof(R));
}

template <int V, typename X>
__device__ __forceinline__ void store_vec(X* __restrict__ p, const X (&v)[V]) {
  using R = typename RawVec<V * sizeof(X)>::type;
  R r;
  memcpy(&r, v, sizeof(R));
  *reinterpret_cast<R*>(p) = r;
}

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15ull) == 0;
}

// The block's fixed tree over v[s] of its SUM_THREADS threads (the
// shared-memory levels down to 32, then one warp's shuffles): thread 0
// ends with the block's sums in v.
template <typename T, int NS>
__device__ __forceinline__ void sum_block_tree(T (&sh)[NS][SUM_THREADS], T (&v)[NS]) {
  const int t = threadIdx.x;
#pragma unroll
  for (int s = 0; s < NS; ++s) sh[s][t] = v[s];
#pragma unroll
  for (int st = SUM_THREADS / 2; st >= 32; st >>= 1) {
    __syncthreads();
    if (t < st) {
#pragma unroll
      for (int s = 0; s < NS; ++s) sh[s][t] = add_rn(sh[s][t], sh[s][t + st]);
    }
  }
  __syncthreads();
  if (t < 32) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      v[s] = sh[s][t];
#pragma unroll
      for (int st = 16; st > 0; st >>= 1)
        v[s] = add_rn(v[s], __shfl_down_sync(0xffffffffu, v[s], st));
    }
  }
}

// The end of every fixed-order sum: the block's tree over the threads'
// running sums acc[s], the block's slots, the ticket, and in the last
// block the sum of the slots; store(sums) runs in thread 0 of the last
// block. The grid must be SUM_BLOCKS blocks of SUM_THREADS threads.
template <typename T, int NS, typename Store>
__device__ __forceinline__ void sum_finish(T (&acc)[NS], unsigned char* scratch, Store store) {
  static_assert(NS <= SUM_MAX_SUMS && sizeof(T) <= 8, "scratch layout");
  __shared__ T sh[NS][SUM_THREADS];
  __shared__ bool last;
  T* slots = reinterpret_cast<T*>(scratch);
  unsigned int* ticket = reinterpret_cast<unsigned int*>(scratch + SUM_TICKET_OFFSET);
  sum_block_tree<T, NS>(sh, acc);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < NS; ++s) slots[s * SUM_BLOCKS + blockIdx.x] = acc[s];
    __threadfence();
    last = atomicAdd(ticket, 1u) == SUM_BLOCKS - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  T v[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    v[s] = T(0);
    for (int j = threadIdx.x; j < SUM_BLOCKS; j += SUM_THREADS)
      v[s] = add_rn(v[s], __ldcg(slots + s * SUM_BLOCKS + j));
  }
  __syncthreads();
  sum_block_tree<T, NS>(sh, v);
  if (threadIdx.x == 0) {
    store(v);
    *ticket = 0u;
  }
}

}  // namespace hz
