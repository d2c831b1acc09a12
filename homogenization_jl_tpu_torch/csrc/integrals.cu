// K9: the sigma integrals of the checkerboard driver, the mass product and
// the row dots fused.
//
// Replaces homogenization_jl_tpu/models/checkerboard.py::_integrals_fns
// (area, first_term, terms: an einsum with the reference mass matrix, a row
// sum and a masked dot that XLA lowers on the TPU). Its next_rhs is kernel
// K1 with the one-piece stack [mass] and is not here.
//
// Every form reduces to one scalar
//
//   total = scale * sum_e mask[e] * s[e],
//
// with, per element row e (Mx = M x[e], M the symmetric [n, n] mass matrix):
//   mode 0, terms:               s = detJ * sum_i (x + v)_i (Mx)_i
//   mode 1, first_term (quirk):  s = detJ * (sum_i x_i (Mx)_i + sum_i x_i b0_i)
//   mode 2, first_term:          s = sum_i x_i b0_i + detJ * sum_i x_i (Mx)_i
//   mode 3, area:                s = detJ          (scale = sum of M)
//   mode 4, dot_M:               s = detJ * sum_i w_i (Mx)_i
//
// Mode 4 is the M-inner product of the multishift recurrence (kernel K14b,
// homogenization_jl_tpu/models/multishift.py:152-155: dot_M(u, v) =
// sum_e detJ_e u_e . (M v_e), with x = v and w = u), unmasked (mask NULL)
// and with scale 1; the mass apply's output is never written.
//
// Bound on the H100: bytes. M is as sparse as K1's stack (12.5 nonzeros per
// row at n = 969: ops/apply.py), so at the flagship's finest level (E =
// 196,608) the mass product is 2 * E * 12,121 = 4.8 GFLOP (0.07 ms at 67
// TFLOP/s FP32) against 1.52 GB of x and v / b0 (0.45 ms at 3.35 TB/s).
//
// Design, two launches:
//   1. K1's sparse row pass (csrc/stencil_rows.cuh) over the mass matrix's
//      row table (vals [n, R, 1]): a block stages the x rows of G elements
//      in shared memory; a lane takes a row m of a chunk of 16 (float32) or
//      8 (float64) elements, a warp 16 rows of 2 chunks, forms (M x)_m of
//      each element from the row's real slots, and adds u_m (M x)_m (u = x,
//      x + v or w; w's rows loaded before the slot walk) and, for the first
//      term, x_m b0_m into its running partials. A warp's lanes on one
//      chunk then add their partials in a fixed butterfly, the warps' sums
//      are added in warp order, and one partial per element goes to device
//      memory: E values instead of the 0.76 GB of M x.
//   2. One launch sums the element terms in the port's fixed order
//      (fixed_sum.cuh, the order of K5's dots): each term is formed from
//      the row partials with the round-to-nearest intrinsics and multiplied
//      by the mask, and the last block to finish adds the block sums and
//      applies the scale.
// No atomics on the values and no launch-dependent order: two launches give
// the same bits, which the driver's stopping rule needs (it reads this
// scalar after every iteration), and the Lanczos recurrence's M-inner
// products repeat. From the same row partials, pass 2 gives the bits of the
// plain form's sum (ops/integrals.py), which is ops/dots.py::
// fixed_order_sum; the AREA form, which has no row partials, is its plain
// form bit for bit.

#include <cuda_runtime.h>

#include "fixed_sum.cuh"
#include "stencil_rows.cuh"

namespace {

constexpr int NT = hz::ROW_THREADS;

// chunks per warp (csrc/stencil_rows.cuh), and elements per chunk: 16 in
// float32, 8 in float64 (one accumulator each), so that a block's chunks
// of 969-value rows take 124 KB
constexpr int CW = 2;
template <typename T>
__host__ __device__ constexpr int chunk_elems() {
  return sizeof(T) == 4 ? 16 : 8;
}

template <typename T>
__global__ void __launch_bounds__(hz::ROW_THREADS, 1)
integrals_rows_kernel(const T* __restrict__ x, const int* __restrict__ cols,
                      const T* __restrict__ vals, const int* __restrict__ counts, int R,
                      const T* __restrict__ w, int mode,
                      T* __restrict__ partA, T* __restrict__ partB, long long E, int n, int G,
                      int CS) {
  constexpr int GC = chunk_elems<T>();
  constexpr int NW = hz::ROW_WARPS;
  extern __shared__ __align__(16) unsigned char smem[];
  T* redA = reinterpret_cast<T*>(smem);  // [G][NW] each warp's partials
  T* redB = redA + G * NW;
  T* xs = redB + G * NW;

  const long long e0 = static_cast<long long>(blockIdx.x) * G;
  const int Gb = E - e0 < G ? static_cast<int>(E - e0) : G;
  const bool with_b = mode == 1 || mode == 2;
  for (int i = threadIdx.x; i < 2 * G * NW; i += blockDim.x) redA[i] = T(0);
  hz::stage_rows<T, T, GC>(x, e0, Gb, G, n, CS, nullptr, xs);
  __syncthreads();

  const int nch = G / GC;
  const int ncg = nch / CW;
  const int items = hz::warp_items<CW>(n, nch);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  // this lane's running terms of its chunk's GC elements; a lane's chunk
  // changes only with the warp's chunk group (never when the block holds
  // one group, as at n = 969)
  T sa[GC], sb[GC];
#pragma unroll
  for (int j = 0; j < GC; ++j) sa[j] = sb[j] = T(0);
  // the sum over the lanes of one chunk (the lane bits above the chunk's) in a fixed
  // butterfly, added into this warp's partials of the chunk's elements
  auto flush = [&](int c) {
#pragma unroll
    for (int j = 0; j < GC; ++j) {
#pragma unroll
      for (int sft = CW; sft < 32; sft <<= 1) {
        sa[j] += __shfl_xor_sync(0xffffffffu, sa[j], sft);
        if (with_b) sb[j] += __shfl_xor_sync(0xffffffffu, sb[j], sft);
      }
    }
    if (lane < CW) {
#pragma unroll
      for (int j = 0; j < GC; ++j) {
        redA[(c * GC + j) * NW + warp] += sa[j];
        if (with_b) redB[(c * GC + j) * NW + warp] += sb[j];
      }
    }
#pragma unroll
    for (int j = 0; j < GC; ++j) sa[j] = sb[j] = T(0);
  };
  int cg_cur = warp < items ? warp % ncg : 0;
  for (int W = warp; W < items; W += NW) {
    if (W % ncg != cg_cur) {
      flush(cg_cur * CW + lane % CW);
      cg_cur = W % ncg;
    }
    int c, m;
    const bool row = hz::item_of<CW>(W, n, nch, lane, c, m);
    const T* xc = xs + c * CS;
    // this lane's rows of w, loaded before the slot walk so that their
    // latency hides behind it
    T wo[GC];
#pragma unroll
    for (int j = 0; j < GC; ++j) {
      const int g = c * GC + j;
      wo[j] = (row && g < Gb) ? w[(e0 + g) * n + m] : T(0);
    }
    if (row) {
      const int* cm = cols + static_cast<long long>(m) * R;
      const T* vm = vals + static_cast<long long>(m) * R;
      const int cnt = __ldg(counts + m);
      hz::prefetch_row<T, 1, CW>(cm, vm, cnt, lane % CW);
      T acc[GC][1];
      hz::row_products<T, 1, 1, GC>(cm, vm, cnt, xc, n, acc);
#pragma unroll
      for (int j = 0; j < GC; ++j) {
        if (c * GC + j < Gb) {
          const T xo = xc[j * n + m];
          const T u = mode == 0 ? xo + wo[j] : (mode == 4 ? wo[j] : xo);
          sa[j] += u * acc[j][0];
          if (with_b) sb[j] += xo * wo[j];
        }
      }
    }
  }
  flush(cg_cur * CW + lane % CW);
  __syncthreads();

  // one partial per element: the warps' partials in warp order
  for (int g = threadIdx.x; g < Gb; g += blockDim.x) {
    T a = T(0), bsum = T(0);
#pragma unroll
    for (int wi = 0; wi < NW; ++wi) {
      a += redA[g * NW + wi];
      bsum += redB[g * NW + wi];
    }
    partA[e0 + g] = a;
    if (with_b) partB[e0 + g] = bsum;
  }
}

// pass 2: total = scale * sum_e [mask_e] s_e in the fixed order
template <typename T>
__device__ __forceinline__ T element_term(const T* __restrict__ partA, const T* __restrict__ partB,
                                          const T* __restrict__ detJ, const T* __restrict__ mask,
                                          int mode, long long e) {
  const T a = mode != 3 ? partA[e] : T(0);
  const T b = (mode == 1 || mode == 2) ? partB[e] : T(0);
  T v;
  if (mode == 0 || mode == 4)
    v = hz::mul_rn(detJ[e], a);
  else if (mode == 1)
    v = hz::mul_rn(detJ[e], hz::add_rn(a, b));
  else if (mode == 2)
    v = hz::add_rn(b, hz::mul_rn(detJ[e], a));
  else
    v = detJ[e];
  return mask == nullptr ? v : hz::mul_rn(v, mask[e]);
}

template <typename T>
__global__ void __launch_bounds__(hz::SUM_THREADS)
integrals_sum_kernel(const T* __restrict__ partA, const T* __restrict__ partB,
                     const T* __restrict__ detJ, const T* __restrict__ mask, int mode,
                     long long E, double scale, unsigned char* scratch, T* __restrict__ out) {
  constexpr int V = hz::sum_vec<T>();
  T acc[1] = {T(0)};
  for (long long i = hz::sum_first<T>(); i < E; i += hz::sum_stride<T>()) {
#pragma unroll
    for (int l = 0; l < V; ++l)
      if (i + l < E)
        acc[0] = hz::add_rn(acc[0], element_term(partA, partB, detJ, mask, mode, i + l));
  }
  hz::sum_finish<T, 1>(acc, scratch,
                       [&](const T (&r)[1]) { out[0] = hz::mul_rn(T(scale), r[0]); });
}

template <typename T>
int launch_integrals(int mode, const void* x, const void* cols, const void* vals,
                     const void* counts, int R,
                     const void* w, const void* detJ, const void* mask, void* partA,
                     void* partB, void* scratch, void* out, long long E, int n, double scale,
                     cudaStream_t stream) {
  T* pa = static_cast<T*>(partA);
  T* pb = static_cast<T*>(partB);
  if (mode != 3 && E > 0) {
    constexpr int GC = chunk_elems<T>();
    static bool allowed = false;
    if (!allowed) {
      hz::allow_smem(integrals_rows_kernel<T>);
      allowed = true;
    }
    const int vb = static_cast<int>(sizeof(T));
    const hz::RowsLayout L = hz::rows_layout(E, n, CW, GC, vb, 2 * GC * hz::ROW_WARPS * vb);
    if (L.smem == 0 || R < 1) return static_cast<int>(cudaErrorInvalidValue);
    integrals_rows_kernel<T><<<L.blocks, NT, L.smem, stream>>>(
        static_cast<const T*>(x), static_cast<const int*>(cols), static_cast<const T*>(vals),
        static_cast<const int*>(counts), R,
        static_cast<const T*>(w), mode, pa, pb, E, n, L.G, L.CS);
  }
  integrals_sum_kernel<T><<<hz::SUM_BLOCKS, hz::SUM_THREADS, 0, stream>>>(
      pa, pb, static_cast<const T*>(detJ), static_cast<const T*>(mask), mode, E, scale,
      static_cast<unsigned char*>(scratch), static_cast<T*>(out));
  return 0;
}

}  // namespace

// dtype: 0 = float32, 1 = float64; mode as above. cols (int32 [R, n]) and
// vals ([R, n, 1]) are the mass matrix's table (ops/apply.py::
// stack_table of the one-piece stack [M]). x, the table, w and
// partA/partB may be NULL where the mode does not read them (area reads
// none of them); mask may be NULL (every row counts once). partA/partB
// hold [E], scratch is the current stream's fixed-sum scratch
// (fixed_sum.cuh), out one value. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for rows too long for one
// block's shared memory.
extern "C" int hz_integrals(int dtype, int mode, const void* x, const void* cols,
                            const void* vals, const void* counts, int R, const void* w,
                            const void* detJ,
                            const void* mask, void* partA, void* partB, void* scratch,
                            void* out, long long E, int n, double scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err =
      dtype == 0
          ? launch_integrals<float>(mode, x, cols, vals, counts, R, w, detJ, mask, partA, partB,
                                    scratch, out, E, n, scale, s)
          : launch_integrals<double>(mode, x, cols, vals, counts, R, w, detJ, mask, partA, partB,
                                     scratch, out, E, n, scale, s);
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}
