// K1: matrix-free element apply, y[e] = sum_p coeff[e,p] * (S_p @ x[e]),
// over the nonzeros of the stack.
//
// Replaces homogenization_jl_tpu/ops/apply.py::element_apply (a chain of P
// batched matmuls that XLA lowers on the TPU). The JAX package multiplies
// the dense [P, n, n] stack only to feed the TPU's matrix unit; the slices
// are almost empty. At n = 969 the union of the seven slices has 12,121
// nonzeros (12.5 per row, at most 19), 1.3% of the dense product, and the
// zeros are exact. The Julia reference applies these operators as
// per-element sparse products (src/apply_local_operators.jl); so does
// this kernel, over the row table of the stack (ops/apply.py::stack_table:
// cols [n, R], vals [n, R, PP] with the P pieces of a slot interleaved and
// padded to PP = 1, 4 or 8, and each row's count of real slots).
//
// Bound on the H100: bytes. At the finest main-path level (E = 196,608,
// n = 969, P = 7) the residual form moves x, b and out (2.29 GB, 0.68 ms
// at 3.35 TB/s) against 2 * E * 66,418 = 26.1 GFLOP of nonzero work (0.39
// ms at 67 TFLOP/s FP32). Tensor cores would not help: at ~12.5 nonzeros
// per row there is no dense tile to feed them, and the dense product they
// could run (DMMA, TF32 wgmma) is 77 times the work.
//
// Design (csrc/stencil_rows.cuh): one block per SM stages the x rows of G
// consecutive elements in shared memory (one contiguous run read with
// 16-byte loads, widened to the state type; the residual form subtracts the
// shift x[e, 0] as it stages). A lane takes an output row m of a chunk of
// GC elements and walks row m's real slots (a row's count; pads are never
// walked), each slot's column and PP values one load, used GC * P times:
// GC * P accumulators, the per-piece partials sum_k S_p[m, k] x_k of the
// JAX form's order, then y = sum_p coeff[e, p] * partial_p. A warp takes 8
// rows of 4 chunks (16 rows of 2 for the one-piece mass apply, whose
// accumulators are few), so a slot load serves 32 (float32) or 16
// (float64) elements; each row's table is prefetched into L1 before it is
// walked, one L2 round trip per row instead of one per slot. GC is 8 in
// float32 and 4 in float64 (16 and 8 for one piece): 124 KB of x rows at
// n = 969. The sums run in a fixed order with no atomics: two launches
// give the same bits, and K16's apply on the widened x is K1's bit for
// bit.
//
// The optional epilogue computes b - y (the smoother's entry residual and
// its in-place r -= A p update; each b is read by the lane that writes its
// out, before it writes) so the residual never takes a second pass.
//
// The optional bool mask multiplies each output at the store (the mask
// constraint after the apply, ``apply_mask(A x, m)`` or ``apply_mask(b - A x,
// m)`` of the JAX smoothers): y * 1 or y * 0, rounded on its own, so the
// result has the bits of the unmasked output times the mask, a -0.0 or a
// NaN included, and the masked state never takes a second pass.
//
// The residual form is shifted. Near convergence each output of b - A x is
// a small difference of products of the size of S_p * x, so the rounding
// of the running float32 sum, not the iterate, sets the floor of the
// solve's residual. The residual form therefore multiplies x[e] - s_e, with
// s_e = x[e, 0], and adds s_e * sum_p coeff[e, p] * rs[p, m] back in the
// epilogue, where rs[p] = S_p 1 are the stack's row sums (zero up to the
// rounding of S for the stiffness pieces). The algebra is exact; the
// products shrink to the variation of x inside an element.
//
// The stored type TX of x may be narrower than the state type T (K16: the
// smoothers' direction vectors in bfloat16 or float16, or float32 under a
// float64 state): each value is widened exactly as it is staged, so the
// result is the state-type kernel's on the widened x, bit for bit.
// element_apply.cu instantiates TX = T, element_apply_half.cu the narrower
// types (two sources: nvcc builds them side by side).

#pragma once

#include <cuda_runtime.h>

#include "stencil_rows.cuh"
#include "widen.cuh"

namespace {

using hz::widen;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

// chunks per warp (csrc/stencil_rows.cuh) and elements per chunk: a block's
// CW chunks of 969-value rows take 124 KB, and GC * PP accumulators at most
// 64 32-bit registers. One piece (the mass apply) takes K9's shape: 2
// chunks of 16 (float32) or 8 (float64) elements, more elements per table
// load where the accumulators are few.
template <int PP>
__host__ __device__ constexpr int chunks_per_warp() {
  return PP == 1 ? 2 : 4;
}
template <typename T, int PP>
__host__ __device__ constexpr int chunk_elems() {
  return 128 / (static_cast<int>(sizeof(T)) * chunks_per_warp<PP>());
}

// PP: the pieces a table slot holds (1, 4, 8); NP <= PP: the pieces
// multiplied (P, or PP when P < PP pads with zero pieces)
template <typename T, typename TX, int PP, int NP, bool RES>
__global__ void __launch_bounds__(hz::ROW_THREADS, 1)
element_apply_kernel(const TX* __restrict__ x, const T* __restrict__ coeff,
                     const int* __restrict__ cols, const T* __restrict__ vals,
                     const int* __restrict__ counts, int R,
                     const T* b, const T* __restrict__ rs, const bool* __restrict__ mask,
                     T* out, long long E, int n, int P, int G, int CS) {
  constexpr int CW = chunks_per_warp<PP>();
  constexpr int GC = chunk_elems<T, PP>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* Cs = reinterpret_cast<T*>(smem);  // [G][PP] coefficients, zero-padded
  T* Ss = Cs + G * PP;                 // [G] shifts x[e, 0] (RES)
  T* xs = Ss + G;                      // the chunks' x rows

  const long long e0 = static_cast<long long>(blockIdx.x) * G;
  const int Gb = E - e0 < G ? static_cast<int>(E - e0) : G;
  for (int i = threadIdx.x; i < G * PP; i += blockDim.x) {
    const int g = i / PP, p = i % PP;
    Cs[i] = (g < Gb && p < P) ? coeff[(e0 + g) * P + p] : T(0);
  }
  if constexpr (RES) {
    for (int g = threadIdx.x; g < G; g += blockDim.x)
      Ss[g] = g < Gb ? T(widen(x[(e0 + g) * n])) : T(0);
    __syncthreads();
  }
  hz::stage_rows<T, TX, GC>(x, e0, Gb, G, n, CS, RES ? Ss : nullptr, xs);
  __syncthreads();

  const int nch = G / GC;
  const int items = hz::warp_items<CW>(n, nch);
  const int lane = threadIdx.x % 32;
  for (int W = threadIdx.x / 32; W < items; W += hz::ROW_WARPS) {
    int c, m;
    if (!hz::item_of<CW>(W, n, nch, lane, c, m)) continue;
    const int* cm = cols + static_cast<long long>(m) * R;
    const T* vm = vals + static_cast<long long>(m) * R * PP;
    const int cnt = __ldg(counts + m);
    hz::prefetch_row<T, PP, CW>(cm, vm, cnt, lane % CW);
    T acc[GC][NP];
    hz::row_products<T, PP, NP, GC>(cm, vm, cnt, xs + c * CS, n, acc);
    // the epilogue's loads first, all in flight together (each b is read
    // before the same thread writes its out: out may alias b)
    T bo[GC];
    bool mo[GC];
#pragma unroll
    for (int j = 0; j < GC; ++j) {
      const int g = c * GC + j;
      const long long o = (e0 + g) * n + m;
      if (g < Gb) {
        if constexpr (RES) bo[j] = b[o];
        if (mask) mo[j] = mask[o];
      }
    }
    T rsm[NP];
    if constexpr (RES) {
#pragma unroll
      for (int p = 0; p < NP; ++p)
        rsm[p] = p < P ? __ldg(rs + static_cast<long long>(p) * n + m) : T(0);
    }
#pragma unroll
    for (int j = 0; j < GC; ++j) {
      const int g = c * GC + j;
      if (g < Gb) {
        const T* cg = Cs + g * PP;
        T y = T(0);
#pragma unroll
        for (int p = 0; p < NP; ++p) y += cg[p] * acc[j][p];
        T v;
        if constexpr (RES) {
          // y = A (x - s) + s * (A 1), the row sums in piece order
          T t = T(0);
#pragma unroll
          for (int p = 0; p < NP; ++p) t += cg[p] * rsm[p];
          v = bo[j] - (y + Ss[g] * t);
        } else {
          v = y;
        }
        out[(e0 + g) * n + m] = mask ? mul_rn(v, T(mo[j])) : v;
      }
    }
  }
}

template <typename T, typename TX, int PP, int NP, bool RES>
int launch_pp(const TX* x, const T* coeff, const int* cols, const T* vals, const int* counts,
              int R, const T* b, const T* rs, const bool* mask, T* out, long long E, int n,
              int P, cudaStream_t stream) {
  constexpr int CW = chunks_per_warp<PP>();
  constexpr int GC = chunk_elems<T, PP>();
  static bool allowed = false;
  if (!allowed) {
    hz::allow_smem(element_apply_kernel<T, TX, PP, NP, RES>);
    allowed = true;
  }
  const int vb = static_cast<int>(sizeof(T));
  const hz::RowsLayout L = hz::rows_layout(E, n, CW, GC, vb, GC * (PP + 1) * vb);
  if (L.smem == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (E == 0) return 0;
  element_apply_kernel<T, TX, PP, NP, RES><<<L.blocks, hz::ROW_THREADS, L.smem, stream>>>(
      x, coeff, cols, vals, counts, R, b, rs, mask, out, E, n, P, L.G, L.CS);
  return 0;
}

template <typename T, typename TX = T>
int launch_apply(const void* x, const void* coeff, const void* cols, const void* vals,
                 const void* counts, int R, int PP, const void* b, const void* rs,
                 const void* mask, void* out, long long E, int n, int P, cudaStream_t stream) {
  const TX* xx = static_cast<const TX*>(x);
  const T* cc = static_cast<const T*>(coeff);
  const int* ci = static_cast<const int*>(cols);
  const T* vv = static_cast<const T*>(vals);
  const int* cn = static_cast<const int*>(counts);
  const T* bb = static_cast<const T*>(b);
  const T* rr = static_cast<const T*>(rs);
  const bool* mm = static_cast<const bool*>(mask);
  T* oo = static_cast<T*>(out);
  if (P > PP || R < 1) return static_cast<int>(cudaErrorInvalidValue);
#define HZ_APPLY(PPV, NPV)                                                                    \
  return b ? launch_pp<T, TX, PPV, NPV, true>(xx, cc, ci, vv, cn, R, bb, rr, mm, oo, E, n, P, \
                                              stream)                                         \
           : launch_pp<T, TX, PPV, NPV, false>(xx, cc, ci, vv, cn, R, bb, rr, mm, oo, E, n, P, \
                                               stream);
  if (PP == 1) HZ_APPLY(1, 1)
  if (PP == 4) HZ_APPLY(4, 4)
  // the 3D stacks: six conductivity pieces and the mass
  if (PP == 8 && P == 7) HZ_APPLY(8, 7)
  if (PP == 8) HZ_APPLY(8, 8)
#undef HZ_APPLY
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
