// K1: matrix-free element apply, y[e] = sum_p coeff[e,p] * (S_p @ x[e]).
//
// Replaces homogenization_jl_tpu/ops/apply.py::element_apply (a chain of P
// batched matmuls that XLA lowers on the TPU).
//
// Shape: a GEMM with M = E (elements), N = n (local DOFs), K = P*n. The A
// operand is x[e, k] scaled by coeff[e, p] as it is stored to shared memory;
// the B operand is S_p[k, m] (S_p is symmetric, so row k of S_p is read,
// coalesced).
//
// Bound on the H100: compute. At the finest level (E = 196,608, n = 969,
// P = 7) one apply is 2*7*969^2*196,608 = 2.6 TFLOP against ~0.8 GB of x
// and y, far above the FP32 ridge point — provided each block's slice of x
// is fetched from L2 once, not once per piece.
//
// Design: a shared-memory tiled GEMM on the CUDA cores in full FP32 (or
// FP64) FMA. Each block owns a BM x BN tile of y. The K axis is walked
// k-slice outer, piece inner: a BK-wide slice of x is loaded into registers
// once and scaled by each piece's coefficient in turn, so x leaves L2 once
// per block instead of P times (the piece-outer order was L2-bound at ~17
// TFLOP/s on the H100; this order ~1.8x faster). The next slice's global
// loads are issued before the current slice's math. Each thread keeps a
// TM x TN register tile made of 4-wide row and column groups, so every
// shared-memory operand read is one 16-byte load. Three tile shapes cover
// the levels' widths (n = 4, 10, 35, 165, 969); edges in E, n and K are
// masked by zero-filling the tiles. The optional epilogue computes b - y
// (the smoother's entry residual and its in-place r -= A p update) so the
// residual never takes a second pass. Tensor cores (TF32 / 3xTF32 wgmma)
// are later work.
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
// float64 state): each value is widened as it is loaded into the registers
// that hold the slice, exactly, so the result is the state-type kernel's
// on the widened x, bit for bit. element_apply.cu instantiates TX = T,
// element_apply_half.cu the narrower types (two sources: nvcc builds them
// side by side).

#pragma once

#include <cuda_runtime.h>

#include "widen.cuh"

namespace {

using hz::widen;

// four consecutive values from 16-byte-aligned shared memory
__device__ __forceinline__ void load4(const float* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}

__device__ __forceinline__ void load4(const double* p, double* o) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  const double2 b = *reinterpret_cast<const double2*>(p + 2);
  o[0] = a.x;
  o[1] = a.y;
  o[2] = b.x;
  o[3] = b.y;
}

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

// the residual form's pieces staged per block (3D: 6 conductivity pieces
// and the mass)
constexpr int MAXP = 8;

template <typename T, typename TX, int BM, int BN, int BK, int TM, int TN, bool RES>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
element_apply_kernel(const TX* __restrict__ x, const T* __restrict__ coeff,
                     const T* __restrict__ S, const T* b,
                     const T* __restrict__ rs, const bool* __restrict__ mask, T* out,
                     int E, int n, int P) {
  constexpr int NTX = BN / TN;
  constexpr int NTY = BM / TM;
  constexpr int NT = NTX * NTY;
  constexpr int SGM = NTY * 4;  // row stride between a thread's row groups
  constexpr int SGN = NTX * 4;  // column stride between its column groups
  constexpr int PAD = 4;        // keeps the transposed A stores conflict-free
  constexpr int A_PER = BM * BK / NT;
  constexpr int B_PER = BK * BN / NT;
  static_assert(TM % 4 == 0 && TN % 4 == 0, "4-wide register groups");
  static_assert(A_PER * NT == BM * BK && B_PER * NT == BK * BN, "tile split");
  // As[k][r] = coeff[e0+r, p] * x[e0+r, k0+k];  Bs[k][c] = S_p[k0+k, m0+c]
  __shared__ __align__(16) T As[BK][BM + PAD];
  __shared__ __align__(16) T Bs[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % NTX;
  const int ty = tid / NTX;
  // column tiles vary fastest: the blocks resident together share x rows
  const int m0 = blockIdx.x * BN;
  const long long e0 = (long long)blockIdx.y * BM;

  T acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = T(0);

  // RES: the block's shifts x[e, 0], coefficients and row sums, staged in
  // shared memory (the epilogue reads them for every output)
  __shared__ T Ss[RES ? BM : 1];
  __shared__ T Cs[RES ? BM : 1][MAXP];
  __shared__ T Rs[RES ? MAXP : 1][BN];
  if constexpr (RES) {
    for (int i = tid; i < BM; i += NT) Ss[i] = e0 + i < E ? T(widen(x[(e0 + i) * n])) : T(0);
    // zero-filled to MAXP pieces: the epilogue's piece loop has a fixed
    // trip count, so it unrolls and the output loads batch around it
    for (int i = tid; i < BM * MAXP; i += NT) {
      const int r = i / MAXP, p = i % MAXP;
      Cs[r][p] = (p < P && e0 + r < E) ? coeff[(e0 + r) * P + p] : T(0);
    }
    for (int i = tid; i < MAXP * BN; i += NT) {
      const int p = i / BN, m = m0 + i % BN;
      Rs[p][i % BN] = (p < P && m < n) ? rs[(long long)p * n + m] : T(0);
    }
    __syncthreads();
  }
  T xv[A_PER], sv[B_PER];  // the next slice, in flight during the math
  auto load_x = [&](int k0) {
#pragma unroll
    for (int q = 0; q < A_PER; ++q) {
      const int i = tid + q * NT;
      const long long e = e0 + i / BK;
      const int k = k0 + i % BK;
      xv[q] = (e < E && k < n) ? T(widen(x[e * n + k])) : T(0);
    }
  };
  auto load_s = [&](int k0, int p) {
    const T* Sp = S + (long long)p * n * n;
#pragma unroll
    for (int q = 0; q < B_PER; ++q) {
      const int i = tid + q * NT;
      const int k = k0 + i / BN, m = m0 + i % BN;
      sv[q] = (k < n && m < n) ? Sp[(long long)k * n + m] : T(0);
    }
  };

  load_x(0);
  load_s(0, 0);
  for (int k0 = 0; k0 < n; k0 += BK) {
    if constexpr (RES) {
      // the shift, subtracted once per slice where the slice is first used
      // (at the load it would stall the prefetch in flight during the math)
#pragma unroll
      for (int q = 0; q < A_PER; ++q) {
        const int i = tid + q * NT;
        xv[q] = k0 + i % BK < n ? xv[q] - Ss[i / BK] : T(0);
      }
    }
    for (int p = 0; p < P; ++p) {
#pragma unroll
      for (int q = 0; q < A_PER; ++q) {
        const int i = tid + q * NT;
        const long long e = e0 + i / BK;
        As[i % BK][i / BK] = e < E ? coeff[e * P + p] * xv[q] : T(0);
      }
#pragma unroll
      for (int q = 0; q < B_PER; ++q) {
        const int i = tid + q * NT;
        Bs[i / BN][i % BN] = sv[q];
      }
      __syncthreads();
      if (p + 1 < P) {
        load_s(k0, p + 1);
      } else if (k0 + BK < n) {
        load_x(k0 + BK);
        load_s(k0 + BK, 0);
      }
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        T a[TM], bb[TN];
#pragma unroll
        for (int g = 0; g < TM / 4; ++g) load4(&As[kk][g * SGM + ty * 4], a + 4 * g);
#pragma unroll
        for (int g = 0; g < TN / 4; ++g) load4(&Bs[kk][g * SGN + tx * 4], bb + 4 * g);
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] += a[i] * bb[j];
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = (i / 4) * SGM + ty * 4 + i % 4;
    const long long e = e0 + r;
    if (e >= E) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = (j / 4) * SGN + tx * 4 + j % 4;
      const int m = m0 + c;
      if (m >= n) continue;
      const long long o = e * n + m;
      T v;
      if constexpr (RES) {
        // y = A (x - s) + s * (A 1), the row sums in piece order
        T t = T(0);
#pragma unroll
        for (int p = 0; p < MAXP; ++p) t += Cs[r][p] * Rs[p][c];
        v = b[o] - (acc[i][j] + Ss[r] * t);
      } else {
        v = acc[i][j];
      }
      out[o] = mask ? mul_rn(v, T(mask[o])) : v;
    }
  }
}

template <typename T, typename TX, int BM, int BN, int BK, int TM, int TN>
void launch_tile(const TX* x, const T* coeff, const T* S, const T* b,
                 const T* rs, const bool* mask, T* out, int E, int n, int P,
                 cudaStream_t stream) {
  dim3 grid((n + BN - 1) / BN, (E + BM - 1) / BM);
  dim3 block((BM / TM) * (BN / TN));
  if (b)
    element_apply_kernel<T, TX, BM, BN, BK, TM, TN, true>
        <<<grid, block, 0, stream>>>(x, coeff, S, b, rs, mask, out, E, n, P);
  else
    element_apply_kernel<T, TX, BM, BN, BK, TM, TN, false>
        <<<grid, block, 0, stream>>>(x, coeff, S, b, rs, mask, out, E, n, P);
}

template <typename T, typename TX = T>
void launch_apply(const void* x, const void* coeff, const void* S,
                  const void* b, const void* rs, const void* mask, void* out,
                  int E, int n, int P, cudaStream_t stream) {
  const TX* xx = static_cast<const TX*>(x);
  const T* cc = static_cast<const T*>(coeff);
  const T* ss = static_cast<const T*>(S);
  const T* bb = static_cast<const T*>(b);
  const T* rr = static_cast<const T*>(rs);
  const bool* mm = static_cast<const bool*>(mask);
  T* oo = static_cast<T*>(out);
  // the 8x8 register tile is for float only: in double it needs ~2x the
  // registers and would spill
  if constexpr (sizeof(T) == 4) {
    if (n > 64) {
      launch_tile<T, TX, 128, 128, 8, 8, 8>(xx, cc, ss, bb, rr, mm, oo, E, n, P, stream);
      return;
    }
  }
  if (n > 16)
    launch_tile<T, TX, 64, 64, 8, 4, 4>(xx, cc, ss, bb, rr, mm, oo, E, n, P, stream);
  else
    launch_tile<T, TX, 128, 16, 8, 4, 4>(xx, cc, ss, bb, rr, mm, oo, E, n, P, stream);
}

}  // namespace
