// K9's block layout (integrals.cu): a block of G consecutive elements whose
// x rows sit in dynamic shared memory, and the row table of a reference
// stack's nonzeros (ops/apply.py::StackTable: cols [n, R], vals [n, R, PP],
// counts [n]) read through L1. ``stage_rows``, ``row_products``, the warp
// items and ``rows_layout`` serve K9 only; K1 (element_apply.cuh), whose
// first design they were, now runs its own pipeline and takes from here the
// block shape (ROW_*) and ``allow_smem``.
//
// The G elements are cut into chunks of GC. A lane takes one output row m
// of one chunk at a time and walks row m's real slots once for the GC
// elements of its chunk: each slot's column and its PP values are one
// load, used GC times per piece. The lanes of a warp take 32 / CW
// neighbouring rows of CW chunks (lane = row * CW + chunk, a "warp item"),
// so the CW lanes on one row load the same slot (one transaction for all
// of them), a table load from L2 serves CW * GC elements, and the warp's
// loads and stores of [E, n] rows are runs of 32 / CW values. Chunk c's
// rows start at c * CS in shared memory, with CS padded so that the CW
// chunks of a warp start on banks 32 / CW apart.
//
// G is set on the host: as many chunk groups of CW chunks as the shared
// memory holds (one block per SM), but no more than leaves every SM a few
// blocks.

#pragma once

#include <cuda_runtime.h>

#include "widen.cuh"

namespace hz {

constexpr int ROW_WARPS = 16;
constexpr int ROW_THREADS = ROW_WARPS * 32;
// dynamic shared memory of one block (one block per SM)
constexpr int ROW_SMEM = 227 * 1024;
constexpr int MIN_BLOCKS = 2 * 132;

struct RowsLayout {
  int G;       // elements per block (a multiple of CW * GC)
  int CS;      // chunk stride in values
  int smem;    // dynamic shared memory bytes (0: one chunk group does not fit)
  int blocks;  // grid size
};

// cw: chunks per warp; gc: elements per chunk; vb: bytes per value;
// per_chunk: the bytes a chunk needs beside its x rows (coefficients,
// shifts, partials)
inline RowsLayout rows_layout(long long E, int n, int cw, int gc, int vb, int per_chunk) {
  RowsLayout L;
  // the chunk stride, in 4-byte words, 32 / cw modulo 32
  L.CS = gc * n;
  while ((L.CS * vb / 4) % 32 != 32 / cw) ++L.CS;
  const int group = cw * (L.CS * vb + per_chunk);
  const long long groups_total = (E + cw * gc - 1) / (cw * gc);
  int ng = ROW_SMEM / group;
  const long long cap = (groups_total + MIN_BLOCKS - 1) / MIN_BLOCKS;
  if (ng > cap) ng = static_cast<int>(cap);
  if (ng < 1) ng = 1;
  L.G = ng * cw * gc;
  L.smem = ng * group <= ROW_SMEM ? ng * group : 0;
  L.blocks = static_cast<int>((E + L.G - 1) / L.G);
  return L;
}

// the x rows of elements [e0, e0 + G) into xs in chunk layout, widened to T
// (and, with a shift, minus ss[g]; ss must be in place before); rows past
// the last element are zeros. The block's rows are one contiguous run: read
// with 16-byte loads when it is aligned, STAGE_UNROLL of them in flight per
// thread.
constexpr int STAGE_UNROLL = 4;

// i / n without an integer division (i < 2^24: the float quotient is off
// by one at most)
__device__ __forceinline__ void div_n(int i, int n, float inv_n, int& g, int& k) {
  g = __float2int_rz(static_cast<float>(i) * inv_n);
  k = i - g * n;
  if (k < 0) {
    --g;
    k += n;
  } else if (k >= n) {
    ++g;
    k -= n;
  }
}

template <typename T, typename TX, int GC>
__device__ __forceinline__ void stage_rows(const TX* __restrict__ x, long long e0, int Gb,
                                           int G, int n, int CS, const T* ss, T* xs) {
  constexpr int V = 16 / sizeof(TX);  // values per 16-byte load
  const TX* xb = x + e0 * n;
  const int total = G * n;
  const int limit = Gb * n;
  const float inv_n = 1.0f / static_cast<float>(n);
  auto put = [&](int g, int k, T t) { xs[(g / GC) * CS + (g % GC) * n + k] = t; };
  const int nvec = reinterpret_cast<unsigned long long>(xb) % 16 == 0 ? limit / V : 0;
  for (int q0 = threadIdx.x; q0 < nvec; q0 += STAGE_UNROLL * blockDim.x) {
    uint4 buf[STAGE_UNROLL];
#pragma unroll
    for (int u = 0; u < STAGE_UNROLL; ++u) {
      const int q = q0 + u * blockDim.x;
      if (q < nvec) buf[u] = __ldg(reinterpret_cast<const uint4*>(xb) + q);
    }
#pragma unroll
    for (int u = 0; u < STAGE_UNROLL; ++u) {
      const int q = q0 + u * blockDim.x;
      if (q < nvec) {
        const TX* v = reinterpret_cast<const TX*>(&buf[u]);
        int g, k;
        div_n(q * V, n, inv_n, g, k);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          T t = T(widen(v[j]));
          if (ss) t -= ss[g];
          put(g, k, t);
          if (++k == n) {
            k = 0;
            ++g;
          }
        }
      }
    }
  }
  // the rest (an unaligned run, the last element's tail, the zero rows)
  for (int i = nvec * V + threadIdx.x; i < total; i += blockDim.x) {
    int g, k;
    div_n(i, n, inv_n, g, k);
    T t = T(0);
    if (i < limit) {
      t = T(widen(xb[i]));
      if (ss) t -= ss[g];
    }
    put(g, k, t);
  }
}

// the warp items of a block of nch chunks (a multiple of CW), and item W's
// row m and chunk c for this lane (false past the last row)
template <int CW>
__host__ __device__ inline int warp_items(int n, int nch) {
  constexpr int RW = 32 / CW;
  return (nch / CW) * ((n + RW - 1) / RW);
}

template <int CW>
__device__ __forceinline__ bool item_of(int W, int n, int nch, int lane, int& c, int& m) {
  constexpr int RW = 32 / CW;
  const int ncg = nch / CW;
  c = (W % ncg) * CW + lane % CW;
  m = (W / ncg) * RW + lane / CW;
  return m < n;
}

// one table slot's PP piece values (one or two vector loads for PP = 4, 8)
template <int PP>
__device__ __forceinline__ void load_slot(const float* __restrict__ v, float* o) {
  if constexpr (PP == 1) {
    o[0] = __ldg(v);
  } else {
#pragma unroll
    for (int q = 0; q < PP / 4; ++q) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(v) + q);
      o[4 * q] = a.x;
      o[4 * q + 1] = a.y;
      o[4 * q + 2] = a.z;
      o[4 * q + 3] = a.w;
    }
  }
}

template <int PP>
__device__ __forceinline__ void load_slot(const double* __restrict__ v, double* o) {
  if constexpr (PP == 1) {
    o[0] = __ldg(v);
  } else {
#pragma unroll
    for (int q = 0; q < PP / 2; ++q) {
      const double2 a = __ldg(reinterpret_cast<const double2*>(v) + q);
      o[2 * q] = a.x;
      o[2 * q + 1] = a.y;
    }
  }
}

// the lines of [p, p + bytes) into L1, the CW lanes of a row taking every
// CW-th line (cl: this lane's chunk slot)
template <int CW>
__device__ __forceinline__ void prefetch_lines(const void* p, int bytes, int cl) {
  const unsigned long long a = reinterpret_cast<unsigned long long>(p);
  const unsigned long long first = a & ~127ull;
  const int lines = static_cast<int>(((a + bytes - 1) & ~127ull) - first) / 128 + 1;
  for (int i = cl; i < lines; i += CW)
    asm volatile("prefetch.global.L1 [%0];" ::"l"(first + 128ull * i));
}

// row m's first cnt table slots (cm = cols + m * R, vm = vals + m * R * PP)
// into L1 before they are walked: one L2 round trip per row instead of one
// per slot
template <typename T, int PP, int CW>
__device__ __forceinline__ void prefetch_row(const int* cm, const T* vm, int cnt, int cl) {
  if (cnt < 1) return;
  prefetch_lines<CW>(vm, cnt * PP * static_cast<int>(sizeof(T)), cl);
  prefetch_lines<CW>(cm, cnt * 4, cl);
}

// acc[j][p] = sum over row m's first cnt slots k of vals[m, k, p] *
// xc[j * n + cols[m, k]], p < NP (the pieces in use of the PP a slot holds),
// for the GC elements j of one chunk (cm = cols + m * R, vm = vals + m * R *
// PP; xc: the chunk's rows), slots in order; the next slot's loads are
// issued before the current slot's math
template <typename T, int PP, int NP, int GC>
__device__ __forceinline__ void row_products(const int* __restrict__ cm, const T* __restrict__ vm,
                                             int cnt, const T* xc, int n, T (&acc)[GC][NP]) {
#pragma unroll
  for (int j = 0; j < GC; ++j)
#pragma unroll
    for (int p = 0; p < NP; ++p) acc[j][p] = T(0);
  int col = __ldg(cm);
  T v[PP];
  load_slot<PP>(vm, v);
  for (int k = 0; k < cnt; ++k) {
    const int c = col;
    T w[NP];
#pragma unroll
    for (int p = 0; p < NP; ++p) w[p] = v[p];
    if (k + 1 < cnt) {
      col = __ldg(cm + k + 1);
      load_slot<PP>(vm + (k + 1) * PP, v);
    }
#pragma unroll
    for (int j = 0; j < GC; ++j) {
      const T xv = xc[j * n + c];
#pragma unroll
      for (int p = 0; p < NP; ++p) acc[j][p] += w[p] * xv;
    }
  }
}

// set the kernel's dynamic shared memory limit once (above 48 KB a launch
// needs it)
template <typename K>
inline void allow_smem(K kernel) {
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, ROW_SMEM);
}

}  // namespace hz
