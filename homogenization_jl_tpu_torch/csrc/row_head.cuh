// The head columns [0, i0) of an element row (its interior DOFs, which no
// other element shares): out = x, times the mask when one is given, in
// 16-byte vectors where the operands allow. Shared by the interface
// combines K2 (structured_combine.cu) and K8 (gather_combine.cu), each of
// which copies a row's head with the lanes that then take its tail (K2) or
// with a warp per row (K8).

#pragma once

#include <cuda_runtime.h>

#include "fixed_sum.cuh"

namespace hz {

// head vectors of one lane whose loads go out together: 64 bytes in float32;
// two in float64, which keep its registers, and so its blocks per SM, at the
// float32 form's
template <typename T>
__host__ __device__ constexpr int head_unroll() {
  return sizeof(T) == 4 ? 4 : 2;
}

// [row, row + i0): out = x (times the mask), VW entries per load when VEC
template <typename T, bool VEC>
__device__ __forceinline__ void copy_head(const T* __restrict__ x, T* __restrict__ out,
                                          const bool* __restrict__ mask, long long row,
                                          int i0, int lane, int width) {
  constexpr int VW = 16 / sizeof(T);
  constexpr int HEAD_UNROLL = head_unroll<T>();
  long long a = row, b = row;  // the vector middle [a, b)
  if (VEC) {
    a = (row + VW - 1) / VW * VW;
    b = (row + i0) / VW * VW;
    if (a > b) a = b = row;
  }
  const long long step = (long long)width * VW;
  for (long long i = a + (long long)lane * VW; i < b; i += HEAD_UNROLL * step) {
    T v[HEAD_UNROLL][VW];
    bool mv[HEAD_UNROLL][VW];
#pragma unroll
    for (int h = 0; h < HEAD_UNROLL; ++h)
      if (i + h * step < b) {
        load_vec<VW>(x + i + h * step, v[h]);
        if (mask != nullptr) load_vec<VW>(mask + i + h * step, mv[h]);
      }
#pragma unroll
    for (int h = 0; h < HEAD_UNROLL; ++h)
      if (i + h * step < b) {
        if (mask != nullptr)
#pragma unroll
          for (int l = 0; l < VW; ++l) v[h][l] = v[h][l] * T(mv[h][l]);
        store_vec<VW>(out + i + h * step, v[h]);
      }
  }
  // entry by entry: [row, a) and [b, row + i0)
  const int lo = (int)(a - row), hi = (int)(b - row);
  for (int j = lane; j < i0 - (hi - lo); j += width) {
    const long long i = row + (j < lo ? j : j - lo + hi);
    out[i] = mask ? x[i] * T(mask[i]) : x[i];
  }
}

}  // namespace hz
