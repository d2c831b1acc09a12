// Conversions between a state's dtype and a narrower storage dtype, shared
// by the kernels that read or write a half-width operand (K16: the
// smoothers' direction vectors stored in bfloat16, float16 or, under a
// float64 state, float32; K15: the mixed-precision boundary).
//
// widen(v) converts a stored value to float (double stays double): exact
// for every narrower type, so a kernel that widens on load computes what
// it computes on the widened tensor.
// narrow<TD>(v) rounds a state value to the storage type TD to nearest
// even, as PyTorch's ``.to()`` does: a double goes through float first
// (c10::BFloat16 and c10::Half are built from a float), so the kernels
// round twice there, as the plain forms do.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace hz {

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ double widen(double v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float widen(__half v) { return __half2float(v); }

template <typename TD>
__device__ __forceinline__ TD narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half narrow<__half>(float v) { return __float2half_rn(v); }

template <typename TD>
__device__ __forceinline__ TD narrow(double v) {
  return narrow<TD>(__double2float_rn(v));
}
template <>
__device__ __forceinline__ double narrow<double>(double v) { return v; }

// the storage codes of the C entries' ``dtype`` arguments
enum StoreType { F32 = 0, F64 = 1, BF16 = 2, F16 = 3 };

}  // namespace hz
