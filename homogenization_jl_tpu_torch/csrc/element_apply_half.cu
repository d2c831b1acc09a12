// K16's apply: K1 (element_apply.cuh) on an x stored narrower than the
// state, the smoothers' half-width direction vectors of ``direction_dtype``
// (homogenization_jl_tpu/solver/multigrid.py:719-747 and :822-841, where
// the JAX package applies ``load(p)``, p cast up to the state dtype).
//
// Bound and design: K1's; x takes half (bfloat16, float16) or two thirds
// (float32 under float64) of its bytes. Each x value is widened exactly as
// it is staged, so the result is K1's on x cast up to the state dtype, bit
// for bit, in all three forms (the apply, the shifted residual form, the
// mask store).

#include "element_apply.cuh"

// dtype: 0 = float32, 1 = float64 (coeff, vals, b, rs, out); xtype: the
// stored type of x, 0 = float32 (under float64 only), 2 = bfloat16,
// 3 = float16. Otherwise as hz_element_apply. Returns cudaGetLastError(),
// or cudaErrorInvalidValue for a pair or table it does not take.
extern "C" int hz_element_apply_half(int dtype, int xtype, const void* x, const void* coeff,
                                     const void* words, const void* values, int R, int PP,
                                     int V, const void* b, const void* rs,
                                     const void* mask, void* out, long long E, int n, int P,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
#define HZ_HALF(T, TX)                                                                         \
  err = launch_apply<T, TX>(x, coeff, words, values, R, PP, V, b, rs, mask, out, E, n, P, s)
  if (dtype == hz::F32 && xtype == hz::BF16)
    HZ_HALF(float, __nv_bfloat16);
  else if (dtype == hz::F32 && xtype == hz::F16)
    HZ_HALF(float, __half);
  else if (dtype == hz::F64 && xtype == hz::F32)
    HZ_HALF(double, float);
  else if (dtype == hz::F64 && xtype == hz::BF16)
    HZ_HALF(double, __nv_bfloat16);
  else if (dtype == hz::F64 && xtype == hz::F16)
    HZ_HALF(double, __half);
  else
    return static_cast<int>(cudaErrorInvalidValue);
#undef HZ_HALF
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}
