// K1: matrix-free element apply, y[e] = sum_p coeff[e,p] * (S_p @ x[e]),
// with x stored in the state's dtype (the kernel, its bound and design:
// element_apply.cuh).

#include "element_apply.cuh"

// dtype: 0 = float32, 1 = float64. b may be NULL (plain apply) and may alias
// out (in-place r -= A x); with b, rs holds the [P, n] row sums of S and P
// is at most MAXP; mask (bool [E, n]) may be NULL; x must not alias out.
// Returns cudaGetLastError().
extern "C" int hz_element_apply(int dtype, const void* x, const void* coeff,
                                const void* S, const void* b, const void* rs,
                                const void* mask, void* out, int E, int n,
                                int P, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b && P > MAXP) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    launch_apply<float>(x, coeff, S, b, rs, mask, out, E, n, P, s);
  else
    launch_apply<double>(x, coeff, S, b, rs, mask, out, E, n, P, s);
  return static_cast<int>(cudaGetLastError());
}
