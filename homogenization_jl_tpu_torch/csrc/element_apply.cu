// K1: matrix-free element apply, y[e] = sum_p coeff[e,p] * (S_p @ x[e]),
// with x stored in the state's dtype (the kernel, its bound and design:
// element_apply.cuh).

#include "element_apply.cuh"

// dtype: 0 = float32, 1 = float64. words (int32 [n16, R + 1, 16]) and
// values (V vectors of PP = 1, 4 or 8 pieces) are the stack's table
// (ops/apply.py::stack_table: slot_words, slot_values). b
// may be NULL (plain apply) and may alias out (in-place r -= A x); with b,
// rs holds the [P, n] row sums of S; mask (bool [E, n]) may be NULL; x
// must not alias out. Returns cudaGetLastError(), or cudaErrorInvalidValue
// for a table it does not take or rows too long for one block's shared
// memory.
extern "C" int hz_element_apply(int dtype, const void* x, const void* coeff, const void* words,
                                const void* values, int R, int PP, int V, const void* b,
                                const void* rs, const void* mask, void* out, long long E, int n,
                                int P, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = dtype == 0 ? launch_apply<float>(x, coeff, words, values, R, PP, V, b, rs, mask,
                                                   out, E, n, P, s)
                             : launch_apply<double>(x, coeff, words, values, R, PP, V, b, rs,
                                                    mask, out, E, n, P, s);
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}
