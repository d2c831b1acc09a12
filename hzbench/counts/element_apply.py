"""``element_apply`` (homogenization_jl_tpu/ops/apply.py:28), y[e] =
sum_p coeff[e, p] stack[p] x[e], and the residual b - y that the solver
forms from it (its kernel, K1, fuses the two).

Operands: x [E, n], coeff [E, P], stack [P, n, n] (dense, as the JAX
function takes it), b [E, n] for the residual, the bool mask [E, n] where
the constraint is applied to the result (``apply_mask``); output [E, n].
Operations: a multiply and an add per nonzero of each stack slice and
element, and per piece and entry the scale by coeff and the add into y
(the dense product's zeros need no work); one subtraction per entry for
the residual.
"""

from __future__ import annotations

from . import Work


def work(E, n, P, itemsize, x_itemsize=None, residual=False, mask=False, stack_nnz=None):
    """One call. ``stack_nnz``: the nonzeros of the [P, n, n] stack, summed
    over its slices (None counts the dense product's, an upper bound)."""
    x_itemsize = itemsize if x_itemsize is None else x_itemsize
    vec = E * n
    nbytes = (vec * x_itemsize + E * P * itemsize + P * n * n * itemsize
              + vec * itemsize * (2 if residual else 1) + (vec if mask else 0))
    nnz = P * n * n if stack_nnz is None else stack_nnz
    flops = 2.0 * E * nnz + 2.0 * E * P * n + (vec if residual else 0)
    return Work(float(nbytes), float(flops))


def describe(x, coeff, stack, b=None, out=None, rowsum=None, mask=None, table=None):
    """A call's summary for ``work`` (the stack is kept to count its
    nonzeros after the window)."""
    return dict(E=x.shape[0], n=x.shape[1], P=stack.shape[0], itemsize=coeff.element_size(),
                x_itemsize=x.element_size(), residual=b is not None, mask=mask is not None,
                stack=stack)


def resolve(desc, cache):
    """``work``'s arguments from a summary: the stack's nonzeros counted
    once per stack."""
    d = dict(desc)
    stack = d.pop("stack")
    key = (stack.data_ptr(), tuple(stack.shape))
    if key not in cache:
        import torch

        cache[key] = int(torch.count_nonzero(stack))
    d["stack_nnz"] = cache[key]
    return d
