"""The Jacobi-preconditioned CG step of the multishift recurrence's mass
solves (homogenization_jl_tpu/models/multishift.py:174, the JAX ``cg``
iteration with ``precond=lambda r: inv_diag_M * r``): x += alpha p,
r -= alpha Ap, z = d r, and the masked dots <r, z> and <r, r>.

Operands: x (unread on a first step that writes it), r, p, Ap, d [N], the
bool mask w [N] of the dots; outputs x, r, z [N] (two scalars). Operations:
9 per entry (two updates, the scale, two dots).
"""

from __future__ import annotations

from . import Work


def work(N, itemsize, x_zero=False, mask=True):
    reads = (4 if x_zero else 5) * N * itemsize + (N if mask else 0)
    return Work(float(reads + 3 * N * itemsize), 9.0 * N)


def describe(x, r, p, Ap, d, w, num, den, r_out=None, x_zero=False):
    """A ``jacobi_cg_step`` call's summary for ``work``."""
    return dict(N=x.numel(), itemsize=x.element_size(), x_zero=bool(x_zero),
                mask=w is not None)


def resolve(desc, cache):
    return desc
