"""``combine_structured`` (homogenization_jl_tpu/ops/structured.py:622,
with ``constrain=True`` the zero-Dirichlet fold) and
``constrain_structured`` (:1159): every copy of a shared fine DOF gets the
sum of its copies, boundary DOFs zero.

Operands: x [E, n]; the bool mask [E, n] where the constraint is a mask
(``apply_mask`` of the combined result); output [E, n]. The lattice layout
is static (no index table is an operand). Operations: at most one add per
entry.
"""

from __future__ import annotations

from . import Work


def work(E, n, itemsize, mask=False):
    vec = E * n
    return Work(float(2 * vec * itemsize + (vec if mask else 0)), float(vec))


def describe(x, st, constrain=False, mask=None):
    """A ``combine_structured`` call's summary for ``work``."""
    return dict(E=x.shape[0], n=x.shape[1], itemsize=x.element_size(), mask=mask is not None)


def describe_constrain(x, st):
    """A ``constrain_structured`` call's summary for ``work``."""
    return dict(E=x.shape[0], n=x.shape[1], itemsize=x.element_size(), mask=False)


def resolve(desc, cache):
    return desc
