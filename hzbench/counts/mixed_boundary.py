"""The casts at mixed-precision PCG's boundary
(homogenization_jl_tpu/solver/multigrid.py:1612-1623, kernel K15 in the
port): ``downcast_scale``, c [N] float64 cast to float32 and multiplied by
the float32 s [N] (the cast alone where s is None), and ``upcast``, z [N]
float32 cast to float64.

Operands read once and the output written once: downcast_scale 8 + 4 + 4
bytes an entry (8 + 4 without s), upcast 4 + 8; one float32 multiply an
entry where s is given.
"""

from __future__ import annotations

from . import Work

_BYTES = {"downcast_scale": 16, "downcast": 12, "upcast": 12}


def work(N, kind, itemsize=4):
    """One call over N entries; ``kind`` is "downcast_scale", "downcast" or
    "upcast". ``itemsize`` 4: the multiply is float32's."""
    return Work(float(_BYTES[kind] * N), float(N if kind == "downcast_scale" else 0))


def describe(c, s=None):
    """A ``downcast_scale(c, s)`` call's summary for ``work``."""
    return dict(N=c.numel(), kind="downcast" if s is None else "downcast_scale", itemsize=4)


def describe_upcast(z):
    """An ``upcast(z)`` call's summary for ``work``."""
    return dict(N=z.numel(), kind="upcast", itemsize=4)


def resolve(desc, cache):
    return dict(desc)
