"""Bytes and operations of the JAX functions whose hand kernels the
benchmark reads against the card's peaks.

Each count function takes one call's shapes (and, where the work depends on
the data, what the inputs hold) and returns ``Work(bytes, flops)``: every
operand of the JAX function read once and its output written once, and the
operations these inputs need. ``bound_seconds`` is the larger of the two
times at the card's published peaks and says which bound applies. They
count the work, never what the port's own tables add, so that a redesigned
kernel reads against the same work.
"""

from __future__ import annotations

import dataclasses

from .peaks import HBM_BYTES_PER_S, flops_per_s


@dataclasses.dataclass(frozen=True)
class Work:
    bytes: float
    flops: float


def bound_seconds(work: Work, dtype: str) -> tuple[float, str]:
    """(least seconds on the card, "bytes" or "flops": which bound it is)."""
    t_bytes = work.bytes / HBM_BYTES_PER_S
    t_flops = work.flops / flops_per_s(dtype)
    return (t_bytes, "bytes") if t_bytes >= t_flops else (t_flops, "flops")
