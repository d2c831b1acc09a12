"""The mixed-precision boundary of iterative-refinement PCG (device,
PyTorch + CUDA kernel K15).

Replaces the casts of homogenization_jl_tpu/solver/multigrid.py::
_mixed_pcg_impls's preconditioner (:1612-1623), which XLA fuses into
passes on the TPU:

  * ``downcast_scale(c, s)``: ``c.to(float32) * s``, the float64 residual
    at the assembled scale (``combine(r)``) cast down and split back over
    its copies by the float32 ``s`` = 1/multiplicity; with ``s`` None the
    cast alone (the multiplicity table of ``mixed_precision_setup``,
    :1587-1598, once per setup);
  * ``upcast(z)``: ``z.to(float64)``, the float32 V-cycle's correction.

Kernel K15 (csrc/mixed_boundary.cu) runs for CUDA tensors, in 16-byte
vectors (entry by entry when an operand is a view whose address is not
16-byte aligned): it gives the bits of the plain form (PyTorch's ``.to()``
and a multiply), which runs for CPU tensors. It follows whichever combine
the outer solver uses (K2, K8 or K11). Each call runs inside the span
``hz.op.downcast_scale`` or ``hz.op.upcast`` (utils/logging.py), which the
benchmark's K15 roofline reads.
"""

from __future__ import annotations

import torch

from ..csrc.build import LAUNCHES, launch
from ..utils.logging import span


def downcast_scale_plain(c, s=None):
    y = c.to(torch.float32)
    return y if s is None else y * s


def upcast_plain(z):
    return z.to(torch.float64)


def _check(fn, t, dtype, ref=None):
    if not isinstance(t, torch.Tensor) or t.dtype != dtype:
        raise TypeError(f"{fn}: expected a {dtype} tensor, got {getattr(t, 'dtype', type(t))}")
    if ref is not None and (t.shape != ref.shape or t.device != ref.device):
        raise ValueError(f"{fn}: shape {tuple(t.shape)} on {t.device}, expected "
                         f"{tuple(ref.shape)} on {ref.device}")
    if not t.is_contiguous():
        raise ValueError(f"{fn}: operands must be contiguous")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn}: unsupported device {t.device}")
    return t.device.type == "cuda"


def downcast_scale(c, s=None):
    """float32(c) * s (float32(c) when ``s`` is None): c float64, s float32
    of c's shape and device, both contiguous. K15 for CUDA tensors, the
    plain form for CPU tensors."""
    kern = _check("downcast_scale", c, torch.float64)
    if s is not None:
        _check("downcast_scale", s, torch.float32, c)
    with span("hz.op.downcast_scale"):
        if not kern:
            return downcast_scale_plain(c, s)
        out = torch.empty(c.shape, dtype=torch.float32, device=c.device)
        LAUNCHES["mixed_boundary"] += 1
        launch("hz_downcast_scale", c.data_ptr(), None if s is None else s.data_ptr(),
               out.data_ptr(), c.numel())
        return out


def upcast(z):
    """float64(z) of a contiguous float32 z. K15 for CUDA tensors, the plain
    form for CPU tensors."""
    kern = _check("upcast", z, torch.float32)
    with span("hz.op.upcast"):
        if not kern:
            return upcast_plain(z)
        out = torch.empty(z.shape, dtype=torch.float64, device=z.device)
        LAUNCHES["mixed_boundary"] += 1
        launch("hz_upcast", z.data_ptr(), out.data_ptr(), z.numel())
        return out
