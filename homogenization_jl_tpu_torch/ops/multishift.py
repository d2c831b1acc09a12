"""The per-shift update of multishift CG (device, PyTorch + CUDA kernel K13).

Replaces the tail of the loop body of homogenization_jl_tpu/solver/cg.py::
multishift_cg (:118-136): after the Lanczos step, the per-shift scalars of
the root-free LDL' factorization of the shifted tridiagonal matrix and the
shift-batched state updates,

    D_curr = t_curr + s                          (k == 0)
           = (t_curr + s) - t_prev^2 / D_prev'   (k > 0)
    y      = y / D_curr  (k == 0),   y * (-t_prev / D_curr)  (k > 0)
    W[s]   = v           (k == 0),   v - W[s] * (t_prev / D_prev')  (k > 0)
    xs[s]  = xs[s] + W[s] * y[s]

with D_prev' = where(D_prev == 0, 1, D_prev). ``t_curr``, ``t_prev`` are
0-d device tensors, ``shifts``, ``D_prev``, ``y_prev`` [n_shifts] device
tensors: no scalar reaches the host. W and xs ([n_shifts, ...]) are updated
in place; at k == 0 neither is read (W = v, xs = 0 + W y: the JAX form's
broadcast start and zero xs), so both may come from ``torch.empty``.

Kernel K13 (csrc/multishift.cu) runs for CUDA tensors: a one-block launch
for the scalars, then one pass that reads v once for every shift, each
product, sum and quotient rounded on its own, so it gives the bits of the
plain form (the JAX expressions in PyTorch), which runs for CPU tensors.
"""

from __future__ import annotations

import torch

from ..csrc.build import LAUNCHES, launch

_DTYPES = {torch.float32: 0, torch.float64: 1}
MAX_SHIFTS = 32  # csrc/multishift.cu


def shift_scalars_plain(shifts, t_curr, t_prev, D_prev, y_prev, first: bool):
    """(D_curr, y_curr, coef) of one step: the JAX scalar recurrence, with
    coef = t_prev / D_prev' the W coefficient."""
    dps = torch.where(D_prev == 0, torch.ones_like(D_prev), D_prev)
    base = t_curr + shifts
    if first:
        D = base
        y = y_prev / D
    else:
        D = base - (t_prev * t_prev) / dps
        y = y_prev * (-t_prev / D)
    return D, y, t_prev / dps


def multishift_step_plain(v, W, xs, shifts, t_curr, t_prev, D_prev, y_prev, first: bool):
    """Plain form of ``multishift_step``: W and xs updated in place; returns
    (D_curr, y_curr)."""
    D, y, coef = shift_scalars_plain(shifts, t_curr, t_prev, D_prev, y_prev, first)
    dims = (-1,) + (1,) * v.dim()
    if first:
        W.copy_(v.expand_as(W))
        xs.copy_(torch.zeros_like(xs) + W * y.reshape(dims))
    else:
        W.copy_(v.unsqueeze(0) - W * coef.reshape(dims))
        xs.copy_(xs + W * y.reshape(dims))
    return D, y


def _check(v, W, xs, shifts, t_curr, t_prev, D_prev, y_prev):
    dt, dev = v.dtype, v.device
    if dt not in _DTYPES:
        raise TypeError(f"multishift_step: unsupported dtype {dt}")
    ns = shifts.shape[0] if shifts.dim() == 1 else -1
    if not 1 <= ns <= MAX_SHIFTS:
        raise ValueError(f"multishift_step: shifts must be [n_shifts], 1 <= n_shifts <= {MAX_SHIFTS}")
    for name, t, shape in (("W", W, (ns,) + tuple(v.shape)), ("xs", xs, (ns,) + tuple(v.shape)),
                           ("shifts", shifts, (ns,)), ("D_prev", D_prev, (ns,)),
                           ("y_prev", y_prev, (ns,)), ("t_curr", t_curr, ()),
                           ("t_prev", t_prev, ())):
        if t.dtype != dt or t.device != dev or tuple(t.shape) != shape:
            raise ValueError(f"multishift_step: {name} must be {dt} {shape} on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"multishift_step: {name} must be contiguous")
    if not v.is_contiguous():
        raise ValueError("multishift_step: v must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"multishift_step: unsupported device {dev}")
    return ns


def multishift_step(v, W, xs, shifts, t_curr, t_prev, D_prev, y_prev, first: bool):
    """One K13 step (module docstring): W and xs in place; returns new
    tensors (D_curr, y_curr), so D_prev and y_prev are never overwritten
    (the kernel's scalar launch writes what its second launch reads). v:
    the current Lanczos vector; W, xs: [n_shifts, *v.shape]; one dtype
    (float32/float64) and device, contiguous. Kernel K13 for CUDA tensors,
    the plain form for CPU tensors."""
    ns = _check(v, W, xs, shifts, t_curr, t_prev, D_prev, y_prev)
    if v.device.type == "cpu":
        return multishift_step_plain(v, W, xs, shifts, t_curr, t_prev, D_prev, y_prev, first)
    D = torch.empty_like(D_prev)
    y = torch.empty_like(y_prev)
    coef = torch.empty_like(D_prev)
    LAUNCHES["multishift_update"] += 1
    launch("hz_multishift_step", _DTYPES[v.dtype], v.data_ptr(), W.data_ptr(), xs.data_ptr(),
           shifts.data_ptr(), t_curr.data_ptr(), t_prev.data_ptr(), D_prev.data_ptr(),
           y_prev.data_ptr(), D.data_ptr(), y.data_ptr(), coef.data_ptr(), ns, v.numel(),
           int(bool(first)))
    return D, y
