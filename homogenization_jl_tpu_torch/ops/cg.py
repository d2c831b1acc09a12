"""The CG smoothers' updates (device, PyTorch + CUDA kernel K10).

Replaces the update expressions of the JAX package's CG smoothers
(homogenization_jl_tpu/solver/multigrid.py::_smooth_cg, :779-784, and
::_smooth_cg_exact, :833-840):

    cg_step:       alpha = safe_div(num, den);  x += alpha p;  r -= alpha Ap
    cg_direction:  beta  = safe_div(num, den);  out = rc + beta p

and ``cg_step`` serves V-cycle-preconditioned CG too (the JAX ``pcg``
step, :1210-1222), where the flexible beta keeps the old residual: then
``r_out`` receives r - alpha Ap and r stays as it was. With ``x_zero`` x is
not read and receives 0 + alpha p: the first step of a smooth from a zero
iterate, whose buffer then needs no zero pass (the JAX form's zeros_like,
which XLA folds into this first use);

with safe_div(num, den) = 0 where den == 0, else num / den (the JAX
``_safe_div``). ``num`` and ``den`` are 0-d tensors on the state's device,
the outputs of ``ops/dots.py::dot`` (kernel K5): alpha and beta never reach
the host.

Kernel K10 (csrc/cg_smoother.cu, CUDA C++) runs for CUDA tensors: one pass
per update, in place, each product and sum rounded on its own, so it gives
the plain form's bits. The plain form (CPU tensors) is the JAX expression.

``cg_step_half`` / ``cg_direction_half`` (kernel K16) take the direction p
stored narrower than the state (``direction_dtype``, ops/apply.py::
NARROWER; the JAX ``_smooth_cg_exact``'s store/load, :822-841): cg_step
reads p widened, cg_direction writes ``out`` (p's storage type) rounded
from the state-type rc + beta p, or from rc alone when p is None (the first
direction, store(rc)). Their plain forms are the state-type forms on p cast
up, then the cast down: the same bits.
"""

from __future__ import annotations

import torch

from ..csrc.build import LAUNCHES, launch
from .apply import NARROWER, STORE_CODES

_DTYPES = {torch.float32: 0, torch.float64: 1}


def safe_div(num, den):
    """num / den, but 0 where den == 0 (the converged-exactly guard)."""
    zero = den == 0
    return torch.where(zero, torch.zeros_like(num), num / torch.where(zero, torch.ones_like(den), den))


def cg_step_plain(x, r, p, Ap, num, den, r_out=None, x_zero=False):
    """Plain form of ``cg_step``: x and r (or ``r_out``) updated in place."""
    alpha = safe_div(num, den)
    x.copy_((torch.zeros_like(x) if x_zero else x) + alpha * p)
    if r is not None:
        (r if r_out is None else r_out).copy_(r - alpha * Ap)


def cg_direction_plain(out, rc, p, num, den):
    """Plain form of ``cg_direction``: ``out`` written in place."""
    out.copy_(rc + safe_div(num, den) * p)


def cg_step_half_plain(x, r, p, Ap, num, den, r_out=None, x_zero=False):
    """Plain form of ``cg_step_half``: ``cg_step_plain`` on p cast up."""
    cg_step_plain(x, r, p.to(x.dtype), Ap, num, den, r_out, x_zero)


def cg_direction_half_plain(out, rc, p, num, den):
    """Plain form of ``cg_direction_half``: rc + beta p in the state dtype,
    then cast down into ``out`` (rc alone when p is None)."""
    out.copy_(rc if p is None else rc + safe_div(num, den) * p.to(rc.dtype))


def _check(fn, tensors, scalars):
    ref = tensors[0][1]
    if ref.dtype not in _DTYPES:
        raise TypeError(f"{fn}: unsupported dtype {ref.dtype}")
    for name, t in tensors:
        if t.dtype != ref.dtype or t.shape != ref.shape or t.device != ref.device:
            raise ValueError(f"{fn}: {name} does not match {tensors[0][0]}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
    for name, t in scalars:
        if t.dtype != ref.dtype or t.dim() != 0 or t.device != ref.device:
            raise ValueError(f"{fn}: {name} must be a 0-d tensor like {tensors[0][0]}")
    return ref.device


def cg_step(x, r, p, Ap, num, den, r_out=None, x_zero=False):
    """In place: alpha = safe_div(num, den); x += alpha * p; r -= alpha * Ap
    (r=None: x only), or with ``r_out`` r_out = r - alpha * Ap and r kept;
    ``x_zero``: x = 0 + alpha * p, x's old values unread.
    x, r, p, Ap, r_out: one shape, float32 or float64, one device,
    contiguous; num, den: 0-d tensors of that dtype and device. Kernel K10
    for CUDA tensors, the plain form for CPU tensors."""
    tensors = [("x", x), ("p", p)] + ([("r", r), ("Ap", Ap)] if r is not None else [])
    if r_out is not None:
        if r is None:
            raise ValueError("cg_step: r_out needs r")
        tensors.append(("r_out", r_out))
    dev = _check("cg_step", tensors, [("num", num), ("den", den)])
    if dev.type == "cpu":
        cg_step_plain(x, r, p, Ap, num, den, r_out, x_zero)
        return
    if dev.type != "cuda":
        raise ValueError(f"cg_step: unsupported device {dev}")
    LAUNCHES["cg_update"] += 1
    launch(
        "hz_cg_step", _DTYPES[x.dtype], x.data_ptr(), None if r is None else r.data_ptr(),
        p.data_ptr(), None if r is None else Ap.data_ptr(), num.data_ptr(),
        den.data_ptr(), None if r_out is None else r_out.data_ptr(), int(x_zero), x.numel(),
    )


def cg_direction(out, rc, p, num, den):
    """In place: out = rc + safe_div(num, den) * p; ``out`` may be ``rc`` or
    ``p``. Same contract as ``cg_step``."""
    dev = _check("cg_direction", [("out", out), ("rc", rc), ("p", p)], [("num", num), ("den", den)])
    if dev.type == "cpu":
        cg_direction_plain(out, rc, p, num, den)
        return
    if dev.type != "cuda":
        raise ValueError(f"cg_direction: unsupported device {dev}")
    LAUNCHES["cg_update"] += 1
    launch(
        "hz_cg_direction", _DTYPES[out.dtype], out.data_ptr(), rc.data_ptr(), p.data_ptr(),
        num.data_ptr(), den.data_ptr(), out.numel(),
    )


def _check_half(fn, state, stored):
    """The state dtype of ``state`` (a tensor) and the stored direction
    tensors ``stored`` ([(name, tensor)]): one narrower dtype, the state's
    shape and device, contiguous."""
    dt = state.dtype
    sd = stored[0][1].dtype
    if dt not in _DTYPES or sd not in NARROWER[dt]:
        raise TypeError(f"{fn}: direction dtype {sd} under a {dt} state")
    for name, t in stored:
        if t.dtype != sd or t.shape != state.shape or t.device != state.device:
            raise ValueError(f"{fn}: {name} does not match the direction's dtype, shape, device")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
    return sd


def cg_step_half(x, r, p, Ap, num, den, r_out=None, x_zero=False):
    """``cg_step`` with p stored narrower than the state (module docstring):
    x += alpha * p widened; the rest as ``cg_step``."""
    tensors = [("x", x)] + ([("r", r), ("Ap", Ap)] if r is not None else [])
    if r_out is not None:
        if r is None:
            raise ValueError("cg_step_half: r_out needs r")
        tensors.append(("r_out", r_out))
    dev = _check("cg_step_half", tensors, [("num", num), ("den", den)])
    pt = _check_half("cg_step_half", x, [("p", p)])
    if dev.type == "cpu":
        cg_step_half_plain(x, r, p, Ap, num, den, r_out, x_zero)
        return
    if dev.type != "cuda":
        raise ValueError(f"cg_step_half: unsupported device {dev}")
    LAUNCHES["direction_cg"] += 1
    launch(
        "hz_cg_step_half", _DTYPES[x.dtype], STORE_CODES[pt], x.data_ptr(),
        None if r is None else r.data_ptr(), p.data_ptr(),
        None if r is None else Ap.data_ptr(), num.data_ptr(), den.data_ptr(),
        None if r_out is None else r_out.data_ptr(), int(x_zero), x.numel(),
    )


def cg_direction_half(out, rc, p, num, den):
    """In place: out = store(rc + safe_div(num, den) * p), out and p stored
    narrower than rc (p may be ``out``), or out = store(rc) when p is None
    (module docstring)."""
    dev = _check("cg_direction_half", [("rc", rc)], [("num", num), ("den", den)])
    pt = _check_half("cg_direction_half", rc,
                     [("out", out)] + ([("p", p)] if p is not None else []))
    if dev.type == "cpu":
        cg_direction_half_plain(out, rc, p, num, den)
        return
    if dev.type != "cuda":
        raise ValueError(f"cg_direction_half: unsupported device {dev}")
    LAUNCHES["direction_cg"] += 1
    launch(
        "hz_cg_direction_half", _DTYPES[rc.dtype], STORE_CODES[pt], out.data_ptr(),
        rc.data_ptr(), None if p is None else p.data_ptr(), num.data_ptr(), den.data_ptr(),
        out.numel(),
    )
