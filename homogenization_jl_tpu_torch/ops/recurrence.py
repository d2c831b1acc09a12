"""The multishift recurrence's device passes (device, PyTorch + CUDA kernel
K14, parts (a) and (c); part (b), the M-inner product, is
ops/integrals.py::dot_M on kernel K9).

Replaces the elementwise and basis passes of homogenization_jl_tpu/models/
multishift.py::homogenization_multishift that XLA lowers on the TPU:

  * ``jacobi_cg_step(x, r, p, Ap, d, w, num, den)`` (K14a): one step of
    the Jacobi-preconditioned mass solves (solver/cg.py:67-87 with
    ``precond = inv_diag * r``, multishift.py:173-178): alpha =
    safe_div(num, den); x += alpha p; r -= alpha Ap; z = d * r; and the
    first-copy-weighted dots rz = sum [w] r z, rs = sum [w] r r, summed in
    kernel K5's fixed order (ops/dots.py::fixed_order_sum) in the same
    launch: the bits of ``dot(r, z, w)`` and ``dot(r, r, w)`` on the updated
    r and z. Returns (z, rz, rs). As K10's
    ``cg_step`` it takes ``r_out`` (r_out = r - alpha Ap, r kept) and
    ``x_zero`` (x = 0 + alpha p, x unread): a solve from zero starts from
    r = b with no zero pass and no apply of the zero iterate.
  * ``basis_combine(V, Y)`` (K14c): out[k] = sum_j Y[k, j] V[j] for the
    coefficient rows Y [K, m] in one read of the basis V [m, ...] (the
    one-pass mode's einsum, :245), each thread a 16-byte vector of
    columns with the loads of several basis rows in flight;
  * ``basis_accumulate(sums, v, c, first)`` (K14c): sums[k] += c[k] v (or
    sums[k] = c[k] v when ``first``), the two-pass mode's accumulation
    (:257-260) in one pass over v.
Both basis forms add the terms in basis order from the first product, so
the one-pass and the two-pass modes give the same bits on the same basis.

Kernel K14 (csrc/recurrence.cu) runs for CUDA tensors, each product and sum
rounded on its own: it gives the bits of the plain forms, which run for CPU
tensors. The scalars num, den, rz, rs are 0-d device tensors: none reaches
the host here.
"""

from __future__ import annotations

import torch

from ..csrc.build import LAUNCHES, current_stream, launch
from ..utils.logging import spanned
from .cg import safe_div
from .dots import dot_plain, sum_scratch

_DTYPES = {torch.float32: 0, torch.float64: 1}
MAXK = 8  # rows of one basis_combine launch (csrc/recurrence.cu)
COMBINE_SMEM_MAX = 227 * 1024  # bytes of coefficients one launch stages


def jacobi_cg_step_plain(x, r, p, Ap, d, w, num, den, r_out=None, x_zero=False):
    """Plain form of ``jacobi_cg_step``: x and r (or ``r_out``) in place;
    (z, rz, rs)."""
    alpha = safe_div(num, den)
    x.copy_((torch.zeros_like(x) if x_zero else x) + alpha * p)
    r = (r if r_out is None else r_out).copy_(r - alpha * Ap)
    z = d * r
    return z, dot_plain(r, z, mask=w), dot_plain(r, r, mask=w)


def basis_combine_plain(V, Y):
    """Plain form of ``basis_combine``: [K, ...] in basis order."""
    out = []
    for k in range(Y.shape[0]):
        acc = Y[k, 0] * V[0]
        for j in range(1, V.shape[0]):
            acc = acc + Y[k, j] * V[j]
        out.append(acc)
    return torch.stack(out)


def basis_accumulate_plain(sums, v, c, first: bool):
    """Plain form of ``basis_accumulate``: sums in place."""
    for k in range(sums.shape[0]):
        t = c[k] * v
        sums[k].copy_(t if first else sums[k] + t)


def _check(fn, ref, tensors, scalars=()):
    dt, dev = ref.dtype, ref.device
    if dt not in _DTYPES:
        raise TypeError(f"{fn}: unsupported dtype {dt}")
    for name, t, shape in tensors:
        if t.dtype != dt or t.device != dev or tuple(t.shape) != tuple(shape):
            raise ValueError(f"{fn}: {name} must be {dt} {tuple(shape)} on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
    for name, t in scalars:
        if t.dtype != dt or t.dim() != 0 or t.device != dev:
            raise ValueError(f"{fn}: {name} must be a 0-d {dt} tensor on {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn}: unsupported device {dev}")
    return dev.type == "cuda"


@spanned("hz.op.jacobi_cg_step")
def jacobi_cg_step(x, r, p, Ap, d, w, num, den, r_out=None, x_zero=False):
    """K14a (module docstring): x and r (or ``r_out``, r then kept) updated
    in place, x unread when ``x_zero``; returns (z, rz, rs), z a new state
    and rz, rs 0-d tensors. x, r, p, Ap, d, r_out: one shape, float32 or
    float64, one device, contiguous; w: a bool tensor of that shape, or None
    (every entry counts); num, den: 0-d tensors."""
    shape = tuple(x.shape)
    named = (("x", x), ("r", r), ("p", p), ("Ap", Ap), ("d", d), ("r_out", r_out))
    tensors = [(n, t, shape) for n, t in named if t is not None]
    kern = _check("jacobi_cg_step", x, tensors, [("num", num), ("den", den)])
    if w is not None and (w.dtype != torch.bool or tuple(w.shape) != shape
                          or w.device != x.device or not w.is_contiguous()):
        raise ValueError(f"jacobi_cg_step: w must be a contiguous bool {shape} on {x.device}")
    if not kern:
        return jacobi_cg_step_plain(x, r, p, Ap, d, w, num, den, r_out, x_zero)
    z = torch.empty_like(x)
    rz = torch.empty((), dtype=x.dtype, device=x.device)
    rs = torch.empty((), dtype=x.dtype, device=x.device)
    stream = current_stream()
    LAUNCHES["jacobi_cg"] += 1
    launch("hz_jacobi_cg_step", _DTYPES[x.dtype], x.data_ptr(), r.data_ptr(), p.data_ptr(),
           Ap.data_ptr(), d.data_ptr(), None if w is None else w.data_ptr(), num.data_ptr(),
           den.data_ptr(), z.data_ptr(), sum_scratch(x.device, stream), rz.data_ptr(),
           rs.data_ptr(), None if r_out is None else r_out.data_ptr(), int(bool(x_zero)),
           x.numel(), stream=stream)
    return z, rz, rs


def basis_combine(V, Y):
    """K14c: [K, *V.shape[1:]] = sum_j Y[:, j] V[j] for V [m, ...] and Y
    [K, m] (one dtype and device, contiguous); launches of at most MAXK
    rows, and of as many as fit COMBINE_SMEM_MAX bytes of coefficients."""
    if V.dim() < 2 or Y.dim() != 2 or Y.shape[1] != V.shape[0] or Y.shape[0] < 1:
        raise ValueError(f"basis_combine: V {tuple(V.shape)}, Y {tuple(Y.shape)}")
    kern = _check("basis_combine", V, [("V", V, V.shape), ("Y", Y, Y.shape)])
    if not kern:
        return basis_combine_plain(V, Y)
    K, m = Y.shape
    rows = min(MAXK, COMBINE_SMEM_MAX // (m * V.element_size()))
    if rows < 1:
        raise ValueError(f"basis_combine: {m} basis vectors exceed one launch's coefficients")
    out = torch.empty((K,) + tuple(V.shape[1:]), dtype=V.dtype, device=V.device)
    N = V[0].numel()
    for k0 in range(0, K, rows):
        kc = min(rows, K - k0)
        LAUNCHES["basis_combine"] += 1
        launch("hz_basis_combine", _DTYPES[V.dtype], V.data_ptr(), Y[k0].data_ptr(), m,
               out[k0].data_ptr(), m, kc, N)
    return out


def basis_accumulate(sums, v, c, first: bool = False):
    """K14c: in place, sums[k] = sums[k] + c[k] * v (c[k] * v when
    ``first``: sums not read) for sums [K, *v.shape], c [K] (one dtype and
    device, contiguous)."""
    K = sums.shape[0] if sums.dim() == v.dim() + 1 else 0
    if K < 1:
        raise ValueError(f"basis_accumulate: sums {tuple(sums.shape)}, v {tuple(v.shape)}")
    kern = _check("basis_accumulate", v, [("v", v, v.shape), ("sums", sums, (K,) + tuple(v.shape)),
                                          ("c", c, (K,))])
    if not kern:
        basis_accumulate_plain(sums, v, c, first)
        return
    LAUNCHES["basis_combine"] += 1
    launch("hz_basis_accumulate", _DTYPES[v.dtype], v.data_ptr(), c.data_ptr(), 1,
           sums.data_ptr(), K, v.numel(), int(bool(first)))
