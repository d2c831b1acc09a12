"""The sigma integrals of the checkerboard driver (device, PyTorch + CUDA
kernel K9).

Port of homogenization_jl_tpu/models/checkerboard.py::_integrals_fns
(reference: homogenized_coefficients.jl:592-713). With the finest reference
mass matrix M [n, n] (symmetric: the last slice of the finest operator
stack), the per-element |det J| and a 0/1 element mask, each integral is a
masked sum over element rows:

  * ``area(mask)``           = sum(M) * sum_e detJ_e mask_e;
  * ``first_term(x, b0, m)`` = sum_e m_e detJ_e sum_i x (b0 + M x)   (quirk)
                             or sum_e m_e (sum_i x b0 + detJ_e sum_i x M x);
  * ``terms(x, v_prev, m)``  = sum_e m_e detJ_e sum_i (x + v_prev) M x;
  * ``next_rhs(x, lam)``     = lam detJ_e (M x)[e], kernel K1 with the
    one-piece stack [M] and the coefficient lam * detJ.

``sigma_integral`` computes the first three, and ``dot_M(u, v)`` =
sum_e detJ_e u_e . (M v_e), the M-inner product of the multishift
recurrence (homogenization_jl_tpu/models/multishift.py:152-155; kernel
K14b: K9's mode DOT_M, unmasked, the mass apply never written): kernel K9
(csrc/integrals.cu) for CUDA tensors, the plain form for CPU tensors.
The kernel forms M x over the nonzeros of M (12.5 per row at n = 969),
from the row table of the one-piece stack [M] (ops/apply.py::stack_table),
which CUDA calls must pass (``table=``; ``integrals_fns`` builds it once).
It writes one partial per element row and sums them in the port's fixed
order, K5's (ops/dots.py::fixed_order_sum, csrc/fixed_sum.cuh), in one
launch. The plain form is the JAX expression with the sum over elements
taken in that order; only the row sums, which the kernel takes over its
threads' rows, round differently (``area``, which has none, gives the plain
form's bits).

``reference_quirk``: the reference's integrate_first_term multiplies the
b0 part, which already carries detJ, by detJ again. On unit cells (every
detJ == 1) both forms agree and the quirk form is the reference's bit for
bit; otherwise the quirk is wrong. None picks the quirk form exactly when
every detJ == 1, as the JAX package does (ROADMAP.md, section 3).

On a slab of the slab-sharded solver (``group``, parallel/group.py) each
integral is the rank's K9 partial over its rows, then ``SlabGroup.sum``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..csrc.build import LAUNCHES, current_stream, launch
from .apply import check_table, element_apply, stack_table
from .dots import fixed_order_sum, sum_scratch

_DTYPES = {torch.float32: 0, torch.float64: 1}

TERMS, FIRST_QUIRK, FIRST, AREA, DOT_M = 0, 1, 2, 3, 4


def sigma_integral_plain(mode, x, mass, w, detJ, mask, scale=1.0):
    """Plain form of ``sigma_integral`` (the JAX expressions)."""
    if mode == AREA:
        s = detJ
    else:
        Mx = torch.matmul(x, mass.T)
        u = x + w if mode == TERMS else (w if mode == DOT_M else x)
        a = (u * Mx).sum(dim=1)
        if mode in (TERMS, DOT_M):
            s = detJ * a
        else:
            b = (x * w).sum(dim=1)
            s = detJ * (a + b) if mode == FIRST_QUIRK else b + detJ * a
    return scale * fixed_order_sum(s if mask is None else s * mask)


def _check(name, t, dtype, device, shape):
    if t.dtype != dtype:
        raise TypeError(f"sigma_integral: {name} dtype {t.dtype}, expected {dtype}")
    if t.device != device:
        raise ValueError(f"sigma_integral: {name} on {t.device}, expected {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"sigma_integral: {name} shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"sigma_integral: {name} must be contiguous")


def sigma_integral(mode, x, mass, w, detJ, mask, scale=1.0, table=None):
    """One of the driver's integrals as a 0-d tensor: ``mode`` TERMS (w =
    v_prev), FIRST_QUIRK / FIRST (w = b0), AREA (x, mass, w unused: pass
    None) or DOT_M (sum_e detJ_e w_e . (M x_e)). x, w: [E, n]; mass: [n, n]
    symmetric; detJ, mask: [E] (mask None: every row counts); one dtype
    (float32/float64) and device. ``table``: ``stack_table(mass[None])``,
    which CUDA calls need (but AREA). Kernel K9 for CUDA tensors, the plain
    form for CPU tensors."""
    if mode not in (TERMS, FIRST_QUIRK, FIRST, AREA, DOT_M):
        raise ValueError(f"sigma_integral: unknown mode {mode}")
    dtype, dev = detJ.dtype, detJ.device
    if dtype not in _DTYPES:
        raise TypeError(f"sigma_integral: unsupported dtype {dtype}")
    E = detJ.shape[0]
    _check("detJ", detJ, dtype, dev, (E,))
    if mask is not None:
        _check("mask", mask, dtype, dev, (E,))
    n = 0
    if mode != AREA:
        n = x.shape[1] if x.dim() == 2 else -1
        _check("x", x, dtype, dev, (E, n))
        _check("w", w, dtype, dev, (E, n))
        _check("mass", mass, dtype, dev, (n, n))
    if dev.type == "cpu":
        return sigma_integral_plain(mode, x, mass, w, detJ, mask, scale)
    if dev.type != "cuda":
        raise ValueError(f"sigma_integral: unsupported device {dev}")
    if mode != AREA:
        check_table("sigma_integral", table, n, 1, dtype, dev)
    part_a = torch.empty(E, dtype=dtype, device=dev) if mode != AREA else None
    part_b = torch.empty(E, dtype=dtype, device=dev) if mode in (FIRST_QUIRK, FIRST) else None
    out = torch.empty((), dtype=dtype, device=dev)
    stream = current_stream()

    def ptr(t):
        return None if t is None else t.data_ptr()

    tab = (None, None, None) if mode == AREA else (table.cols, table.vals, table.counts)
    R = 0 if mode == AREA else table.width
    LAUNCHES["mass_dot" if mode == DOT_M else "integrals"] += 1
    launch(
        "hz_integrals", _DTYPES[dtype], mode, ptr(x), *(ptr(t) for t in tab), R, ptr(w),
        detJ.data_ptr(), ptr(mask), ptr(part_a), ptr(part_b), sum_scratch(dev, stream),
        out.data_ptr(), E, n, float(scale), stream=stream,
    )
    return out


def dot_M(u, v, mass, detJ, table=None):
    """sum_e detJ_e u_e . (M v_e) as a 0-d tensor (kernel K14b: K9's mode
    DOT_M for CUDA tensors, the plain form for CPU tensors). u, v: [E, n];
    mass: [n, n] symmetric; detJ: [E]; ``table``: ``stack_table(mass[None])``
    (CUDA calls need it)."""
    return sigma_integral(DOT_M, v, mass, u, detJ, None, table=table)


def integrals_fns(mass, detJ, reference_quirk: bool | None = None, group=None):
    """(area, first_term, terms, next_rhs), closed over the finest reference
    mass matrix ``mass`` [n, n] and the per-element |det J| ``detJ`` [E]
    (tensors of one dtype and device; the mass matrix's row table is built
    here, once); see the module docstring. With a ``group`` (a SlabGroup),
    ``detJ`` and the states are the rank's rows and the three integrals are
    summed over the ranks; pass ``reference_quirk`` then, decided on the
    whole base."""
    mass = mass.contiguous()
    detJ = detJ.contiguous()
    # the JAX form sums the mass matrix in the state dtype
    mass_total = float(mass.sum())
    if reference_quirk is None:
        reference_quirk = bool(np.allclose(detJ.cpu().numpy(), 1.0))
    first_mode = FIRST_QUIRK if reference_quirk else FIRST
    stack = mass[None]
    table = stack_table(stack)
    total = (lambda t: t) if group is None else group.sum

    def area(mask):
        return total(sigma_integral(AREA, None, None, None, detJ, mask, scale=mass_total))

    def first_term(x, b0, mask):
        return total(sigma_integral(first_mode, x, mass, b0, detJ, mask, table=table))

    def terms(x, v_prev, mask):
        return total(sigma_integral(TERMS, x, mass, v_prev, detJ, mask, table=table))

    def next_rhs(x, lam):
        return element_apply(x, (lam * detJ)[:, None].contiguous(), stack, table=table)

    return area, first_term, terms, next_rhs
