"""Fused Chebyshev smoother update (device, PyTorch + Triton kernel K3).

Replaces the update steps of the JAX package's Jacobi-preconditioned
Chebyshev smoother (homogenization_jl_tpu/solver/multigrid.py:727-747,
inside ``_smooth_chebyshev``):

    z = dinv * rc;   p = a * p + b * z;   x = x + p

with ``rc`` the combined, constrained local residual. The first step of a
smooth has no previous direction: p = b * z (``first=True``; p is then
written, never read). From a zero iterate (``x_zero=True``) x is written
0 + p and never read, so its buffer needs no zero pass (the JAX form's
zeros_like, which XLA folds into this first use).

Kernel K3 (Triton, CUDA tensors): one fused elementwise pass — it reads
dinv, rc, p and x and writes p and x, so z never reaches device memory.
Bound on the H100: memory bandwidth (no reuse, 2 flops per byte pair); a
block of 1024 contiguous elements per program keeps the loads coalesced and
wide. The scalars (a, b) are read from a 2-element device tensor of the
state's dtype, so float64 runs keep float64 coefficients and no host value
is needed at launch. p and x are updated in place (the JAX form allocates
new arrays; in place saves two state-sized buffers).

``chebyshev_update_half`` (kernel K16, Triton): p stored narrower than the
state (``direction_dtype``: the JAX smoother's ``p = store(a load(p) + b
z)``, ``x = x + load(p)``, :727-747): p is widened as it is loaded, the
new direction computed in the state dtype and rounded to p's type at the
store (to nearest even; from float64 through float32, as PyTorch's
``.to()``), and x adds the ROUNDED p, as the JAX form does. Each product
and sum is rounded on its own (``enable_fp_fusion=False``: no FMA
contraction), so the kernel gives the bits of its plain form.
"""

from __future__ import annotations

import torch

from ..csrc.build import LAUNCHES

_KERNEL = None
_KERNEL_HALF = None
_BLOCK = 1024


def chebyshev_update_plain(x, p, rc, dinv, ab, first: bool, x_zero: bool = False):
    """Plain PyTorch form; updates p and x in place."""
    z = dinv * rc
    if first:
        p.copy_(ab[1] * z)
    else:
        p.copy_(ab[0] * p + ab[1] * z)
    x.copy_((torch.zeros_like(x) if x_zero else x) + p)


def _kernel():
    global _KERNEL
    if _KERNEL is None:
        import triton
        import triton.language as tl

        @triton.jit
        def cheb_update(x_ptr, p_ptr, rc_ptr, dinv_ptr, ab_ptr, N,
                        FIRST: tl.constexpr, X_ZERO: tl.constexpr, BLOCK: tl.constexpr):
            pid = tl.program_id(0)
            offs = pid.to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
            m = offs < N
            b = tl.load(ab_ptr + 1)
            z = tl.load(dinv_ptr + offs, mask=m) * tl.load(rc_ptr + offs, mask=m)
            if FIRST:
                p = b * z
            else:
                a = tl.load(ab_ptr)
                p = a * tl.load(p_ptr + offs, mask=m) + b * z
            tl.store(p_ptr + offs, p, mask=m)
            if X_ZERO:
                x = 0.0 + p
            else:
                x = tl.load(x_ptr + offs, mask=m) + p
            tl.store(x_ptr + offs, x, mask=m)

        _KERNEL = (triton, cheb_update)
    return _KERNEL


def chebyshev_update_half_plain(x, p, rc, dinv, ab, first: bool, x_zero: bool = False):
    """Plain form of ``chebyshev_update_half``; updates p and x in place."""
    z = dinv * rc
    p.copy_(ab[1] * z if first else ab[0] * p.to(x.dtype) + ab[1] * z)
    x.copy_((torch.zeros_like(x) if x_zero else x) + p.to(x.dtype))


def _kernel_half():
    global _KERNEL_HALF
    if _KERNEL_HALF is None:
        import triton
        import triton.language as tl

        @triton.jit
        def cheb_update_half(x_ptr, p_ptr, rc_ptr, dinv_ptr, ab_ptr, N,
                             FIRST: tl.constexpr, X_ZERO: tl.constexpr,
                             VIA_F32: tl.constexpr, BLOCK: tl.constexpr):
            pid = tl.program_id(0)
            offs = pid.to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
            m = offs < N
            b = tl.load(ab_ptr + 1)
            z = tl.load(dinv_ptr + offs, mask=m) * tl.load(rc_ptr + offs, mask=m)
            if FIRST:
                p = b * z
            else:
                a = tl.load(ab_ptr)
                p = a * tl.load(p_ptr + offs, mask=m).to(z.dtype) + b * z
            if VIA_F32:
                p = p.to(tl.float32)
            ps = p.to(p_ptr.dtype.element_ty)
            tl.store(p_ptr + offs, ps, mask=m)
            if X_ZERO:
                x = 0.0 + ps.to(z.dtype)
            else:
                x = tl.load(x_ptr + offs, mask=m) + ps.to(z.dtype)
            tl.store(x_ptr + offs, x, mask=m)

        _KERNEL_HALF = (triton, cheb_update_half)
    return _KERNEL_HALF


def _check(fn, x, p, rc, dinv, ab, pdtype):
    dt = x.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"{fn}: unsupported dtype {dt}")
    if p.dtype != pdtype:
        raise TypeError(f"{fn}: p dtype {p.dtype}, expected {pdtype}")
    for name, t in (("p", p), ("rc", rc), ("dinv", dinv)):
        if (t.dtype != dt and t is not p) or t.shape != x.shape or t.device != x.device:
            raise ValueError(f"{fn}: {name} does not match x")
    if ab.dtype != dt or ab.shape != (2,) or ab.device != x.device:
        raise ValueError(f"{fn}: ab must be a [2] tensor like x")
    for name, t in (("x", x), ("p", p), ("rc", rc), ("dinv", dinv), ("ab", ab)):
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn}: unsupported device {x.device}")
    return x.device.type == "cuda"


def chebyshev_update_half(x, p, rc, dinv, ab, first: bool = False, x_zero: bool = False):
    """``chebyshev_update`` with p stored narrower than x (module docstring;
    ops/apply.py::NARROWER): in place, p = store(a*load(p) + b*(dinv*rc))
    (store(b*(dinv*rc)) when ``first``), then x += load(p). Kernel K16
    for CUDA tensors, the plain form for CPU tensors."""
    from .apply import NARROWER

    if x.dtype not in NARROWER or p.dtype not in NARROWER[x.dtype]:
        raise TypeError(f"chebyshev_update_half: p dtype {p.dtype} under a {x.dtype} state")
    if not _check("chebyshev_update_half", x, p, rc, dinv, ab, p.dtype):
        chebyshev_update_half_plain(x, p, rc, dinv, ab, first, x_zero)
        return
    triton, kern = _kernel_half()
    N = x.numel()
    LAUNCHES["direction_chebyshev"] += 1
    kern[(triton.cdiv(N, _BLOCK),)](
        x, p, rc, dinv, ab, N, FIRST=bool(first), X_ZERO=bool(x_zero),
        VIA_F32=x.dtype == torch.float64 and p.dtype != torch.float32, BLOCK=_BLOCK,
        num_warps=4, enable_fp_fusion=False,
    )


def chebyshev_update(x, p, rc, dinv, ab, first: bool = False, x_zero: bool = False):
    """In place: p = a*p + b*(dinv*rc) (p = b*(dinv*rc) when ``first``),
    then x += p (x = 0 + p, x unread, when ``x_zero``). x, p, rc, dinv: one
    shape, float32 or float64, contiguous, one device; ab: [2] tensor (a,
    b) of the same dtype and device. Kernel K3 for CUDA tensors, the plain
    form for CPU tensors."""
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"chebyshev_update: unsupported dtype {x.dtype}")
    if p.dtype != x.dtype:
        raise ValueError("chebyshev_update: p does not match x")
    if not _check("chebyshev_update", x, p, rc, dinv, ab, x.dtype):
        chebyshev_update_plain(x, p, rc, dinv, ab, first, x_zero)
        return
    triton, kern = _kernel()
    N = x.numel()
    LAUNCHES["chebyshev_update"] += 1
    kern[(triton.cdiv(N, _BLOCK),)](
        x, p, rc, dinv, ab, N, FIRST=bool(first), X_ZERO=bool(x_zero), BLOCK=_BLOCK,
        num_warps=4,
    )
