"""Conjugate gradients and multishift CG (device, PyTorch).

Port of homogenization_jl_tpu/solver/cg.py (reference: tools/
multishift_cg.jl): plain and preconditioned CG, and the Lanczos-basis CG
that solves (A + shift_i I) x_i = b for several shifts with ONE mat-vec per
iteration. The mat-vec is any function of a tensor (the implicit element
apply + interface combine in models/multishift.py), so both run matrix-free
on the duplicated [E, n_local] layout as well as on plain vectors.

``cg`` stops on the true residual, ||r||^2 <= tol^2 ||r_0||^2, as the JAX
``lax.while_loop``: a Python loop that reads one device scalar per
iteration on the host (``host_read``). Besides the JAX function's callables it takes
tensors: ``dot`` a bool mask w (the first-copy dot sum(a * w * b), kernel
K5) and ``precond`` the inverse diagonal d (the Jacobi multiply z = d * r).
Each iteration is the mat-vec, the dot p . Ap, K10's step x += alpha p,
r -= alpha Ap, the preconditioner and its dots, and K10's direction
p = z + beta p; with a tensor ``precond`` the step, z = d * r and the dots
r . z and r . r are one pass of kernel K14a (ops/recurrence.py, in K5's
order).

``multishift_cg`` runs a fixed number of iterations with no host read: the
Lanczos scalars are 0-d device tensors and the per-shift scalars
[n_shifts] device tensors. Each iteration is the mat-vec, two dots, the
three-term update and normalization (K18: ops/elementwise.py::
lanczos_update, div_nz) and K13 (ops/multishift.py::multishift_step).
"""

from __future__ import annotations

import torch

from ..ops.cg import cg_direction, cg_step
from ..ops.dots import dot as masked_dot
from ..ops.elementwise import div_nz, lanczos_update, mul
from ..ops.multishift import multishift_step
from ..ops.recurrence import jacobi_cg_step
from ..utils.logging import host_read


def _as_dot(dot, ref):
    """(dot callable, mask or None) of ``cg``'s ``dot`` argument: None is
    the plain dot, a bool tensor the first-copy dot through K5."""
    if dot is None:
        return (lambda a, b: masked_dot(a.contiguous(), b.contiguous())), None
    if isinstance(dot, torch.Tensor):
        if dot.dtype != torch.bool or dot.shape != ref.shape:
            raise ValueError(f"cg: a dot mask must be a bool tensor of shape {tuple(ref.shape)}")
        return (lambda a, b: masked_dot(a, b, mask=dot)), dot
    return dot, None


def cg(matvec, b, x0=None, tol=1e-10, maxiter=200, dot=None, precond=None):
    """Plain CG (reference: CGIterable, tools/multishift_cg.jl:12-49), or
    with ``precond`` preconditioned CG. Returns (x, iterations, final_rs),
    final_rs the last ||r||^2 as a 0-d tensor.

    ``dot``: a callable dot(a, b) returning a 0-d tensor of b's dtype and
    device, or a bool mask w (sum(a * w * b), K5), or None (sum(a * b)).
    ``precond``: a callable z = P^{-1} r, or a tensor d, the Jacobi multiply
    z = d * r fused into kernel K14a (then ``dot`` must be a mask or None).
    The stop test is on the TRUE residual in every form: ||r||^2 <
    tol^2 ||r_0||^2, read on the host per iteration. x and r are updated in
    place by K10 (or K14a), whose bits are the JAX expressions'. From x0 =
    None the residual b - A 0 is b itself: the first step reads b as r and
    writes x (from zero, unread) and a new r, so the start makes no zero
    pass, no apply and no copy of b. The first direction is z (r itself
    without a preconditioner): the first step and direction update write
    new buffers, so it needs no copy either.
    """
    dotf, mask = _as_dot(dot, b)
    jacobi = isinstance(precond, torch.Tensor)
    if jacobi and callable(dot):
        raise ValueError("cg: a tensor precond takes a mask (or None) as dot")
    if x0 is None:
        x, r = torch.empty_like(b), b  # r = b - A 0; b is only read
    else:
        x = x0.clone()
        r = b - matvec(x)
    rs = dotf(r, r)
    eps2 = torch.tensor(tol, dtype=b.dtype, device=b.device) ** 2 * rs
    if precond is None:
        z, rz = r, rs
    else:
        z = mul(precond, r) if jacobi else precond(r)
        rz = dotf(r, z)
    p = z  # may be r or b: the first direction update writes a new buffer
    i = 0
    while i < maxiter and host_read(rs > eps2, bool):
        Ap = matvec(p)
        pAp = dotf(p, Ap)
        first = i == 0
        r_out = torch.empty_like(b) if first else None  # p may be r
        x_zero = first and x0 is None
        if jacobi:
            z, rz_new, rs = jacobi_cg_step(x, r, p, Ap, precond, mask, rz, pAp, r_out, x_zero)
        else:
            cg_step(x, r, p, Ap, rz, pAp, r_out=r_out, x_zero=x_zero)
        if r_out is not None:
            r = r_out
        if not jacobi:
            z = r if precond is None else precond(r)
            rz_new = dotf(r, z)
            rs = rz_new if precond is None else dotf(r, r)
        p_out = torch.empty_like(b) if first else p
        cg_direction(p_out, z, p, rz_new, rz)
        p, rz = p_out, rz_new
        i += 1
    if i == 0 and x0 is None:
        x = torch.zeros_like(b)
    return x, i, rs


def multishift_cg(matvec, b, shifts, iters: int, dot=None):
    """Solve (A + shifts[i] I) x_i = b for all i with one mat-vec per
    iteration (the JAX function's Lanczos recurrence and batched root-free
    LDL' scalars; no host read). ``dot``: a callable, a bool mask (K5's
    first-copy dot) or None. Returns (xs [n_shifts, *b.shape], resnorms
    [n_shifts])."""
    dotf, _ = _as_dot(dot, b)
    shifts = torch.as_tensor(shifts, dtype=b.dtype).to(b.device)
    ns = shifts.shape[0]

    beta0 = torch.sqrt(dotf(b, b))
    v_curr = div_nz(b, beta0)
    W = torch.empty((ns,) + tuple(b.shape), dtype=b.dtype, device=b.device)
    xs = torch.empty_like(W)
    y = beta0.expand(ns).clone()
    D_prev = torch.zeros(ns, dtype=b.dtype, device=b.device)
    v_prev = None
    t_prev = torch.zeros((), dtype=b.dtype, device=b.device)
    t_next = t_prev
    for k in range(iters):
        w = matvec(v_curr)
        t_curr = dotf(v_curr, w)
        w = lanczos_update(w, v_curr, v_prev, t_curr, t_prev, out=w)
        t_next = torch.sqrt(dotf(w, w))
        v_next = div_nz(w, t_next, out=w)
        D_prev, y = multishift_step(v_curr, W, xs, shifts, t_curr, t_prev, D_prev, y, k == 0)
        v_prev, v_curr, t_prev = v_curr, v_next, t_next
    if iters == 0:
        xs.zero_()
    return xs, torch.abs(t_next * y)
