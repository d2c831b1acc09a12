"""Shifted-family solves on the implicit fine grid (multishift CG).

Port of homogenization_jl_tpu/models/multishift.py (reference: the
out-of-tree tools/multishift_cg.jl): the homogenization recurrence halves
lambda each outer step, so the systems (A + lambda_i I) x_i = b for
lambda_i = lambda, lambda/2, ... share the Krylov space of A and b. One
mat-vec per iteration serves every shift (solver/cg.py).

``homogenization_multishift`` is BASELINE config 4's estimator: one
generalized Lanczos pass in the M-inner product serves every step of the
fixed-domain recurrence. Device work per Lanczos step: one A apply (K1 +
the combine), one Jacobi-preconditioned mass solve (K1 with the one-piece
stack [M] and coefficient detJ, the combine, K5, kernel K14a and K10's
direction per iteration, one host read each), two M-inner products (kernel
K14b, each read on the host) and the three-term update and normalization
(K18). The basis combination is kernel K14c. The host keeps the Lanczos
scalars and solves the m x m shifted tridiagonal systems in NumPy, as the
JAX module does.

Memory: the one-pass mode keeps the basis in ONE preallocated tensor
[lanczos_iters, E, n_local] (the JAX form stacks a list of vectors, which
holds the basis twice for a moment); ``two_pass=True`` keeps K + 1 running
sums instead and regenerates the basis, at twice the mat-vecs.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..mesh.grid import affine_maps, hypercube
from ..ops.apply import element_apply, stack_table
from ..ops.elementwise import diagonal, div_nz, inv_positive, lanczos_update
from ..ops.integrals import dot_M as k9_dot_M
from ..ops.integrals import integrals_fns
from ..ops.plan import build_grid_plan
from ..ops.recurrence import basis_accumulate, basis_combine
from ..solver.cg import cg, multishift_cg
from ..solver.multigrid import MultigridSolver, resolve_device
from ..utils.logging import host_read, span, spanned


def shifted_family_solve(solver: MultigridSolver, coeff_diffusion, b, shifts, iters: int = 200,
                         level: int | None = None):
    """Solve (A + shift_i I) x_i = b for all shifts on the duplicated layout.

    ``coeff_diffusion`` must be built with lam=0 (the pure -div a grad
    part); the shifts act as an identity term. Dots count each physical DOF
    once (the first-copy mask, K5), so the Lanczos recurrence sees the true
    operator on the unduplicated space. Returns (xs [n_shifts, E, n_local],
    resnorms [n_shifts]) on the solver's device.
    """
    k = solver.nlevels - 1 if level is None else level

    def matvec(v):
        return solver._combine(solver._apply_constrained(v, coeff_diffusion, k), k)

    b = solver._constrain(solver._combine(b, k), k)
    return multishift_cg(matvec, b, shifts, iters=iters, dot=solver.levels[k].first_copy_mask)


@spanned("hz.estimate")
def homogenization_multishift(
    n: int = 2,
    dim: int = 2,
    refinements: int = 1,
    lanczos_iters: int = 120,
    xi=None,
    cond_field=None,
    seed=None,
    dtype=torch.float64,
    mass_tol: float = 1e-12,
    return_stats: bool = False,
    two_pass: bool = False,
    device=None,
):
    """Fixed-domain homogenization recurrence via ONE Lanczos pass (the JAX
    function, its arguments and defaults, plus ``device``: the card unless
    the caller asks for the CPU).

    The recurrence v_{k+1} = (lam_{k+1} M + A)^{-1} lam_{k+1} M v_k with lam
    halving applies a chain of resolvents of the pencil (A, M) to one
    starting functional b0. The generalized Lanczos process in the
    M-inner product builds an M-orthonormal basis V with V' A V = T
    tridiagonal; every step reduces to an m x m shifted tridiagonal solve on
    the host: y_0 = (T + lam_0)^{-1} beta_0 e_1, y_k = lam_k (T + lam_k)^{-1}
    y_{k-1}, v_k = V y_k. The domain is fixed at the k = 0 radius (the
    driver's ``shrink=False``); sigma uses the driver's box masks,
    integrals and 2^k scaling.

    ``two_pass=True`` stores no basis: pass 1 collects the tridiagonal,
    the host solves for the y_k, pass 2 regenerates the identical basis
    and accumulates v_k = sum_j y_k[j] v_j (kernel K14c in both modes, which
    add in the same order: the two modes give the same bits).

    Returns sigma, or (sigma, stats) with ``return_stats``: stats has
    ``A_applies``, ``M_applies``, ``lanczos_iters`` and ``sigma_steps``,
    plus the port's host-clock ``setup_seconds`` and ``lanczos_seconds``.
    """
    from .checkerboard import (
        compute_boundary_layer,
        compute_box_radius,
        conductivity_per_element,
        generate_conductivity,
        initial_rhs,
        ordered_hypercube,
        prefix_in_radius,
    )

    t_start = time.perf_counter()
    with span("hz.estimate_setup"):
        dev = resolve_device(device)
        lam = 1.0
        box_radius = compute_box_radius(0, n)
        R0 = box_radius + compute_boundary_layer(lam, n)
        if xi is None:
            xi = np.ones(dim) / np.sqrt(dim)
        rng = np.random.default_rng(seed)
        if cond_field is None:
            cond_field = generate_conductivity(dim, 2 * R0, rng)

        base, _, center_norms = ordered_hypercube(dim, R0)
        sigma_el = conductivity_per_element(base, cond_field, np.full(dim, float(R0)))
        nlevels = refinements + 1
        plan = build_grid_plan(base, nlevels, slot_tables=False)
        solver = MultigridSolver(plan, dtype=dtype, device=dev, coarse="cg")
        kf = nlevels - 1
        w = solver.levels[kf].first_copy_mask
        bm = solver._bmask(kf)

        def to_dev(a):
            return torch.as_tensor(np.asarray(a)).to(dtype).contiguous().to(dev)

        coeff_A = solver.coefficients(sigma_el, 0.0)  # the pure -div a grad part
        mass = solver.levels[kf].stack[-1].contiguous()
        mass_stack = mass[None]
        mass_table = stack_table(mass_stack)  # the mass's nonzeros (K1, K14b)
        _, _, detJ_np, _ = affine_maps(base)
        detJ = to_dev(detJ_np)
        detJ_col = detJ[:, None].contiguous()
        area_fn, first_fn, terms_fn, _ = integrals_fns(mass, detJ)

        stats = {"A_applies": 0, "M_applies": 0}

        def Aop(v):
            stats["A_applies"] += 1
            return solver._combine(solver._apply_constrained(v, coeff_A, kf), kf)

        def Mop(v):
            # combine(constrain(detJ_e Mhat v_e)): K1 with the one-piece stack
            y = element_apply(v, detJ_col, mass_stack, mask=bm, table=mass_table)
            return solver._combine(y if bm is not None else solver._constrain(y, kf), kf)

        def dot_M(u, v):
            # the exact global M-inner product sum_e u_e' (detJ_e Mhat) v_e (K14b)
            return k9_dot_M(u, v, mass, detJ, table=mass_table)

        def scalar(value):
            return torch.tensor(value, dtype=dtype, device=dev)

        b0 = to_dev(initial_rhs(plan, sigma_el, xi))
        b0c = solver._constrain(solver._combine(b0, kf), kf)

        # Jacobi preconditioner of the mass solves: the assembled mass diagonal
        # per duplicated slot, combine(detJ_e * diag(Mhat)) (K18, the combine)
        inv_diag_M = inv_positive(
            solver._combine(diagonal(detJ_col, torch.diagonal(mass)[None, :].contiguous()), kf))

        @spanned("hz.mass_solve")
        def Msolve(b):
            x, it, _ = cg(Mop, b, tol=mass_tol, maxiter=400, dot=w, precond=inv_diag_M)
            stats["M_applies"] += it + 1
            return x

        def run_lanczos(consume, max_iters, out=None):
            """One sweep of the M-inner-product Lanczos recurrence; calls
            ``consume(j, v_j)`` as each basis vector appears, v_j written into
            ``out(j)`` when that gives a buffer. Returns (beta0, alphas, betas).
            Re-running with the same inputs reproduces the same bits."""
            alphas, betas = [], []
            slot = (lambda j: None) if out is None else out
            q0 = Msolve(b0c)
            beta0_ = float(np.sqrt(host_read(dot_M(q0, q0))))
            v = div_nz(q0, scalar(beta0_), out=slot(0))
            del q0
            v_prev = None
            consume(0, v)
            beta_j = 0.0
            for j in range(max_iters):
                with span("hz.lanczos_step"):
                    u = Msolve(Aop(v))  # M^{-1} A v
                    alpha_t = dot_M(u, v)  # = v' A v
                    alpha = host_read(alpha_t)
                    u = lanczos_update(u, v, v_prev, alpha_t, scalar(beta_j), out=u)
                    beta_next = float(np.sqrt(max(host_read(dot_M(u, u)), 0.0)))
                    alphas.append(alpha)
                    if beta_next <= 1e-300:
                        break
                    betas.append(beta_next)
                    v_prev, v = v, div_nz(u, scalar(beta_next), out=slot(j + 1))
                    consume(j + 1, v)
                    beta_j = beta_next
            return beta0_, alphas, betas

        def tridiag(alphas, betas, m):
            T = np.diag(np.array(alphas[:m]))
            if m > 1:
                off = np.array(betas[: m - 1])
                T += np.diag(off, 1) + np.diag(off, -1)
            return T

        def coefficient_vectors(T, beta0_, m):
            """The host's reduced recurrence: y_0 = (T + lam_0)^{-1} beta0 e1,
            y_k = lam_k (T + lam_k)^{-1} y_{k-1}, one per executed step."""
            ys = []
            lam_r = 1.0
            e1 = np.zeros(m)
            e1[0] = beta0_
            y = np.linalg.solve(T + lam_r * np.eye(m), e1)
            ys.append(y)
            for k in range(n + 1):
                lam_r /= 2.0
                box_r = compute_box_radius(k + 1, n)
                if box_r + compute_boundary_layer(lam_r, n) > R0:
                    break
                y = lam_r * np.linalg.solve(T + lam_r * np.eye(m), y)
                ys.append(y)
            return ys

    t_lanczos = time.perf_counter()
    stats["setup_seconds"] = t_lanczos - t_start
    if not two_pass:
        V = torch.empty((lanczos_iters,) + tuple(b0.shape), dtype=dtype, device=dev)
        beta0, alphas, betas = run_lanczos(
            lambda j, v: None, lanczos_iters,
            out=lambda j: V[j] if j < lanczos_iters else None)
        m = len(alphas)
        T = tridiag(alphas, betas, m)
        ys = coefficient_vectors(T, beta0, m)
        with span("hz.basis_combine"):
            vks = basis_combine(V[:m], to_dev(np.stack(ys)))
        del V
    else:
        # pass 1: scalars only, no basis storage
        beta0, alphas, betas = run_lanczos(lambda j, v: None, lanczos_iters)
        m = len(alphas)
        T = tridiag(alphas, betas, m)
        ys = coefficient_vectors(T, beta0, m)
        Yt = to_dev(np.stack(ys).T)  # [m, K+1]: row j holds every step's y_k[j]
        # pass 2: regenerate the identical basis, accumulate K+1 sums
        vks = torch.empty((len(ys),) + tuple(b0.shape), dtype=dtype, device=dev)

        def accumulate(j, v):
            with span("hz.basis_combine"):
                basis_accumulate(vks, v, Yt[j], first=j == 0)

        # m - 1 iterations regenerate exactly v_0 .. v_{m-1}
        beta0_2, _, _ = run_lanczos(accumulate, m - 1)
        if abs(beta0_2 - beta0) >= 1e-12 * max(abs(beta0), 1e-300):
            raise AssertionError("two-pass Lanczos did not reproduce pass 1")
    stats["lanczos_iters"] = m
    stats["lanczos_seconds"] = time.perf_counter() - t_lanczos

    # ---- sigma integrals over the reduced-space recurrence -----------------
    sigma = 0.0
    sigma_steps = []
    v_km1 = None
    with span("hz.sigma_integrals"):
        for k in range(vks.shape[0]):
            v_k = vks[k]
            n_box = prefix_in_radius(center_norms, box_radius)
            mask = to_dev((np.arange(base.nelements) < n_box).astype(np.float64))
            area = host_read(area_fn(mask))
            if k == 0:
                integral = host_read(first_fn(v_k, b0, mask))
            else:
                integral = host_read(terms_fn(v_k, v_km1, mask))
            sigma += 2.0**k * integral / area
            sigma_steps.append(sigma)
            lam /= 2.0
            box_radius = compute_box_radius(k + 1, n)
            v_km1 = v_k

    if return_stats:
        stats["sigma_steps"] = sigma_steps
        return sigma, stats
    return sigma


def multishift_demo(dim=2, n=4, levels=3, n_shifts=3, iters=150, seed=0, dtype=torch.float64,
                    device=None):
    """One Krylov pass against per-shift CG with shifts 1, 1/2, 1/4, ...
    (tools/multishift_cg.jl:87). Returns (worst relative difference of the
    solutions, resnorms as a NumPy array)."""
    from .checkerboard import conductivity_per_element, generate_conductivity

    dev = resolve_device(device)
    base = hypercube(dim, n)
    rng = np.random.default_rng(seed)
    sigma = conductivity_per_element(base, generate_conductivity(dim, n, rng), np.zeros(dim))
    plan = build_grid_plan(base, levels, slot_tables=False)
    solver = MultigridSolver(plan, dtype=dtype, device=dev, coarse="cg")
    coeff = solver.coefficients(sigma, 0.0)
    k = levels - 1
    b = torch.as_tensor(rng.standard_normal((base.nelements, plan.n_local(k)))).to(dtype).to(dev)
    shifts = [1.0 / 2**i for i in range(n_shifts)]
    xs, res = shifted_family_solve(solver, coeff, b, shifts, iters=iters)
    worst = shift_solutions_gap(solver, coeff, b, shifts, xs, k, maxiter=iters * 2)
    return worst, res.cpu().numpy()


def shift_solutions_gap(solver, coeff, b, shifts, xs, k, maxiter, tol=1e-12):
    """max over shifts of max|(xs[i] - x_cg) w| / max|x_cg w|, x_cg the
    per-shift CG solve (tol, first-copy dot) of (A + s I) x = b on level k
    of the combined, constrained b."""
    w = solver.levels[k].first_copy_mask
    zero = torch.zeros((), dtype=b.dtype, device=b.device)

    def matvec(v, s):
        # A v + s v, as A v - (-s) v (K18's update: the same bits)
        return lanczos_update(solver._combine(solver._apply_constrained(v, coeff, k), k), v,
                              None, -s, zero)

    bc = solver._constrain(solver._combine(b, k), k)
    worst = 0.0
    for i, s in enumerate(shifts):
        s_t = torch.tensor(s, dtype=b.dtype, device=b.device)
        x_cg, _, _ = cg(lambda v: matvec(v, s_t), bc, tol=tol, maxiter=maxiter, dot=w)
        num = float(torch.abs((xs[i] - x_cg) * w).max())
        den = float(torch.abs(x_cg * w).max())
        worst = max(worst, num / max(den, 1e-300))
    return worst
