"""The "st1" spectral-field elliptic solve (reference: tools/
generate_st1_field.jl st1_example, :122-136).

Port of homogenization_jl_tpu/models/st1.py: a log-normal-ish conductivity
field with power-law spectral decay (utils/fft_field.py, kernel K17 around
the FFTs), then (lam - div sigma grad) u = 1 with zero Dirichlet values,
solved either on the implicit fine grid (``st1_multigrid``, the scalable
path: the solver's kernels, one scalar sigma per base element) or by a
host direct solve (``st1_example``, small demos).

``noise=`` hands the field generator its white noise (JAX's draw, for the
tests and for the TPU record's field: utils/fft_field.py::pinned_noise);
without it the noise is drawn by a ``torch.Generator`` seeded with
``seed``, which gives another field than the JAX package's for that seed.
``save=`` writes a .vtu file (utils/vtk.py): the mesh with the solution
and the field for ``st1_example``, the finest level's solution on the
exploded grid for ``st1_multigrid``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..fem.assembly import assemble_operator
from ..fem.local_operators import load_vector
from ..mesh.grid import affine_maps, hypercube, interior_nodes
from ..ops.plan import build_grid_plan
from ..solver.multigrid import CHEBYSHEV_SMOOTHERS, MultigridSolver, resolve_device
from ..utils.fft_field import st1_conductivity


def conductivity_per_cell(mesh, field: np.ndarray) -> np.ndarray:
    """sigma_el[e] = field[floor(center_e)], a scalar per element (host;
    reference: conductivity_per_cell, tools/generate_st1_field.jl:206-214)."""
    centers = mesh.nodes[mesh.elements].mean(axis=1)
    idx = np.clip(np.floor(centers).astype(np.int64), 0, field.shape[0] - 1)
    return np.asarray(field)[tuple(idx[:, k] for k in range(mesh.dim))]


def st1_example(n: int = 32, dim: int = 2, lam: float = 1.0, p: float = 1.5, alpha: float = 3.0,
                seed: int = 0, save: str | None = None, noise=None, device=None):
    """Direct solve of (lam - div sigma grad) u = 1 with an st1 field: the
    field on ``device`` (the card unless the caller asks for the CPU), the
    assembly and scipy's sparse direct solve on the host.

    Returns (mesh, u, sigma_el). ``alpha`` defaults lower than the
    reference's 100: exp(100 |f|) reaches contrasts of 10^4-10^5.
    """
    import scipy.sparse.linalg as spl

    mesh = hypercube(dim, n)
    field = st1_conductivity(seed, n, dim, p=p, alpha=alpha, noise=noise, device=device)
    sigma_el = conductivity_per_cell(mesh, field.cpu().numpy())

    A = assemble_operator(mesh, sigma_el, lam)
    b = load_vector(mesh)
    ii = interior_nodes(mesh)
    u = np.zeros(mesh.nnodes)
    u[ii] = spl.spsolve(A[np.ix_(ii, ii)].tocsc(), b[ii])

    if save:
        from ..utils.vtk import write_vtu

        write_vtu(save, mesh, point_data={"x": u}, cell_data={"sigma": sigma_el})
    return mesh, u, sigma_el


def st1_multigrid(
    n: int = 32,
    dim: int = 2,
    refinements: int = 2,
    lam: float = 1.0,
    p: float = 1.5,
    alpha: float = 3.0,
    seed: int = 0,
    max_cycles: int = 20,
    smoothing_steps: int = 3,
    coarse: str = "chol",
    coarse_dense_limit: int = 8_000,
    dtype=torch.float64,
    save: str | None = None,
    solver_opts: dict | None = None,
    method: str = "vcycle",
    tol: float = 0.0,
    noise=None,
    device=None,
    timings: dict | None = None,
):
    """The st1 field solve on the implicit fine grid, the scalable path
    (the JAX function, its arguments and defaults, plus ``noise``,
    ``device`` and ``timings``).

    The field lives on unit cells, so the base mesh is taken at the field's
    resolution (one scalar sigma per base element); refinement resolves the
    solution, not the coefficient. ``method``: "vcycle" (plain V-cycles) or
    "pcg" (V-cycle-preconditioned CG, contrast-robust; defaults the smoother
    to "chebyshev"). ``timings``: a dict that receives host seconds
    (``field_s``, ``plan_s``, ``solver_s``, ``setup_s``: coefficients,
    coarse setup and lambda_max; ``solve_s``), each after a device sync,
    and on the card ``solve_events_s``, the solve between CUDA events.

    Returns (residual_history, x_finest, solver, sigma_el); history[0] is
    the initial residual norm, for both methods.
    """
    dev = resolve_device(device)
    clock = {} if timings is None else timings

    def lap(key, t0):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        clock[key] = t1 - t0
        return t1

    t = time.perf_counter()
    base = hypercube(dim, n)
    field = st1_conductivity(seed, n, dim, p=p, alpha=alpha, noise=noise, device=dev)
    sigma_el = conductivity_per_cell(base, field.cpu().numpy())
    t = lap("field_s", t)

    plan = build_grid_plan(base, refinements + 1, slot_tables=False)
    if coarse == "chol" and len(plan.interior_base_nodes) > coarse_dense_limit:
        coarse = "mg"
    solver_opts = dict(solver_opts or {})
    if method == "pcg":
        # pcg requires a linear SPD V-cycle (chebyshev smoothing)
        solver_opts.setdefault("smoother", "chebyshev")
    elif method != "vcycle":
        raise ValueError(f"method={method!r}")
    t = lap("plan_s", t)
    solver = MultigridSolver(plan, dtype=dtype, device=dev, smoothing_steps=smoothing_steps,
                             coarse=coarse, **solver_opts)
    t = lap("solver_s", t)
    coeff = solver.coefficients(sigma_el, lam)
    setup = solver.coarse_setup(sigma_el, lam)

    b_ref = load_vector(plan.reference.levels[refinements])
    _, _, detJ, _ = affine_maps(base)
    b = torch.as_tensor(detJ[:, None] * b_ref[None, :]).to(dtype).contiguous().to(dev)
    lam_max = (solver.estimate_lambda_max(coeff) if solver.smoother in CHEBYSHEV_SMOOTHERS
               else None)
    t = lap("setup_s", t)
    events = None
    if timings is not None and dev.type == "cuda":
        events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        events[0].record()
    if method == "pcg":
        # V-cycle-preconditioned CG: contrast-robust where the standalone
        # V-cycle stalls (alpha=100 fields contract at ~0.99/cycle)
        x, history = solver.pcg(b, coeff, setup, lam_max=lam_max, iters=max_cycles, tol=tol)
    else:
        # history[0] = the initial residual norm, as pcg's, so a given
        # ``tol`` means the same stopping point for both methods
        x, _ = solver.zero_states()
        history = [float(solver.initial_residual_norm(b, coeff))]
        for _ in range(max_cycles):
            x, r = solver.vcycle(x, b, coeff, setup, lam_max=lam_max)
            history.append(float(solver.residual_norm(r)))
            if tol and history[-1] <= tol * history[0]:
                break
    if events is not None:
        events[1].record()
    lap("solve_s", t)
    if events is not None:
        clock["solve_events_s"] = events[0].elapsed_time(events[1]) / 1e3

    if save:
        from ..utils.vtk import export_solution

        export_solution(save, plan, refinements, x)
    return history, x, solver, sigma_el
