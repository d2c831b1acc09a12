"""The slab-sharded solver's large run (port of scripts/run_slab_big.py:
88-209), its ``torchrun`` entry point, and the spawned ranks of the CPU
tests.

``run(group, ...)`` runs on every rank of a ``SlabGroup``: the problem of
run_slab_big.py (``hypercube(dim, n, order="cube")``, a checkerboard
conductivity from ``default_rng(0)``, the ``load_vector`` rhs), a few
V-cycles from zero with the first-copy residual norm after each, and the
sigma integral sum_e detJ_e x_e' M x_e of the result (kernel K9, summed over
the ranks). ``compare=True`` (rank 0 only) runs the same V-cycles on the
single-device solver on the same cube-order plan, with the same lambda_max,
and reports the integral's and the residuals' relative differences.
Every rank returns a dict of numbers (and, with ``keep_states``, its rows of
x and r as numpy).

On cards, one process per card:

    torchrun --nproc-per-node=S -m homogenization_jl_tpu_torch.parallel.run_slab \\
        [--cubes 32] [--levels 5] [--cycles 3] [--smoother chebyshev] [--compare]

prints rank 0's result as one JSON line (``--device cpu`` runs gloo ranks
on the CPU instead). In-process with a world of one
(``SlabGroup.from_file``), as chip_smoke.py drives it, ``run`` is called
directly. ``spawn_ranks(size, job)`` starts ``size`` processes with a
gloo group over a FileStore, on the CPU or sharing one card (NCCL refuses
two ranks on one card), runs ``job`` on each (``worker``) and returns
their outputs in rank order; the spawned ranks import no JAX. The job kinds:
"run" (this module's slab run), "driver" (the lattice driver through the
slab solver), "sharded" (the gather-sharded solver of parallel/sharding.py
on the JAX suite's problem, ``run_sharded``), "ordered_driver" (the
ordered driver through it) and "mixed" (mixed-precision PCG on slabs,
``run_mixed``: the float64 Krylov loop around the float32 V-cycle of
run_mixed_pcg.py, the JAX script's ``MIXED_SLAB=S``).

On cards the mixed-precision run is

    torchrun --nproc-per-node=S -m homogenization_jl_tpu_torch.parallel.run_slab \\
        --kind mixed [--cubes 32] [--levels 5] [--iters 30] [--tol 1e-10] [--compare]

and the gather-sharded solver's are ``--kind sharded`` (float64 V-cycles on
``sharded_problem``, ``run_sharded``) and ``--kind ordered_driver`` (the
ordered driver with ``--cubes`` its n, ``--levels`` refinements + 1, seed 0,
inner="pcg" for the Chebyshev smoothers, else "vcycle"; ``--tol`` its
tolerance); ``--coarse`` (default "chol", as run_slab_big.py) picks the
coarse solve of every kind but mixed, ``--dim`` the dimension (3), and
``--compare`` adds the single-device run on rank 0. ``--cubes`` is ``--n``
under a name that torchrun does not take for an abbreviation of its own
options (torch 2.11's refuses ``--n`` after the module).
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import pickle
import shutil
import tempfile
import time

import numpy as np
import torch

from ..csrc.build import LAUNCHES, reset_launches
from ..fem.local_operators import load_vector, mass_matrix
from ..mesh.grid import affine_maps, hypercube
from ..models.checkerboard import conductivity_per_element, generate_conductivity
from ..ops.integrals import integrals_fns
from ..ops.plan import build_grid_plan
from ..solver.multigrid import CHEBYSHEV_SMOOTHERS, MultigridSolver
from .group import SlabGroup
from .sharding import ShardedMultigridSolver, join_rows
from .slab import SlabShardedMultigridSolver


def problem(dim: int, n: int, nlevels: int):
    """(plan, sigma_el, b [E, n_local], detJ [E], mass [n_local, n_local])
    of run_slab_big.py on a cube-major base (host arrays, float64)."""
    base = hypercube(dim, n, order="cube")
    sigma = conductivity_per_element(
        base, generate_conductivity(dim, n, np.random.default_rng(0)), np.zeros(dim)
    )
    plan = build_grid_plan(base, nlevels, slot_tables=False)
    fine = plan.reference.levels[nlevels - 1]
    _, _, detJ, _ = affine_maps(base)
    return plan, sigma, detJ[:, None] * load_vector(fine)[None, :], detJ, mass_matrix(fine)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _cycles(solver, sigma, b_np, detJ, mass_np, lam, cycles, lam_max, group=None):
    """V-cycles from zero on ``solver``: (residual norms, seconds per cycle,
    integral, x, r). The residual norm is read after each cycle."""
    dev, dt = solver.device, solver.dtype
    coeff = solver.coefficients(sigma, lam)
    setup = solver.coarse_setup(sigma, lam)
    x, _ = solver.zero_states()
    b = torch.as_tensor(np.ascontiguousarray(solver.rows_of(b_np), dtype=solver._np_dtype),
                        device=dev)
    hist, secs, r = [], [], None
    for _ in range(cycles):
        _sync(dev)
        t0 = time.perf_counter()
        x, r = solver.vcycle(x, b, coeff, setup, lam_max=lam_max)
        hist.append(float(solver.residual_norm(r)))
        secs.append(time.perf_counter() - t0)
    rows = torch.as_tensor(solver.rows_of(detJ), device=dev).to(dt)
    _, _, terms, _ = integrals_fns(torch.as_tensor(mass_np, device=dev).to(dt), rows,
                                   reference_quirk=False, group=group)
    integral = float(terms(x, torch.zeros_like(x), torch.ones_like(rows)))
    return hist, secs, integral, x, r


def run(group: SlabGroup, n: int = 32, nlevels: int = 5, cycles: int = 3, *, dim: int = 3,
        smoother: str = "cg", coarse: str = "chol", dtype=torch.float32, lam: float = 0.0,
        compare: bool = False, pcg_iters: int = 0, keep_states: bool = False,
        solver_opts: dict | None = None, prob=None) -> dict:
    """One rank's part of the slab run (see the module docstring).
    ``pcg_iters`` > 0 adds a V-cycle-preconditioned CG solve from zero
    (Chebyshev smoothers), its history and, with ``keep_states``, its x.
    ``prob``: ``problem(dim, n, nlevels)`` when the caller has it
    already. ``launches`` counts the hand kernels of the slab leg."""
    dev = group.device
    t0 = time.perf_counter()
    plan, sigma, b_np, detJ, mass_np = problem(dim, n, nlevels) if prob is None else prob
    opts = dict(smoother=smoother, coarse=coarse, **(solver_opts or {}))
    solver = SlabShardedMultigridSolver(plan, group, dtype=dtype, **opts)
    out = dict(n=n, dim=dim, levels=nlevels, dofs=plan.base.nelements * plan.n_local(nlevels - 1),
               slabs=group.size, rank=group.rank, dtype=str(dtype)[6:], smoother=smoother,
               coarse=coarse, host_setup_s=time.perf_counter() - t0)
    lam_max = None
    if smoother in CHEBYSHEV_SMOOTHERS:
        lam_max = solver.estimate_lambda_max(solver.coefficients(sigma, lam))
        out["lam_max"] = lam_max
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    before = dict(LAUNCHES)
    hist, secs, integral, x, r = _cycles(solver, sigma, b_np, detJ, mass_np, lam, cycles,
                                          lam_max, group)
    out.update(residuals=hist, sec_per_cycle=secs, integral=integral,
               launches={k: v - before[k] for k, v in LAUNCHES.items()})
    if dev.type == "cuda":
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    if keep_states:
        out.update(x=x.cpu().numpy(), r=None if r is None else r.cpu().numpy())
    del x, r
    if pcg_iters:
        coeff = solver.coefficients(sigma, lam)
        setup = solver.coarse_setup(sigma, lam)
        b = solver.put(b_np)
        xp, hp = solver.pcg(b, coeff, setup, lam_max=lam_max, iters=pcg_iters)
        out["pcg_history"] = hp
        if keep_states:
            out["pcg_x"] = xp.cpu().numpy()
    del solver
    if compare and group.rank == 0:
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        single = MultigridSolver(plan, dtype=dtype, device=dev, **opts)
        h1, s1, i1, _, _ = _cycles(single, sigma, b_np, detJ, mass_np, lam, cycles, lam_max)
        rate_s = [a / c for a, c in zip(hist[1:], hist[:-1])]
        rate_1 = [a / c for a, c in zip(h1[1:], h1[:-1])]
        out.update(
            residuals_single=h1, sec_per_cycle_single=s1, integral_single=i1,
            integral_rel_err=abs(integral - i1) / max(abs(i1), 1e-300),
            residual_rel_err=[abs(a - c) / c for a, c in zip(hist, h1)],
            rate_rel_err=[abs(a - c) / c for a, c in zip(rate_s, rate_1)],
        )
        if dev.type == "cuda":
            out["max_memory_allocated_single"] = torch.cuda.max_memory_allocated(dev)
    return out


def run_driver(group: SlabGroup, **kwargs) -> dict:
    """The lattice driver with ``device_mesh=group`` on one rank: sigma and
    the trace's per-step numbers."""
    from ..models.checkerboard import checkerboard_homogenization

    sigma, trace = checkerboard_homogenization(
        geometry="lattice", device_mesh=group, return_trace=True, **kwargs
    )
    return dict(sigma=sigma, sigma_steps=trace.sigma_steps,
                cycles_per_step=trace.cycles_per_step, residuals=trace.residuals)


def sharded_problem(dim: int, n: int, nlevels: int, seed: int = 3):
    """(plan, sigma_el, b) of the JAX suite's sharded tests
    (tests/test_sharding.py:23-35): ``hypercube(dim, n)``, a checkerboard
    conductivity from ``default_rng(seed)``, the ``load_vector`` rhs."""
    base = hypercube(dim, n)
    sigma = conductivity_per_element(
        base, generate_conductivity(dim, n, np.random.default_rng(seed)), np.zeros(dim)
    )
    plan = build_grid_plan(base, nlevels, slot_tables=False)
    _, _, detJ, _ = affine_maps(base)
    return plan, sigma, detJ[:, None] * load_vector(plan.reference.levels[nlevels - 1])[None, :]


def _sharded_mode(s, b_np, sigma, lam, mode, cycles, iters, tol):
    """``run_sharded``'s solve on the solver ``s``: (x, r or None, the
    residual norms, lambda_max or None)."""
    b = torch.as_tensor(np.ascontiguousarray(s.rows_of(b_np), dtype=s._np_dtype), device=s.device)
    if mode == "solve":
        x, hist = s.solve(b, sigma, lam, tol=tol)
        return x, None, hist, None
    coeff = s.coefficients(sigma, lam)
    setup = s.coarse_setup(sigma, lam)
    lam_max = None
    if s.smoother in CHEBYSHEV_SMOOTHERS:
        lam_max = s.estimate_lambda_max(coeff)
    if mode == "pcg":
        x, hist = s.pcg(b, coeff, setup, lam_max=lam_max, iters=iters)
        return x, None, hist, lam_max
    if mode == "fmg":
        x, r = s.fmg(b, coeff, setup, lam_max=lam_max)
        return x, r, [float(s.residual_norm(r))], lam_max
    x, _ = s.zero_states()
    hist = []
    for _ in range(cycles):
        x, r = s.vcycle(x, b, coeff, setup, lam_max=lam_max)
        hist.append(float(s.residual_norm(r)))
    return x, r, hist, lam_max


def run_sharded(group: SlabGroup, dim: int, n: int, nlevels: int, mode: str = "vcycle", *,
                lam: float = 0.0, seed: int = 3, cycles: int = 3, iters: int = 8,
                tol: float = 1e-8, solver_opts: dict | None = None,
                compare: bool = False) -> dict:
    """One rank of the gather-sharded solver on ``sharded_problem`` in
    float64: ``mode`` "vcycle" (``cycles`` V-cycles from zero, the residual
    norm after each), "pcg" (``iters`` PCG iterations from zero), "fmg"
    (one FMG start) or "solve" (``solve(tol=tol)``). Returns the rank's rows
    of x (and r), the residual norms and, for the Chebyshev smoothers, the
    lambda_max estimate, and the hand kernels' launches of the solve.
    ``compare`` (rank 0) adds the single-device solver's norms on the same
    problem and the largest difference of its x from the joined sharded x,
    relative to its largest |x| (every rank joins)."""
    plan, sigma, b_np = sharded_problem(dim, n, nlevels, seed)
    s = ShardedMultigridSolver(plan, group, dtype=torch.float64, **(solver_opts or {}))
    out = dict(rank=group.rank, rows=s.n_rows, cross_slots=[s.cross_slots(k) for k in range(nlevels)])
    before = dict(LAUNCHES)
    x, r, hist, lam_max = _sharded_mode(s, b_np, sigma, lam, mode, cycles, iters, tol)
    out.update(x=x.cpu().numpy(), hist=hist,
               launches={k: v - before[k] for k, v in LAUNCHES.items()})
    if r is not None:
        out["r"] = r.cpu().numpy()
    if lam_max is not None:
        out["lam_max"] = lam_max
    if compare:
        x_all = join_rows(group, x, plan.base.nelements)
        if group.rank == 0:
            single = MultigridSolver(plan, dtype=torch.float64, device=group.device,
                                     **(solver_opts or {}))
            x1, _, h1, _ = _sharded_mode(single, b_np, sigma, lam, mode, cycles, iters, tol)
            out.update(hist_single=h1, x_rel_diff=float(
                (x_all - x1).abs().max() / x1.abs().max().clamp_min(1e-300)))
    return out


def run_ordered_driver(group: SlabGroup, compare: bool = False, **kwargs) -> dict:
    """The ordered driver with ``device_mesh=group`` on one rank, with the
    hand kernels' launches of the run; with ``compare`` (rank 0) the
    single-device driver's sigma from the same arguments beside it."""
    from ..models.checkerboard import checkerboard_homogenization

    before = dict(LAUNCHES)
    sigma, trace = checkerboard_homogenization(
        geometry="ordered", device_mesh=group, return_trace=True, **kwargs
    )
    out = dict(rank=group.rank, sigma=sigma, sigma_steps=trace.sigma_steps,
               cycles_per_step=trace.cycles_per_step, residuals=trace.residuals,
               launches={k: v - before[k] for k, v in LAUNCHES.items()})
    if compare and group.rank == 0:
        single = checkerboard_homogenization(geometry="ordered", device=group.device, **kwargs)
        out.update(sigma_single=single, sigma_rel_err=abs(sigma - single) / abs(single))
    return out


def mixed_pair(plan, make):
    """run_mixed_pcg.py's solver pair on ``plan`` through ``make(dtype,
    **options)``: the inner float32 Chebyshev V-cycle (``coarse_mg_tol=5e-2``,
    ``smooth_precision="high"``) and the outer float64 Chebyshev solver;
    the dense coarse factor while the base has at most 8000 interior
    nodes, else ``coarse="mg"``. Returns (outer, inner)."""
    coarse = "chol" if len(plan.interior_base_nodes) <= 8000 else "mg"
    inner = make(torch.float32, smoother="chebyshev", coarse=coarse,
                 smooth_precision="high", coarse_mg_tol=5e-2)
    outer = make(torch.float64, smoother="chebyshev", coarse=coarse)
    return outer, inner


def run_mixed(group: SlabGroup, dim: int = 3, n: int = 8, nlevels: int = 3, *,
              iters: int = 30, tol: float = 1e-10, keep_best: bool = True, sigma=None,
              compare: bool = False, keep_states: bool = False) -> dict:
    """One rank of mixed-precision PCG on slabs: run_mixed_pcg.py's pair
    (``mixed_pair``) of ``SlabShardedMultigridSolver`` on ``group`` over a
    cube-major ``hypercube(dim, n)`` plan, ``sigma`` the element
    conductivities (default: the checkerboard of ``problem``), the
    ``load_vector`` rhs. Returns the
    residual history, the seconds of the setup and of the solve, the rank's
    kernel launches of the solve, its rows of x with ``keep_states``, and
    with ``compare`` (rank 0) the single-device solve of the same problem:
    its history and its x's largest difference from the joined slab x,
    relative to the largest |x| (the slab x is gathered to rank 0)."""
    from ..solver.multigrid import mixed_precision_pcg, mixed_precision_setup

    dev = group.device
    plan, sig, b_np, _, _ = problem(dim, n, nlevels)
    sigma = sig if sigma is None else np.asarray(sigma)

    outer, inner = mixed_pair(
        plan, lambda dtype, **kw: SlabShardedMultigridSolver(plan, group, dtype=dtype, **kw))
    out = dict(rank=group.rank, slabs=group.size, dofs=plan.base.nelements * plan.n_local(nlevels - 1),
               coarse=outer.coarse_kind)
    b = outer.put(b_np)
    _sync(dev)
    t0 = time.perf_counter()
    setup = mixed_precision_setup(outer, inner, sigma)
    _sync(dev)
    out["setup_s"] = time.perf_counter() - t0
    before = dict(LAUNCHES)
    t0 = time.perf_counter()
    x, hist = mixed_precision_pcg(outer, inner, b, setup=setup, iters=iters, tol=tol,
                                  keep_best=keep_best)
    _sync(dev)
    out.update(history=hist, solve_s=time.perf_counter() - t0,
               launches={k: v - before[k] for k, v in LAUNCHES.items()})
    if keep_states:
        out["x"] = x.cpu().numpy()
    parts = None
    if compare:
        # the whole x on rank 0 (every rank joins the gather)
        parts = [torch.empty_like(x) for _ in range(group.size)] if group.size > 1 else [x]
        if group.size > 1:
            torch.distributed.all_gather(parts, x)
    del outer, inner, setup, x
    if compare and group.rank == 0:
        x_slab = torch.cat(parts).cpu().numpy()
        del parts
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        o1, i1 = mixed_pair(
            plan, lambda dtype, **kw: MultigridSolver(plan, dtype=dtype, device=dev, **kw))
        x1, h1 = mixed_precision_pcg(o1, i1, torch.as_tensor(b_np, device=dev), sigma,
                                     iters=iters, tol=tol, keep_best=keep_best)
        x1 = x1.cpu().numpy()
        out.update(history_single=h1,
                   x_rel_diff=float(np.abs(x_slab - x1).max() / np.abs(x1).max()))
    return out


JOBS = {"run": run, "driver": run_driver, "sharded": run_sharded,
        "ordered_driver": run_ordered_driver, "mixed": run_mixed}


def worker(rank: int, size: int, init_file: str, out_dir: str, job: dict) -> None:
    """One spawned rank: join the gloo group over ``init_file`` (on the CPU,
    or with ``job["device"]`` on a card that the ranks share), run
    ``JOBS[job["kind"]](group, **job["kwargs"])`` and pickle its result, with
    the hand kernels' launches in the job (``job_launches``), to
    ``out_dir/rank{rank}.pkl``."""
    torch.set_num_threads(1)
    group = SlabGroup.from_file(init_file, rank, size, device=job.get("device", "cpu"),
                                timeout=datetime.timedelta(seconds=job.get("timeout", 120)),
                                backend="gloo")
    try:
        reset_launches()
        res = JOBS[job["kind"]](group, **job["kwargs"])
        res["job_launches"] = dict(LAUNCHES)
    finally:
        SlabGroup.destroy()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


def spawn_ranks(size: int, job: dict, timeout: float = 300.0) -> list:
    """Run ``job`` ({"kind": a key of JOBS, "kwargs": ..., and "device":
    "cuda" for ranks that share the card, default "cpu"}) on ``size``
    spawned ranks with a gloo group; return their results in rank order.
    Raises if a rank fails or the ranks outlive ``timeout`` seconds (they
    are killed then)."""
    tmp = tempfile.mkdtemp(prefix="slab_ranks_")
    try:
        ctx = torch.multiprocessing.start_processes(
            worker, args=(size, os.path.join(tmp, "store"), tmp, dict(job, timeout=timeout)),
            nprocs=size, join=False, start_method="spawn",
        )
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"slab ranks still running after {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        out = []
        for r in range(size):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description="the sharded solvers' runs (one process per card)")
    ap.add_argument("--kind", choices=("run", "mixed", "sharded", "ordered_driver"),
                    default="run",
                    help="run: slab V-cycles (run); mixed: mixed-precision PCG on slabs "
                    "(run_mixed); sharded: gather-sharded V-cycles (run_sharded); "
                    "ordered_driver: the ordered driver on the gather-sharded solver")
    # --cubes: torchrun (torch 2.11) refuses --n after the module as an
    # ambiguous abbreviation of its own options
    ap.add_argument("--n", "--cubes", dest="n", type=int, default=32,
                    help="cubes per axis (ordered_driver: the driver's n)")
    ap.add_argument("--levels", type=int, default=5,
                    help="levels (ordered_driver: refinements + 1)")
    ap.add_argument("--dim", type=int, default=3)
    ap.add_argument("--cycles", type=int, default=3)
    ap.add_argument("--smoother", default="cg")
    ap.add_argument("--coarse", default="chol",
                    help="run, sharded, ordered_driver: the coarse solve")
    ap.add_argument("--iters", type=int, default=30, help="mixed: PCG iterations at most")
    ap.add_argument("--tol", type=float, default=None,
                    help="mixed: relative tolerance (1e-10); ordered_driver: the driver's "
                    "tolerance (1e-4)")
    ap.add_argument("--compare", action="store_true",
                    help="also run the single-device solver on rank 0")
    ap.add_argument("--device", default=None,
                    help="cpu for gloo ranks on the CPU (default: the card of LOCAL_RANK)")
    args = ap.parse_args(argv)
    group = SlabGroup.from_env(device=args.device)
    try:
        if args.kind == "mixed":
            out = run_mixed(group, args.dim, args.n, args.levels, iters=args.iters,
                            tol=1e-10 if args.tol is None else args.tol, compare=args.compare)
        elif args.kind == "sharded":
            out = run_sharded(group, args.dim, args.n, args.levels, cycles=args.cycles,
                              solver_opts=dict(smoother=args.smoother, coarse=args.coarse),
                              compare=args.compare)
            del out["x"], out["r"]
        elif args.kind == "ordered_driver":
            out = run_ordered_driver(
                group, compare=args.compare, n=args.n, dim=args.dim,
                refinements=args.levels - 1, tolerance=1e-4 if args.tol is None else args.tol,
                smoother=args.smoother, coarse=args.coarse, seed=0,
                inner="pcg" if args.smoother in CHEBYSHEV_SMOOTHERS else "vcycle")
        else:
            out = run(group, args.n, args.levels, args.cycles, dim=args.dim,
                      smoother=args.smoother, coarse=args.coarse, compare=args.compare)
    finally:
        SlabGroup.destroy()
    if out["rank"] == 0:
        dev = group.device
        out["device"] = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
