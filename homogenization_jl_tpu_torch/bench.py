"""The benchmark entry point of the port (port of bench.py:107-440, the
child's ``main()``).

    python -m homogenization_jl_tpu_torch.bench

runs on the card and prints bench.py's JSON lines: first a partial line
(the V-cycle headline), then the final one with the solve's numbers
("north star": iterations and seconds to a relative residual of 1e-3 and
1e-4). The metric is ``gmg_vcycle_dof_per_s_per_chip_3d_checkerboard``,
``value`` the DOFs swept per second by one V-cycle of the headline solver,
``vs_baseline`` that over the same ``REFERENCE_CPU_DOF_PER_S``.

Configuration, as bench.py's (every ``BENCH_*`` knob it reads):
``BENCH_DIM`` (3), ``BENCH_N`` (32), ``BENCH_LEVELS`` (5): the 3D
checkerboard on ``hypercube(3, 32, order=BENCH_ORDER="type")``, 5 levels,
190,513,152 DOFs in float32; ``BENCH_CYCLES`` (10) timed V-cycles;
``BENCH_PRECISION`` ("highest"), ``BENCH_SMOOTH_PRECISION`` ("high"),
``BENCH_RESTRICT_PRECISION`` / ``BENCH_KRYLOV_PRECISION`` ("high" on the
solve's own solver; empty for None); ``BENCH_COARSE`` ("chol" up to 8000
interior base nodes, else "mg"); ``BENCH_SOLVE_MODE`` ("fmg_pcg", or
"pcg", "vcycle"); ``BENCH_SMOOTHER`` ("chebyshev", "cg_exact" for
vcycle); ``BENCH_DIRECTION_DTYPE`` (the smoothers' direction storage,
e.g. "bfloat16"); ``BENCH_SMOOTH_STEPS`` (3); ``BENCH_COARSE_TOL`` (1e-6),
``BENCH_COARSE_MAXITER`` (200), ``BENCH_COARSE_MG_TOL`` (5e-2);
``BENCH_MAX_CYCLES`` (30) iterations of the solve.

Every precision knob runs full FP32 on the CUDA cores in this port (the
"high" defaults are honoured at equal or better accuracy; ``detail``
says so): TF32 / 3xTF32 forms are later work.

Timing: CUDA events around each V-cycle and each PCG iteration of a run,
the residual norms kept on the device and read once after it. The
headline is the mean of ``BENCH_CYCLES`` V-cycles after two warm-up
cycles; the solve's seconds per iteration the mean of its iterations after
the fourth (bench.py's differences of two runs, 2 and 2 + cycles, 4 and
max); ``detail`` has every repeat and their spread. ``sec_to_1e3/1e4``
add the FMG start's own seconds (CUDA events around the second of two
FMG calls) to the iterations' (bench.py adds 1.14 V-cycles, a TPU
measurement). The TPU parent's queue
guard and timeout ladder (bench.py:48-104) are not ported, so
``degraded`` is always null. ``BENCH_DEVICE=cpu`` runs on the CPU (for the
tests; host clock, no card numbers).
"""

from __future__ import annotations

import json
import os
import subprocess
import time

import numpy as np
import torch

REFERENCE_CPU_DOF_PER_S = 1.7e7
METRIC = "gmg_vcycle_dof_per_s_per_chip_3d_checkerboard"
PRECISION_RUN = "fp32 CUDA cores"
PRECISION_NOTE = (
    "every precision knob (apply, smooth, restrict, krylov) runs full FP32 on the "
    "CUDA cores: 'high' is honoured at equal or better accuracy"
)


def env(name, default):
    return os.environ.get(f"BENCH_{name}", default)


class Clock:
    """Per-step times of a run: CUDA events on the card (one per step
    boundary, read after the run), the host clock on the CPU."""

    def __init__(self, dev):
        self.cuda = dev.type == "cuda"
        self.marks = []

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def seconds(self):
        """Seconds between consecutive marks."""
        if self.cuda:
            torch.cuda.synchronize()
            return [a.elapsed_time(b) / 1e3 for a, b in zip(self.marks, self.marks[1:])]
        return [b - a for a, b in zip(self.marks, self.marks[1:])]


def card_info(dev):
    """(card name, power limit) of the device; the limit as nvidia-smi
    gives it, None where it cannot be read."""
    if dev.type != "cuda":
        return "cpu", None
    try:
        line = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()[dev.index or 0]
        limit = line.split(",")[-1].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        limit = None
    return torch.cuda.get_device_name(dev), limit


def spread(ts):
    return dict(min=min(ts), max=max(ts), rel=(max(ts) - min(ts)) / (sum(ts) / len(ts)))


def main():
    from .fem.local_operators import load_vector
    from .mesh.grid import affine_maps, hypercube
    from .models.checkerboard import conductivity_per_element, generate_conductivity
    from .ops.plan import build_grid_plan
    from .solver.multigrid import CHEBYSHEV_SMOOTHERS, MultigridSolver, resolve_device

    dev = resolve_device(env("DEVICE", None))
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    dim = int(env("DIM", 3))
    n = int(env("N", 32))
    nlevels = int(env("LEVELS", 5))
    cycles = int(env("CYCLES", 10))
    precision = env("PRECISION", "highest")
    dtype = torch.float32

    base = hypercube(dim, n, order=env("ORDER", "type"))
    rng = np.random.default_rng(0)
    sigma = conductivity_per_element(base, generate_conductivity(dim, n, rng), np.zeros(dim))
    plan = build_grid_plan(base, nlevels, slot_tables=False)
    dofs = plan.base.nelements * plan.n_local(nlevels - 1)
    coarse = env("COARSE", "chol" if len(plan.interior_base_nodes) <= 8000 else "mg")
    solve_mode = env("SOLVE_MODE", "fmg_pcg")
    smoother = env("SMOOTHER", "cg_exact" if solve_mode == "vcycle" else "chebyshev")
    smooth_precision = env("SMOOTH_PRECISION", "high")
    direction_dtype = env("DIRECTION_DTYPE", "") or None
    common = dict(
        dtype=dtype, device=dev, coarse=coarse, smoother=smoother, apply_precision=precision,
        smooth_precision=smooth_precision, direction_dtype=direction_dtype,
        smoothing_steps=int(env("SMOOTH_STEPS", 3)),
        coarse_cg_tol=float(env("COARSE_TOL", 1e-6)),
        coarse_cg_maxiter=int(env("COARSE_MAXITER", 200)),
        coarse_mg_tol=float(env("COARSE_MG_TOL", 5e-2)),
    )
    solver = MultigridSolver(plan, **common)
    coeff = solver.coefficients(sigma, 0.0)
    chol = solver.coarse_setup(sigma, 0.0)
    lam_max = solver.estimate_lambda_max(coeff) if smoother in CHEBYSHEV_SMOOTHERS else None
    _, _, detJ, _ = affine_maps(base)
    b = torch.as_tensor(detJ[:, None] * load_vector(plan.reference.levels[nlevels - 1])[None, :],
                        dtype=dtype, device=dev)
    max_star = int(env("MAX_CYCLES", 30))

    def vcycles(x, count):
        """``count`` V-cycles from x (updated in place): per-cycle seconds
        and residual norms (read once, after the run)."""
        clock, norms = Clock(dev), []
        clock.mark()
        for _ in range(count):
            x, r = solver._vcycle_impl(x, b, coeff, chol, lam_max)
            norms.append(solver.residual_norm(r))
            del r
            clock.mark()
        return clock.seconds(), torch.stack(norms).cpu().tolist()

    x, _ = solver.zero_states()
    vcycles(x, 2)  # warm-up: builds and loads the kernels
    secs, hist = vcycles(x, cycles)
    dt = sum(secs) / len(secs)
    value = dofs / dt
    name, limit = card_info(dev)
    detail_common = {
        "dofs": dofs,
        "sec_per_vcycle": dt,
        "base_elements": plan.base.nelements,
        "n_local": plan.n_local(nlevels - 1),
        "levels": nlevels,
        "coarse": coarse,
        "smoother": smoother,
        "dtype": "float32",
        "apply_precision": precision,
        "smooth_precision": smooth_precision,
        "device": name,
        "residual_norm": hist[-1],
        "degraded": None,
        "power_limit": limit,
        "direction_dtype": None if solver.direction_dtype is None
        else str(solver.direction_dtype)[6:],
        "precision_run": PRECISION_RUN,
        "precision_note": PRECISION_NOTE,
        "sec_per_vcycle_repeats": secs,
        "sec_per_vcycle_spread": spread(secs),
    }
    line = {"metric": METRIC, "value": value, "unit": "DOF/s",
            "vs_baseline": value / REFERENCE_CPU_DOF_PER_S}
    print(json.dumps({**line, "detail": {**detail_common, "partial": True}}), flush=True)
    del x

    # ---- the solve: iterations and seconds to 1e-3 / 1e-4 ---------------
    b_norm = float(solver.residual_norm(b))

    def iters_to(history, tol):
        idx = np.nonzero(np.asarray(history) / b_norm < tol)[0]
        return int(idx[0]) + 1 if idx.size else None

    star = {"solve_mode": solve_mode}
    if solve_mode == "vcycle":
        x0, _ = solver.zero_states()
        _, hist_star = vcycles(x0, max_star)
        del x0
        it3, it4 = iters_to(hist_star, 1e-3), iters_to(hist_star, 1e-4)
        star.update(iters_to_1e3=it3, sec_to_1e3=None if it3 is None else it3 * dt,
                    iters_to_1e4=it4, sec_to_1e4=None if it4 is None else it4 * dt,
                    sec_per_iter=dt)
    else:
        if smoother not in CHEBYSHEV_SMOOTHERS:
            raise ValueError("BENCH_SOLVE_MODE=pcg/fmg_pcg needs BENCH_SMOOTHER=chebyshev[4]")
        # the solve's own solver: the restrict / krylov knobs on
        ps = MultigridSolver(
            plan, **common,
            restrict_precision=env("RESTRICT_PRECISION", "high") or None,
            krylov_precision=env("KRYLOV_PRECISION", "high") or None,
        )
        flexible = ps.coarse_kind not in ("chol", "inv")
        if solve_mode == "fmg_pcg":
            ps.fmg(b, coeff, chol, lam_max=lam_max)  # warm-up
            clock = Clock(dev)
            clock.mark()
            x0, _ = ps.fmg(b, coeff, chol, lam_max=lam_max)
            clock.mark()
            (fmg_s,) = clock.seconds()
        else:
            x0, _ = ps.zero_states()
            fmg_s = 0.0

        def run_pcg(count):
            """PCG from x0 (not modified): the initial norm, per-step seconds
            and norms (read once, after the run)."""
            clock, norms = Clock(dev), []
            state = ps._pcg_init_impl(x0.clone(), b, coeff, chol, lam_max)
            rn0 = state[4]
            clock.mark()
            for _ in range(count):
                state = ps._pcg_step_impl(*state[:4], coeff, chol, lam_max, flexible=flexible)
                norms.append(state[4])
                clock.mark()
            del state
            return float(rn0), clock.seconds(), torch.stack(norms).cpu().tolist()

        run_pcg(4)  # warm-up
        rn0, secs_p, hist_p = run_pcg(max_star)
        timed = secs_p[4:] if len(secs_p) > 4 else secs_p
        dt_pcg = sum(timed) / len(timed)
        it3, it4 = iters_to(hist_p, 1e-3), iters_to(hist_p, 1e-4)
        star.update(
            iters_to_1e3=it3,
            sec_to_1e3=None if it3 is None else fmg_s + it3 * dt_pcg,
            iters_to_1e4=it4,
            sec_to_1e4=None if it4 is None else fmg_s + it4 * dt_pcg,
            sec_per_iter=dt_pcg,
            dof_per_s_solve=dofs / dt_pcg,
            fmg_start_rel_residual=rn0 / b_norm if solve_mode == "fmg_pcg" else None,
            history=[h / b_norm for h in hist_p],
            sec_per_iter_repeats=timed,
            sec_per_iter_spread=spread(timed),
        )
    print(json.dumps({**line, "detail": {**detail_common, **star}}), flush=True)


if __name__ == "__main__":
    main()
