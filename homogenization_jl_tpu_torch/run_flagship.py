"""Full-scale flagship driver run (port of scripts/run_flagship.py).

    python -m homogenization_jl_tpu_torch.run_flagship [refinements] [n] [tolerance]

(defaults 4, 2, 1e-4: the recorded 190,513,152-unknown run, ACCURACY.md)
runs ``checkerboard_homogenization`` end to end on the card: 3D, lattice
geometry (the structured combine every outer step), float32, coarse="mg",
seed 7, with per-step timings, and prints the JAX script's JSON line
(sigma, sigma_steps, cycles_per_step, residuals, wall_s, n, refinements,
tolerance). ``FLAGSHIP_INNER``: "pcg" (the default: V-cycle-preconditioned
CG with the Chebyshev smoother) or "vcycle" (plain V-cycles with the
cg_exact smoother, the round-3 configuration).

``flagship(...)`` makes the call and returns that record with the driver's
trace (host seconds per step and per inner iteration); ``main`` prints the
record.
"""

from __future__ import annotations

import json
import os
import sys
import time

import torch

from .models.checkerboard import checkerboard_homogenization


def flagship(refinements: int = 4, n: int = 2, tol: float = 1e-4, inner: str | None = None,
             device=None, verbose: bool = True):
    """The JAX script's driver call; ``inner`` defaults to FLAGSHIP_INNER
    (else "pcg"), ``device`` to the card. Returns (record, trace)."""
    inner = os.environ.get("FLAGSHIP_INNER", "pcg") if inner is None else inner
    t0 = time.perf_counter()
    sigma, trace = checkerboard_homogenization(
        n,
        dim=3,
        refinements=refinements,
        tolerance=tol,
        seed=7,
        dtype=torch.float32,
        geometry="lattice",
        coarse="mg",
        smoother="chebyshev" if inner == "pcg" else "cg_exact",
        inner=inner,
        solver_opts=dict(smooth_precision="high", coarse_mg_tol=5e-2),
        verbose=verbose,
        return_trace=True,
        device=device,
    )
    wall = time.perf_counter() - t0
    record = dict(
        sigma=sigma,
        sigma_steps=trace.sigma_steps,
        cycles_per_step=trace.cycles_per_step,
        residuals=trace.residuals,
        wall_s=round(wall, 1),
        n=n,
        refinements=refinements,
        tolerance=tol,
    )
    return record, trace


def main(argv=None, device=None):
    """The script's run; ``device`` (default: the card) is for tests.
    Returns the printed record."""
    argv = sys.argv[1:] if argv is None else list(argv)
    refinements = int(argv[0]) if len(argv) > 0 else 4
    n = int(argv[1]) if len(argv) > 1 else 2
    tol = float(argv[2]) if len(argv) > 2 else 1e-4
    record, _ = flagship(refinements, n, tol, device=device)
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
