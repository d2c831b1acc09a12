"""Large high-contrast st1 spectral-field solve (port of
scripts/run_st1.py).

    python -m homogenization_jl_tpu_torch.run_st1 [n] [refinements] [alpha] [cycles]

(defaults 32, 4, 10.0, 20) runs ``st1_multigrid`` on the card: the 3D
implicit-grid solve of a field of contrast exp(2 alpha max|f|) with seed 3,
``coarse="mg"``, float32, and prints the JAX script's JSON line (n,
refinements, alpha, dofs, contrast, sigma_min, sigma_max, residuals,
contraction_last5, wall_s) plus the port's ``noise`` ("jax": the JAX
package's draw for seed 3, kept in data/, so the card solves the TPU
record's field; "torch": a torch.Generator draw, another field), ``device``
and ``timings`` (host seconds of the setup's parts).

The script's knobs: ST1_METHOD ("vcycle" or "pcg", the contrast-robust
outer solve), ST1_TOL, ST1_SMOOTH_STEPS (3), ST1_SMOOTHER (the vcycle
method's smoother, "cg_exact"), ST1_SMOOTH_PRECISION ("high"),
ST1_COARSE_MG_TOL (5e-2). The TPU record (ACCURACY.md:153-159) is
``ST1_METHOD=pcg ... run_st1 32 4 100.0 40``.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

from .models.st1 import st1_multigrid
from .solver.multigrid import resolve_device
from .utils.fft_field import pinned_noise

SEED = 3


def main(argv=None, device=None):
    """The JAX script's run; ``device`` (default: the card) is for tests.
    Returns the printed record."""
    argv = sys.argv[1:] if argv is None else list(argv)
    n = int(argv[0]) if len(argv) > 0 else 32
    refinements = int(argv[1]) if len(argv) > 1 else 4
    alpha = float(argv[2]) if len(argv) > 2 else 10.0
    cycles = int(argv[3]) if len(argv) > 3 else 20
    method = os.environ.get("ST1_METHOD", "vcycle")
    dev = resolve_device(device)
    noise = pinned_noise(SEED, (n,) * 3)

    timings = {}
    t0 = time.perf_counter()
    history, x, solver, sigma_el = st1_multigrid(
        n, dim=3, refinements=refinements, lam=1.0, alpha=alpha, seed=SEED,
        max_cycles=cycles, coarse="mg", dtype=torch.float32, method=method,
        tol=float(os.environ.get("ST1_TOL", 0.0)),
        smoothing_steps=int(os.environ.get("ST1_SMOOTH_STEPS", 3)),
        solver_opts=dict(
            smoother=("chebyshev" if method == "pcg"
                      else os.environ.get("ST1_SMOOTHER", "cg_exact")),
            smooth_precision=os.environ.get("ST1_SMOOTH_PRECISION", "high"),
            coarse_mg_tol=float(os.environ.get("ST1_COARSE_MG_TOL", 5e-2)),
        ),
        noise=noise, device=dev, timings=timings,
    )
    wall = time.perf_counter() - t0
    sig = np.asarray(sigma_el)
    rec = dict(
        n=n,
        refinements=refinements,
        alpha=alpha,
        dofs=solver.plan.base.nelements * solver.plan.n_local(refinements),
        contrast=float(sig.max() / sig.min()),
        sigma_min=float(sig.min()),
        sigma_max=float(sig.max()),
        residuals=history,
        contraction_last5=(float((history[-1] / history[-6]) ** 0.2)
                           if len(history) > 6 else None),
        wall_s=round(wall, 1),
        noise="torch" if noise is None else "jax",
        device=torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev),
        timings=timings,
    )
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
