"""The multishift (one-Lanczos-pass) recurrence against the per-step
driver (port of scripts/run_multishift_compare.py).

    python -m homogenization_jl_tpu_torch.run_multishift_compare [n] [dim] [refinements] [tol]

(defaults 2, 3, 1, 1e-6) pins one conductivity field (``default_rng``
with MS_SEED, 7) and runs the SAME fixed-domain recurrence three ways on
the card, each through ``checkerboard_homogenization`` with
``shrink=False``:

  vcycle      per-outer-step plain V-cycles (the reference's semantics)
  pcg         per-outer-step V-cycle-preconditioned CG (chebyshev)
  multishift  ONE generalized-Lanczos pass serving every recurrence step

then ``homogenization_multishift`` directly for its apply counts, and
prints the JAX script's lines: one "name: sigma=... wall=..." per run and
the JSON record (sigma, wall_s, cycles_per_step or the A / M apply counts
and Lanczos iterations, sigma_steps, rel_diff_vs_vcycle). Knobs as the
script's: MS_DTYPE=float32|float64 (default float64), MS_LANCZOS=120,
MS_SEED=7.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

from .models.checkerboard import (
    checkerboard_homogenization,
    compute_boundary_layer,
    compute_box_radius,
    generate_conductivity,
)
from .models.multishift import homogenization_multishift
from .solver.multigrid import resolve_device


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None, device=None):
    """The JAX script's run; ``device`` (default: the card) is for tests.
    Returns the printed record."""
    argv = sys.argv[1:] if argv is None else list(argv)
    n = int(argv[0]) if len(argv) > 0 else 2
    dim = int(argv[1]) if len(argv) > 1 else 3
    refinements = int(argv[2]) if len(argv) > 2 else 1
    tol = float(argv[3]) if len(argv) > 3 else 1e-6
    lanczos = int(os.environ.get("MS_LANCZOS", 120))
    seed = int(os.environ.get("MS_SEED", 7))
    dtype = torch.float64 if os.environ.get("MS_DTYPE", "float64") == "float64" else torch.float32
    dev = resolve_device(device)

    R0 = compute_box_radius(0, n) + compute_boundary_layer(1.0, n)
    field = generate_conductivity(dim, 2 * R0, np.random.default_rng(seed))
    xi = np.ones(dim) / np.sqrt(dim)
    common = dict(dim=dim, refinements=refinements, cond_field=field, xi=xi, dtype=dtype,
                  tolerance=tol, shrink=False, device=dev)
    out = {
        "n": n, "dim": dim, "refinements": refinements, "tolerance": tol,
        "dtype": str(dtype).replace("torch.", ""), "lanczos_iters_budget": lanczos,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev),
    }
    for name, kwargs in (
        ("vcycle", dict(solver="vcycle", inner="vcycle")),
        ("pcg", dict(solver="vcycle", inner="pcg", smoother="chebyshev")),
        ("multishift", dict(solver="multishift", lanczos_iters=lanczos)),
    ):
        t0 = time.perf_counter()
        sigma, trace = checkerboard_homogenization(n, return_trace=True, **common, **kwargs)
        _sync(dev)
        wall = time.perf_counter() - t0
        rec = {"sigma": float(sigma), "wall_s": wall}
        if isinstance(trace, dict):  # the multishift stats
            for key in ("A_applies", "M_applies", "lanczos_iters"):
                rec[key] = trace[key]
            rec["sigma_steps"] = [float(s) for s in trace["sigma_steps"]]
        else:  # HomogenizationTrace
            rec["cycles_per_step"] = list(trace.cycles_per_step)
            rec["sigma_steps"] = [float(s) for s in trace.sigma_steps]
        out[name] = rec
        print(f"  {name}: sigma={sigma!r} wall={wall:.2f}s", flush=True)

    # the direct call (no driver wrapper) with its stats
    t0 = time.perf_counter()
    sig_d, stats = homogenization_multishift(
        n, dim=dim, refinements=refinements, lanczos_iters=lanczos, cond_field=field, xi=xi,
        dtype=dtype, return_stats=True, device=dev)
    _sync(dev)
    out["multishift_direct"] = {
        "sigma": float(sig_d), "wall_s": time.perf_counter() - t0,
        "A_applies": stats["A_applies"], "M_applies": stats["M_applies"],
        "lanczos_iters": stats["lanczos_iters"],
    }
    ref = out["vcycle"]["sigma"]
    for name in ("pcg", "multishift", "multishift_direct"):
        out[name]["rel_diff_vs_vcycle"] = abs(out[name]["sigma"] - ref) / max(abs(ref), 1e-300)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
