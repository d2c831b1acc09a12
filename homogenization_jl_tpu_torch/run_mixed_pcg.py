"""Mixed-precision PCG at scale: a float64 Krylov loop around the float32
V-cycle (port of scripts/run_mixed_pcg.py:76-145).

    python -m homogenization_jl_tpu_torch.run_mixed_pcg [n] [levels] [iters] [tol]

(defaults 16, 5, 30, 1e-10) runs on the card. It measures what the
float32 path cannot do, converge below its floor (~9.4e-4 relative at
190M DOFs, ACCURACY.md), at the cost per iteration of one float64 fine
apply, float64 BLAS-1 and one float32 V-cycle. The problem is the JAX
script's: the 3D checkerboard on ``hypercube(3, n, order="type")``, the
conductivity ``generate_conductivity`` from ``default_rng(0)``, the
``load_vector`` rhs, ``coarse="chol"`` up to 8000 interior base nodes and
``coarse="mg"`` above; the solver pair is the inner float32 Chebyshev
(``coarse_mg_tol=5e-2``, ``smooth_precision="high"``) and the outer
float64 Chebyshev (``parallel/run_slab.py::mixed_pair``). It prints the
JAX script's lines: the size, the setup's seconds, the warm-up's (two
iterations), then every iteration's residual and the summary.

The slab-sharded form (the JAX script's ``MIXED_SLAB=S``) runs one process
per card: ``torchrun --nproc-per-node=S -m
homogenization_jl_tpu_torch.parallel.run_slab --kind mixed``.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from .fem.local_operators import load_vector
from .mesh.grid import affine_maps, hypercube
from .models.checkerboard import conductivity_per_element, generate_conductivity
from .ops.plan import build_grid_plan
from .parallel.run_slab import mixed_pair
from .solver.multigrid import (
    MultigridSolver,
    mixed_precision_pcg,
    mixed_precision_setup,
    resolve_device,
)


def build(n: int, nlevels: int, device=None, dim: int = 3):
    """(plan, sigma_el, b float64 [E, n_local] on the device, outer, inner)
    of the JAX script's problem and solver pair."""
    dev = resolve_device(device)
    base = hypercube(dim, n, order="type")
    sigma = conductivity_per_element(
        base, generate_conductivity(dim, n, np.random.default_rng(0)), np.zeros(dim)
    )
    plan = build_grid_plan(base, nlevels, slot_tables=False)
    outer, inner = mixed_pair(
        plan, lambda dtype, **kw: MultigridSolver(plan, dtype=dtype, device=dev, **kw))
    _, _, detJ, _ = affine_maps(base)
    b_np = detJ[:, None] * load_vector(plan.reference.levels[nlevels - 1])[None, :]
    b = torch.as_tensor(b_np, dtype=torch.float64, device=dev)
    return plan, sigma, b, outer, inner


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None, device=None):
    """The JAX script's run; ``device`` (default: the card) is for tests."""
    argv = sys.argv[1:] if argv is None else list(argv)
    n = int(argv[0]) if len(argv) > 0 else 16
    nlevels = int(argv[1]) if len(argv) > 1 else 5
    iters = int(argv[2]) if len(argv) > 2 else 30
    tol = float(argv[3]) if len(argv) > 3 else 1e-10

    plan, sigma, b, outer, inner = build(n, nlevels, device)
    dev = outer.device
    dofs = plan.base.nelements * plan.n_local(nlevels - 1)
    print(f"n={n} levels={nlevels} dofs={dofs:,} slab=0", flush=True)

    t0 = time.perf_counter()
    setup = mixed_precision_setup(outer, inner, sigma)
    _sync(dev)
    print(f"setup (coeffs+coarse+lam_max): {time.perf_counter() - t0:.1f}s", flush=True)

    t0 = time.perf_counter()
    x, hist = mixed_precision_pcg(outer, inner, b, setup=setup, iters=2, tol=0.0)
    _sync(dev)
    print(f"compile+2 iters: {time.perf_counter() - t0:.1f}s", flush=True)

    t0 = time.perf_counter()
    x, hist = mixed_precision_pcg(outer, inner, b, setup=setup, iters=iters, tol=tol)
    _sync(dev)
    dt = time.perf_counter() - t0
    for i, h in enumerate(hist):
        print(f"  iter {i}: |r| = {h:.4e}  rel = {h / hist[0]:.4e}")
    print(
        f"mixed pcg: {len(hist) - 1} iters, rel residual "
        f"{hist[-1] / hist[0]:.3e}, {dt:.1f}s "
        f"({dt / (len(hist) - 1):.3f} s/iter)",
        flush=True,
    )
    return x, hist


if __name__ == "__main__":
    main()
