"""The port's homogenization driver against the JAX driver, end to end, in
float64 on the CPU: the reference-order ("ordered") geometry with
inner="pcg". tests/test_torch_driver_lattice.py and
test_torch_driver_vcycle.py run the lattice geometry (the JAX driver
compiles slowly, so each case has a file that a test worker runs beside the
others).

Both drivers run n = 3 in 2D with 2 refinements, smoother="chebyshev", and
the schedule patched to compute_boundary_layer = floor(lam**-0.5) (as the
JAX package's own driver tests patch it): four outer steps on the radii
9 -> 6 -> 6 -> 4, two shrinks and one step that keeps its domain. The
ordered run rebuilds its plan and its gather-combine solver (coarse
"chol") at each shrink; the lattice run keeps one solver and passes the
shrunken masks (coarse "cg"). Both drivers must take the same number of
iterations in every step, and their sigma after every step must agree to
1e-10 relative."""

import math

import jax.numpy as jnp
import numpy as np
import torch

from homogenization_jl_tpu.models import checkerboard as jcb
from homogenization_jl_tpu_torch.models import checkerboard as tcb

TOL = 1e-10
RADII = [9, 6, 6, 4]


def _layer(lam, n):
    return int(math.floor(lam**-0.5))


def run_both(monkeypatch, geometry, inner, **extra):
    """Both drivers on the patched schedule (``extra``: further driver
    arguments for both); returns their traces."""
    monkeypatch.setattr(jcb, "compute_boundary_layer", _layer)
    monkeypatch.setattr(tcb, "compute_boundary_layer", _layer)
    kw = dict(dim=2, refinements=2, tolerance=1e-8, seed=5, smoother="chebyshev",
              inner=inner, geometry=geometry, return_trace=True, **extra)
    sj, tj = jcb.checkerboard_homogenization(3, dtype=jnp.float64, **kw)
    st, tt = tcb.checkerboard_homogenization(3, dtype=torch.float64, device="cpu", **kw)
    assert len(tt.sigma_steps) == len(RADII)
    assert tt.cycles_per_step == tj.cycles_per_step
    rel = np.abs(np.array(tt.sigma_steps) - np.array(tj.sigma_steps)) / np.abs(tj.sigma_steps)
    assert rel.max() <= TOL, (tt.sigma_steps, tj.sigma_steps)
    assert abs(st - sj) <= TOL * abs(sj)
    assert all(r > 0 for r in tt.residuals)
    return tj, tt


def test_ordered_driver_pcg_matches_jax(monkeypatch):
    run_both(monkeypatch, "ordered", "pcg")
