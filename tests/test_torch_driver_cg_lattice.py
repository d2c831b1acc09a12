"""The port's lattice-geometry driver with smoother="cg_exact" against the
JAX driver, in float64 on the CPU: two outer steps (a shrink between
them), with the schedule patched to compute_boundary_layer =
floor(lam**-0.5) as tests/test_torch_driver_ordered.py patches it; sigma
per step to 1e-10 relative and equal cycles per step (a file of its own,
beside test_torch_driver_cg.py, so that the test workers compile the JAX
driver's programs side by side)."""

import jax.numpy as jnp
import torch

from homogenization_jl_tpu.models import checkerboard as jcb
from homogenization_jl_tpu_torch.models import checkerboard as tcb
from test_torch_driver_cg import _check, _layer


def test_lattice_driver_cg_exact_matches_jax(monkeypatch):
    monkeypatch.setattr(jcb, "compute_boundary_layer", _layer)
    monkeypatch.setattr(tcb, "compute_boundary_layer", _layer)
    kw = dict(dim=2, refinements=2, tolerance=1e-8, seed=5, smoother="cg_exact",
              geometry="lattice", return_trace=True)
    _, tj = jcb.checkerboard_homogenization(1, dtype=jnp.float64, **kw)
    _, tt = tcb.checkerboard_homogenization(1, dtype=torch.float64, device="cpu", **kw)
    assert len(tt.sigma_steps) == 2
    _check(tj, tt)
