"""The lattice driver with ``device_mesh`` (a SlabGroup of spawned gloo
ranks) against the JAX driver without a mesh, both with
``lattice_order="cube"`` (the same element order, so the same random start),
in float64 on the CPU.

The configurations are the JAX suite's own sharded-lattice tests:
tests/test_homogenization.py:376-380 (n = 2, 2D, one refinement, the
driver's default smoother and inner loop, tolerance 1e-6, seed 29; 2
slabs of the 32-cube box) and :429-435 (n = 1, Chebyshev, inner="pcg",
tolerance 1e-5, seed 7; 4 slabs of the 20-cube box). sigma, and every
step's sigma, agree within 1e-9 relative, with the same cycle counts; every
rank returns the same sigma. The ordered geometry with a mesh runs on the
gather-sharded solver (tests/test_torch_sharding_driver.py)."""

import numpy as np
import pytest

from homogenization_jl_tpu.models.checkerboard import (
    checkerboard_homogenization as j_checkerboard,
)
from homogenization_jl_tpu_torch.parallel import run_slab

CASES = [
    (2, 2, dict(dim=2, refinements=1, tolerance=1e-6, seed=29, max_cycles=100)),
    (4, 1, dict(dim=2, refinements=1, tolerance=1e-5, seed=7, smoother="chebyshev",
                inner="pcg")),
]


@pytest.mark.parametrize("S,n,kw", CASES, ids=["defaults-S2", "chebyshev-pcg-S4"])
def test_slab_driver_matches_jax_single_device(S, n, kw):
    sigma, trace = j_checkerboard(n, geometry="lattice", lattice_order="cube",
                                  return_trace=True, **kw)
    outs = run_slab.spawn_ranks(S, dict(kind="driver", kwargs=dict(
        n=n, lattice_order="cube", **kw)))
    got = outs[0]
    assert all(o["sigma"] == got["sigma"] for o in outs)
    assert abs(got["sigma"] - sigma) <= 1e-9 * abs(sigma), (got["sigma"], sigma)
    assert got["cycles_per_step"] == trace.cycles_per_step
    np.testing.assert_allclose(got["sigma_steps"], trace.sigma_steps, rtol=1e-9)
