"""The ordered driver with ``device_mesh`` (a SlabGroup of 2 spawned gloo
ranks, each step on the gather-sharded solver) against the JAX ordered
driver without a mesh, in float64 on the CPU.

The configurations are the JAX suite's own sharded-ordered tests:
tests/test_sharding.py:150-165 (n = 2, 2D, one refinement, the driver's
default smoother and inner loop, tolerance 1e-6, seed 5: two steps and a
shrink, whose state is joined across the ranks, sliced, masked and cut to
the new partition) and tests/test_homogenization.py:421-426 (n = 1,
Chebyshev, inner="pcg", tolerance 1e-5, seed 7). sigma, and every step's
sigma, agree within 1e-9 relative with the same cycle counts, and every
rank returns the same sigma."""

import numpy as np
import pytest

from homogenization_jl_tpu.models.checkerboard import (
    checkerboard_homogenization as j_checkerboard,
)
from homogenization_jl_tpu_torch.parallel import run_slab

CASES = [
    (2, dict(dim=2, refinements=1, tolerance=1e-6, seed=5, max_cycles=60)),
    (1, dict(dim=2, refinements=1, tolerance=1e-5, seed=7, smoother="chebyshev", inner="pcg")),
]


@pytest.mark.parametrize("n,kw", CASES, ids=["defaults", "chebyshev-pcg"])
def test_sharded_ordered_driver_matches_jax_single_device(n, kw):
    sigma, trace = j_checkerboard(n, geometry="ordered", return_trace=True, **kw)
    outs = run_slab.spawn_ranks(2, dict(kind="ordered_driver", kwargs=dict(n=n, **kw)))
    got = outs[0]
    assert all(o["sigma"] == got["sigma"] for o in outs)
    assert abs(got["sigma"] - sigma) <= 1e-9 * abs(sigma), (got["sigma"], sigma)
    assert got["cycles_per_step"] == trace.cycles_per_step
    np.testing.assert_allclose(got["sigma_steps"], trace.sigma_steps, rtol=1e-9)
