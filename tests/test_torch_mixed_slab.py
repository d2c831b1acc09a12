"""Mixed-precision PCG on slabs (parallel/slab.py: the slab solver's
``_mixed_pcg_programs``, through ``run_slab``'s job kind "mixed") on 2
spawned gloo ranks against the JAX package's single-device mixed solve, in
float64 / float32 on the CPU (the kernels' plain forms).

The JAX suite's slab test (tests/test_mixed_pcg.py:90-140): the cube-order
``hypercube(3, 8)``, 3 levels, sigma ``default_rng(3).choice([1, 9])``,
the ``load_vector`` rhs, Chebyshev outer float64 and inner float32
(coarse="chol": the job's run_mixed_pcg pair, whose other inner options,
``smooth_precision="high"`` and ``coarse_mg_tol``, change nothing here),
40 iterations to 1e-12. The slab history reaches 1e-12 within 2
iterations of the single-device count, its first 6 entries track the
single-device history within 1e-4 (the float32 preconditioner's rounding
differs across layouts), every rank reads the same history bit for bit,
and the joined slab x is within 1e-9 relative of JAX's x. Rank 0 also runs
the port's single-device solve of the same problem (``compare``).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from homogenization_jl_tpu.fem.local_operators import load_vector
from homogenization_jl_tpu.mesh.grid import affine_maps, hypercube
from homogenization_jl_tpu.ops.plan import build_grid_plan
from homogenization_jl_tpu.solver.multigrid import MultigridSolver, mixed_precision_pcg
from homogenization_jl_tpu_torch.interop import join_slabs
from homogenization_jl_tpu_torch.parallel import run_slab


@pytest.fixture(scope="module")
def reference():
    base = hypercube(3, 8)  # cube-major (the slab requirement)
    plan = build_grid_plan(base, 3, slot_tables=False)
    sigma = np.random.default_rng(3).choice([1.0, 9.0], size=(base.nelements, base.dim))
    _, _, detJ, _ = affine_maps(base)
    b = jnp.asarray(detJ[:, None] * load_vector(plan.reference.levels[2])[None, :],
                    dtype=jnp.float64)
    outer = MultigridSolver(plan, dtype=jnp.float64, smoother="chebyshev")
    inner = MultigridSolver(plan, dtype=jnp.float32, smoother="chebyshev")
    x, hist = mixed_precision_pcg(outer, inner, b, sigma, iters=40, tol=1e-12)
    return sigma, np.asarray(x), hist


def test_mixed_pcg_on_two_slabs_matches_jax(reference):
    sigma, xj, hj = reference
    outs = run_slab.spawn_ranks(2, {"kind": "mixed", "kwargs": dict(
        dim=3, n=8, nlevels=3, iters=40, tol=1e-12, sigma=sigma, compare=True,
        keep_states=True)})
    h = outs[0]["history"]
    assert all(o["history"] == h for o in outs)  # rank-order sums: the same bits
    assert h[-1] <= 1e-12 * h[0], h
    assert abs(len(h) - len(hj)) <= 2, (len(h), len(hj))
    for a, c in zip(h[:6], hj[:6]):
        assert abs(a - c) <= 1e-4 * max(a, c), (h, hj)
    x = join_slabs([o["x"] for o in outs])
    assert np.abs(x - xj).max() <= 1e-9 * np.abs(xj).max()
    # the port's single-device solve on rank 0, and the slab's kernels
    assert outs[0]["history_single"][-1] <= 1e-12 * outs[0]["history_single"][0]
    assert outs[0]["x_rel_diff"] <= 1e-9
    assert outs[0]["coarse"] == "chol" and outs[0]["slabs"] == 2
