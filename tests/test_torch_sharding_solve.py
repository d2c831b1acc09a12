"""The port's gather-sharded solver (parallel/sharding.py) on spawned gloo
ranks against the JAX package's single-device MultigridSolver: PCG, FMG
and the one-call solve(), in float64 on the CPU.

The JAX suite's own cases (tests/test_sharding.py:196-268) on its problem
(hypercube(2, 4), 3 levels, default_rng(3), lam = 0): 6 Chebyshev PCG
iterations with coarse="chol" (lambda_max, the history and x within 1e-9),
one FMG start (x and the residual norm within 1e-9), and solve(tol=1e-6,
max_cycles=20) with the "cg" smoother (FMG + V-cycles) and the Chebyshev
one (FMG + PCG), the histories and x within 1e-8 (the suite's bar there).
Every rank reads the same history bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest

from homogenization_jl_tpu.solver.multigrid import MultigridSolver as JaxSolver
from homogenization_jl_tpu_torch.interop import join_shards
from test_torch_sharding import TOL, jax_setup, rel, spawn


def test_sharded_pcg_matches_jax_single_device():
    plan, sigma, b = jax_setup(2, 4, 3)
    ref = JaxSolver(plan, dtype=jnp.float64, coarse="chol", smoother="chebyshev")
    coeff = ref.coefficients(sigma, 0.0)
    lam_max = ref.estimate_lambda_max(coeff)
    x, hist = ref.pcg(jnp.asarray(b), coeff, ref.coarse_cholesky(sigma, 0.0), lam_max=lam_max,
                      iters=6)
    outs = spawn(4, dim=2, n=4, nlevels=3, mode="pcg", iters=6,
                 solver_opts=dict(coarse="chol", smoother="chebyshev"))
    assert abs(outs[0]["lam_max"] - lam_max) <= TOL * lam_max
    h = outs[0]["hist"]
    assert len(h) == len(hist)
    for a, c in zip(h, hist):
        assert abs(a - c) <= TOL * c
    assert rel(join_shards([o["x"] for o in outs]), x) <= TOL


def test_sharded_fmg_matches_jax_single_device():
    plan, sigma, b = jax_setup(2, 4, 3)
    ref = JaxSolver(plan, dtype=jnp.float64, coarse="chol")
    coeff = ref.coefficients(sigma, 0.0)
    x, r = ref.fmg(jnp.asarray(b), coeff, ref.coarse_cholesky(sigma, 0.0))
    outs = spawn(2, dim=2, n=4, nlevels=3, mode="fmg", solver_opts=dict(coarse="chol"))
    assert rel(join_shards([o["x"] for o in outs]), x) <= TOL
    rn = float(ref.residual_norm(r))
    assert abs(outs[0]["hist"][0] - rn) <= TOL * rn


@pytest.mark.parametrize("smoother", ["cg", "chebyshev"])
def test_sharded_solve_matches_jax_single_device(smoother):
    plan, sigma, b = jax_setup(2, 4, 3)
    ref = JaxSolver(plan, dtype=jnp.float64, coarse="chol", smoother=smoother)
    x, hist = ref.solve(jnp.asarray(b), sigma, 0.0, tol=1e-6, max_cycles=20)
    outs = spawn(2, dim=2, n=4, nlevels=3, mode="solve", tol=1e-6,
                 solver_opts=dict(coarse="chol", smoother=smoother))
    h = outs[0]["hist"]
    assert h[-1] <= 1e-6 and len(h) == len(hist)
    for a, c in zip(h, hist):
        assert abs(a - c) <= 1e-8 * c
    assert rel(join_shards([o["x"] for o in outs]), x) <= 1e-8
