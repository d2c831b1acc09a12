"""The port's mixed-precision PCG (solver/multigrid.py::mixed_precision_pcg:
a float64 Krylov loop around a float32 Chebyshev V-cycle, K15 at the
boundary) against the JAX package's, on the CPU (the kernels' plain forms).

On the JAX suite's problems (tests/test_mixed_pcg.py:26-35: ``_problem(2,
4, 3)`` and ``(3, 2, 3)``), each package on its own setup:
  * the iterations to 1e-12 equal within 1, and the returned x within 1e-9
    relative of JAX's;
  * the JAX test's bars: the history reaches 1e-12, the float64 residual of
    the returned x recomputed from scratch is within 1.1e-12 of the initial
    one, and x is within 1e-10 of 80 float64 V-cycles;
  * float32 V-cycles alone floor orders above it;
  * the guards, with the JAX messages; the keep-best stop past the floor;
  * the reference's own findings, kept and pinned: the snapshot of the
    best iterate is taken inside the loop, on each new minimum (the
    returned x is bitwise the iterate at the minimum); when no iterate
    improves on the initial residual the LAST iterate is returned (JAX
    multigrid.py:1772, ADVICE.md item 2), not the start;
  * ``setup=`` reuse, a caller's start x left unmodified, ``coarse="mg"``
    on both solvers, and the gather-sharded solver's refusal."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from homogenization_jl_tpu.fem.local_operators import load_vector
from homogenization_jl_tpu.mesh.grid import affine_maps, hypercube as j_hypercube
from homogenization_jl_tpu.ops.plan import build_grid_plan as j_build_grid_plan
from homogenization_jl_tpu.solver.multigrid import MultigridSolver as JaxSolver
from homogenization_jl_tpu.solver.multigrid import mixed_precision_pcg as j_mixed_pcg
from homogenization_jl_tpu_torch.mesh.grid import hypercube as t_hypercube
from homogenization_jl_tpu_torch.ops.plan import build_grid_plan as t_build_grid_plan
from homogenization_jl_tpu_torch.solver.multigrid import (
    MultigridSolver,
    mixed_precision_pcg,
    mixed_precision_setup,
)

_JAX: dict = {}


def _problem(dim, n, levels, seed=3):
    """The JAX suite's _problem: (torch plan, sigma, b float64 numpy)."""
    base = t_hypercube(dim, n)
    plan = t_build_grid_plan(base, levels, slot_tables=False)
    sigma = np.random.default_rng(seed).choice([1.0, 9.0], size=(base.nelements, base.dim))
    _, _, detJ, _ = affine_maps(base)
    b = detJ[:, None] * load_vector(plan.reference.levels[levels - 1])[None, :]
    return plan, sigma, b


def _pair(plan, **kw):
    return (MultigridSolver(plan, dtype=torch.float64, device="cpu", smoother="chebyshev", **kw),
            MultigridSolver(plan, dtype=torch.float32, device="cpu", smoother="chebyshev", **kw))


def _jax_solve(dim, n, levels):
    """The JAX mixed solve of ``_problem`` (cached per configuration)."""
    key = (dim, n, levels)
    if key not in _JAX:
        base = j_hypercube(dim, n)
        plan = j_build_grid_plan(base, levels, slot_tables=False)
        _, sigma, b = _problem(dim, n, levels)
        outer = JaxSolver(plan, dtype=jnp.float64, smoother="chebyshev")
        inner = JaxSolver(plan, dtype=jnp.float32, smoother="chebyshev")
        x, hist = j_mixed_pcg(outer, inner, jnp.asarray(b), sigma, iters=60, tol=1e-12)
        _JAX[key] = (np.asarray(x), hist)
    return _JAX[key]


@pytest.mark.parametrize("dim,n,levels", [(2, 4, 3), (3, 2, 3)])
def test_mixed_pcg_matches_jax_and_reaches_f64_depth(dim, n, levels):
    plan, sigma, b_np = _problem(dim, n, levels)
    outer, inner = _pair(plan)
    b = torch.as_tensor(b_np)
    x, hist = mixed_precision_pcg(outer, inner, b, sigma, iters=60, tol=1e-12)
    xj, hj = _jax_solve(dim, n, levels)
    assert hist[-1] <= 1e-12 * hist[0], hist
    assert abs(len(hist) - len(hj)) <= 1, (len(hist), len(hj))
    assert np.abs(x.numpy() - xj).max() <= 1e-9 * np.abs(xj).max()

    # the float64 residual of the returned iterate, recomputed from scratch
    coeff64 = outer.coefficients(sigma, 0.0)
    r = outer._local_residual(x, b, coeff64, outer.nlevels - 1)
    assert float(outer.residual_norm(outer.combine(r))) <= 1.1e-12 * hist[0]

    # and x matches a pure float64 V-cycle solve of the same system
    chol64 = outer.coarse_setup(sigma, 0.0)
    lam_max = outer.estimate_lambda_max(coeff64)
    x_ref, _ = outer.zero_states()
    for _ in range(80):
        x_ref, rr = outer.vcycle(x_ref, b, coeff64, chol64, lam_max=lam_max)
    assert float(outer.residual_norm(rr)) < 1e-12 * hist[0]
    assert float((x - x_ref).abs().max()) < 1e-10 * float(x_ref.abs().max())


def test_f32_alone_floors_above_mixed():
    plan, sigma, b_np = _problem(2, 4, 3)
    outer, inner = _pair(plan)
    coeff32 = inner.coefficients(sigma, 0.0)
    chol32 = inner.coarse_setup(sigma, 0.0)
    lam_max = inner.estimate_lambda_max(coeff32)
    b32 = torch.as_tensor(b_np, dtype=torch.float32)
    x, _ = inner.zero_states()
    norms = []
    for _ in range(80):
        x, r = inner.vcycle(x, b32, coeff32, chol32, lam_max=lam_max)
        norms.append(float(inner.residual_norm(r)))
    f32_floor_rel = norms[-1] / norms[0]
    assert f32_floor_rel > 1e-9
    _, hist = mixed_precision_pcg(outer, inner, torch.as_tensor(b_np), sigma, iters=60,
                                  tol=1e-12)
    assert hist[-1] / hist[0] < 1e-3 * f32_floor_rel


def test_mixed_pcg_guards():
    plan, sigma, b_np = _problem(2, 2, 2)
    b = torch.as_tensor(b_np)
    f32 = MultigridSolver(plan, dtype=torch.float32, device="cpu", smoother="chebyshev")
    f64 = MultigridSolver(plan, dtype=torch.float64, device="cpu", smoother="chebyshev")
    cg32 = MultigridSolver(plan, dtype=torch.float32, device="cpu", smoother="cg_exact")
    with pytest.raises(AssertionError, match="chebyshev"):
        mixed_precision_pcg(f64, cg32, b, sigma, iters=1)
    with pytest.raises(AssertionError, match="higher precision"):
        mixed_precision_pcg(f32, f32, b.float(), sigma, iters=1)
    other = t_build_grid_plan(t_hypercube(2, 2), 2, slot_tables=False)
    with pytest.raises(AssertionError, match="share"):
        mixed_precision_pcg(
            f64, MultigridSolver(other, dtype=torch.float32, device="cpu", smoother="chebyshev"),
            b, sigma, iters=1)
    with pytest.raises(AssertionError, match="sigma_el or setup="):
        mixed_precision_pcg(f64, f32, b, iters=1)
    with pytest.raises(AssertionError, match="same solver kind"):
        mixed_precision_setup(f64, object(), sigma)


def test_keep_best_guard_stops_at_floor():
    """With tol=0 only the guard ends the loop before its budget; the
    returned iterate solves to float64 depth (the JAX test's bars)."""
    plan, sigma, b_np = _problem(2, 4, 3)
    outer, inner = _pair(plan)
    b = torch.as_tensor(b_np)
    x, hist = mixed_precision_pcg(outer, inner, b, sigma, iters=80, tol=0.0)
    assert len(hist) < 81, "guard did not stop the post-floor iteration"
    assert min(hist) <= 1e-13 * hist[0], hist
    coeff64 = outer.coefficients(sigma, 0.0)
    r = outer._local_residual(x, b, coeff64, outer.nlevels - 1)
    assert float(outer.residual_norm(outer.combine(r))) <= 1e-12 * hist[0]


def test_keep_best_snapshots_the_minimum_inside_the_loop():
    """The reference's snapshot sits inside the loop (ADVICE.md item 3),
    taken on each new minimum: the returned x is bitwise the iterate at the
    history's minimum, which a run stopped there without the guard
    returns."""
    plan, sigma, b_np = _problem(2, 4, 3)
    outer, inner = _pair(plan)
    b = torch.as_tensor(b_np)
    setup = mixed_precision_setup(outer, inner, sigma)
    x, hist = mixed_precision_pcg(outer, inner, b, setup=setup, iters=80, tol=0.0)
    best = int(np.argmin(hist))
    assert 0 < best < len(hist) - 1  # stopped past the minimum
    x_at, h_at = mixed_precision_pcg(outer, inner, b, setup=setup, iters=best, tol=0.0,
                                     keep_best=False)
    assert h_at == hist[: best + 1]
    assert torch.equal(x, x_at)


def test_no_improvement_returns_the_last_iterate():
    """The reference's x_best is None case, kept (JAX multigrid.py:1772;
    ADVICE.md item 2): with divergence_stop=1 the first iteration of this
    problem raises the residual (1.26x), the loop stops, and the returned x
    is that iterate, not the start (zero)."""
    plan, sigma, b_np = _problem(2, 4, 3)
    outer, inner = _pair(plan)
    b = torch.as_tensor(b_np)
    setup = mixed_precision_setup(outer, inner, sigma)
    x, hist = mixed_precision_pcg(outer, inner, b, setup=setup, iters=20, tol=0.0,
                                  divergence_stop=1)
    assert len(hist) == 2 and hist[1] > hist[0]
    x1, _ = mixed_precision_pcg(outer, inner, b, setup=setup, iters=1, tol=0.0, keep_best=False)
    assert torch.equal(x, x1) and float(x.abs().max()) > 0


def test_setup_reuse_start_and_mg_coarse():
    plan, sigma, b_np = _problem(2, 4, 3)
    outer, inner = _pair(plan)
    b = torch.as_tensor(b_np)
    setup = mixed_precision_setup(outer, inner, sigma)
    assert setup.inv_mult.dtype == torch.float32
    assert float(setup.inv_mult.max()) == 1.0 and float(setup.inv_mult.min()) < 1.0
    x0, h0 = mixed_precision_pcg(outer, inner, b, sigma, iters=5, tol=0.0)
    x1, h1 = mixed_precision_pcg(outer, inner, b, setup=setup, iters=5, tol=0.0)
    assert h0 == h1 and torch.equal(x0, x1)
    # a caller's start is copied, not updated
    start = x1.clone()
    x2, h2 = mixed_precision_pcg(outer, inner, b, setup=setup, x=x1, iters=3, tol=0.0)
    assert torch.equal(x1, start) and h2[0] < h0[0]

    # coarse="mg" on both solvers (the main path's coarse solve above 8000
    # interior base nodes): f64 depth, the same x as the dense coarse solve
    plan3, sigma3, b3 = _problem(3, 4, 2)
    xs = {}
    for kw in (dict(coarse="chol"), dict(coarse="mg", coarse_mg_dense_limit=4,
                                         coarse_mg_tol=5e-2)):
        o, i = _pair(plan3, **kw)
        xs[kw["coarse"]], h = mixed_precision_pcg(o, i, torch.as_tensor(b3), sigma3, iters=60,
                                                  tol=1e-12)
        assert h[-1] <= 1e-12 * h[0]
    assert float((xs["mg"] - xs["chol"]).abs().max()) <= 1e-10 * float(xs["chol"].abs().max())


def test_gather_sharded_solver_has_no_mixed_form(tmp_path):
    from homogenization_jl_tpu_torch.parallel.group import SlabGroup
    from homogenization_jl_tpu_torch.parallel.sharding import ShardedMultigridSolver

    plan, sigma, b_np = _problem(2, 2, 2)
    g = SlabGroup.from_file(os.path.join(tmp_path, "store"), 0, 1, device="cpu")
    try:
        o = ShardedMultigridSolver(plan, g, dtype=torch.float64, smoother="chebyshev")
        i = ShardedMultigridSolver(plan, g, dtype=torch.float32, smoother="chebyshev")
        msg = "no mixed-precision form"
        with pytest.raises(NotImplementedError, match=msg):
            mixed_precision_pcg(o, i, o.put(b_np), sigma, iters=1)
        with pytest.raises(NotImplementedError, match=msg):
            mixed_precision_setup(o, i, sigma)
        with pytest.raises(NotImplementedError, match=msg):
            o.mixed_precision_pcg()
        with pytest.raises(NotImplementedError, match="ShardedMultigridSolver has none"):
            o.mixed_precision_setup()
    finally:
        SlabGroup.destroy()
