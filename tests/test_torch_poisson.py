"""The port's Poisson demos (models/poisson.py) against the JAX package's, in
float64 on the CPU.

  * ``local_unit_rhs``: equal to JAX's, array for array;
  * ``checkerboard_hypercube_multigrid`` on the 2D cases of
    tests/test_multigrid.py:18 ((dim, n, levels, coarse) = (2, 4, 3, chol),
    (2, 4, 3, cg); 12 cycles; the 3D case in
    tests/test_torch_poisson_3d.py, BASELINE config 3 in
    tests/test_torch_poisson_config3.py: the JAX compiles take most of each
    file's time, and test workers run the files side by side): every
    history entry within
    1e-10 x the first of JAX's (measured 6e-16: rounding differences scale
    with the first residual, not with the entry, so a relative bar on the
    late entries would measure the floor: 3.9e-10 at 8e-8 of the first),
    x within 1e-10 of JAX's largest |x| (measured 1.5e-15), the JAX test's
    contraction bar;
  * BASELINE config 1 (tests/test_multigrid.py:71-96): |r| <= 1e-8 within
    30 cycles, its history beside JAX's under the same bar;
  * ``coarse="mg"``: JAX's function passes no coarse payload for it and
    trips its own assertion; the port passes ``coarse_setup`` (the same
    payload as JAX's for "chol" and "cg") and runs, within 1e-6 x the
    first residual of its "cg" run (the coarse PCG stops at 1e-8; measured
    7.8e-10). "cg", not "chol": the dense factor of this base's 16,129
    interior nodes is 2 GB and takes 39 s on one core;
  * ``checkerboard_hypercube_full`` at n = 2: the same arrays as JAX's
    (host code in both packages)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from homogenization_jl_tpu.mesh.grid import hypercube as j_hypercube
from homogenization_jl_tpu.models import poisson as jp
from homogenization_jl_tpu.ops.plan import build_grid_plan as j_build_grid_plan
from homogenization_jl_tpu.solver.multigrid import MultigridSolver as JaxSolver
from homogenization_jl_tpu_torch.mesh.grid import hypercube
from homogenization_jl_tpu_torch.models import poisson as tp
from homogenization_jl_tpu_torch.ops.plan import build_grid_plan
from homogenization_jl_tpu_torch.solver.multigrid import MultigridSolver

TOL = 1e-10


def _close_histories(ht, hj, tol=TOL):
    ht, hj = np.asarray(ht), np.asarray(hj)
    assert ht.shape == hj.shape
    assert np.abs(ht - hj).max() <= tol * hj[0], (ht, hj)


@pytest.mark.parametrize("dim,n,nlevels", [(2, 3, 3), (3, 2, 2)])
def test_local_unit_rhs_matches_jax(dim, n, nlevels):
    for dt, jdt in ((torch.float64, jnp.float64), (torch.float32, jnp.float32)):
        s = MultigridSolver(build_grid_plan(hypercube(dim, n), nlevels, slot_tables=False),
                            dtype=dt, device="cpu")
        sj = JaxSolver(j_build_grid_plan(j_hypercube(dim, n), nlevels, slot_tables=False),
                       dtype=jdt)
        bt, bj = tp.local_unit_rhs(s), np.asarray(jp.local_unit_rhs(sj))
        assert bt.dtype == dt and bt.device.type == "cpu"
        assert bt.numpy().dtype == bj.dtype and np.array_equal(bt.numpy(), bj)


@pytest.mark.parametrize("dim,n,levels,coarse", [(2, 4, 3, "chol"), (2, 4, 3, "cg")])
def test_checkerboard_multigrid_matches_jax(dim, n, levels, coarse):
    hj, xj, _ = jp.checkerboard_hypercube_multigrid(n, dim=dim, refinements=levels - 1,
                                                    max_cycles=12, coarse=coarse)
    ht, xt, s = tp.checkerboard_hypercube_multigrid(n, dim=dim, refinements=levels - 1,
                                                    max_cycles=12, coarse=coarse, device="cpu")
    assert s.device.type == "cpu" and s.dtype == torch.float64 and s.combine_kind == "structured"
    _close_histories(ht, hj)
    xj = np.asarray(xj)
    assert np.abs(xt.numpy() - xj).max() <= TOL * np.abs(xj).max()
    assert ht[-1] < 1e-4 * ht[0]


def _config1(solver, rhs, sigma, cycles=40):
    """tests/test_multigrid.py:71-96's loop: V-cycles from zero until
    |r| <= 1e-8."""
    coeff = solver.coefficients(sigma, 0.0)
    chol = solver.coarse_cholesky(sigma, 0.0)
    x, _ = solver.zero_states()
    b = rhs(solver)
    hist = []
    for _ in range(cycles):
        x, r = solver.vcycle(x, b, coeff, chol)
        hist.append(float(solver.residual_norm(r)))
        if hist[-1] <= 1e-8:
            break
    return hist


def test_baseline_config1_to_1e8_within_30_cycles():
    base = hypercube(2, 8, scale=1.0 / 8.0)  # the unit square
    sigma = np.ones((base.nelements, 2))
    ht = _config1(MultigridSolver(build_grid_plan(base, 3), device="cpu"), tp.local_unit_rhs,
                  sigma)
    hj = _config1(JaxSolver(j_build_grid_plan(j_hypercube(2, 8, scale=1.0 / 8.0), 3)),
                  jp.local_unit_rhs, sigma)
    assert ht[-1] <= 1e-8 and len(ht) <= 30, ht
    _close_histories(ht, hj)


def test_coarse_mg_runs_in_the_port_where_jax_asserts():
    """hypercube(2, 128): the smallest 2D base that coarse="mg" coarsens
    at its default dense limit (127^2 interior nodes > 4000)."""
    with pytest.raises(AssertionError, match="coarse_setup"):
        jp.checkerboard_hypercube_multigrid(128, dim=2, refinements=1, max_cycles=1,
                                            coarse="mg")
    hm, xm, sm = tp.checkerboard_hypercube_multigrid(128, dim=2, refinements=1, max_cycles=3,
                                                     coarse="mg", device="cpu")
    hc, xc, _ = tp.checkerboard_hypercube_multigrid(128, dim=2, refinements=1, max_cycles=3,
                                                    coarse="cg", device="cpu")
    assert sm.coarse_kind == "mg" and len(sm.coarse_iterations) == 3
    _close_histories(hm, hc, 1e-6)
    assert (xm - xc).abs().max() <= 1e-6 * xc.abs().max()


@pytest.mark.parametrize("dim", [2, 3])
def test_checkerboard_full_matches_jax(dim):
    mt, xt, ht, st = tp.checkerboard_hypercube_full(2, dim=dim, refinements=2)
    mj, xj, hj, sj = jp.checkerboard_hypercube_full(2, dim=dim, refinements=2)
    assert np.array_equal(mt.nodes, mj.nodes) and np.array_equal(mt.elements, mj.elements)
    for a, b in ((xt, xj), (ht, hj), (st, sj)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.abs(xt).max() > 0 and np.abs(ht).max() > 0
