"""The port's CG smoothers ("cg", "cg_exact"), the fourth-kind Chebyshev
smoother ("chebyshev4") and W-cycles against the JAX package, in float64 on
the CPU (the K4, K5 and K10 wrappers run their plain forms here).

Both solvers get identical state (coefficients, coarse payload, lambda_max
for "chebyshev4" and None for the CG smoothers, level stacks,
prolongations and rhs, carried across through
``interop.solver_state_from_numpy``):

  * x and r after one V-cycle, and after one W-cycle for "cg" and
    "cg_exact", agree to 1e-10;
  * a 3-cycle ``solve(method="vcycle")`` history, each package on its own
    setup, agrees to 1e-10;
  * ``solve(method="auto", tol=1e-8)`` takes the same number of cycles in
    both packages (for the CG smoothers "auto" is FMG + V-cycles, with no
    lambda_max estimate);
  * the JAX class's defaults: ``MultigridSolver(plan)`` builds the "cg"
    smoother in both packages, and lam_max is optional for the CG smoothers
    through ``vcycle``, ``fmg`` and interop.

This file runs the 2D configuration hypercube(2, 8, "cube") with 3 levels
and coarse="chol", and the bench's coarse="mg" at coarse_mg_tol=5e-2 with
"cg_exact"; test_torch_smoothers_3d.py and test_torch_smoothers_3d_solve.py
run the same parity tests on the 3D one (the JAX programs compile per
solver, so the files spread them over the test workers)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from homogenization_jl_tpu.fem.local_operators import load_vector
from homogenization_jl_tpu.mesh.grid import affine_maps, hypercube as j_hypercube
from homogenization_jl_tpu.models.checkerboard import (
    conductivity_per_element,
    generate_conductivity,
)
from homogenization_jl_tpu.ops.plan import build_grid_plan as j_build_grid_plan
from homogenization_jl_tpu.solver.multigrid import MultigridSolver as JaxSolver
from homogenization_jl_tpu_torch.interop import solver_state_from_numpy
from homogenization_jl_tpu_torch.mesh.grid import hypercube as t_hypercube
from homogenization_jl_tpu_torch.ops.plan import build_grid_plan as t_build_grid_plan
from homogenization_jl_tpu_torch.solver.multigrid import MultigridSolver as TorchSolver

TOL = 1e-10
SMOOTHERS = ["cg", "cg_exact", "chebyshev4"]
CONFIG_2D = (2, 8, 3, "cube")
CONFIG_3D = (3, 4, 3, "type")


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-300)


def _payload(sj, setup):
    """The JAX coarse payload as numpy, in interop's form."""
    if sj.coarse_kind in ("chol", "inv"):
        return np.asarray(setup)
    out = {k: np.asarray(setup[k]) for k in ("coeff", "chol", "lam_max", "lam_max0", "dinv_g")}
    out["stacks"] = [np.asarray(L.stack) for L in sj.aux_solver.levels]
    out["P_up"] = [None if L.P_up is None else np.asarray(L.P_up) for L in sj.aux_solver.levels]
    return out


def make_pair(config, smoother, cycle="V", **kw):
    """Both packages' solvers on one configuration, the JAX setup, and the
    port's state loaded from it through interop."""
    dim, n, nlevels, order = config
    pj = j_build_grid_plan(j_hypercube(dim, n, order=order), nlevels, slot_tables=False)
    pt = t_build_grid_plan(t_hypercube(dim, n, order=order), nlevels, slot_tables=False)
    kw = dict(dict(coarse="chol"), **kw)
    sj = JaxSolver(pj, smoother=smoother, cycle=cycle, combine="structured", **kw)
    st = TorchSolver(pt, dtype=torch.float64, device="cpu", smoother=smoother, cycle=cycle, **kw)
    sigma = conductivity_per_element(
        pj.base, generate_conductivity(dim, n, np.random.default_rng(0)), np.zeros(dim)
    )
    coeff = sj.coefficients(sigma, 0.0)
    setup = sj.coarse_setup(sigma, 0.0)
    lam_max = sj.estimate_lambda_max(coeff) if smoother.startswith("chebyshev") else None
    b_ref = load_vector(pj.reference.levels[nlevels - 1])
    _, _, detJ, _ = affine_maps(pj.base)
    b = detJ[:, None] * b_ref[None, :]
    state = solver_state_from_numpy(
        st, coeff=np.asarray(coeff), chol=_payload(sj, setup), lam_max=lam_max,
        stacks=[np.asarray(L.stack) for L in sj.levels],
        P_up=[None if L.P_up is None else np.asarray(L.P_up) for L in sj.levels],
        b=b,
    )
    return dict(sj=sj, st=st, sigma=sigma, coeff=coeff, setup=setup, lam_max=lam_max,
                b=b, state=state)


def check_cycle(p, seed=5):
    """One cycle from a random start: x and r of both packages."""
    sj, st, s = p["sj"], p["st"], p["state"]
    x0 = np.random.default_rng(seed).standard_normal(p["b"].shape)
    xj, rj = sj.vcycle(jnp.asarray(x0), jnp.asarray(p["b"]), p["coeff"], p["setup"],
                       lam_max=p["lam_max"])
    xt0 = torch.as_tensor(x0)
    xt, rt = st.vcycle(xt0, s.b, s.coeff, s.chol, s.lam_max)
    assert np.array_equal(xt0.numpy(), x0)  # the public vcycle leaves x alone
    assert _rel(xj, xt) <= TOL
    assert _rel(rj, rt) <= TOL


def check_history(p):
    """Three cycles of solve(method="vcycle"), each package on its own
    setup (coefficients, coarse factor, lambda_max where it takes one)."""
    sj, st, b = p["sj"], p["st"], p["b"]
    _, hj = sj.solve(jnp.asarray(b), p["sigma"], 0.0, tol=1e-14, max_cycles=3, method="vcycle")
    _, ht = st.solve(torch.as_tensor(b), p["sigma"], 0.0, tol=1e-14, max_cycles=3,
                     method="vcycle")
    assert len(hj) == len(ht) == 4
    assert np.max(np.abs(np.array(hj) - np.array(ht)) / np.array(hj)) <= TOL


def check_solve_auto(p):
    sj, st, b = p["sj"], p["st"], p["b"]
    xj, hj = sj.solve(jnp.asarray(b), p["sigma"], 0.0, tol=1e-8)
    xt, ht = st.solve(torch.as_tensor(b), p["sigma"], 0.0, tol=1e-8)
    assert len(hj) == len(ht)
    assert ht[-1] <= 1e-8
    assert _rel(xj, xt) <= 1e-8


@pytest.fixture(scope="module", params=SMOOTHERS)
def pair(request):
    return make_pair(CONFIG_2D, request.param)


@pytest.fixture(scope="module", params=["cg", "cg_exact"])
def wpair(request):
    return make_pair(CONFIG_2D, request.param, cycle="W")


def test_vcycle_matches_jax(pair):
    check_cycle(pair)


def test_vcycle_history_matches_jax(pair):
    check_history(pair)


def test_solve_auto_iterations_match_jax(pair):
    check_solve_auto(pair)


def test_wcycle_matches_jax(wpair):
    check_cycle(wpair)
    # a W-cycle is not a V-cycle: the second sub-cycles change the iterate
    p = wpair
    st, s = p["st"], p["state"]
    v = TorchSolver(st.plan, dtype=torch.float64, device="cpu", smoother=st.smoother)
    x0 = torch.zeros_like(s.b)
    xw, _ = st.vcycle(x0, s.b, s.coeff, s.chol)
    xv, _ = v.vcycle(x0, s.b, s.coeff, s.chol)
    assert _rel(xw, xv) > 1e-6


def test_mg_coarse_cg_exact_at_bench_tolerance_matches_jax():
    """The bench's coarse="mg" at coarse_mg_tol=5e-2 with the cg_exact
    smoother: the coarse PCG stops after a few iterations, so the cycle
    depends on the coarse preconditioner too."""
    p = make_pair(CONFIG_2D, "cg_exact", coarse="mg", coarse_mg_dense_limit=4,
                  coarse_mg_tol=5e-2)
    check_cycle(p, seed=8)
    assert 0 < max(p["st"].coarse_iterations) < 10


def test_default_smoother_is_cg():
    """MultigridSolver(plan) builds the JAX class's default: the "cg"
    smoother and V-cycles."""
    dim, n, nlevels, order = CONFIG_2D
    pj = j_build_grid_plan(j_hypercube(dim, n, order=order), nlevels, slot_tables=False)
    pt = t_build_grid_plan(t_hypercube(dim, n, order=order), nlevels, slot_tables=False)
    st = TorchSolver(pt, device="cpu")
    assert st.smoother == JaxSolver(pj).smoother == "cg"
    assert st.cycle == "V"
    with pytest.raises(ValueError, match="smoother"):
        TorchSolver(pt, device="cpu", smoother="jacobi")
    with pytest.raises(ValueError, match="cycle"):
        TorchSolver(pt, device="cpu", cycle="F")


def test_lam_max_is_optional_for_cg_smoothers(pair):
    """vcycle, fmg and interop take lam_max=None for the CG smoothers; the
    Chebyshev smoothers still require it, and pcg refuses the CG ones."""
    st, s = pair["st"], pair["state"]
    x0 = torch.zeros_like(s.b)
    if st.smoother.startswith("chebyshev"):
        assert s.lam_max is not None
        with pytest.raises(ValueError, match="lam_max"):
            st.vcycle(x0, s.b, s.coeff, s.chol)
        with pytest.raises(ValueError, match="lam_max"):
            st.fmg(s.b, s.coeff, s.chol)
        return
    assert s.lam_max is None
    x, r = st.vcycle(x0, s.b, s.coeff, s.chol)
    assert bool(torch.isfinite(x).all()) and float(st.residual_norm(r)) > 0
    xf, rf = st.fmg(s.b, s.coeff, s.chol)
    xj, rj = pair["sj"].fmg(jnp.asarray(pair["b"]), pair["coeff"], pair["setup"])
    assert _rel(xj, xf) <= TOL and _rel(rj, rf) <= TOL
    with pytest.raises(ValueError, match="linear SPD"):
        st.pcg(s.b, s.coeff, s.chol, iters=1)


def test_solve_estimates_lambda_max_for_chebyshev_only(pair, monkeypatch):
    """solve_driver gates the Lanczos estimate as the JAX driver does: none
    for the CG smoothers, one for the Chebyshev ones."""
    st = pair["st"]
    calls = []
    real = st.estimate_lambda_max

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(st, "estimate_lambda_max", counted)
    st.solve(torch.as_tensor(pair["b"]), pair["sigma"], 0.0, tol=1e-3)
    assert len(calls) == (1 if st.smoother.startswith("chebyshev") else 0)
