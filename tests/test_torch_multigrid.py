"""The PyTorch port's multigrid solver against the JAX package's, in float64
on the CPU (the wrappers run their plain forms here).

Both solvers get identical state (coefficients, coarse factor, lambda_max,
level stacks, prolongations and rhs, carried across as numpy through
``interop.solver_state_from_numpy``): x and r after one V-cycle, the FMG
output and a 5-iteration PCG history agree to 1e-10. Separately, the port's
own setup (coefficients, factor, Lanczos lambda_max from the same seed)
matches the JAX package's, and ``solve(tol=1e-8)`` from both packages takes
the same number of iterations."""

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
# the bench's element order in 3D; cube-major in 2D
CONFIGS = [(3, 4, 3, "type"), (2, 8, 3, "cube")]


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-300)


@pytest.fixture(scope="module", params=CONFIGS, ids=lambda c: "%dd-n%d-L%d-%s" % c)
def pair(request):
    dim, n, nlevels, order = request.param
    pj = j_build_grid_plan(j_hypercube(dim, n, order=order), nlevels, slot_tables=False)
    pt = t_build_grid_plan(t_hypercube(dim, n, order=order), nlevels, slot_tables=False)
    sj = JaxSolver(pj, smoother="chebyshev", combine="structured", coarse="chol")
    st = TorchSolver(pt, dtype=torch.float64, device="cpu", smoother="chebyshev", coarse="chol")
    sigma = conductivity_per_element(
        pj.base, generate_conductivity(dim, n, np.random.default_rng(0)), np.zeros(dim)
    )
    coeff = sj.coefficients(sigma, 0.0)
    chol = sj.coarse_setup(sigma, 0.0)
    lam_max = sj.estimate_lambda_max(coeff)
    b_ref = load_vector(pj.reference.levels[nlevels - 1])
    _, _, detJ, _ = affine_maps(pj.base)
    b = detJ[:, None] * b_ref[None, :]
    state = solver_state_from_numpy(
        st,
        coeff=np.asarray(coeff),
        chol=np.asarray(chol),
        lam_max=lam_max,
        stacks=[np.asarray(L.stack) for L in sj.levels],
        P_up=[None if L.P_up is None else np.asarray(L.P_up) for L in sj.levels],
        b=b,
    )
    return dict(sj=sj, st=st, sigma=sigma, coeff=coeff, chol=chol, lam_max=lam_max,
                b=b, state=state)


def test_port_setup_matches_jax(pair):
    sj, st, sigma = pair["sj"], pair["st"], pair["sigma"]
    assert np.array_equal(np.asarray(pair["coeff"]), st.coefficients(sigma, 0.0).numpy())
    assert _rel(pair["chol"], st.coarse_setup(sigma, 0.0)) <= 1e-12
    for Lj, Lt in zip(sj.levels, st.levels):
        assert np.array_equal(np.asarray(Lj.stack), Lt.stack.numpy())
        assert np.array_equal(np.asarray(Lj.first_copy_mask), Lt.first_copy_mask.numpy())
        if Lj.P_up is not None:
            assert np.array_equal(np.asarray(Lj.P_up), Lt.P_up.numpy())
    # Lanczos lambda_max from the same seed, on the port's own coefficients
    lam_t = st.estimate_lambda_max(st.coefficients(sigma, 0.0))
    assert abs(lam_t - pair["lam_max"]) <= TOL * pair["lam_max"]


def test_vcycle_matches_jax(pair):
    sj, st, s = pair["sj"], pair["st"], pair["state"]
    x0 = np.random.default_rng(5).standard_normal(pair["b"].shape)
    xj, rj = sj.vcycle(jnp.asarray(x0), jnp.asarray(pair["b"]), pair["coeff"],
                       pair["chol"], lam_max=pair["lam_max"])
    xt0 = torch.as_tensor(x0)
    xt, rt = st.vcycle(xt0, s.b, s.coeff, s.chol, s.lam_max)
    assert np.array_equal(xt0.numpy(), x0)  # the public vcycle leaves x alone
    assert _rel(xj, xt) <= TOL
    assert _rel(rj, rt) <= TOL


def test_fmg_matches_jax(pair):
    sj, st, s = pair["sj"], pair["st"], pair["state"]
    xj, rj = sj.fmg(jnp.asarray(pair["b"]), pair["coeff"], pair["chol"],
                    lam_max=pair["lam_max"])
    xt, rt = st.fmg(s.b, s.coeff, s.chol, s.lam_max)
    assert _rel(xj, xt) <= TOL
    assert _rel(rj, rt) <= TOL


def test_pcg_history_matches_jax(pair):
    sj, st, s = pair["sj"], pair["st"], pair["state"]
    xj, hj = sj.pcg(jnp.asarray(pair["b"]), pair["coeff"], pair["chol"],
                    lam_max=pair["lam_max"], iters=5)
    xt, ht = st.pcg(s.b, s.coeff, s.chol, s.lam_max, iters=5)
    assert len(hj) == len(ht) == 6
    assert _rel(xj, xt) <= TOL
    assert np.max(np.abs(np.array(hj) - np.array(ht)) / np.array(hj)) <= TOL


def test_solve_iterations_match_jax(pair):
    """solve(method="auto") runs each package's own setup end to end."""
    sj, st, sigma = pair["sj"], pair["st"], pair["sigma"]
    b = pair["b"]
    xj, hj = sj.solve(jnp.asarray(b), sigma, 0.0, tol=1e-8)
    xt, ht = st.solve(torch.as_tensor(b), sigma, 0.0, tol=1e-8)
    assert len(hj) == len(ht)
    assert ht[-1] <= 1e-8
    assert _rel(xj, xt) <= 1e-8
