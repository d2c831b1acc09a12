"""The gather combine (kernel K8's plain form) and the gather-combine
solver of the port against the JAX package, in float64 on the CPU.

  * ``combine_gather_rows`` on the reference-order (ordered) bases of the
    driver, 2D and 3D, every level: within 1e-12 of the JAX form, every
    copy of every shared DOF bitwise equal, with and without the mask
    epilogue (the kernel's table walk, emulated in NumPy, is held to the
    plain form's bits in tests/test_torch_gather_walk.py);
  * ``MultigridSolver(combine="auto")`` on an ordered base takes the gather
    combine and the mask constraint, as the JAX solver does; with the JAX
    state carried over (interop), x and r after one V-cycle, FMG and a
    5-iteration PCG history agree to 1e-10, for coarse="chol" and "mg"."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from homogenization_jl_tpu.fem.local_operators import load_vector
from homogenization_jl_tpu.mesh.grid import affine_maps
from homogenization_jl_tpu.models import checkerboard as jcb
from homogenization_jl_tpu.ops import interfaces as j_if
from homogenization_jl_tpu.ops.plan import build_grid_plan as j_build_grid_plan
from homogenization_jl_tpu.solver.multigrid import MultigridSolver as JaxSolver
from homogenization_jl_tpu_torch.interop import solver_state_from_numpy
from homogenization_jl_tpu_torch.ops import interfaces as t_if
from homogenization_jl_tpu_torch.ops.plan import build_grid_plan as t_build_grid_plan
from homogenization_jl_tpu_torch.solver.multigrid import MultigridSolver as TorchSolver

OPS_TOL = 1e-12
TOL = 1e-10


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _bits(a):
    return np.asarray(a).view(np.int64)


def copies_equal(y, plan, k):
    """Every copy of every shared DOF of y has the same bits."""
    lay = plan.reference.layout[k]
    lp = plan.levels[k]
    for tabs, offsets, width in (
        (lp.gather.face, lay.face_offsets, lay.npf),
        (lp.gather.edge, lay.edge_offsets, lay.npe),
        (lp.gather.corner, lay.corner_cols, 1),
    ):
        if tabs is None or width == 0:
            continue
        oe, ol, om, _ = (np.asarray(a) for a in tabs)
        cols = np.asarray(offsets)[ol][..., None] + np.arange(width)
        vals = _bits(y)[oe[..., None], cols]
        first = np.broadcast_to(vals[:, :1], vals.shape)
        if not np.array_equal(np.where(om[..., None] != 0, vals, first), first):
            return False
    return True


@pytest.fixture(scope="module", params=[(2, 3, 3), (3, 2, 3)], ids=["2d-R3-L3", "3d-R2-L3"])
def ordered_plans(request):
    dim, radius, nlevels = request.param
    mesh, _, _ = jcb.ordered_hypercube(dim, radius)
    return (j_build_grid_plan(mesh, nlevels, slot_tables=False),
            t_build_grid_plan(mesh, nlevels, slot_tables=False))


def test_gather_combine_matches_jax(ordered_plans):
    pj, pt = ordered_plans
    js = JaxSolver(pj, combine="gather", smoother="chebyshev")
    rng = np.random.default_rng(3)
    for k in range(pt.nlevels):
        gt = t_if.build_gather_tables(pt, k)
        x = rng.standard_normal((pt.base.nelements, pt.n_local(k)))
        ref = np.asarray(j_if.combine_gather_rows(jnp.asarray(x), js.levels[k].row["gather"],
                                                  js.row_layout[k]))
        got = t_if.combine_gather_rows(torch.as_tensor(x), gt).numpy()
        assert _rel(got, ref) <= OPS_TOL, k
        assert copies_equal(got, pt, k), k
        bm = pt.levels[k].boundary_mask != 0
        masked = t_if.combine_gather_rows(torch.as_tensor(x), gt, mask=torch.as_tensor(bm)).numpy()
        assert np.array_equal(_bits(masked), _bits(got * bm)), k


def test_gather_tables_reject_bad_inputs(ordered_plans):
    _, pt = ordered_plans
    gt = t_if.build_gather_tables(pt, 1)
    x = torch.zeros((pt.base.nelements, pt.n_local(1)), dtype=torch.float64)
    with pytest.raises(ValueError):
        t_if.combine_gather_rows(x[:, :-1], gt)
    with pytest.raises(ValueError):
        t_if.combine_gather_rows(x[:-1], gt)
    with pytest.raises(ValueError):
        t_if.combine_gather_rows(x, gt, mask=torch.ones(x.shape))  # mask must be bool
    with pytest.raises(TypeError):
        t_if.combine_gather_rows(x.to(torch.float16), gt)


# --------------------------------------------------------------------- #
# the gather-combine solver with the JAX state carried over
# --------------------------------------------------------------------- #
def _payload(sj, setup):
    if sj.coarse_kind in ("chol", "inv"):
        return np.asarray(setup)
    out = {k: np.asarray(setup[k]) for k in ("coeff", "chol", "lam_max", "lam_max0", "dinv_g")}
    out["stacks"] = [np.asarray(L.stack) for L in sj.aux_solver.levels]
    out["P_up"] = [None if L.P_up is None else np.asarray(L.P_up) for L in sj.aux_solver.levels]
    return out


def make_ordered_pair(coarse, dim=2, radius=4, nlevels=3):
    """Both packages' solvers on one ordered base, the JAX setup, and the
    port's state loaded from it (interop)."""
    mesh, _, _ = jcb.ordered_hypercube(dim, radius)
    pj = j_build_grid_plan(mesh, nlevels, slot_tables=False)
    pt = t_build_grid_plan(mesh, nlevels, slot_tables=False)
    kw = dict(coarse=coarse, coarse_mg_dense_limit=4, coarse_mg_tol=1e-12)
    sj = JaxSolver(pj, smoother="chebyshev", **kw)
    st = TorchSolver(pt, dtype=torch.float64, device="cpu", smoother="chebyshev", **kw)
    assert sj.combine_kind == st.combine_kind == "gather"
    assert st.constraint_kind == "mask"
    field = jcb.generate_conductivity(dim, 2 * radius, np.random.default_rng(2))
    sigma = jcb.conductivity_per_element(mesh, field, np.full(dim, float(radius)))
    coeff = sj.coefficients(sigma, 0.5)
    setup = sj.coarse_setup(sigma, 0.5)
    lam_max = sj.estimate_lambda_max(coeff)
    _, _, detJ, _ = affine_maps(mesh)
    b = detJ[:, None] * load_vector(pj.reference.levels[nlevels - 1])[None, :]
    state = solver_state_from_numpy(
        st, coeff=np.asarray(coeff), chol=_payload(sj, setup), lam_max=lam_max,
        stacks=[np.asarray(L.stack) for L in sj.levels],
        P_up=[None if L.P_up is None else np.asarray(L.P_up) for L in sj.levels], b=b,
    )
    return dict(sj=sj, st=st, sigma=sigma, coeff=coeff, setup=setup, lam_max=lam_max,
                b=b, state=state)


@pytest.fixture(scope="module", params=["chol", "mg"])
def gpair(request):
    return make_ordered_pair(request.param)


def test_gather_solver_setup_matches_jax(gpair):
    sj, st, sigma = gpair["sj"], gpair["st"], gpair["sigma"]
    for Lj, Lt in zip(sj.levels, st.levels):
        assert np.array_equal(np.asarray(Lj.boundary_mask), Lt.boundary_mask.numpy())
    lam = st.estimate_lambda_max(st.coefficients(sigma, 0.5))
    assert abs(lam - gpair["lam_max"]) <= TOL * gpair["lam_max"]


def test_gather_solver_cycles_match_jax(gpair):
    sj, st, s = gpair["sj"], gpair["st"], gpair["state"]
    b = jnp.asarray(gpair["b"])
    x0 = np.random.default_rng(5).standard_normal(gpair["b"].shape)
    xj, rj = sj.vcycle(jnp.asarray(x0), b, gpair["coeff"], gpair["setup"], lam_max=gpair["lam_max"])
    xt, rt = st.vcycle(torch.as_tensor(x0), s.b, s.coeff, s.chol, s.lam_max)
    assert _rel(xt, xj) <= TOL and _rel(rt, rj) <= TOL
    xj, rj = sj.fmg(b, gpair["coeff"], gpair["setup"], lam_max=gpair["lam_max"])
    xt, rt = st.fmg(s.b, s.coeff, s.chol, s.lam_max)
    assert _rel(xt, xj) <= TOL and _rel(rt, rj) <= TOL
    xj, hj = sj.pcg(b, gpair["coeff"], gpair["setup"], lam_max=gpair["lam_max"], iters=5)
    xt, ht = st.pcg(s.b, s.coeff, s.chol, s.lam_max, iters=5)
    assert _rel(xt, xj) <= TOL
    assert np.max(np.abs(np.array(hj) - np.array(ht)) / np.array(hj)) <= TOL
