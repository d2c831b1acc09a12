"""The coarse solves below the implicit hierarchy (coarse="inv", "cg", "mg")
of the PyTorch port against the JAX package, in float64 on the CPU (where
the K6/K7 wrappers run their plain forms).

Two small configurations, both with coarse_mg_dense_limit=4: 3D
hypercube(3, 4, "type") with 3 levels (coarsening depth m = 1, a 15-point
stencil) and 2D hypercube(2, 8, "cube") with 3 levels (m = 2, 7 points).

  * host copies (solver/coarse.py, ops/stencil.py tables) equal the JAX
    arrays exactly;
  * the lattice-stencil and coarse-gather plain forms match ops/stencil.py,
    copy_to_base / _to_global / distribute to 1e-12, and a NumPy emulation
    of the K6 kernel's per-thread arithmetic, reading its by-value table,
    reproduces them (the CUDA kernel cannot run here);
  * the segment sum adds each node's contributions in the presorted order;
  * with the JAX payload carried over by interop: V-cycle x and r, the FMG
    output and a 5-iteration flexible-PCG history to 1e-10, for each of
    "mg" (coarse_mg_tol=1e-12), "inv" and "cg"; solve(tol=1e-8) takes the
    same number of iterations in both packages. This file runs them on the
    2D configuration; test_torch_coarse_3d.py ("inv", "cg") and
    test_torch_coarse_mg3d.py ("mg") run the same tests on the 3D one."""

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
from homogenization_jl_tpu.ops import interfaces as j_if
from homogenization_jl_tpu.ops import stencil as j_stencil
from homogenization_jl_tpu.ops.plan import build_grid_plan as j_build_grid_plan
from homogenization_jl_tpu.solver import coarse as j_coarse
from homogenization_jl_tpu.solver.multigrid import MultigridSolver as JaxSolver
from homogenization_jl_tpu_torch.interop import solver_state_from_numpy
from homogenization_jl_tpu_torch.mesh.grid import hypercube as t_hypercube
from homogenization_jl_tpu_torch.ops import interfaces as t_if
from homogenization_jl_tpu_torch.ops import stencil as t_stencil
from homogenization_jl_tpu_torch.ops.plan import build_grid_plan as t_build_grid_plan
from homogenization_jl_tpu_torch.solver import coarse as t_coarse
from homogenization_jl_tpu_torch.solver.multigrid import MultigridSolver as TorchSolver

OPS_TOL = 1e-12
TOL = 1e-10
# (dim, n, nlevels, order, coarsening depth m, stencil points K)
CONFIGS = [(3, 4, 3, "type", 1, 15), (2, 8, 3, "cube", 2, 7)]
IDS = ["3d-n4-L3-type", "2d-n8-L3-cube"]
DENSE_LIMIT = 4


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-300)


def _eq(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert np.array_equal(a, b), what


@pytest.fixture(scope="module", params=CONFIGS, ids=IDS)
def plans(request):
    dim, n, nlevels, order, m, K = request.param
    pj = j_build_grid_plan(j_hypercube(dim, n, order=order), nlevels, slot_tables=False)
    pt = t_build_grid_plan(t_hypercube(dim, n, order=order), nlevels, slot_tables=False)
    return dict(pj=pj, pt=pt, dim=dim, n=n, m=m, K=K)


# --------------------------------------------------------------------- #
# host copies
# --------------------------------------------------------------------- #
def test_coarse_geometry_matches_jax(plans):
    pj, pt = plans["pj"], plans["pt"]
    m = plans["m"]
    assert j_coarse.coarsening_depth(pj.base, DENSE_LIMIT) == m
    assert t_coarse.coarsening_depth(pt.base, DENSE_LIMIT) == m
    assert t_coarse.coarsening_depth(pt.base) == j_coarse.coarsening_depth(pj.base)
    gj = j_coarse.build_coarse_geometry(pj, dense_limit=DENSE_LIMIT)
    gt = t_coarse.build_coarse_geometry(pt, dense_limit=DENSE_LIMIT)
    for f in ("node_map", "aux_first_flat", "main_first_flat", "aux_first_mask",
              "cube_of_base", "cube_of_aux"):
        _eq(getattr(gj, f), getattr(gt, f), f)
    assert (gj.n_cubes, gj.m) == (gt.n_cubes, gt.m) == (gj.n_cubes, m)
    _eq(gj.plan.base.nodes, gt.plan.base.nodes, "aux base nodes")
    _eq(gj.plan.base.elements, gt.plan.base.elements, "aux base elements")
    assert gj.plan.nlevels == gt.plan.nlevels == m + 1
    for lj, lt in zip(gj.plan.levels, gt.plan.levels):
        _eq(lj.first_copy_mask, lt.first_copy_mask, "aux first-copy mask")
    sigma = np.random.default_rng(3).uniform(1.0, 9.0, (pj.base.nelements, plans["dim"]))
    _eq(gj.average_sigma(sigma), gt.average_sigma(sigma), "average_sigma")
    # not coarsenable: an odd cube count
    odd = t_build_grid_plan(t_hypercube(plans["dim"], 3), 2, slot_tables=False)
    assert t_coarse.build_coarse_geometry(odd, dense_limit=DENSE_LIMIT) is None


def test_lattice_stencil_tables_match_jax(plans):
    sj = j_stencil.build_lattice_stencil(plans["pj"].base)
    st = t_stencil.build_lattice_stencil(plans["pt"].base)
    assert (sj.dim, sj.n, sj.ept, sj.order) == (st.dim, st.n, st.ept, st.order)
    assert sj.corner == st.corner and sj.entries == st.entries and sj.deltas == st.deltas
    assert len(st.deltas) == plans["K"]


# --------------------------------------------------------------------- #
# K6 / K7 plain forms against the JAX functions
# --------------------------------------------------------------------- #
def _level0(plans):
    """JAX stencil, port stencil, level-0 stack [P, d+1, d+1], and random
    coefficients, node vector and local [E, d+1] array."""
    pj, pt = plans["pj"], plans["pt"]
    sj = j_stencil.build_lattice_stencil(pj.base)
    st = t_stencil.build_lattice_stencil(pt.base)
    solver = TorchSolver(pt, dtype=torch.float64, device="cpu", coarse="cg")
    stack0 = solver.levels[0].stack
    rng = np.random.default_rng(21)
    E, N = pj.base.nelements, pj.base.nnodes
    coeff = rng.uniform(0.5, 2.0, (E, stack0.shape[0]))
    u = rng.standard_normal(N)
    y = rng.standard_normal((E, pj.base.dim + 1))
    return sj, st, solver, stack0, coeff, u, y


def test_lattice_plain_forms_match_jax(plans):
    sj, st, solver, stack0, coeff, u, y = _level0(plans)
    Wj = j_stencil.lattice_weights(jnp.asarray(coeff), jnp.asarray(stack0.numpy()), sj)
    Wt = t_stencil.lattice_weights(torch.as_tensor(coeff), stack0, st)
    assert Wt.shape == (len(st.deltas), plans["pt"].base.nnodes)
    assert _rel(np.asarray(Wj).reshape(Wt.shape), Wt) <= OPS_TOL
    Wj_flat = np.asarray(Wj).reshape(Wt.shape)
    ut = torch.as_tensor(u)
    m = solver._interior_mask_N
    ref = np.asarray(j_stencil.lattice_apply(jnp.asarray(u), jnp.asarray(Wj), sj))
    assert _rel(ref, t_stencil.lattice_apply(ut, torch.tensor(Wj_flat), st)) <= OPS_TOL
    masked = ref * m.numpy()
    assert _rel(masked, t_stencil.lattice_apply(ut, Wt, st, m=m)) <= OPS_TOL
    b = np.random.default_rng(22).standard_normal(u.shape)
    got = t_stencil.lattice_apply(ut, Wt, st, m=m, b=torch.as_tensor(b))
    assert _rel(b - masked, got) <= OPS_TOL
    assert _rel(j_stencil.lattice_assemble(jnp.asarray(y), sj),
                t_stencil.lattice_assemble(torch.as_tensor(y), st)) <= OPS_TOL
    assert np.array_equal(np.asarray(j_stencil.lattice_distribute(jnp.asarray(u), sj)),
                          t_stencil.lattice_distribute(ut, st).numpy())


def test_coarse_gather_plain_forms_match_jax(plans):
    pj = plans["pj"]
    _, _, solver, _, _, u, y = _level0(plans)
    js = JaxSolver(pj, smoother="chebyshev", combine="structured", coarse="cg")
    els = jnp.asarray(pj.base.elements.astype(np.int32))
    yt, ut = torch.as_tensor(y), torch.as_tensor(u)
    ref = np.asarray(j_if.copy_to_base(jnp.asarray(y), els, pj.base.nnodes))
    assert _rel(ref, t_if.copy_to_base(yt, solver._asm)) <= OPS_TOL
    assert _rel(js._to_global(jnp.asarray(y), els), solver._to_global(yt)) <= OPS_TOL
    assert np.array_equal(np.asarray(j_if.distribute(jnp.asarray(u), els)),
                          t_if.distribute(ut, solver._base_idx).numpy())
    # the aux transfers of coarse="mg": r[node_map] * mask, x.flat[first] * m
    g = t_coarse.build_coarse_geometry(plans["pt"], dense_limit=DENSE_LIMIT)
    nm = t_if.index_tensor(g.node_map)
    mask = torch.as_tensor(g.aux_first_mask != 0)
    assert nm.dtype == torch.int32
    assert np.array_equal(t_if.gather_scale(ut, nm, mask).numpy(),
                          u[g.node_map] * g.aux_first_mask)
    xa = np.random.default_rng(23).standard_normal(g.node_map.shape)
    im = solver._interior_mask_N
    got = t_if.gather_scale(torch.as_tensor(xa), t_if.index_tensor(g.aux_first_flat), im)
    assert np.array_equal(got.numpy(), xa.reshape(-1)[g.aux_first_flat] * im.numpy())


def test_segment_sum_adds_in_presorted_order():
    """Each node sums its slots left to right in flat slot order (the
    stable presorted order), so the result is fixed bit for bit; values of
    mixed magnitude make any other order give other bits."""
    keys = np.array([2, 0, 1, 0, 2, 0, 1, 0, 2])
    vals = np.array([1e16, 1.0, -3.0, 1e16, 1.0, 1.0, 0.5, -1e16, -1e16])
    tab = t_if.build_segment_tables(keys, 3)
    got = t_if.segment_sum(torch.as_tensor(vals), tab)
    want = np.zeros(3)
    for k, v in zip(keys, vals):
        want[k] += v  # left to right, in slot order
    assert got.numpy().tobytes() == want.tobytes()
    rev = np.zeros(3)
    for k, v in zip(keys[::-1], vals[::-1]):
        rev[k] += v
    assert rev.tobytes() != want.tobytes()  # the order is observable
    # repeated calls and the plain form directly: identical bits
    again = t_if.segment_sum_plain(torch.as_tensor(vals), tab)
    assert torch.equal(got, again) and got.numpy().tobytes() == again.numpy().tobytes()
    # copy_to_base is this sum: keys from element rows
    els = keys.reshape(3, 3)
    assert torch.equal(t_if.copy_to_base(torch.as_tensor(vals).reshape(3, 3),
                                         t_if.build_segment_tables(els, 3)), got)


def _emulate_k6(st, tab, coeff, stack0, u, m, y):
    """NumPy emulation of csrc/lattice_stencil.cu, reading only the
    kernel's int32 table: returns (W, A u * m, assemble(y), distribute(u))."""
    dim, n, ept, type_major, K, ne = (int(v) for v in tab[:6])
    corner = tab[6:6 + 72].reshape(6, 4, 3)
    delta = tab[78:78 + 81].reshape(27, 3)
    ent = tab[159:159 + 384].reshape(96, 4)
    n1 = n + 1
    N = n1**dim
    nd = n**dim
    coords = np.array(np.unravel_index(np.arange(N), (n1,) * dim)).T  # [N, dim]

    def elem(t, q):
        cube = np.ravel_multi_index(tuple(q.T), (n,) * dim)
        return t * nd + cube if type_major else cube * ept + t

    d1 = dim + 1
    W = np.zeros((K, N))
    for e in range(ne):
        t, i, j, k = ent[e]
        q = coords - corner[t, i, :dim]
        ok = np.all((q >= 0) & (q < n), axis=1)
        s = coeff[elem(t, q[ok])] @ stack0[:, i, j]
        W[k, ok] += s
    Au = np.zeros(N)
    for k in range(K):
        nb = coords + delta[k, :dim]
        ok = np.all((nb >= 0) & (nb < n1), axis=1)
        Au[ok] += W[k, ok] * u[np.ravel_multi_index(tuple(nb[ok].T), (n1,) * dim)]
    asm = np.zeros(N)
    for t in range(ept):
        for i in range(d1):
            q = coords - corner[t, i, :dim]
            ok = np.all((q >= 0) & (q < n), axis=1)
            asm[ok] += y[elem(t, q[ok]), i]
    E = ept * nd
    e = np.arange(E)
    t = e // nd if type_major else e % ept
    cube = e % nd if type_major else e // ept
    q = np.array(np.unravel_index(cube, (n,) * dim)).T
    dist = np.zeros((E, d1))
    for i in range(d1):
        node = q + corner[t, i, :dim]
        dist[:, i] = u[np.ravel_multi_index(tuple(node.T), (n1,) * dim)]
    return W, Au * m, asm, dist


def test_k6_table_emulation_matches_plain_forms(plans):
    _, st, solver, stack0, coeff, u, y = _level0(plans)
    tab = t_stencil.kernel_table(st)
    assert tab.dtype == np.int32 and tab.size == 543
    m = solver._interior_mask_N
    W, Au, asm, dist = _emulate_k6(st, tab, coeff, stack0.numpy(), u, m.numpy(), y)
    Wt = t_stencil.lattice_weights(torch.as_tensor(coeff), stack0, st)
    assert _rel(Wt, W) <= OPS_TOL
    assert _rel(t_stencil.lattice_apply(torch.as_tensor(u), Wt, st, m=m), Au) <= OPS_TOL
    # assemble and distribute: the same additions in the same order
    assert np.array_equal(t_stencil.lattice_assemble(torch.as_tensor(y), st).numpy(), asm)
    assert np.array_equal(t_stencil.lattice_distribute(torch.as_tensor(u), st).numpy(), dist)


def test_level0_fallback_matches_stencil(plans):
    """Without a lattice stencil (a base whose node ids are not
    lexicographic), the level-0 operators fall back to distribute + element
    apply + segment sum: the same operator."""
    _, _, solver, _, coeff, u, y = _level0(plans)
    m = solver._interior_mask_N
    c = torch.as_tensor(coeff)
    ut, yt = torch.as_tensor(u), torch.as_tensor(y)
    b = torch.as_tensor(np.random.default_rng(24).standard_normal(u.shape))
    ops = solver._level0_ops(c, m)
    st, solver.lattice_stencil = solver.lattice_stencil, None
    try:
        fb = solver._level0_ops(c, m)
    finally:
        solver.lattice_stencil = st
    assert _rel(ops[0](ut), fb[0](ut)) <= OPS_TOL
    assert _rel(ops[0](ut, b=b), fb[0](ut, b=b)) <= OPS_TOL
    assert _rel(ops[1](yt), fb[1](yt)) <= OPS_TOL
    assert torch.equal(ops[2](ut), fb[2](ut))


# --------------------------------------------------------------------- #
# solver parity with the JAX payload carried over
# --------------------------------------------------------------------- #
COARSE = ["mg", "inv", "cg"]


def _payload(sj, setup):
    """The JAX coarse payload as numpy, in interop's form."""
    if sj.coarse_kind in ("chol", "inv"):
        return np.asarray(setup)
    if sj.coarse_kind == "cg":
        return None
    out = {k: np.asarray(setup[k]) for k in ("coeff", "chol", "lam_max", "lam_max0", "dinv_g")}
    out["stacks"] = [np.asarray(L.stack) for L in sj.aux_solver.levels]
    out["P_up"] = [None if L.P_up is None else np.asarray(L.P_up) for L in sj.aux_solver.levels]
    return out


def make_pair(config, coarse, coarse_mg_tol=1e-12):
    """Both packages' solvers on one configuration, the JAX setup, and the
    port's state loaded from it through interop."""
    dim, n, nlevels, order, _, _ = config
    pj = j_build_grid_plan(j_hypercube(dim, n, order=order), nlevels, slot_tables=False)
    pt = t_build_grid_plan(t_hypercube(dim, n, order=order), nlevels, slot_tables=False)
    kw = dict(coarse=coarse, coarse_mg_dense_limit=DENSE_LIMIT, coarse_mg_tol=coarse_mg_tol)
    sj = JaxSolver(pj, smoother="chebyshev", combine="structured", **kw)
    st = TorchSolver(pt, dtype=torch.float64, device="cpu", smoother="chebyshev", **kw)
    sigma = conductivity_per_element(
        pj.base, generate_conductivity(dim, n, np.random.default_rng(0)), np.zeros(dim)
    )
    coeff = sj.coefficients(sigma, 0.0)
    setup = sj.coarse_setup(sigma, 0.0)
    lam_max = sj.estimate_lambda_max(coeff)
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


# the JAX package compiles a V-cycle, FMG and PCG program per solver (the
# 3D "mg" ones take ~100 s): the 3D cases run from test_torch_coarse_3d.py
# and test_torch_coarse_mg3d.py, so that the test workers share them
@pytest.fixture(scope="module", params=COARSE, ids=[f"{IDS[1]}-{k}" for k in COARSE])
def pair(request):
    return make_pair(CONFIGS[1], request.param)


def test_coarse_setup_matches_jax(pair):
    """The port's own setup, on its own coefficients, against the JAX one."""
    sj, st, sigma, setup = pair["sj"], pair["st"], pair["sigma"], pair["setup"]
    own = st.coarse_setup(sigma, 0.0)
    if sj.coarse_kind == "cg":
        assert own is None
    elif sj.coarse_kind == "inv":
        assert _rel(setup, own) <= 1e-12
    else:
        assert np.array_equal(np.asarray(setup["coeff"]), own.coeff.numpy())
        assert _rel(setup["chol"], own.inv) <= 1e-12
        assert abs(float(setup["lam_max"]) - own.lam_max) <= TOL * own.lam_max
        assert abs(float(setup["lam_max0"]) - own.lam_max0) <= TOL * own.lam_max0
        m = st._interior_mask_N.numpy()
        assert _rel(np.asarray(setup["dinv_g"]) * m, own.dinv) <= OPS_TOL


def test_vcycle_matches_jax(pair):
    sj, st, s = pair["sj"], pair["st"], pair["state"]
    x0 = np.random.default_rng(5).standard_normal(pair["b"].shape)
    xj, rj = sj.vcycle(jnp.asarray(x0), jnp.asarray(pair["b"]), pair["coeff"],
                       pair["setup"], lam_max=pair["lam_max"])
    xt, rt = st.vcycle(torch.as_tensor(x0), s.b, s.coeff, s.chol, s.lam_max)
    assert _rel(xj, xt) <= TOL
    assert _rel(rj, rt) <= TOL


def test_fmg_matches_jax(pair):
    sj, st, s = pair["sj"], pair["st"], pair["state"]
    xj, rj = sj.fmg(jnp.asarray(pair["b"]), pair["coeff"], pair["setup"],
                    lam_max=pair["lam_max"])
    xt, rt = st.fmg(s.b, s.coeff, s.chol, s.lam_max)
    assert _rel(xj, xt) <= TOL
    assert _rel(rj, rt) <= TOL


def test_pcg_history_matches_jax(pair):
    """Five PCG iterations with each package's default beta: flexible for
    the tolerance-stopped coarse solves ("cg", "mg"), classic for "inv"."""
    sj, st, s = pair["sj"], pair["st"], pair["state"]
    xj, hj = sj.pcg(jnp.asarray(pair["b"]), pair["coeff"], pair["setup"],
                    lam_max=pair["lam_max"], iters=5)
    xt, ht = st.pcg(s.b, s.coeff, s.chol, s.lam_max, iters=5)
    assert len(hj) == len(ht) == 6
    assert _rel(xj, xt) <= TOL
    assert np.max(np.abs(np.array(hj) - np.array(ht)) / np.array(hj)) <= TOL
    if sj.coarse_kind != "inv":  # the flexible beta is the default there
        _, hc = st.pcg(s.b, s.coeff, s.chol, s.lam_max, iters=5, flexible=False)
        assert not np.array_equal(hc, ht)


def test_solve_iterations_match_jax(pair):
    """solve(method="auto") runs each package's own setup end to end."""
    sj, st, sigma, b = pair["sj"], pair["st"], pair["sigma"], pair["b"]
    xj, hj = sj.solve(jnp.asarray(b), sigma, 0.0, tol=1e-8)
    n0 = len(st.coarse_iterations)
    xt, ht = st.solve(torch.as_tensor(b), sigma, 0.0, tol=1e-8)
    assert len(hj) == len(ht)
    assert ht[-1] <= 1e-8
    assert _rel(xj, xt) <= 1e-8
    if sj.coarse_kind in ("cg", "mg"):
        assert len(st.coarse_iterations) > n0
        assert all(0 < it < 50 for it in st.coarse_iterations[n0:])


def test_mg_vcycle_at_bench_coarse_tolerance_matches_jax():
    """At the bench's coarse_mg_tol=5e-2 the coarse PCG stops after a few
    iterations, so the V-cycle depends on the coarse preconditioner itself
    (the junction smoothing and the aux V-cycle); at 1e-12 any SPD
    preconditioner would give the same coarse solution."""
    p = make_pair(CONFIGS[1], "mg", coarse_mg_tol=5e-2)
    sj, st, s = p["sj"], p["st"], p["state"]
    x0 = np.random.default_rng(8).standard_normal(p["b"].shape)
    xj, rj = sj.vcycle(jnp.asarray(x0), jnp.asarray(p["b"]), p["coeff"], p["setup"],
                       lam_max=p["lam_max"])
    xt, rt = st.vcycle(torch.as_tensor(x0), s.b, s.coeff, s.chol, s.lam_max)
    assert 0 < max(st.coarse_iterations) < 10
    assert _rel(xj, xt) <= TOL
    assert _rel(rj, rt) <= TOL
