"""The port's precision surface against the JAX package (CPU, float64 and
float32) and its kernels K15 and K16 against their plain forms (card).

On the CPU (the wrappers take their plain forms):
  * ``direction_dtype=float32`` under a float64 state, for the Chebyshev
    and ``cg_exact`` smoothers: x and r after one V-cycle and a 3-cycle
    history within 1e-10 of the JAX solver's, the state carried across by
    ``interop.solver_state_from_numpy``;
  * ``direction_dtype="bfloat16"``: the JAX suite's convergence test
    (tests/test_multigrid.py:126-160) with its bar, on the port;
  * per-level lam_max (``estimate_lambda_max_levels``) and the power
    estimate within 1e-10 of JAX's in float64, and V-cycles and PCG with
    the per-level tensor within 1e-10;
  * the plain forms of K15 (``downcast_scale``, ``upcast``) and K16 (the
    half-width apply, Chebyshev update, dot, CG step and direction)
    against the JAX expressions on the same inputs, bit for bit;
  * the arguments: the names and dtypes ``direction_dtype`` takes, a wider
    one refused, the slab solver taking it, the gather-sharded solver
    keeping the JAX class's surface.

On the card (the ``cuda`` marker; skipped without one; run there with
``python -m pytest tests/test_torch_direction.py -q --noconftest -m cuda``):
each K16 variant (K1's three forms, K3, K5, K10) bitwise equal to its plain
form for bfloat16 and float16 directions under float32 and float64 states
and float32 under float64, and K15's two entries bitwise equal to theirs,
each launch counted; a small mixed-precision solve on the card within
1e-9 of the CPU's.

The JAX package is imported inside the CPU tests (``jx``), so the card's
run, which has no JAX, collects this file too."""

import os
import types

import numpy as np
import pytest
import torch

from homogenization_jl_tpu_torch.csrc.build import LAUNCHES
from homogenization_jl_tpu_torch.interop import solver_state_from_numpy
from homogenization_jl_tpu_torch.mesh.grid import hypercube as t_hypercube
from homogenization_jl_tpu_torch.ops import apply as t_apply
from homogenization_jl_tpu_torch.ops import cg as t_cg
from homogenization_jl_tpu_torch.ops import chebyshev as t_cheb
from homogenization_jl_tpu_torch.ops import dots as t_dots
from homogenization_jl_tpu_torch.ops import mixed as t_mixed
from homogenization_jl_tpu_torch.ops.plan import build_grid_plan as t_build_grid_plan
from homogenization_jl_tpu_torch.solver.multigrid import MultigridSolver as TorchSolver

TOL = 1e-10
CONFIG = (2, 8, 3, "cube")
# (state dtype, direction dtype) pairs the K16 kernels take
PAIRS = [(torch.float32, torch.bfloat16), (torch.float32, torch.float16),
         (torch.float64, torch.float32), (torch.float64, torch.bfloat16),
         (torch.float64, torch.float16)]


@pytest.fixture(scope="module")
def jx():
    """The JAX package's modules (the CPU tests only)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from homogenization_jl_tpu.fem.local_operators import load_vector
    from homogenization_jl_tpu.mesh.grid import affine_maps, hypercube
    from homogenization_jl_tpu.models.checkerboard import (
        conductivity_per_element,
        generate_conductivity,
    )
    from homogenization_jl_tpu.ops.apply import element_apply
    from homogenization_jl_tpu.ops.plan import build_grid_plan
    from homogenization_jl_tpu.solver.multigrid import MultigridSolver

    return types.SimpleNamespace(
        jnp=jnp, load_vector=load_vector, affine_maps=affine_maps, hypercube=hypercube,
        conductivity_per_element=conductivity_per_element,
        generate_conductivity=generate_conductivity, element_apply=element_apply,
        build_grid_plan=build_grid_plan, Solver=MultigridSolver,
    )


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels)")
    return torch.device("cuda")


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _bits(t):
    return t.contiguous().view({1: torch.int8, 2: torch.int16, 4: torch.int32,
                                8: torch.int64}[t.element_size()])


def _pair(jx, smoother, dtype=np.float64, **kw):
    """Both packages' solvers on CONFIG (coarse="chol"), the JAX setup and
    the port's state loaded from it."""
    dim, n, nlevels, order = CONFIG
    pj = jx.build_grid_plan(jx.hypercube(dim, n, order=order), nlevels, slot_tables=False)
    pt = t_build_grid_plan(t_hypercube(dim, n, order=order), nlevels, slot_tables=False)
    jd = jx.jnp.float64 if dtype == np.float64 else jx.jnp.float32
    td = torch.float64 if dtype == np.float64 else torch.float32
    sj = jx.Solver(pj, dtype=jd, smoother=smoother, coarse="chol", combine="structured", **kw)
    st = TorchSolver(pt, dtype=td, device="cpu", smoother=smoother, coarse="chol", **kw)
    sigma = jx.conductivity_per_element(
        pj.base, jx.generate_conductivity(dim, n, np.random.default_rng(0)), np.zeros(dim))
    coeff = sj.coefficients(sigma, 0.0)
    chol = sj.coarse_setup(sigma, 0.0)
    lam_max = sj.estimate_lambda_max(coeff) if smoother.startswith("chebyshev") else None
    _, _, detJ, _ = jx.affine_maps(pj.base)
    b = (detJ[:, None] * jx.load_vector(pj.reference.levels[nlevels - 1])[None, :]).astype(dtype)
    state = solver_state_from_numpy(
        st, coeff=np.asarray(coeff), chol=np.asarray(chol), lam_max=lam_max,
        stacks=[np.asarray(L.stack) for L in sj.levels],
        P_up=[None if L.P_up is None else np.asarray(L.P_up) for L in sj.levels], b=b)
    return sj, st, sigma, coeff, chol, lam_max, jx.jnp.asarray(b), state


# --------------------------------------------------------------------- #
# CPU: parity with the JAX package
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("smoother", ["chebyshev", "cg_exact"])
def test_f32_directions_under_f64_match_jax(jx, smoother):
    sj, st, sigma, coeff, chol, lam_max, bj, s = _pair(jx, smoother, direction_dtype="float32")
    assert st.direction_dtype == torch.float32 and str(sj.direction_dtype) == "float32"
    xj, _ = sj.zero_states()
    xj, rj = sj.vcycle(xj, bj, coeff, chol, lam_max=lam_max)
    xt, rt = st.vcycle(torch.zeros_like(s.b), s.b, s.coeff, s.chol, lam_max=s.lam_max)
    assert _rel(xt, xj) <= TOL and _rel(rt, rj) <= TOL
    hj, ht = [], []
    for _ in range(2):
        xj, rj = sj.vcycle(xj, bj, coeff, chol, lam_max=lam_max)
        xt, rt = st.vcycle(xt, s.b, s.coeff, s.chol, lam_max=s.lam_max)
        hj.append(float(sj.residual_norm(rj)))
        ht.append(float(st.residual_norm(rt)))
    assert _rel(ht, hj) <= TOL and _rel(xt, xj) <= TOL
    # the stored directions are float32: a float64 direction differs
    s64 = TorchSolver(st.plan, dtype=torch.float64, device="cpu", smoother=smoother,
                      coarse="chol")
    s64.levels = st.levels
    x64, _ = s64.vcycle(torch.zeros_like(s.b), s.b, s.coeff, s.chol, lam_max=s.lam_max)
    x1, _ = st.vcycle(torch.zeros_like(s.b), s.b, s.coeff, s.chol, lam_max=s.lam_max)
    assert 1e-13 < _rel(x1, x64) < 1e-5


def test_bf16_direction_storage_convergence():
    """The JAX suite's test (tests/test_multigrid.py:126-160) on the port:
    bfloat16 directions change the 10-cycle residual by less than 5x."""
    from homogenization_jl_tpu_torch.fem.local_operators import load_vector
    from homogenization_jl_tpu_torch.mesh.grid import affine_maps

    base = t_hypercube(2, 8)
    plan = t_build_grid_plan(base, 4, slot_tables=False)
    rng = np.random.default_rng(2)
    sigma = rng.choice([1.0, 9.0], size=(base.nelements, 2))
    _, _, detJ, _ = affine_maps(base)
    b = torch.as_tensor(detJ[:, None] * load_vector(plan.reference.levels[3])[None, :],
                        dtype=torch.float32)
    finals = {}
    for dd in (None, "bfloat16"):
        for smoother in ("cg_exact", "chebyshev"):
            s = TorchSolver(plan, dtype=torch.float32, device="cpu", smoother=smoother,
                            direction_dtype=dd)
            coeff = s.coefficients(sigma, 0.0)
            chol = s.coarse_cholesky(sigma, 0.0)
            lam_max = s.estimate_lambda_max(coeff) if smoother == "chebyshev" else None
            x, _ = s.zero_states()
            for _ in range(10):
                x, r = s.vcycle(x, b, coeff, chol, lam_max=lam_max)
            finals[(dd, smoother)] = float(s.residual_norm(r))
    for smoother in ("cg_exact", "chebyshev"):
        a, c = finals[(None, smoother)], finals[("bfloat16", smoother)]
        assert c < 5 * max(a, 1e-7), (smoother, a, c)
        assert c != a  # the directions really were stored in bfloat16


def test_per_level_and_power_lam_max_match_jax(jx):
    sj, st, sigma, coeff, chol, lam_max, bj, s = _pair(jx, "chebyshev")
    lj = np.asarray(sj.estimate_lambda_max_levels(coeff))
    lt = st.estimate_lambda_max_levels(s.coeff)
    assert lt.shape == (st.nlevels,) and lt.dtype == torch.float64
    assert _rel(lt, lj) <= TOL
    for k in (0, st.nlevels - 1):
        pj = sj.estimate_lambda_max(coeff, k, method="power", iters=30)
        pt = st.estimate_lambda_max(s.coeff, k, method="power", iters=30)
        assert abs(pt - pj) <= TOL * pj
    # the margins: power 1.15, Lanczos 1.1 (raw values within 1% at 500)
    p500 = st.estimate_lambda_max(s.coeff, method="power", iters=500) / 1.15
    l30 = st.estimate_lambda_max(s.coeff) / 1.1
    assert abs(l30 - p500) < 0.01 * p500
    with pytest.raises(ValueError, match="method"):
        st.estimate_lambda_max(s.coeff, method="chebyshev")
    # cycles and PCG with the per-level bounds, through interop
    s2 = solver_state_from_numpy(st, coeff=np.asarray(coeff), chol=np.asarray(chol),
                                 lam_max=lj, b=np.asarray(bj))
    assert isinstance(s2.lam_max, torch.Tensor) and s2.lam_max.shape == (st.nlevels,)
    xj, _ = sj.zero_states()
    xt = torch.zeros_like(s2.b)
    for _ in range(3):
        xj, rj = sj.vcycle(xj, bj, coeff, chol, lam_max=lj)
        xt, rt = st.vcycle(xt, s2.b, s2.coeff, s2.chol, lam_max=s2.lam_max)
    assert _rel(xt, xj) <= TOL and _rel(rt, rj) <= TOL
    _, hpj = sj.pcg(bj, coeff, chol, lam_max=lj, iters=6)
    _, hpt = st.pcg(s2.b, s2.coeff, s2.chol, lam_max=s2.lam_max, iters=6)
    assert _rel(hpt, hpj) <= TOL
    with pytest.raises(ValueError, match="lam_max"):
        st.vcycle(xt, s2.b, s2.coeff, s2.chol, lam_max=s2.lam_max[:2])


def test_plain_forms_match_jax_expressions(jx):
    """K15's and K16's plain forms against the JAX expressions on the same
    numpy inputs (float32 states with bfloat16 / float16 directions, a
    float64 state with float32 ones), bit for bit."""
    jnp = jx.jnp
    rng = np.random.default_rng(5)
    E, n, P = 12, 10, 3
    # K15: f32(c) * s, f64(z)
    c = rng.standard_normal((E, n))
    s = rng.uniform(0.2, 1.0, (E, n)).astype(np.float32)
    want = np.asarray(jnp.asarray(c).astype(jnp.float32) * jnp.asarray(s))
    got = t_mixed.downcast_scale(torch.as_tensor(c), torch.as_tensor(s)).numpy()
    assert got.dtype == np.float32 and np.array_equal(got, want)
    assert np.array_equal(t_mixed.downcast_scale(torch.as_tensor(c)).numpy(), c.astype(np.float32))
    z = rng.standard_normal((E, n)).astype(np.float32)
    assert np.array_equal(t_mixed.upcast(torch.as_tensor(z)).numpy(),
                          np.asarray(jnp.asarray(z).astype(jnp.float64)))
    S = rng.standard_normal((P, n, n))
    S = S + S.transpose(0, 2, 1)
    for sdt, ddt, jdt, jdd in ((torch.float32, torch.bfloat16, jnp.float32, jnp.bfloat16),
                               (torch.float32, torch.float16, jnp.float32, jnp.float16),
                               (torch.float64, torch.float32, jnp.float64, jnp.float32)):
        np_s = np.float32 if sdt == torch.float32 else np.float64

        def tj(a, dt=jdt):
            return jnp.asarray(a).astype(dt)

        x0, rc, dinv, p_full = (rng.standard_normal((E, n)).astype(np_s) for _ in range(4))
        pj = tj(p_full, jdd)  # the stored direction
        p_np = np.array(pj.astype(jdt))
        pt = torch.as_tensor(p_np).to(ddt)
        assert np.array_equal(pt.to(sdt).numpy(), p_np)  # the same rounding of p
        a_, b_ = 0.37, 1.9
        ab = torch.tensor([a_, b_], dtype=sdt)
        # Chebyshev: p = store(a load(p) + b dinv rc); x = x + load(p)
        for first in (True, False):
            zj = tj(dinv) * tj(rc)
            pn = (jnp.asarray(ab.numpy()[1]) * zj if first
                  else jnp.asarray(ab.numpy()[0]) * pj.astype(jdt) + jnp.asarray(ab.numpy()[1]) * zj
                  ).astype(jdd)
            xn = tj(x0) + pn.astype(jdt)
            xt, pt2 = torch.as_tensor(x0.copy()), pt.clone()
            t_cheb.chebyshev_update_half(xt, pt2, torch.as_tensor(rc), torch.as_tensor(dinv), ab,
                                         first=first)
            assert np.array_equal(pt2.to(sdt).numpy(), np.asarray(pn.astype(jdt)))
            assert np.array_equal(xt.numpy(), np.asarray(xn))
        # the apply on load(p): the JAX element_apply on p cast up
        coeff = rng.uniform(0.5, 2.0, (E, P)).astype(np_s)
        yj = jx.element_apply(pj.astype(jdt), tj(coeff), tj(S.astype(np_s)))
        yt = t_apply.element_apply_half(pt, torch.as_tensor(coeff), torch.as_tensor(S.astype(np_s)))
        assert yt.dtype == sdt and _rel(yt.numpy(), yj) < (1e-6 if np_s == np.float32 else 1e-14)
        assert torch.equal(yt, t_apply.element_apply(pt.to(sdt), torch.as_tensor(coeff),
                                                     torch.as_tensor(S.astype(np_s))))
        # the dot vdot(load(p), Ap)
        Ap = rng.standard_normal((E, n)).astype(np_s)
        dj = float(jnp.vdot(pj.astype(jdt), tj(Ap)))
        dt_ = float(t_dots.dot_half(pt, torch.as_tensor(Ap)))
        assert abs(dt_ - dj) <= (1e-5 if np_s == np.float32 else 1e-13) * abs(dj) + 1e-30
        assert dt_ == float(t_dots.dot(pt.to(sdt), torch.as_tensor(Ap)))
        # the CG step and direction with load(p) / store
        num, den = torch.tensor(0.8, dtype=sdt), torch.tensor(1.3, dtype=sdt)
        alpha = (jnp.asarray(num.numpy()) / jnp.asarray(den.numpy())).astype(jdt)
        xt, rt = torch.as_tensor(x0.copy()), torch.as_tensor(rc.copy())
        t_cg.cg_step_half(xt, rt, pt, torch.as_tensor(Ap), num, den)
        assert np.array_equal(xt.numpy(), np.asarray(tj(x0) + alpha * pj.astype(jdt)))
        assert np.array_equal(rt.numpy(), np.asarray(tj(rc) - alpha * tj(Ap)))
        out = torch.empty_like(pt)
        t_cg.cg_direction_half(out, torch.as_tensor(rc), pt, num, den)
        want = (tj(rc) + alpha * pj.astype(jdt)).astype(jdd).astype(jdt)
        assert np.array_equal(out.to(sdt).numpy(), np.asarray(want))
        t_cg.cg_direction_half(out, torch.as_tensor(rc), None, num, den)
        assert np.array_equal(out.to(sdt).numpy(), np.asarray(tj(rc).astype(jdd).astype(jdt)))


def test_direction_dtype_arguments(tmp_path):
    plan = t_build_grid_plan(t_hypercube(2, 4, order="cube"), 2, slot_tables=False)
    for name, want in (("bfloat16", torch.bfloat16), ("float16", torch.float16),
                       ("half", torch.float16), (torch.bfloat16, torch.bfloat16),
                       (None, None), ("float32", torch.float32)):
        s = TorchSolver(plan, dtype=torch.float32, device="cpu", smoother="chebyshev",
                        direction_dtype=name)
        assert s.direction_dtype == want
    # the state's own dtype stores nothing narrower
    assert TorchSolver(plan, dtype=torch.float32, device="cpu",
                       direction_dtype="float32")._dd is None
    with pytest.raises(ValueError, match="wider"):
        TorchSolver(plan, dtype=torch.float32, device="cpu", direction_dtype="float64")
    with pytest.raises(ValueError, match="direction_dtype"):
        TorchSolver(plan, dtype=torch.float32, device="cpu", direction_dtype="int8")
    # both sharded solvers inherit it: a world of one with float32
    # directions under float64 runs the single device's V-cycle (the same
    # arithmetic on one rank)
    from homogenization_jl_tpu_torch.fem.local_operators import load_vector
    from homogenization_jl_tpu_torch.mesh.grid import affine_maps
    from homogenization_jl_tpu_torch.parallel.group import SlabGroup
    from homogenization_jl_tpu_torch.parallel.sharding import ShardedMultigridSolver
    from homogenization_jl_tpu_torch.parallel.slab import SlabShardedMultigridSolver

    sigma = np.random.default_rng(4).choice([1.0, 9.0], size=(plan.base.nelements, 2))
    _, _, detJ, _ = affine_maps(plan.base)
    b_np = detJ[:, None] * load_vector(plan.reference.levels[1])[None, :]
    g = SlabGroup.from_file(os.path.join(tmp_path, "store"), 0, 1, device="cpu")
    try:
        for cls, combine in ((SlabShardedMultigridSolver, "structured"),
                             (ShardedMultigridSolver, "gather")):
            xs = []
            for s in (cls(plan, g, dtype=torch.float64, smoother="chebyshev",
                          direction_dtype="float32"),
                      TorchSolver(plan, dtype=torch.float64, device="cpu", smoother="chebyshev",
                                  combine=combine, direction_dtype="float32")):
                assert s.direction_dtype == torch.float32
                coeff = s.coefficients(sigma, 0.0)
                x, _ = s.vcycle(s.zero_states()[0], torch.as_tensor(b_np), coeff,
                                s.coarse_setup(sigma, 0.0), s.estimate_lambda_max(coeff))
                xs.append(x)
            assert _rel(xs[0], xs[1]) <= 1e-12, cls.__name__
    finally:
        SlabGroup.destroy()


def test_half_wrappers_reject_malformed_inputs():
    x = torch.zeros((6, 4), dtype=torch.float32)
    coeff = torch.ones((6, 2), dtype=torch.float32)
    stack = torch.zeros((2, 4, 4), dtype=torch.float32)
    with pytest.raises(TypeError):  # not narrower than the state
        t_apply.element_apply_half(x, coeff, stack)
    with pytest.raises(TypeError):  # the strict wrapper keeps one dtype
        t_apply.element_apply(x.to(torch.bfloat16), coeff, stack)
    with pytest.raises(TypeError):
        t_dots.dot_half(x, x)
    with pytest.raises(ValueError):
        t_dots.dot_half(x[:3].to(torch.bfloat16), x)
    one = torch.tensor(1.0)
    with pytest.raises(TypeError):
        t_cg.cg_step_half(x, None, x, None, one, one)
    with pytest.raises(ValueError):  # out and p of two storage types
        t_cg.cg_direction_half(x.to(torch.bfloat16), x, x.to(torch.float16), one, one)
    with pytest.raises(TypeError):
        t_cheb.chebyshev_update_half(x, x.clone(), x, x, torch.zeros(2))
    with pytest.raises(ValueError):  # the strict update keeps one dtype
        t_cheb.chebyshev_update(x, x.to(torch.bfloat16), x, x, torch.zeros(2))
    with pytest.raises(TypeError):
        t_mixed.downcast_scale(x)
    with pytest.raises(ValueError):
        t_mixed.downcast_scale(x.double(), x[:3])
    with pytest.raises(TypeError):
        t_mixed.upcast(x.double())


# --------------------------------------------------------------------- #
# card: K16 and K15 against their plain forms
# --------------------------------------------------------------------- #
@pytest.mark.cuda
@pytest.mark.parametrize("sdt,ddt", PAIRS, ids=[f"{str(a)[6:]}-{str(b)[6:]}" for a, b in PAIRS])
def test_k16_kernels_bitwise_equal_to_plain(cuda, sdt, ddt):
    g = torch.Generator(device=cuda).manual_seed(11)
    E, n, P = 1000, 35, 7

    def rnd(dt=sdt):
        return torch.randn((E, n), generator=g, device=cuda, dtype=sdt).to(dt)

    p, x, rc, dinv, b = rnd(ddt), rnd(), rnd(), rnd(), rnd()
    coeff = torch.rand((E, P), generator=g, device=cuda, dtype=sdt) + 0.5
    S = torch.randn((P, n, n), generator=g, device=cuda, dtype=sdt)
    S = (S + S.transpose(1, 2)).contiguous()
    rs = t_apply.stack_rowsum(S)
    tab = t_apply.stack_table(S)
    m = torch.rand((E, n), generator=g, device=cuda) < 0.7
    before = dict(LAUNCHES)
    # K1: the apply, the shifted residual form, the mask store, in place
    for kw in ({}, dict(b=b), dict(mask=m), dict(b=b, mask=m)):
        got = t_apply.element_apply_half(p, coeff, S, rowsum=rs, table=tab, **kw)
        want = t_apply.element_apply(p.to(sdt), coeff, S, rowsum=rs, table=tab, **kw)
        assert got.dtype == sdt and torch.equal(_bits(got), _bits(want)), kw
    r = b.clone()
    t_apply.element_apply_half(p, coeff, S, b=r, out=r, rowsum=rs, mask=m, table=tab)
    assert torch.equal(_bits(r), _bits(t_apply.element_apply(p.to(sdt), coeff, S, b=b, rowsum=rs,
                                                             mask=m, table=tab)))
    # K3: p = store(a load(p) + b z), x += load(p)
    ab = torch.tensor([0.37, 1.9], dtype=sdt, device=cuda)
    for first, x_zero in ((True, True), (True, False), (False, False)):
        xk, pk, xp, pp = x.clone(), p.clone(), x.clone(), p.clone()
        if x_zero:
            xk.fill_(float("nan"))
        t_cheb.chebyshev_update_half(xk, pk, rc, dinv, ab, first=first, x_zero=x_zero)
        t_cheb.chebyshev_update_half_plain(xp, pp, rc, dinv, ab, first, x_zero)
        assert torch.equal(_bits(pk), _bits(pp)) and torch.equal(_bits(xk), _bits(xp))
    # K5: one operand half-width, with and without the mask and the scale
    for kw in ({}, dict(mask=m), dict(scale=dinv), dict(mask=m, scale=dinv)):
        got = t_dots.dot_half(p, rc, **kw)
        assert torch.equal(_bits(got), _bits(t_dots.dot(p.to(sdt), rc, **kw)))
        assert torch.equal(_bits(got), _bits(t_dots.dot_plain(p.to(sdt), rc, **kw)))
    # K10: the step on load(p) (r in place, r_out, x only, x_zero), the
    # direction's store (with p in place, and without p)
    for den_v in (1.3, 0.0):
        num = torch.tensor(0.8, dtype=sdt, device=cuda)
        den = torch.tensor(den_v, dtype=sdt, device=cuda)
        for r_out, with_r, x_zero in ((False, True, False), (True, True, False),
                                      (False, False, True)):
            xk, xp = x.clone(), x.clone()
            rk, rp = (rc.clone(), rc.clone()) if with_r else (None, None)
            ok, op = (torch.empty_like(rc), torch.empty_like(rc)) if r_out else (None, None)
            t_cg.cg_step_half(xk, rk, p, b if with_r else None, num, den, r_out=ok, x_zero=x_zero)
            t_cg.cg_step_half_plain(xp, rp, p, b if with_r else None, num, den, r_out=op,
                                    x_zero=x_zero)
            assert torch.equal(_bits(xk), _bits(xp))
            for a, c in ((rk, rp), (ok, op)):
                assert a is None or torch.equal(_bits(a), _bits(c))
        for src in (p, None):
            pk, pp = p.clone(), p.clone()
            t_cg.cg_direction_half(pk, rc, None if src is None else pk, num, den)
            t_cg.cg_direction_half_plain(pp, rc, None if src is None else pp, num, den)
            assert torch.equal(_bits(pk), _bits(pp))
    torch.cuda.synchronize()
    assert LAUNCHES["direction_apply"] - before["direction_apply"] == 5
    assert LAUNCHES["direction_chebyshev"] - before["direction_chebyshev"] == 3
    assert LAUNCHES["direction_dot"] - before["direction_dot"] == 4
    assert LAUNCHES["direction_cg"] - before["direction_cg"] == 10


@pytest.mark.cuda
def test_k15_kernels_bitwise_equal_to_plain(cuda):
    g = torch.Generator(device=cuda).manual_seed(12)
    c = torch.randn((3001, 17), generator=g, device=cuda, dtype=torch.float64) * 1e3
    s = torch.rand((3001, 17), generator=g, device=cuda, dtype=torch.float32)
    z = torch.randn((3001, 17), generator=g, device=cuda, dtype=torch.float32)
    before = LAUNCHES["mixed_boundary"]
    assert torch.equal(_bits(t_mixed.downcast_scale(c, s)), _bits(t_mixed.downcast_scale_plain(c, s)))
    assert torch.equal(_bits(t_mixed.downcast_scale(c)), _bits(t_mixed.downcast_scale_plain(c)))
    assert torch.equal(_bits(t_mixed.upcast(z)), _bits(t_mixed.upcast_plain(z)))
    assert LAUNCHES["mixed_boundary"] - before == 3


@pytest.mark.cuda
def test_mixed_pcg_on_the_card_matches_the_cpu(cuda):
    from homogenization_jl_tpu_torch.fem.local_operators import load_vector
    from homogenization_jl_tpu_torch.mesh.grid import affine_maps
    from homogenization_jl_tpu_torch.solver.multigrid import mixed_precision_pcg

    base = t_hypercube(2, 4)
    plan = t_build_grid_plan(base, 3, slot_tables=False)
    sigma = np.random.default_rng(3).choice([1.0, 9.0], size=(base.nelements, 2))
    _, _, detJ, _ = affine_maps(base)
    b = detJ[:, None] * load_vector(plan.reference.levels[2])[None, :]
    xs = {}
    for dev in ("cpu", cuda):
        outer = TorchSolver(plan, dtype=torch.float64, device=dev, smoother="chebyshev")
        inner = TorchSolver(plan, dtype=torch.float32, device=dev, smoother="chebyshev")
        before = LAUNCHES["mixed_boundary"]
        x, hist = mixed_precision_pcg(outer, inner, torch.as_tensor(b, device=dev), sigma,
                                      iters=60, tol=1e-12)
        assert hist[-1] <= 1e-12 * hist[0]
        assert (LAUNCHES["mixed_boundary"] > before) == (dev != "cpu")
        xs[str(dev)] = x.cpu().numpy()
    assert _rel(xs["cuda"], xs["cpu"]) < 1e-9
