"""Kernels K12 (the gather-sharded combine's cross-shard fix-up), K18 (the
state-sized elementwise passes), K1's mask store and K10's ``r_out`` form
against their plain PyTorch forms.

On the card (the ``cuda`` marker; skipped without one; run there with
``python -m pytest tests/test_torch_sharding_kernels.py -q --noconftest``),
float32 and float64:
  * K12 on every rank of S = 1, 2, 4 and 8 blocks of hypercube(3, 3)
    (E = 162) and of the ordered base ordered_hypercube(2, 4), at every
    level, with and without a mask: each rank's result (K8, the cross
    partials added in rank order, the scatter) bitwise equal to the plain
    forms', and the launches counted; each rank's partial vector (its own
    groups' sums, +0 elsewhere) bitwise equal to the plain form's;
  * every K18 entry, K1's mask store (y * mask of the unmasked output, in
    both the apply and the residual form), K10's r_out and x_zero forms and
    K3's x_zero form bitwise equal to their plain forms, den == 0 and
    s == 0 included; K18's diagonal over the launches its C entry plans
    (narrow widths, the one-piece tile, windows) too;
  * the gather-sharded solver through an NCCL group of one rank equal to
    the single-device solver bit for bit, and on 2 spawned ranks that
    share the card through a gloo group within 1e-9 of it, K12's
    cross-shard kernels launched on each rank.
On the CPU: the wrappers take the plain path and count no launch."""

import numpy as np
import pytest
import torch

from homogenization_jl_tpu_torch.csrc.build import LAUNCHES
from homogenization_jl_tpu_torch.interop import shard_rows
from homogenization_jl_tpu_torch.mesh.grid import hypercube
from homogenization_jl_tpu_torch.models.checkerboard import ordered_hypercube
from homogenization_jl_tpu_torch.ops import apply as t_apply
from homogenization_jl_tpu_torch.ops import cg as t_cg
from homogenization_jl_tpu_torch.ops import elementwise as t_ew
from homogenization_jl_tpu_torch.ops import interfaces as t_if
from homogenization_jl_tpu_torch.ops import sharded as t_sh
from homogenization_jl_tpu_torch.ops.plan import build_grid_plan
from homogenization_jl_tpu_torch.parallel.sharding import shard_tables

DTYPES = [torch.float32, torch.float64]


@pytest.fixture(scope="module", params=["3d-E162", "2d-ordered"])
def plan(request):
    mesh = hypercube(3, 3) if request.param == "3d-E162" else ordered_hypercube(2, 4)[0]
    return build_grid_plan(mesh, 3, slot_tables=False)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels)")
    return torch.device("cuda")


def _bits(t):
    return t.contiguous().view(torch.int32 if t.element_size() == 4 else torch.int64)


def rank_results(plan, k, S, x, mask, device, plain):
    """Every rank's K12 result of the global x cut into S blocks, with the
    kernels or (``plain``) the plain forms; the partials added in rank
    order as SlabGroup.sum adds them."""
    ranks = [shard_tables(plan, k, S, r, device) for r in range(S)]
    xs = [torch.as_tensor(shard_rows(x, r, S)).to(device).contiguous() for r in range(S)]
    ms = [None if mask is None else torch.as_tensor(shard_rows(mask, r, S)).to(device).contiguous()
          for r in range(S)]
    if plain:
        local = [(t_if.combine_gather_rows_plain(xr, gt, mr),
                  t_sh.cross_partial_plain(xr, ct) if ct.n_groups else None)
                 for xr, (gt, ct), mr in zip(xs, ranks, ms)]
    else:
        local = [t_sh.sharded_combine_local(xr, gt, ct, mr) for xr, (gt, ct), mr in zip(xs, ranks, ms)]
    if local[0][1] is not None:
        total = local[0][1]
        for _, part in local[1:]:
            total = total + part
        for (out, _), (_, ct), mr in zip(local, ranks, ms):
            (t_sh.cross_scatter_plain if plain else t_sh.cross_scatter)(out, total, ct, mr)
    return [out for out, _ in local]


# --------------------------------------------------------------------- #
# CPU: the wrapper contract
# --------------------------------------------------------------------- #
def test_wrappers_take_plain_path_without_counting(plan):
    before = dict(LAUNCHES)
    rng = np.random.default_rng(0)
    k = plan.nlevels - 1
    E, n = plan.base.nelements, plan.n_local(k)
    x = rng.standard_normal((E, n))
    m = rng.random(x.shape) < 0.7
    for S in (1, 4):
        got = rank_results(plan, k, S, x, m, "cpu", plain=False)
        want = rank_results(plan, k, S, x, m, "cpu", plain=True)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    xt, mt = torch.as_tensor(x), torch.as_tensor(m)
    s = torch.tensor(0.5, dtype=torch.float64)
    assert torch.equal(t_if.apply_mask(xt, mt), xt * mt)
    assert torch.equal(t_ew.mul(xt, xt), xt * xt)
    assert torch.equal(t_ew.lanczos_update(xt, xt, xt, s, s), xt - s * xt - s * xt)
    assert torch.equal(t_ew.div_nz(xt, s), xt / s)
    assert torch.equal(t_ew.inv_positive(xt), t_ew.inv_positive_plain(xt))
    assert torch.equal(t_ew.lanczos_update(xt, xt, None, s, s), xt - s * xt)
    y = xt.clone()
    t_cg.cg_step(y, None, xt, None, s, s, x_zero=True)
    assert torch.equal(y, torch.zeros_like(xt) + xt)
    assert LAUNCHES == before
    gt, ct = shard_tables(plan, k, 4, 1)
    with pytest.raises(ValueError, match="block"):  # another rank's block size
        t_sh.cross_partial(torch.zeros((ct.size // n + 1, n), dtype=torch.float64), ct)


def test_element_apply_mask_on_the_cpu(plan):
    """K1's mask store in the plain form: the unmasked result times the
    mask, for the apply and the residual form, in place too."""
    rng = np.random.default_rng(1)
    E, n, P = plan.base.nelements, plan.n_local(1), 3
    x = torch.as_tensor(rng.standard_normal((E, n)))
    b = torch.as_tensor(rng.standard_normal((E, n)))
    c = torch.as_tensor(rng.uniform(0.5, 2.0, (E, P)))
    S = torch.as_tensor(rng.standard_normal((P, n, n)))
    m = torch.as_tensor(rng.random((E, n)) < 0.6)
    assert torch.equal(t_apply.element_apply(x, c, S, mask=m), t_apply.element_apply(x, c, S) * m)
    want = t_apply.element_apply(x, c, S, b=b) * m
    assert torch.equal(t_apply.element_apply(x, c, S, b=b, mask=m), want)
    assert torch.equal(t_apply.element_apply(x, c, S, b=b, out=b, mask=m), want)
    with pytest.raises(TypeError):
        t_apply.element_apply(x, c, S, mask=m.double())


# --------------------------------------------------------------------- #
# the card
# --------------------------------------------------------------------- #
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_sharded_combine_kernel_equals_plain(plan, cuda, dtype):
    rng = np.random.default_rng(2)
    E = plan.base.nelements
    for k in range(plan.nlevels):
        x = rng.standard_normal((E, plan.n_local(k))).astype(np.float32 if dtype == torch.float32 else np.float64)
        m = rng.random(x.shape) < 0.7
        for S in (1, 2, 4, 8):
            for mask in (None, m):
                n0 = LAUNCHES["sharded_combine"]
                got = rank_results(plan, k, S, x, mask, cuda, plain=False)
                torch.cuda.synchronize()
                launched = LAUNCHES["sharded_combine"] - n0
                want = rank_results(plan, k, S, x, mask, cuda, plain=True)
                for r, (a, b) in enumerate(zip(got, want)):
                    assert torch.equal(_bits(a), _bits(b)), (k, S, r)
                assert (launched > 0) == (S > 1), (k, S, launched)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_partial_kernel_equals_plain(plan, cuda, dtype):
    """K12's partial vector on every rank: the sums of the rank's groups
    and +0 for every other group of the level, bit for bit (the vector
    comes from torch.empty: the kernel zeroes it)."""
    rng = np.random.default_rng(5)
    E = plan.base.nelements
    for k in range(plan.nlevels):
        x = rng.standard_normal((E, plan.n_local(k)))
        for S in (2, 4, 8):
            for r in range(S):
                _, ct = shard_tables(plan, k, S, r, cuda)
                xr = torch.as_tensor(shard_rows(x, r, S)).to(dtype).to(cuda).contiguous()
                got = t_sh.cross_partial(xr, ct)
                want = t_sh.cross_partial_plain(xr, ct)
                assert torch.equal(_bits(got), _bits(want)), (k, S, r)
                assert ct.n_local_groups < ct.n_groups or S == 2, (k, S, r)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_elementwise_kernels_equal_plain(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(3)
    E, n, P = 3001, 37, 7
    u, v, w, d = (torch.randn((E, n), generator=g, device=cuda, dtype=dtype) for _ in range(4))
    d[torch.rand((E, n), generator=g, device=cuda) < 0.2] = 0.0
    m = torch.rand((E, n), generator=g, device=cuda) < 0.6
    c = torch.rand((E, P), generator=g, device=cuda, dtype=dtype) + 0.5
    dref = torch.randn((P, n), generator=g, device=cuda, dtype=dtype)
    a = torch.tensor(0.37, dtype=dtype, device=cuda)
    b = torch.tensor(-1.25, dtype=dtype, device=cuda)
    n0 = LAUNCHES["elementwise"]
    pairs = [
        (t_if.apply_mask(u, m), u * m),
        (t_ew.mul(d, u), t_ew.mul_plain(d, u)),
        (t_ew.lanczos_update(u, v, w, a, b), t_ew.lanczos_update_plain(u, v, w, a, b)),
        (t_ew.inv_positive(d), t_ew.inv_positive_plain(d)),
        (t_ew.diagonal(c, dref), t_ew.diagonal_plain(c, dref)),
        (t_ew.lanczos_update(u, v, None, a, b), t_ew.lanczos_update_plain(u, v, None, a, b)),
    ]
    for s in (a, torch.zeros((), dtype=dtype, device=cuda)):
        pairs.append((t_ew.div_nz(u, s), t_ew.div_nz_plain(u, s)))
    torch.cuda.synchronize()
    assert LAUNCHES["elementwise"] == n0 + 8
    for i, (got, want) in enumerate(pairs):
        assert torch.equal(_bits(got), _bits(want)), i
    # in place (out = the first operand)
    y = u.clone()
    t_if.apply_mask(y, m, out=y)
    assert torch.equal(_bits(y), _bits(u * m))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("P,n", [(1, 969), (1, 35), (7, 4), (7, 10), (7, 35), (7, 165), (7, 969),
                                 (7, 5000), (1, 6000), (8, 35)],
                         ids=["P1-969", "P1-35", "P7-4", "P7-10", "P7-35", "P7-165", "P7-969",
                              "P7-5000-windows", "P1-6000-windows", "P8-35"])
def test_diagonal_launches_equal_plain(cuda, dtype, P, n):
    """K18's diagonal over the launches its C entry plans: narrow widths
    (several row groups a block), a row tail, the one-piece tile, rows too
    wide for shared memory (windows, in float64 at least), the most pieces
    it takes; bitwise equal to the plain form, one count a call. More
    pieces than it takes are refused."""
    g = torch.Generator(device=cuda).manual_seed(P * 1000 + n)
    E = 4 * 333 + 1
    c = torch.rand((E, P), generator=g, device=cuda, dtype=dtype) + 0.5
    dref = torch.randn((P, n), generator=g, device=cuda, dtype=dtype)
    n0 = LAUNCHES["elementwise"]
    got = t_ew.diagonal(c, dref)
    torch.cuda.synchronize()
    assert LAUNCHES["elementwise"] == n0 + 1
    assert torch.equal(_bits(got), _bits(t_ew.diagonal_plain(c, dref)))
    if P == 8:
        with pytest.raises(RuntimeError, match="hz_ew_diagonal"):
            t_ew.diagonal(torch.ones((E, 9), device=cuda, dtype=dtype),
                          torch.ones((9, n), device=cuda, dtype=dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [10, 35, 165])
def test_element_apply_mask_store_equals_masked_output(cuda, dtype, n):
    g = torch.Generator(device=cuda).manual_seed(4)
    E, P = 2000, 7
    x = torch.randn((E, n), generator=g, device=cuda, dtype=dtype)
    b = torch.randn((E, n), generator=g, device=cuda, dtype=dtype)
    c = torch.rand((E, P), generator=g, device=cuda, dtype=dtype) + 0.5
    S = torch.randn((P, n, n), generator=g, device=cuda, dtype=dtype)
    S = (S + S.transpose(1, 2)).contiguous()
    m = torch.rand((E, n), generator=g, device=cuda) < 0.6
    tab = t_apply.stack_table(S)
    for kw in (dict(), dict(b=b)):
        ref = t_apply.element_apply(x, c, S, table=tab, **kw) * m
        got = t_apply.element_apply(x, c, S, mask=m, table=tab, **kw)
        assert torch.equal(_bits(got), _bits(ref))
    r = b.clone()
    t_apply.element_apply(x, c, S, b=r, out=r, mask=m, table=tab)
    assert torch.equal(_bits(r), _bits(t_apply.element_apply(x, c, S, b=b, table=tab) * m))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_cg_step_r_out_equals_plain(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(5)
    shape = (4001, 35)
    x, r, p, Ap = (torch.randn(shape, generator=g, device=cuda, dtype=dtype) for _ in range(4))
    num = torch.tensor(0.7, dtype=dtype, device=cuda)
    for den_v in (1.3, 0.0):
        den = torch.tensor(den_v, dtype=dtype, device=cuda)
        xk, xp = x.clone(), x.clone()
        rk, rp = torch.empty_like(r), torch.empty_like(r)
        t_cg.cg_step(xk, r, p, Ap, num, den, r_out=rk)
        t_cg.cg_step_plain(xp, r, p, Ap, num, den, r_out=rp)
        assert torch.equal(xk, xp) and torch.equal(rk, rp)
    r0 = r.clone()
    t_cg.cg_step(x.clone(), r, p, Ap, num, num, r_out=torch.empty_like(r))
    assert torch.equal(r, r0)  # r kept
    # x_zero: x's old values (NaN here) unread, x = 0 + alpha p
    den = torch.tensor(1.3, dtype=dtype, device=cuda)
    xk, xp = torch.full(shape, float("nan"), dtype=dtype, device=cuda), torch.empty_like(x)
    t_cg.cg_step(xk, r, p, Ap, num, den, r_out=torch.empty_like(r), x_zero=True)
    t_cg.cg_step_plain(xp, r, p, Ap, num, den, r_out=torch.empty_like(r), x_zero=True)
    assert torch.equal(_bits(xk), _bits(xp))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_chebyshev_update_x_zero_equals_plain(cuda, dtype):
    """K3 from a zero iterate: x's old values (NaN here) unread, x = 0 + p."""
    from homogenization_jl_tpu_torch.ops import chebyshev as t_cheb

    g = torch.Generator(device=cuda).manual_seed(7)
    shape = (3001, 35)
    rc, dinv = (torch.randn(shape, generator=g, device=cuda, dtype=dtype) for _ in range(2))
    ab = torch.tensor([0.4, 0.9], dtype=dtype, device=cuda)
    xk, pk = torch.full(shape, float("nan"), dtype=dtype, device=cuda), torch.empty_like(rc)
    xp, pp = torch.empty_like(rc), torch.empty_like(rc)
    t_cheb.chebyshev_update(xk, pk, rc, dinv, ab, first=True, x_zero=True)
    t_cheb.chebyshev_update_plain(xp, pp, rc, dinv, ab, True, x_zero=True)
    assert torch.equal(pk, pp) and torch.equal(xk, xp)


@pytest.mark.cuda
def test_world_of_one_nccl_sharded_equals_single_device(cuda, tmp_path):
    """The gather-sharded solver through an NCCL group of one rank on the
    card: the combine equals K8's bit for bit at every level and a
    Chebyshev PCG run equals the single-device solver's bit for bit."""
    from homogenization_jl_tpu_torch.parallel import run_slab
    from homogenization_jl_tpu_torch.parallel.group import SlabGroup
    from homogenization_jl_tpu_torch.parallel.sharding import ShardedMultigridSolver
    from homogenization_jl_tpu_torch.solver.multigrid import MultigridSolver

    group = SlabGroup.from_file(tmp_path / "store", 0, 1, device=cuda)
    try:
        plan, sigma, b = run_slab.sharded_problem(3, 4, 3)
        kw = dict(dtype=torch.float64, coarse="chol", smoother="chebyshev")
        sh = ShardedMultigridSolver(plan, group, **kw)
        single = MultigridSolver(plan, device=cuda, combine="gather", **kw)
        rng = np.random.default_rng(6)
        for k in range(plan.nlevels):
            x = torch.as_tensor(rng.standard_normal((plan.base.nelements, plan.n_local(k))),
                                device=cuda)
            assert torch.equal(_bits(sh.combine(x, k)), _bits(single.combine(x, k)))
        out = []
        for s in (sh, single):
            coeff = s.coefficients(sigma, 0.0)
            lam_max = s.estimate_lambda_max(coeff)
            x, hist = s.pcg(torch.as_tensor(b, device=cuda), coeff, s.coarse_setup(sigma, 0.0),
                            lam_max=lam_max, iters=5)
            out.append((x, hist, lam_max))
        assert out[0][1] == out[1][1] and out[0][2] == out[1][2]
        assert torch.equal(_bits(out[0][0]), _bits(out[1][0]))
    finally:
        SlabGroup.destroy()


@pytest.mark.cuda
def test_two_ranks_share_the_card_through_gloo(cuda):
    """NCCL refuses two ranks on one card; a gloo group serves the
    gather-sharded solver (its one collective is the sum) on CUDA tensors."""
    from homogenization_jl_tpu_torch.parallel import run_slab
    from homogenization_jl_tpu_torch.solver.multigrid import MultigridSolver

    kw = dict(dim=3, n=3, nlevels=3, mode="pcg", iters=6,
              solver_opts=dict(coarse="chol", smoother="chebyshev"))
    outs = run_slab.spawn_ranks(2, dict(kind="sharded", kwargs=kw, device="cuda"))
    assert outs[0]["hist"] == outs[1]["hist"]
    assert all(o["job_launches"]["sharded_combine"] > 0 for o in outs)
    plan, sigma, b = run_slab.sharded_problem(3, 3, 3)
    s = MultigridSolver(plan, device=cuda, dtype=torch.float64, combine="gather", coarse="chol",
                        smoother="chebyshev")
    coeff = s.coefficients(sigma, 0.0)
    _, hist = s.pcg(torch.as_tensor(b, device=cuda), coeff, s.coarse_setup(sigma, 0.0),
                    lam_max=s.estimate_lambda_max(coeff), iters=6)
    np.testing.assert_allclose(outs[0]["hist"], hist, rtol=1e-9)
