"""Hand kernels of the PyTorch port against their plain PyTorch versions.

The kernel tests carry the ``cuda`` marker and need an NVIDIA card (they
build the CUDA kernels with nvcc and JIT the Triton one); without a card
they skip at run time with a reason. Run them on the card with
``python -m pytest tests/test_torch_kernels.py -q``. Tolerances are those
of chip_smoke.py's kernel phase: K1 relative norm error <= 1e-5 in float32
(a 7n-term sum in another order) and 1e-12 in float64; K2 bitwise-equal
copies and <= 1e-6 from the plain form (and, on small 2D and 3D plans in
both orders, bitwise equal to it in every mode, on a misaligned view
too); K3 <= 1e-6; K6 weights <= 2e-6
(float32) / 1e-13 (float64) of their scale, apply bitwise equal to its
plain form in every mask / b form, distribute exact; K7
gathers exact and the segment sum bitwise equal on two launches; K2 with
the mask epilogue bitwise equal to the plain combine times the mask; K8
(gather combine) bitwise equal to its plain form, with and without the
mask, at class widths 1 and not a multiple of 4, on a misaligned view and
through int64 owner tables; K15 (mixed boundary) bitwise equal to ``.to()``
at every N % 4 and on misaligned views; K9 (sigma integrals) within 1e-5 (float32) / 1e-12 (float64) of its
plain form, relative to the sum of the absolute terms, and bitwise equal on
two launches; K4 (transfers) prolong_add bitwise equal to the dense product
(P's weights make every product exact) and restrict within 1e-6 (float32)
/ 1e-14 (float64) of it; K5 (dots) bitwise equal on two launches and equal
to its plain form, which sums in the kernel's order, on a misaligned view
as on an aligned copy; K10 (CG updates)
bitwise equal to its plain form, den == 0 included.

The CPU tests check the wrappers' contract: CPU tensors take the plain path
and count no launch; malformed inputs raise."""

import dataclasses

import numpy as np
import pytest
import torch

from homogenization_jl_tpu_torch.csrc.build import LAUNCHES
from homogenization_jl_tpu_torch.fem.local_operators import build_level_operators
from homogenization_jl_tpu_torch.mesh.grid import hypercube
from homogenization_jl_tpu_torch.mesh.reference import prolongation_dense
from homogenization_jl_tpu_torch.ops import apply as t_apply
from homogenization_jl_tpu_torch.models.checkerboard import ordered_hypercube
from homogenization_jl_tpu_torch.ops import cg as t_cg
from homogenization_jl_tpu_torch.ops import chebyshev as t_cheb
from homogenization_jl_tpu_torch.ops import dots as t_dots
from homogenization_jl_tpu_torch.ops import integrals as t_int
from homogenization_jl_tpu_torch.ops import interfaces as t_if
from homogenization_jl_tpu_torch.ops import mixed as t_mixed
from homogenization_jl_tpu_torch.ops import stencil as t_stencil
from homogenization_jl_tpu_torch.ops import structured as t_st
from homogenization_jl_tpu_torch.ops import transfer as t_transfer
from homogenization_jl_tpu_torch.ops.plan import build_grid_plan


def _i0(plan, k):
    lay = plan.reference.layout[k]
    return int(min(list(lay.face_offsets) + list(lay.edge_offsets) + list(lay.corner_cols)))


@pytest.fixture(scope="module", params=["type", "cube"])
def plan(request):
    return build_grid_plan(hypercube(3, 4, order=request.param), 4, slot_tables=False)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels)")
    return torch.device("cuda")


def _bits(t):
    return t.contiguous().view(torch.int32 if t.element_size() == 4 else torch.int64)


def _tables(plan, k, device):
    sc = t_st.build_structured_combine_auto(plan, k)
    return t_st.flatten_structured(sc, _i0(plan, k), device=device)


# --------------------------------------------------------------------- #
# CPU: the wrapper contract
# --------------------------------------------------------------------- #
def test_cpu_tensors_take_plain_path_without_counting(plan):
    before = dict(LAUNCHES)
    ops = build_level_operators(plan.reference)
    rng = np.random.default_rng(0)
    E = plan.base.nelements
    k = plan.nlevels - 1
    x = torch.as_tensor(rng.standard_normal((E, plan.n_local(k))))
    coeff = torch.as_tensor(rng.uniform(0.5, 2.0, (E, ops[k].n_pieces)))
    stack = torch.as_tensor(ops[k].stack)
    y = t_apply.element_apply(x, coeff, stack)
    assert torch.equal(y, t_apply.element_apply_plain(x, coeff, stack))
    st = _tables(plan, k, "cpu")
    for c in (False, True):
        assert torch.equal(
            t_st.combine_structured(x, st, constrain=c),
            t_st.combine_structured_plain(x, st, constrain=c),
        )
    assert torch.equal(t_st.constrain_structured(x, st), t_st.constrain_structured_plain(x, st))
    p = torch.zeros_like(x)
    x2 = x.clone()
    ab = torch.tensor([0.5, 2.0], dtype=x.dtype)
    t_cheb.chebyshev_update(x2, p, y, x.abs(), ab, first=True)
    assert torch.equal(p, 2.0 * (x.abs() * y))
    st0 = t_stencil.build_lattice_stencil(plan.base)
    c0 = torch.as_tensor(rng.uniform(0.5, 2.0, (E, ops[0].n_pieces)))
    s0 = torch.as_tensor(ops[0].stack)
    W = t_stencil.lattice_weights(c0, s0, st0)
    assert torch.equal(W, t_stencil.lattice_weights_plain(c0, s0, st0))
    u = torch.as_tensor(rng.standard_normal(plan.base.nnodes))
    assert torch.equal(t_stencil.lattice_apply(u, W, st0), t_stencil.lattice_apply_plain(u, W, st0))
    tab = t_if.build_segment_tables(plan.base.elements, plan.base.nnodes)
    y0 = t_stencil.lattice_distribute(u, st0)
    assert torch.equal(t_if.segment_sum(y0, tab), t_if.segment_sum_plain(y0, tab))
    assert torch.equal(t_if.gather_scale(u, t_if.index_tensor(plan.base.elements)), y0)
    assert LAUNCHES == before


def test_wrappers_reject_malformed_inputs(plan):
    E = plan.base.nelements
    n = plan.n_local(1)
    stack = torch.as_tensor(build_level_operators(plan.reference)[1].stack)
    x = torch.zeros((E, n), dtype=torch.float64)
    coeff = torch.ones((E, stack.shape[0]), dtype=torch.float64)
    with pytest.raises(TypeError):
        t_apply.element_apply(x.float(), coeff, stack)
    with pytest.raises(TypeError):
        t_apply.element_apply(x.to(torch.int64), coeff.to(torch.int64), stack.to(torch.int64))
    with pytest.raises(ValueError):
        t_apply.element_apply(x[:, :-1], coeff, stack)
    with pytest.raises(ValueError):
        t_apply.element_apply(x.t().contiguous().t(), coeff, stack)
    with pytest.raises(ValueError):
        t_apply.element_apply(x, coeff, stack, out=x)
    with pytest.raises(ValueError):  # the residual form takes at most 8 pieces
        s9 = stack[:1].expand(9, -1, -1).contiguous()
        t_apply.element_apply(x, coeff[:, :1].expand(-1, 9).contiguous(), s9, b=x.clone())
    st = _tables(plan, 1, "cpu")
    with pytest.raises(ValueError):
        t_st.combine_structured(x[:, :-1], st)
    with pytest.raises(TypeError):
        t_st.combine_structured(x.to(torch.float16), st)
    with pytest.raises(ValueError):
        t_st.constrain_structured(x[::2], st)
    with pytest.raises(ValueError):
        t_cheb.chebyshev_update(x, x.clone(), x.float(), x, torch.zeros(2, dtype=torch.float64))
    with pytest.raises(ValueError):
        t_cheb.chebyshev_update(x, x.clone(), x, x, torch.zeros(3, dtype=torch.float64))
    st0 = t_stencil.build_lattice_stencil(plan.base)
    N = plan.base.nnodes
    u = torch.zeros(N, dtype=torch.float64)
    W = torch.zeros((len(st0.deltas), N), dtype=torch.float64)
    with pytest.raises(ValueError):
        t_stencil.lattice_apply(u[:-1], W, st0)
    with pytest.raises(TypeError):
        t_stencil.lattice_apply(u.float(), W, st0)
    with pytest.raises(TypeError):
        t_stencil.lattice_apply(u, W, st0, m=torch.ones(N))  # mask must be bool
    with pytest.raises(ValueError):
        t_stencil.lattice_distribute(torch.zeros(2 * N, dtype=torch.float64)[::2], st0)
    with pytest.raises(ValueError):
        t_stencil.lattice_assemble(torch.zeros((E, 3), dtype=torch.float64), st0)
    idx = t_if.index_tensor(plan.base.elements)
    with pytest.raises(TypeError):
        t_if.gather_scale(u, idx.to(torch.int16))
    with pytest.raises(ValueError):
        t_if.gather_scale(u, idx, torch.ones(idx.shape))  # mask must be bool
    tab = t_if.build_segment_tables(plan.base.elements, N)
    with pytest.raises(ValueError):
        t_if.segment_sum(torch.zeros(5, dtype=torch.float64), tab)
    with pytest.raises(ValueError):
        t_if.build_segment_tables(plan.base.elements, N - 1)


# --------------------------------------------------------------------- #
# CUDA: kernel against plain form (skips without a card)
# --------------------------------------------------------------------- #
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_element_apply_kernel_matches_plain(plan, cuda, dtype):
    ops = build_level_operators(plan.reference)
    rng = np.random.default_rng(1)
    E = plan.base.nelements
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    for op in ops:
        x = torch.as_tensor(rng.standard_normal((E, op.n_local)), dtype=dtype, device=cuda)
        b = torch.as_tensor(rng.standard_normal((E, op.n_local)), dtype=dtype, device=cuda)
        coeff = torch.as_tensor(rng.uniform(0.5, 2.0, (E, op.n_pieces)), dtype=dtype, device=cuda)
        stack = torch.as_tensor(op.stack, dtype=dtype, device=cuda)
        tab = t_apply.stack_table(stack)
        ref = t_apply.element_apply_plain(x, coeff, stack)
        b_old = b.clone()
        n0 = LAUNCHES["element_apply"]
        got = t_apply.element_apply(x, coeff, stack, table=tab)
        res = t_apply.element_apply(x, coeff, stack, b=b, table=tab)
        t_apply.element_apply(x, coeff, stack, b=b, out=b, table=tab)  # in place
        torch.cuda.synchronize()
        assert LAUNCHES["element_apply"] == n0 + 3
        assert torch.linalg.norm(got - ref) <= tol * torch.linalg.norm(ref), op.n_local
        ref_res = b_old - ref
        assert torch.linalg.norm(res - ref_res) <= tol * torch.linalg.norm(ref_res)
        # the shifted residual form of the plain version (ops/apply.py)
        ref_shift = t_apply.element_apply_plain(x, coeff, stack, b=b_old)
        assert torch.linalg.norm(res - ref_shift) <= tol * torch.linalg.norm(ref_shift)
        assert torch.equal(res, b)


@pytest.fixture(scope="module")
def level_stacks():
    """The 3D reference stacks of levels 1-4 (n = 10, 35, 165, 969)."""
    from homogenization_jl_tpu_torch.mesh.reference import refined_reference

    return {op.n_local: op.stack for op in build_level_operators(refined_reference(3, 5))[1:]}


def _pieces(stack, P):
    """A stack of P pieces from a 7-piece one: its mass alone (PP = 1), its
    first four (PP = 4), or all seven (PP = 8)."""
    return {1: stack[-1:], 4: stack[:4], 7: stack}[P]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("P", [7, 4, 1])
@pytest.mark.parametrize("n", [969, 165, 35, 10])
def test_element_apply_kernel_forms(level_stacks, cuda, dtype, P, n):
    """K1's pipeline in every form (plain, residual, each with and without
    the mask) at every level width and piece count, at E = 1, 131 (fewer
    steps than SMs) and 1,000 (not a multiple of a step), on an aligned x
    and on views 4 and 8 bytes past a 16-byte boundary (the edges read from
    device memory), within the plain form's tolerance and bitwise equal on
    two launches; in place (out aliasing b) bitwise equal to out of place."""
    rng = np.random.default_rng(n + P)
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    stack = torch.as_tensor(_pieces(level_stacks[n], P), dtype=dtype, device=cuda)
    tab = t_apply.stack_table(stack)
    rs = t_apply.stack_rowsum(stack)
    for E in (1, 131, 1000):
        flat = torch.as_tensor(rng.standard_normal(E * n + 2), dtype=dtype, device=cuda)
        b = torch.as_tensor(rng.standard_normal((E, n)), dtype=dtype, device=cuda)
        coeff = torch.as_tensor(rng.uniform(0.5, 2.0, (E, P)), dtype=dtype, device=cuda)
        mask = torch.as_tensor(rng.random((E, n)) < 0.7, device=cuda)
        for lead in ((0, 1, 2) if dtype == torch.float32 else (0, 1)):
            x = flat[lead:lead + E * n].view(E, n)
            for bb in (None, b):
                for m in (None, mask):
                    got = t_apply.element_apply(x, coeff, stack, b=bb, rowsum=rs, mask=m, table=tab)
                    again = t_apply.element_apply(x, coeff, stack, b=bb, rowsum=rs, mask=m,
                                                  table=tab)
                    ref = t_apply.element_apply_plain(x, coeff, stack, b=bb, rowsum=rs)
                    if m is not None:
                        ref = ref * m
                    torch.cuda.synchronize()
                    assert torch.equal(_bits(got), _bits(again)), (E, lead)
                    err = torch.linalg.norm(got - ref)
                    assert err <= tol * torch.linalg.norm(ref), (E, lead, bb is None, m is None)
            want = t_apply.element_apply(x, coeff, stack, b=b, rowsum=rs, mask=mask, table=tab)
            r = b.clone()
            t_apply.element_apply(x, coeff, stack, b=r, out=r, rowsum=rs, mask=mask, table=tab)
            torch.cuda.synchronize()
            assert torch.equal(_bits(r), _bits(want)), (E, lead)


@pytest.mark.cuda
@pytest.mark.parametrize("pair", [(torch.float32, torch.bfloat16), (torch.float32, torch.float16),
                                  (torch.float64, torch.float32)], ids=str)
@pytest.mark.parametrize("n", [969, 165])
def test_element_apply_half_is_k1_on_the_widened_x(level_stacks, cuda, pair, n):
    """K16: x stored narrower than the state lands in its own width and is
    widened in the transposition: every form bitwise K1's on x cast up, on
    an aligned x and on a view 2 bytes past a 16-byte boundary."""
    dtype, xdtype = pair
    rng = np.random.default_rng(n)
    E = 1000
    stack = torch.as_tensor(level_stacks[n], dtype=dtype, device=cuda)
    tab = t_apply.stack_table(stack)
    rs = t_apply.stack_rowsum(stack)
    flat = torch.as_tensor(rng.standard_normal(E * n + 1), device=cuda).to(xdtype)
    b = torch.as_tensor(rng.standard_normal((E, n)), dtype=dtype, device=cuda)
    coeff = torch.as_tensor(rng.uniform(0.5, 2.0, (E, 7)), dtype=dtype, device=cuda)
    mask = torch.as_tensor(rng.random((E, n)) < 0.7, device=cuda)
    for lead in (0, 1):
        x = flat[lead:lead + E * n].view(E, n)
        for bb, m in ((None, None), (b, None), (b, mask), (None, mask)):
            got = t_apply.element_apply_half(x, coeff, stack, b=bb, rowsum=rs, mask=m, table=tab)
            ref = t_apply.element_apply(x.to(dtype), coeff, stack, b=bb, rowsum=rs, mask=m,
                                        table=tab)
            torch.cuda.synchronize()
            assert torch.equal(_bits(got), _bits(ref)), (lead, bb is None, m is None)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_structured_combine_kernel_matches_plain(plan, cuda, dtype):
    rng = np.random.default_rng(2)
    for k in range(plan.nlevels):
        st = _tables(plan, k, cuda)
        x = torch.as_tensor(
            rng.standard_normal((plan.base.nelements, plan.n_local(k))), dtype=dtype, device=cuda
        )
        for c in (False, True):
            ref = t_st.combine_structured_plain(x, st, constrain=c)
            got = t_st.combine_structured(x, st, constrain=c)
            torch.cuda.synchronize()
            assert (got - ref).abs().max() <= 1e-6 * ref.abs().max(), (k, c)
        ref = t_st.constrain_structured_plain(x, st)
        assert torch.equal(t_st.constrain_structured(x, st), ref), k


@pytest.fixture(scope="module", params=[(2, 5, "type"), (2, 4, "cube"), (3, 3, "type"),
                                        (3, 3, "cube")], ids=lambda p: "%dd-n%d-%s" % p)
def small_plan(request):
    dim, n, order = request.param
    return build_grid_plan(hypercube(dim, n, order=order), 3, slot_tables=False)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_structured_combine_kernel_bitwise_every_mode(small_plan, cuda, dtype):
    """K2 in every mode (combine, fold, constraint, mask store), on an
    aligned state and a misaligned view, bitwise equal to its plain form
    (the same additions in pattern order), every copy of a group equal."""
    rng = np.random.default_rng(4)
    plan = small_plan
    for k in range(plan.nlevels):
        st = _tables(plan, k, cuda)
        shape = (plan.base.nelements, plan.n_local(k))
        flat = torch.as_tensor(rng.standard_normal(shape[0] * shape[1] + 1)).to(dtype).to(cuda)
        m = torch.as_tensor(rng.random(shape) < 0.7, device=cuda)
        for x in (flat[:-1].view(shape), flat[1:].view(shape)):
            pairs = [(t_st.combine_structured(x, st), t_st.combine_structured_plain(x, st)),
                     (t_st.combine_structured(x, st, constrain=True),
                      t_st.combine_structured_plain(x, st, constrain=True)),
                     (t_st.constrain_structured(x, st), t_st.constrain_structured_plain(x, st)),
                     (t_st.combine_structured(x, st, mask=m),
                      t_st.combine_structured_plain(x, st) * m)]
            torch.cuda.synchronize()
            for i, (got, ref) in enumerate(pairs):
                assert torch.equal(_bits(got), _bits(ref)), (k, i)
        y = t_st.combine_structured(x, st).cpu().numpy()
        lay = plan.reference.layout[k]
        for tabs, offsets, width in (
            (plan.levels[k].gather.face, lay.face_offsets, lay.npf),
            (plan.levels[k].gather.edge, lay.edge_offsets, lay.npe),
            (plan.levels[k].gather.corner, lay.corner_cols, 1),
        ):
            if tabs is None or width == 0:
                continue
            oe, ol, om, _ = tabs
            cols = np.asarray(offsets)[ol][..., None] + np.arange(width)
            vals = y[oe[..., None], cols]
            first = vals[:, :1]
            assert np.array_equal(np.where(om[..., None] > 0, vals, first),
                                  np.broadcast_to(first, vals.shape)), k


@pytest.mark.cuda
def test_structured_combine_copies_bitwise_equal(plan, cuda):
    """Every copy of a shared DOF gets the same bits: scatter the kernel's
    output onto the plan's gather groups and compare all owners."""
    k = plan.nlevels - 1
    rng = np.random.default_rng(3)
    st = _tables(plan, k, cuda)
    x = torch.as_tensor(
        rng.standard_normal((plan.base.nelements, plan.n_local(k))), dtype=torch.float32, device=cuda
    )
    y = t_st.combine_structured(x, st).cpu().numpy()
    lay = plan.reference.layout[k]
    for tabs, offsets, width in (
        (plan.levels[k].gather.face, lay.face_offsets, lay.npf),
        (plan.levels[k].gather.edge, lay.edge_offsets, lay.npe),
        (plan.levels[k].gather.corner, lay.corner_cols, 1),
    ):
        if tabs is None or width == 0:
            continue
        oe, ol, om, _ = tabs
        cols = np.asarray(offsets)[ol][..., None] + np.arange(width)
        vals = y[oe[..., None], cols]  # [G, M, width]
        first = vals[:, :1]
        assert np.array_equal(np.where(om[..., None] > 0, vals, first), np.broadcast_to(first, vals.shape))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("first", [True, False])
def test_chebyshev_update_kernel_matches_plain(cuda, dtype, first):
    g = torch.Generator(device="cpu").manual_seed(4)
    shape = (3000, 35)
    x, p, rc = (torch.randn(shape, generator=g, dtype=dtype).to(cuda) for _ in range(3))
    dinv = torch.rand(shape, generator=g, dtype=dtype).to(cuda)
    ab = torch.tensor([0.37, 1.9], dtype=dtype, device=cuda)
    xr, pr = x.clone(), p.clone()
    t_cheb.chebyshev_update_plain(xr, pr, rc, dinv, ab, first)
    n0 = LAUNCHES["chebyshev_update"]
    t_cheb.chebyshev_update(x, p, rc, dinv, ab, first=first)
    torch.cuda.synchronize()
    assert LAUNCHES["chebyshev_update"] == n0 + 1
    assert (p - pr).abs().max() <= 1e-6 * pr.abs().max()
    assert (x - xr).abs().max() <= 1e-6 * xr.abs().max()


# --------------------------------------------------------------------- #
# K6 / K7 (the coarse solves)
# --------------------------------------------------------------------- #
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_lattice_stencil_kernel_matches_plain(plan, cuda, dtype):
    ops = build_level_operators(plan.reference)
    st = t_stencil.build_lattice_stencil(plan.base)
    rng = np.random.default_rng(5)
    E, N = plan.base.nelements, plan.base.nnodes
    tol = 2e-6 if dtype == torch.float32 else 1e-13

    def t(a, dt=dtype):
        return torch.as_tensor(a, device=cuda).to(dt)

    coeff = t(rng.uniform(0.5, 2.0, (E, ops[0].n_pieces)))
    stack0 = t(ops[0].stack)
    u, b = t(rng.standard_normal(N)), t(rng.standard_normal(N))
    m = t(rng.random(N) < 0.8, torch.bool)
    y = t(rng.standard_normal((E, plan.base.dim + 1)))
    n0 = LAUNCHES["lattice_stencil"]
    W = t_stencil.lattice_weights(coeff, stack0, st)
    W_ref = t_stencil.lattice_weights_plain(coeff, stack0, st)
    torch.cuda.synchronize()
    assert (W - W_ref).abs().max() <= tol * W_ref.abs().max()
    for mm, bb in ((None, None), (m, None), (None, b), (m, b)):
        got = t_stencil.lattice_apply(u, W_ref, st, m=mm, b=bb)
        ref = t_stencil.lattice_apply_plain(u, W_ref, st, m=mm, b=bb)
        # the plain form's products and adds in its order: the same bits
        assert torch.equal(got.view(torch.uint8), ref.view(torch.uint8)), (mm is None, bb is None)
    ref = t_stencil.lattice_assemble_plain(y, st)
    assert (t_stencil.lattice_assemble(y, st) - ref).abs().max() <= tol * ref.abs().max()
    assert torch.equal(t_stencil.lattice_distribute(u, st), t_stencil.lattice_distribute_plain(u, st))
    assert LAUNCHES["lattice_stencil"] == n0 + 7


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_coarse_gather_kernel_matches_plain(plan, cuda, dtype):
    rng = np.random.default_rng(6)
    E, N = plan.base.nelements, plan.base.nnodes
    vals = torch.as_tensor(rng.standard_normal((E, plan.base.dim + 1)), device=cuda).to(dtype)
    tab = t_if.build_segment_tables(plan.base.elements, N, cuda)
    n0 = LAUNCHES["coarse_gather"]
    got = t_if.segment_sum(vals, tab)
    again = t_if.segment_sum(vals, tab)
    ref = t_if.segment_sum_plain(vals, tab)
    torch.cuda.synchronize()
    assert torch.equal(got, again)  # deterministic: no atomics
    assert (got - ref).abs().max() <= 1e-6 * ref.abs().max()
    u = torch.as_tensor(rng.standard_normal(N), device=cuda).to(dtype)
    for idx in (t_if.index_tensor(plan.base.elements, cuda),
                torch.as_tensor(plan.base.elements, device=cuda, dtype=torch.int64)):
        mask = torch.as_tensor(rng.random(idx.shape) < 0.5, device=cuda)
        for mk in (None, mask):
            assert torch.equal(t_if.gather_scale(u, idx, mk), t_if.gather_scale_plain(u, idx, mk))
    assert LAUNCHES["coarse_gather"] == n0 + 6


@pytest.mark.cuda
def test_segment_sum_replaces_atomic_scatter(plan, cuda):
    """copy_to_base on the card is reproducible bit for bit: fifty launches
    of the segment sum on values of mixed magnitude give one result."""
    rng = np.random.default_rng(7)
    vals = torch.as_tensor(
        rng.standard_normal((plan.base.nelements, plan.base.dim + 1))
        * 10.0 ** rng.integers(-6, 7, (plan.base.nelements, plan.base.dim + 1)),
        device=cuda, dtype=torch.float32,
    )
    tab = t_if.build_segment_tables(plan.base.elements, plan.base.nnodes, cuda)
    first = t_if.copy_to_base(vals, tab)
    for _ in range(50):
        assert torch.equal(t_if.copy_to_base(vals, tab), first)


# --------------------------------------------------------------------- #
# K2 mask epilogue, K8, K9 (the driver)
# --------------------------------------------------------------------- #
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_structured_combine_mask_epilogue(plan, cuda, dtype):
    rng = np.random.default_rng(8)
    k = plan.nlevels - 1
    st = _tables(plan, k, cuda)
    shape = (plan.base.nelements, plan.n_local(k))
    x = torch.as_tensor(rng.standard_normal(shape), device=cuda).to(dtype)
    m = torch.as_tensor(rng.random(shape) < 0.7, device=cuda)
    n0 = LAUNCHES["structured_combine"]
    got = t_st.combine_structured(x, st, mask=m)
    torch.cuda.synchronize()
    assert LAUNCHES["structured_combine"] == n0 + 1
    assert torch.equal(got, t_st.combine_structured(x, st) * m)
    with pytest.raises(ValueError):
        t_st.combine_structured(x, st, constrain=True, mask=m)


@pytest.fixture(scope="module", params=[(2, 3), (3, 2)], ids=["2d", "3d"])
def ordered_plan(request):
    dim, radius = request.param
    return build_grid_plan(ordered_hypercube(dim, radius)[0], 3, slot_tables=False)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gather_combine_kernel_matches_plain(ordered_plan, cuda, dtype):
    rng = np.random.default_rng(9)
    for k in range(ordered_plan.nlevels):
        gt = t_if.build_gather_tables(ordered_plan, k, cuda)
        shape = (ordered_plan.base.nelements, ordered_plan.n_local(k))
        x = torch.as_tensor(rng.standard_normal(shape), device=cuda).to(dtype)
        m = torch.as_tensor(ordered_plan.levels[k].boundary_mask != 0, device=cuda)
        n0 = LAUNCHES["gather_combine"]
        for mk in (None, m):
            got = t_if.combine_gather_rows(x, gt, mask=mk)
            ref = t_if.combine_gather_rows_plain(x, gt, mask=mk)
            torch.cuda.synchronize()
            # same values added in the same order: the same bits
            assert torch.equal(got.view(torch.uint8), ref.view(torch.uint8)), (k, mk is None)
        assert LAUNCHES["gather_combine"] == n0 + 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gather_combine_kernel_widths_views_and_wide_tables(cuda, dtype):
    """K8 on every level of a 4-level ordered 3D base, whose classes have
    W = 1 (corners, level 1's edges) and W = 3, 7, 21 (not multiples of 4):
    on an aligned state and on a view one entry in (the head then goes
    entry by entry), with the mask, through the int32 owner table and the
    same table widened to int64 (the path of states past 2^31 entries),
    each bitwise equal to the plain form."""
    pl = build_grid_plan(ordered_hypercube(3, 2)[0], 4, slot_tables=False)
    rng = np.random.default_rng(12)
    widths = set()
    for k in range(pl.nlevels):
        gt = t_if.build_gather_tables(pl, k, cuda)
        assert all(c.own.dtype == torch.int32 for c in gt.classes)
        wide = dataclasses.replace(gt, classes=tuple(
            dataclasses.replace(c, own=c.own.to(torch.int64)) for c in gt.classes))
        widths |= {c.W for c in gt.classes}
        E, n = pl.base.nelements, pl.n_local(k)
        buf = torch.as_tensor(rng.standard_normal(E * n + 1), device=cuda).to(dtype)
        m = torch.as_tensor(pl.levels[k].boundary_mask != 0, device=cuda)
        for x in (buf[: E * n].view(E, n), buf[1:].view(E, n)):
            for mk in (None, m):
                ref = t_if.combine_gather_rows_plain(x, gt, mask=mk)
                for tabs in (gt, wide):
                    got = t_if.combine_gather_rows(x, tabs, mask=mk)
                    torch.cuda.synchronize()
                    assert torch.equal(_bits(got), _bits(ref)), (k, x.data_ptr() % 16, mk is None)
    assert 1 in widths and any(w > 1 and w % 4 for w in widths), widths


@pytest.mark.cuda
@pytest.mark.parametrize("N", [4001, 4002, 4003, 4096])
@pytest.mark.parametrize("view", ["aligned", "offset", "s offset"])
def test_mixed_boundary_kernel_tails_and_views(cuda, N, view):
    """K15's three forms bitwise equal to ``.to()`` (and the product) at
    N % 4 = 1, 2, 3, 0, on 16-byte aligned operands and on views one entry
    in (all of them, or the scale alone: the scalar path), each launch
    counted; the values include overflow to inf and float32 subnormals."""
    rng = np.random.default_rng(N)
    c_np = rng.standard_normal(N + 1) * 1e3
    c_np[:3] = (1e39, -1e-41, 3e-39)
    c = torch.as_tensor(c_np, device=cuda)
    s = torch.as_tensor(rng.random(N + 1), dtype=torch.float32, device=cuda)
    z = torch.as_tensor(rng.standard_normal(N + 1), dtype=torch.float32, device=cuda)
    a = 1 if view == "offset" else 0
    cv, zv, sv = c[a : a + N], z[a : a + N], s[(0 if view == "aligned" else 1):][:N]
    n0 = LAUNCHES["mixed_boundary"]
    pairs = ((t_mixed.downcast_scale(cv, sv), cv.to(torch.float32) * sv),
             (t_mixed.downcast_scale(cv), cv.to(torch.float32)),
             (t_mixed.upcast(zv), zv.to(torch.float64)))
    torch.cuda.synchronize()
    assert LAUNCHES["mixed_boundary"] == n0 + 3
    for got, ref in pairs:
        assert torch.equal(_bits(got), _bits(ref))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_local", [15, 35, 165])
def test_integrals_kernel_matches_plain(cuda, dtype, n_local):
    rng = np.random.default_rng(10)
    E = 5000
    tol = 1e-5 if dtype == torch.float32 else 1e-12

    def t(a):
        return torch.as_tensor(a, device=cuda).to(dtype)

    A = rng.standard_normal((n_local, n_local))
    mass = t(A @ A.T / n_local)
    x, w = t(rng.random((E, n_local))), t(rng.standard_normal((E, n_local)))
    detJ, mask = t(rng.uniform(0.5, 2.0, E)), t((rng.random(E) < 0.8).astype(float))
    tab = t_apply.stack_table(mass[None])
    n0 = LAUNCHES["integrals"]
    for mode in (t_int.TERMS, t_int.FIRST_QUIRK, t_int.FIRST, t_int.AREA):
        args = (None, None, None) if mode == t_int.AREA else (x, mass, w)
        got = t_int.sigma_integral(mode, *args, detJ, mask, scale=1.5, table=tab)
        again = t_int.sigma_integral(mode, *args, detJ, mask, scale=1.5, table=tab)
        ref = t_int.sigma_integral_plain(mode, *args, detJ, mask, scale=1.5)
        absargs = (None, None, None) if mode == t_int.AREA else (x.abs(), mass.abs(), w.abs())
        scale = t_int.sigma_integral_plain(mode, *absargs, detJ, mask, scale=1.5)
        torch.cuda.synchronize()
        assert torch.equal(got, again), mode  # fixed order: the same bits
        assert abs(float(got) - float(ref)) <= tol * float(scale), mode
    assert LAUNCHES["integrals"] == n0 + 8


# --------------------------------------------------------------------- #
# K4, K5, K10 (the CG smoothers' path)
# --------------------------------------------------------------------- #
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_transfer_kernel_matches_plain(plan, cuda, dtype):
    rng = np.random.default_rng(11)
    E = plan.base.nelements
    tol = 1e-6 if dtype == torch.float32 else 1e-14
    for k in range(1, plan.nlevels):
        P = torch.as_tensor(prolongation_dense(plan.reference, k - 1), device=cuda).to(dtype)
        T = t_transfer.build_transfer_tables(P)
        n_f, n_c = P.shape
        xf = torch.as_tensor(rng.standard_normal((E, n_f)), device=cuda).to(dtype)
        xc = torch.as_tensor(rng.standard_normal((E, n_c)), device=cuda).to(dtype)
        n0 = LAUNCHES["transfer"]
        got = t_transfer.prolong_add(xf, xc, T)
        alone = t_transfer.prolong_add(None, xc, T)
        r = t_transfer.restrict(xf, T)
        inplace = xf.clone()
        t_transfer.prolong_add(inplace, xc, T, out=inplace)
        torch.cuda.synchronize()
        assert LAUNCHES["transfer"] == n0 + 4
        assert torch.equal(got, t_transfer.prolong_add_plain(xf, xc, P)), k
        assert torch.equal(alone, t_transfer.prolong_add_plain(None, xc, P)), k
        assert torch.equal(inplace, got), k
        ref = t_transfer.restrict_plain(xf, P)
        assert (r - ref).abs().max() <= tol * ref.abs().max(), k


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("N", [1, 1000, 300_001])
def test_masked_dot_kernel_matches_plain(cuda, dtype, N):
    rng = np.random.default_rng(N)

    def t(a):
        return torch.as_tensor(a, device=cuda).to(dtype)

    a, b, d = t(rng.standard_normal(N)), t(rng.standard_normal(N)), t(rng.uniform(0.5, 2, N))
    w = torch.as_tensor(rng.random(N) < 0.6, device=cuda)
    n0 = LAUNCHES["masked_dot"]
    for mask, scale in ((None, None), (w, None), (None, d), (w, d)):
        got = t_dots.dot(a, b, mask=mask, scale=scale)
        again = t_dots.dot(a, b, mask=mask, scale=scale)
        ref = t_dots.dot_plain(a, b, mask=mask, scale=scale)
        torch.cuda.synchronize()
        assert torch.equal(got.view(-1), again.view(-1))  # fixed order: the same bits
        assert float(got) == float(ref)  # the plain form sums in that order
    assert LAUNCHES["masked_dot"] == n0 + 8


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shift", [1, 3])
def test_masked_dot_kernel_misaligned_view(cuda, dtype, shift):
    """An operand that starts off its 16-byte vector (a row-block view)
    takes the same order entry by entry: the bits of an aligned copy."""
    rng = np.random.default_rng(40 + shift)
    N = 300_001
    base = torch.as_tensor(rng.standard_normal(N + shift), device=cuda).to(dtype)
    a = base[shift:]  # storage offset of `shift` entries
    assert a.data_ptr() % 16 != 0
    b = torch.as_tensor(rng.standard_normal(N), device=cuda).to(dtype)
    w = torch.as_tensor(rng.random(N + shift) < 0.6, device=cuda)[shift:]
    for mask in (None, w):
        got = t_dots.dot(a, b, mask=mask)
        copy = t_dots.dot(a.clone(), b, mask=None if mask is None else mask.clone())
        torch.cuda.synchronize()
        assert torch.equal(got.view(-1), copy.view(-1))
        assert float(got) == float(t_dots.dot_plain(a, b, mask=mask))


@pytest.mark.cuda
def test_masked_dot_ticket_resets_between_launches(cuda):
    """One launch per call, its last block resetting the ticket: a hundred
    launches on one stream give one value, and so do launches on another
    stream (its own scratch)."""
    g = torch.Generator(device="cpu").manual_seed(41)
    a, b = (torch.randn(1_000_003, generator=g).to(cuda) for _ in range(2))
    first = t_dots.dot(a, b)
    vals = torch.stack([t_dots.dot(a, b) for _ in range(100)])
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        other = torch.stack([t_dots.dot(a, b) for _ in range(10)])
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    assert torch.equal(vals, first.expand(100)) and torch.equal(other, first.expand(10))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("den_zero", [False, True])
def test_cg_update_kernel_matches_plain(cuda, dtype, den_zero):
    g = torch.Generator(device="cpu").manual_seed(13)
    shape = (3001, 35)
    x, r, p, Ap, rc = (torch.randn(shape, generator=g, dtype=dtype).to(cuda) for _ in range(5))
    num = torch.tensor(0.7, dtype=dtype, device=cuda)
    den = torch.tensor(0.0 if den_zero else 1.3, dtype=dtype, device=cuda)
    xr, rr, pr = x.clone(), r.clone(), rc.clone()
    t_cg.cg_step_plain(xr, rr, p, Ap, num, den)
    t_cg.cg_direction_plain(pr, rc, p, num, den)
    n0 = LAUNCHES["cg_update"]
    xk, rk, pk = x.clone(), r.clone(), rc.clone()
    t_cg.cg_step(xk, rk, p, Ap, num, den)
    t_cg.cg_direction(pk, pk, p, num, den)
    x2 = x.clone()
    t_cg.cg_step(x2, None, p, None, num, den)
    torch.cuda.synchronize()
    assert LAUNCHES["cg_update"] == n0 + 3
    for got, ref in ((xk, xr), (rk, rr), (pk, pr), (x2, xr)):
        assert torch.equal(got, ref)
