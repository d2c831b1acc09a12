"""Hand kernels of the PyTorch port against their plain PyTorch versions.

The kernel tests carry the ``cuda`` marker and need an NVIDIA card (they
build the CUDA kernels with nvcc and JIT the Triton one); without a card
they skip at run time with a reason. Run them on the card with
``python -m pytest tests/test_torch_kernels.py -q``. Tolerances are those
of chip_smoke.py's kernel phase: K1 relative norm error <= 1e-5 in float32
(a 7n-term sum in another order) and 1e-12 in float64; K2 bitwise-equal
copies and <= 1e-6 from the plain form; K3 <= 1e-6.

The CPU tests check the wrappers' contract: CPU tensors take the plain path
and count no launch; malformed inputs raise."""

import numpy as np
import pytest
import torch

from homogenization_jl_tpu_torch.csrc.build import LAUNCHES
from homogenization_jl_tpu_torch.fem.local_operators import build_level_operators
from homogenization_jl_tpu_torch.mesh.grid import hypercube
from homogenization_jl_tpu_torch.ops import apply as t_apply
from homogenization_jl_tpu_torch.ops import chebyshev as t_cheb
from homogenization_jl_tpu_torch.ops import structured as t_st
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
        ref = t_apply.element_apply_plain(x, coeff, stack)
        b_old = b.clone()
        n0 = LAUNCHES["element_apply"]
        got = t_apply.element_apply(x, coeff, stack)
        res = t_apply.element_apply(x, coeff, stack, b=b)
        t_apply.element_apply(x, coeff, stack, b=b, out=b)  # in place
        torch.cuda.synchronize()
        assert LAUNCHES["element_apply"] == n0 + 3
        assert torch.linalg.norm(got - ref) <= tol * torch.linalg.norm(ref), op.n_local
        ref_res = b_old - ref
        assert torch.linalg.norm(res - ref_res) <= tol * torch.linalg.norm(ref_res)
        assert torch.equal(res, b)


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
