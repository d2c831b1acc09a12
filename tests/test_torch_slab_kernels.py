"""Kernel K11 (the slab combine and constraint) and kernel K6's plane window
against their plain PyTorch forms and the single-device kernels.

K11 runs on one rank's x-plane slab of a cube-major state with the halo
planes of its neighbours; with halos cut from one full state it must equal
K2 on the full state's rows bit for bit (the same owners summed in the same
pattern order), in every mode (combine, Dirichlet fold, constraint, mask
store), at every level, for every slab of S = 1, 2 and n / pad slabs,
float32 and float64. K6's windowed weights and assemble, summed over the
windows, must equal the whole-box call to the float tolerance of a
reordered sum (2e-6 float32, 1e-13 float64, of the scale), and the
windowed distribute must equal the whole-box rows exactly.

The card tests carry the ``cuda`` marker and skip without a card (run them
there with ``python -m pytest tests/test_torch_slab_kernels.py -q
--noconftest``); the CPU tests check the wrappers' contract: CPU tensors
take the plain path and count no launch, malformed inputs raise."""

import numpy as np
import pytest
import torch

from homogenization_jl_tpu_torch.csrc.build import LAUNCHES
from homogenization_jl_tpu_torch.fem.local_operators import build_level_operators
from homogenization_jl_tpu_torch.interop import slab_rows
from homogenization_jl_tpu_torch.mesh.grid import hypercube
from homogenization_jl_tpu_torch.ops import stencil as t_stencil
from homogenization_jl_tpu_torch.ops import structured as t_st
from homogenization_jl_tpu_torch.ops.plan import build_grid_plan


@pytest.fixture(scope="module", params=[(2, 8, 3), (3, 4, 4)], ids=["2d", "3d"])
def plan(request):
    dim, n, nlevels = request.param
    return build_grid_plan(hypercube(dim, n, order="cube"), nlevels, slot_tables=False)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels)")
    return torch.device("cuda")


def _tables(plan, k, device):
    lay = plan.reference.layout[k]
    i0 = int(min(list(lay.face_offsets) + list(lay.edge_offsets) + list(lay.corner_cols)))
    return t_st.flatten_structured(t_st.build_structured_combine_auto(plan, k), i0, device=device)


def _bits(t):
    return t.contiguous().view(torch.int32 if t.element_size() == 4 else torch.int64)


def slabs(x, st, S):
    """(x0, W, rows, halo_lo, halo_hi) of every slab of x cut into S slabs,
    the halos cut from x (None beyond the domain ends, as the exchange
    delivers them)."""
    sc = st.sc
    W = sc.n // S
    h = t_st.slab_halo_rows(sc)
    full = x.cpu().numpy()
    out = []
    for r in range(S):
        def rows(q):
            return torch.as_tensor(slab_rows(full, q, S)).to(x.device)
        lo = rows(r - 1)[-h:, st.i0:].contiguous() if r > 0 else None
        hi = rows(r + 1)[:h, st.i0:].contiguous() if r < S - 1 else None
        out.append((r * W, W, rows(r).contiguous(), lo, hi))
    return out


def slab_counts(sc):
    return [S for S in (1, 2, sc.n // sc.pad) if sc.n % S == 0 and sc.n // S >= sc.pad]


# --------------------------------------------------------------------- #
# CPU: the wrapper contract
# --------------------------------------------------------------------- #
def test_slab_wrappers_take_plain_path_without_counting(plan):
    before = dict(LAUNCHES)
    rng = np.random.default_rng(0)
    k = plan.nlevels - 1
    st = _tables(plan, k, "cpu")
    x = torch.as_tensor(rng.standard_normal((plan.base.nelements, plan.n_local(k))))
    mask = torch.as_tensor(rng.random(x.shape) < 0.7)
    S = slab_counts(st.sc)[-1]
    for (x0, W, xr, lo, hi), mr in zip(slabs(x, st, S), slabs(mask, st, S)):
        for c in (False, True):
            assert torch.equal(t_st.combine_structured_slab(xr, lo, hi, st, x0, W, constrain=c),
                               t_st.combine_structured_slab_plain(xr, lo, hi, st, x0, W, c))
        got = t_st.combine_structured_slab(xr, lo, hi, st, x0, W, mask=mr[2])
        assert torch.equal(got, t_st.combine_structured_slab_plain(xr, lo, hi, st, x0, W) * mr[2])
        assert torch.equal(t_st.constrain_structured_slab(xr, st, x0, W),
                           t_st.constrain_structured_slab_plain(xr, st, x0, W))
    assert LAUNCHES == before


def test_slab_plain_forms_equal_single_device_rows(plan):
    """The plain slab forms on every slab give the single-device plain
    forms' rows (values equal; a zero's sign may differ)."""
    rng = np.random.default_rng(1)
    for k in range(plan.nlevels):
        st = _tables(plan, k, "cpu")
        x = torch.as_tensor(rng.standard_normal((plan.base.nelements, plan.n_local(k))))
        refs = [t_st.combine_structured_plain(x, st), t_st.combine_structured_plain(x, st, True),
                t_st.constrain_structured_plain(x, st)]
        for S in slab_counts(st.sc):
            for r, (x0, W, xr, lo, hi) in enumerate(slabs(x, st, S)):
                got = [t_st.combine_structured_slab_plain(xr, lo, hi, st, x0, W),
                       t_st.combine_structured_slab_plain(xr, lo, hi, st, x0, W, True),
                       t_st.constrain_structured_slab_plain(xr, st, x0, W)]
                for g, ref in zip(got, refs):
                    assert torch.equal(g, torch.as_tensor(slab_rows(ref.numpy(), r, S))), (k, S, r)


def test_slab_wrappers_reject_malformed_inputs(plan):
    k = plan.nlevels - 1
    st = _tables(plan, k, "cpu")
    sc = st.sc
    x = torch.zeros((plan.base.nelements, plan.n_local(k)), dtype=torch.float64)
    x0, W, xr, lo, hi = slabs(x, st, 2)[1]  # a halo below, the domain's end above
    with pytest.raises(ValueError):  # rows of another slab width
        t_st.combine_structured_slab(x, lo, hi, st, 0, W)
    with pytest.raises(ValueError):  # planes beyond the box
        t_st.combine_structured_slab(xr, lo, hi, st, sc.n - W + 1, W)
    with pytest.raises(ValueError):  # a halo of the wrong shape
        t_st.combine_structured_slab(xr, lo[:-1], hi, st, x0, W)
    with pytest.raises(ValueError):  # a halo of another dtype
        t_st.combine_structured_slab(xr, lo.float(), hi, st, x0, W)
    with pytest.raises(ValueError):  # a halo is missing only at a domain end
        t_st.combine_structured_slab(xr, None, hi, st, x0, W)
    with pytest.raises(ValueError):
        t_st.combine_structured_slab(slabs(x, st, 2)[0][2], None, None, st, 0, W)
    zero = torch.zeros_like(lo)
    assert torch.equal(t_st.combine_structured_slab(xr, lo, None, st, x0, W),
                       t_st.combine_structured_slab(xr, lo, zero, st, x0, W))
    with pytest.raises(TypeError):
        t_st.constrain_structured_slab(xr.to(torch.float16), st, x0, W)
    with pytest.raises(ValueError):
        t_st.combine_structured_slab(xr, lo, hi, st, x0, W, constrain=True,
                                     mask=torch.ones_like(xr, dtype=torch.bool))
    with pytest.raises(ValueError):  # the slab form needs a cube-major base
        pt = build_grid_plan(hypercube(plan.base.dim, sc.n, order="type"), 2, slot_tables=False)
        stt = _tables(pt, 1, "cpu")
        t_st.constrain_structured_slab(torch.zeros((xr.shape[0], pt.n_local(1)),
                                                   dtype=torch.float64), stt, 0, W)
    s0 = t_stencil.build_lattice_stencil(plan.base)
    with pytest.raises(ValueError):  # a window beyond the box
        t_stencil.lattice_distribute(torch.zeros(plan.base.nnodes, dtype=torch.float64), s0,
                                     x0=sc.n - 1, planes=2)
    with pytest.raises(ValueError):  # rows of the whole box for a window
        t_stencil.lattice_assemble(torch.zeros((plan.base.nelements, plan.base.dim + 1),
                                               dtype=torch.float64), s0, x0=0, planes=1)


def test_lattice_window_plain_forms_sum_to_the_box(plan):
    """K6's windowed plain forms: the windows' weights and assemble partials
    sum to the whole-box result, the distribute rows are the box's rows,
    and each window's partial is zero outside its planes."""
    rng = np.random.default_rng(2)
    ops = build_level_operators(plan.reference)
    s0 = t_stencil.build_lattice_stencil(plan.base)
    E, d = plan.base.nelements, plan.base.dim
    c = torch.as_tensor(rng.uniform(0.5, 2.0, (E, ops[0].n_pieces)))
    stack0 = torch.as_tensor(ops[0].stack)
    y = torch.as_tensor(rng.standard_normal((E, d + 1)))
    u = torch.as_tensor(rng.standard_normal(plan.base.nnodes))
    W_box = t_stencil.lattice_weights(c, stack0, s0)
    a_box = t_stencil.lattice_assemble(y, s0)
    d_box = t_stencil.lattice_distribute(u, s0)
    n = s0.n
    for S in (1, 2, n):
        P = n // S
        W_sum = a_sum = 0
        for r in range(S):
            cr, yr = (torch.as_tensor(slab_rows(a.numpy(), r, S)) for a in (c, y))
            w = t_stencil.lattice_weights(cr, stack0, s0, x0=r * P, planes=P)
            a = t_stencil.lattice_assemble(yr, s0, x0=r * P, planes=P)
            plane = torch.arange(plan.base.nnodes) // (n + 1) ** (d - 1)
            outside = (plane < r * P) | (plane > (r + 1) * P)
            assert not w[:, outside].any() and not a[outside].any()
            W_sum, a_sum = W_sum + w, a_sum + a
            assert torch.equal(t_stencil.lattice_distribute(u, s0, x0=r * P, planes=P),
                               torch.as_tensor(slab_rows(d_box.numpy(), r, S)))
        assert float((W_sum - W_box).abs().max()) <= 1e-13 * float(W_box.abs().max())
        assert float((a_sum - a_box).abs().max()) <= 1e-13 * float(a_box.abs().max())


# --------------------------------------------------------------------- #
# the card
# --------------------------------------------------------------------- #
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_slab_combine_kernel_equals_k2_rows(plan, cuda, dtype):
    rng = np.random.default_rng(3)
    for k in range(plan.nlevels):
        st = _tables(plan, k, cuda)
        x = torch.as_tensor(rng.standard_normal((plan.base.nelements, plan.n_local(k)))).to(dtype).to(cuda)
        mask = torch.as_tensor(rng.random(x.shape) < 0.7, device=cuda)
        refs = [t_st.combine_structured(x, st), t_st.combine_structured(x, st, constrain=True),
                t_st.combine_structured(x, st, mask=mask), t_st.constrain_structured(x, st)]
        for S in slab_counts(st.sc):
            for r, ((x0, W, xr, lo, hi), mr) in enumerate(zip(slabs(x, st, S), slabs(mask, st, S))):
                n0 = LAUNCHES["slab_combine"]
                got = [t_st.combine_structured_slab(xr, lo, hi, st, x0, W),
                       t_st.combine_structured_slab(xr, lo, hi, st, x0, W, constrain=True),
                       t_st.combine_structured_slab(xr, lo, hi, st, x0, W, mask=mr[2]),
                       t_st.constrain_structured_slab(xr, st, x0, W)]
                torch.cuda.synchronize()
                assert LAUNCHES["slab_combine"] == n0 + 4
                for g, ref in zip(got, refs):
                    want = torch.as_tensor(slab_rows(ref.cpu().numpy(), r, S)).to(cuda)
                    assert torch.equal(_bits(g), _bits(want)), (k, S, r)
                plain = t_st.combine_structured_slab_plain(xr, lo, hi, st, x0, W, True)
                assert torch.equal(got[1], plain)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_lattice_window_kernel_matches_plain(plan, cuda, dtype):
    rng = np.random.default_rng(4)
    ops = build_level_operators(plan.reference)
    s0 = t_stencil.build_lattice_stencil(plan.base)
    E, d, n = plan.base.nelements, plan.base.dim, s0.n
    tol = 2e-6 if dtype == torch.float32 else 1e-13
    c = torch.as_tensor(rng.uniform(0.5, 2.0, (E, ops[0].n_pieces))).to(dtype).to(cuda)
    stack0 = torch.as_tensor(ops[0].stack).to(dtype).to(cuda)
    y = torch.as_tensor(rng.standard_normal((E, d + 1))).to(dtype).to(cuda)
    u = torch.as_tensor(rng.standard_normal(plan.base.nnodes)).to(dtype).to(cuda)
    for S in (2, n):
        P = n // S
        for r in range(S):
            cr, yr = (torch.as_tensor(slab_rows(a.cpu().numpy(), r, S)).to(cuda) for a in (c, y))
            win = dict(x0=r * P, planes=P)
            n0 = LAUNCHES["lattice_stencil"]
            w = t_stencil.lattice_weights(cr, stack0, s0, **win)
            a = t_stencil.lattice_assemble(yr, s0, **win)
            dd = t_stencil.lattice_distribute(u, s0, **win)
            torch.cuda.synchronize()
            assert LAUNCHES["lattice_stencil"] == n0 + 3
            w_ref = t_stencil.lattice_weights_plain(cr, stack0, s0, **win)
            assert float((w - w_ref).abs().max()) <= tol * float(w_ref.abs().max())
            a_ref = t_stencil.lattice_assemble_plain(yr, s0, **win)
            assert torch.equal(a, a_ref)
            assert torch.equal(dd, t_stencil.lattice_distribute_plain(u, s0, **win))


@pytest.mark.cuda
def test_world_of_one_nccl_equals_single_device(cuda, tmp_path):
    """The slab solver through an NCCL group of one rank on the card: the
    combine equals K2 bit for bit at every level, three V-cycles equal the
    single-device solver's bit for bit, and K11 carried the combines."""
    from homogenization_jl_tpu_torch.parallel import run_slab
    from homogenization_jl_tpu_torch.parallel.group import SlabGroup
    from homogenization_jl_tpu_torch.parallel.slab import SlabShardedMultigridSolver
    from homogenization_jl_tpu_torch.solver.multigrid import MultigridSolver

    group = SlabGroup.from_file(tmp_path / "store", 0, 1, device=cuda)
    try:
        plan, sigma, b = run_slab.problem(3, 8, 3)[:3]
        kw = dict(dtype=torch.float64, coarse="chol", smoother="chebyshev")
        slab = SlabShardedMultigridSolver(plan, group, **kw)
        single = MultigridSolver(plan, device=cuda, **kw)
        rng = np.random.default_rng(6)
        for k in range(plan.nlevels):
            x = torch.as_tensor(rng.standard_normal((plan.base.nelements, plan.n_local(k))),
                                device=cuda)
            assert torch.equal(_bits(slab.combine(x, k)), _bits(single.combine(x, k)))
        out = []
        for s in (slab, single):
            coeff = s.coefficients(sigma, 0.0)
            setup = s.coarse_setup(sigma, 0.0)
            lam_max = s.estimate_lambda_max(coeff)
            x, _ = s.zero_states()
            n0 = LAUNCHES["slab_combine"]
            for _ in range(3):
                x, r = s.vcycle(x, torch.as_tensor(b, device=cuda), coeff, setup, lam_max)
            torch.cuda.synchronize()
            out.append((x, r, lam_max, LAUNCHES["slab_combine"] - n0))
        assert out[0][2] == out[1][2]
        assert torch.equal(_bits(out[0][0]), _bits(out[1][0]))
        assert torch.equal(_bits(out[0][1]), _bits(out[1][1]))
        assert out[0][3] > 0 and out[1][3] == 0
    finally:
        SlabGroup.destroy()
