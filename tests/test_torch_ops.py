"""Device ops of the PyTorch port against the JAX package, in float64 on the
CPU (where every wrapper runs its plain PyTorch form): element_apply, the
structured combine with and without the Dirichlet fold, the structured
constraint, restriction/prolongation and the Chebyshev update, each to
1e-12 relative on the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from homogenization_jl_tpu.fem.local_operators import build_level_operators
from homogenization_jl_tpu.mesh.grid import hypercube as j_hypercube
from homogenization_jl_tpu.mesh.reference import prolongation_dense
from homogenization_jl_tpu.ops import apply as j_apply
from homogenization_jl_tpu.ops import structured as j_st
from homogenization_jl_tpu.ops import transfer as j_tr
from homogenization_jl_tpu.ops.plan import build_grid_plan as j_build_grid_plan
from homogenization_jl_tpu_torch.mesh.grid import hypercube as t_hypercube
from homogenization_jl_tpu_torch.ops import apply as t_apply
from homogenization_jl_tpu_torch.ops import chebyshev as t_cheb
from homogenization_jl_tpu_torch.ops import structured as t_st
from homogenization_jl_tpu_torch.ops import transfer as t_tr
from homogenization_jl_tpu_torch.ops.plan import build_grid_plan as t_build_grid_plan

RTOL = 1e-12
CONFIGS = [(3, 4, 3, "type"), (3, 4, 3, "cube"), (2, 8, 4, "cube")]


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-300)


def _i0(plan, k):
    lay = plan.reference.layout[k]
    return int(min(list(lay.face_offsets) + list(lay.edge_offsets) + list(lay.corner_cols)))


@pytest.fixture(scope="module", params=CONFIGS, ids=lambda c: "%dd-n%d-L%d-%s" % c)
def plans(request):
    dim, n, nlevels, order = request.param
    pj = j_build_grid_plan(j_hypercube(dim, n, order=order), nlevels, slot_tables=False)
    pt = t_build_grid_plan(t_hypercube(dim, n, order=order), nlevels, slot_tables=False)
    return pj, pt


def test_element_apply_matches_jax(plans):
    pj, _ = plans
    ops = build_level_operators(pj.reference)
    rng = np.random.default_rng(11)
    E = pj.base.nelements
    for k, op in enumerate(ops):
        x = rng.standard_normal((E, op.n_local))
        b = rng.standard_normal((E, op.n_local))
        coeff = rng.uniform(0.5, 2.0, (E, op.n_pieces))
        ref = np.asarray(j_apply.element_apply(jnp.asarray(x), jnp.asarray(coeff), jnp.asarray(op.stack)))
        xt, ct, st = (torch.as_tensor(a) for a in (x, coeff, op.stack))
        assert _rel(ref, t_apply.element_apply(xt, ct, st)) <= RTOL, k
        # fused residual epilogue: b - A x, also written in place into b
        assert _rel(b - ref, t_apply.element_apply(xt, ct, st, b=torch.as_tensor(b))) <= RTOL, k
        bt = torch.as_tensor(b.copy())
        t_apply.element_apply(xt, ct, st, b=bt, out=bt)
        assert _rel(b - ref, bt) <= RTOL, k


def test_element_apply_residual_shift_float32(plans):
    """The residual form's shift by x[e, 0]: exact algebra (the row-sum
    correction), and in float32 on an iterate that varies little inside an
    element, at least 10x closer to the float64 residual than b - A x summed
    unshifted."""
    pj, _ = plans
    ops = build_level_operators(pj.reference)
    rng = np.random.default_rng(13)
    E = pj.base.nelements
    op = ops[-1]
    x = rng.uniform(1.0, 2.0, (E, 1)) + 1e-3 * rng.standard_normal((E, op.n_local))
    coeff = rng.uniform(0.5, 2.0, (E, op.n_pieces))
    x32, c32, s32 = (torch.as_tensor(a, dtype=torch.float32) for a in (x, coeff, op.stack))
    ref = t_apply.element_apply_plain(*(t.double() for t in (x32, c32, s32)))
    b = ref + 1e-6 * torch.as_tensor(rng.standard_normal(ref.shape))
    r_ref = b - ref
    b32 = b.float()
    rs = t_apply.stack_rowsum(s32)
    assert rs.dtype == torch.float32 and tuple(rs.shape) == (op.n_pieces, op.n_local)
    shifted = t_apply.element_apply(x32, c32, s32, b=b32, rowsum=rs)
    assert torch.equal(shifted, t_apply.element_apply(x32, c32, s32, b=b32))
    unshifted = b32 - t_apply.element_apply(x32, c32, s32)
    err_s = float((shifted.double() - (b32.double() - ref)).norm())
    err_u = float((unshifted.double() - (b32.double() - ref)).norm())
    assert err_s * 10 <= err_u, (err_s, err_u)
    # float64: the shifted form equals b - A x to rounding
    x64, c64, s64 = (t.double() for t in (x32, c32, s32))
    r64 = t_apply.element_apply(x64, c64, s64, b=b)
    assert _rel(r_ref, r64) <= 1e-10


def test_structured_combine_and_constrain_match_jax(plans):
    pj, pt = plans
    rng = np.random.default_rng(12)
    for k in range(pj.nlevels):
        scj = j_st.build_structured_combine_auto(pj, k)
        lay = {"iface_start": _i0(pj, k)}
        st = t_st.flatten_structured(t_st.build_structured_combine_auto(pt, k), _i0(pt, k))
        x = rng.standard_normal((pj.base.nelements, pj.n_local(k)))
        xt = torch.as_tensor(x)
        # one jitted program per form (the eager slice-by-slice dispatch of
        # the JAX form costs far more than its compile)
        for constrain in (False, True):
            fn = jax.jit(lambda v, c=constrain: j_st.combine_structured(v, scj, lay, constrain=c))
            ref = np.asarray(fn(jnp.asarray(x)))
            got = t_st.combine_structured(xt, st, constrain=constrain).numpy()
            assert _rel(ref, got) <= RTOL, (k, constrain)
        fn = jax.jit(lambda v: j_st.constrain_structured(v, scj, lay))
        ref = np.asarray(fn(jnp.asarray(x)))
        assert _rel(ref, t_st.constrain_structured(xt, st).numpy()) <= RTOL, k


def test_transfer_matches_jax(plans):
    pj, _ = plans
    rng = np.random.default_rng(13)
    E = pj.base.nelements
    for k in range(1, pj.nlevels):
        P = prolongation_dense(pj.reference, k - 1)
        r = rng.standard_normal((E, P.shape[0]))
        xf = rng.standard_normal((E, P.shape[0]))
        xc = rng.standard_normal((E, P.shape[1]))
        Pt = t_tr.build_transfer_tables(torch.as_tensor(P))
        ref = np.asarray(j_tr.restrict(jnp.asarray(r), jnp.asarray(P)))
        assert _rel(ref, t_tr.restrict(torch.as_tensor(r), Pt)) <= RTOL
        ref = np.asarray(j_tr.prolong_add(jnp.asarray(xf), jnp.asarray(xc), jnp.asarray(P)))
        got = t_tr.prolong_add(torch.as_tensor(xf), torch.as_tensor(xc), Pt)
        assert _rel(ref, got) <= RTOL


@pytest.mark.parametrize("first", [True, False])
def test_chebyshev_update_matches_jax_expression(first):
    """The JAX smoother's update steps (multigrid.py:727-747) against the
    port's chebyshev_update on the same inputs."""
    rng = np.random.default_rng(14)
    x, p, rc = (rng.standard_normal((96, 35)) for _ in range(3))
    dinv = rng.uniform(0.1, 1.0, (96, 35))
    a, b = 0.37, 1.9
    z = jnp.asarray(dinv) * jnp.asarray(rc)
    p_ref = b * z if first else a * jnp.asarray(p) + b * z
    x_ref = jnp.asarray(x) + p_ref
    xt, pt = torch.as_tensor(x.copy()), torch.as_tensor(p.copy())
    ab = torch.tensor([a, b], dtype=torch.float64)
    t_cheb.chebyshev_update(xt, pt, torch.as_tensor(rc), torch.as_tensor(dinv), ab, first=first)
    assert _rel(p_ref, pt) <= RTOL
    assert _rel(x_ref, xt) <= RTOL
