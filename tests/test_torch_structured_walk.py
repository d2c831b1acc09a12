"""Kernel K2's walk over its host tables (ops/structured.py::_walk_tables),
emulated in NumPy as csrc/structured_combine.cu takes it: the rows in
cube-major order whatever the storage order, each row's cube boundary bits,
the head columns copied, each tail column's group summed over its owner
rows in pattern order from +0, an owner skipped where its forbid bits meet
the cube's, the group zeroed where the column's box bits do (the fold and
the constraint), the mask multiplied at the store. In float64 on the CPU
it equals the plain form bit for bit (the same additions in the same
order) and the JAX package's combine_structured / constrain_structured to
1e-12, on hypercube(2, n) and hypercube(3, 4) in both element orders."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from homogenization_jl_tpu.mesh.grid import hypercube as j_hypercube
from homogenization_jl_tpu.ops import structured as j_st
from homogenization_jl_tpu.ops.plan import build_grid_plan as j_build_grid_plan
from homogenization_jl_tpu_torch.mesh.grid import hypercube as t_hypercube
from homogenization_jl_tpu_torch.ops import structured as t_st
from homogenization_jl_tpu_torch.ops.plan import build_grid_plan as t_build_grid_plan

CONFIGS = [(2, 5, 3, "type"), (2, 4, 3, "cube"), (3, 4, 3, "type"), (3, 4, 3, "cube")]
MODES = ("combine", "fold", "constrain", "mask")


def _i0(plan, k):
    lay = plan.reference.layout[k]
    return int(min(list(lay.face_offsets) + list(lay.edge_offsets) + list(lay.corner_cols)))


def walk(x, st, mode, mask=None):
    """K2 on x [E, n_local] (float64 numpy), entry by entry in the kernel's
    order: mode 0 combine (times ``mask``), 1 the fold, 2 the constraint."""
    sc = st.sc
    n, d, ept = sc.n, sc.d, sc.ept
    E, nl = x.shape
    i0, tw = st.i0, nl - st.i0
    tab = st.tab.numpy().astype(np.int64)
    cols = tab[tab[0]:tab[1]].reshape(ept, tw, 4)
    owners = tab[tab[1]:].reshape(-1, 4)
    m = np.ones_like(x) if mask is None else mask.astype(x.dtype)
    xf = x.reshape(-1)
    out = np.empty_like(x)
    r = np.arange(E)  # the walk's rows: cube-major
    cube, t = r // ept, r % ept
    bnd = np.full(E, t_st.OUTSIDE)
    q = cube.copy()
    for k in reversed(range(d)):
        ck = q % n
        q //= n
        bnd |= (ck == 0).astype(np.int64) << (2 * k) | (ck == n - 1).astype(np.int64) << (2 * k + 1)
    e = t * (E // ept) + cube if sc.order == "type" else r
    out[e, :i0] = x[e, :i0] * m[e, :i0]
    for tt in range(ept):
        rows, b = e[t == tt], bnd[t == tt]
        for jj in range(tw):
            q0, q1, box, _ = cols[tt, jj]
            j = i0 + jj
            acc = np.zeros(len(rows))
            for qq in range(q0, q1):
                forbid, rel, dcol, _ = owners[qq]
                ok = (forbid & b) == 0
                src = np.where(ok, (rows + rel) * nl + j + dcol, 0)
                acc = np.where(ok, acc + xf[src], acc)
            if mode == 0:
                out[rows, j] = acc * m[rows, j]
            else:
                out[rows, j] = np.where((box & b) == 0, acc if mode == 1 else x[rows, j], 0.0)
    return out


@pytest.fixture(scope="module", params=CONFIGS, ids=lambda c: "%dd-n%d-L%d-%s" % c)
def plans(request):
    dim, n, nlevels, order = request.param
    pt = t_build_grid_plan(t_hypercube(dim, n, order=order), nlevels, slot_tables=False)
    return request.param, pt


def _inputs(pt, k, seed=5):
    rng = np.random.default_rng(seed + k)
    shape = (pt.base.nelements, pt.n_local(k))
    return rng.standard_normal(shape), rng.random(shape) < 0.7


@pytest.mark.parametrize("mode", MODES)
def test_walk_equals_plain_form_bitwise(plans, mode):
    _, pt = plans
    for k in range(pt.nlevels):
        st = t_st.flatten_structured(t_st.build_structured_combine_auto(pt, k), _i0(pt, k))
        x, m = _inputs(pt, k)
        xt = torch.as_tensor(x)
        if mode == "constrain":
            ref, got = t_st.constrain_structured_plain(xt, st), walk(x, st, 2)
        elif mode == "mask":
            ref, got = t_st.combine_structured_plain(xt, st) * torch.as_tensor(m), walk(x, st, 0, m)
        else:
            fold = mode == "fold"
            ref, got = t_st.combine_structured_plain(xt, st, constrain=fold), walk(x, st, int(fold))
        assert np.array_equal(got.view(np.int64), ref.numpy().view(np.int64)), (k, mode)


def test_walk_matches_jax(plans):
    (dim, n, nlevels, order), pt = plans
    pj = j_build_grid_plan(j_hypercube(dim, n, order=order), nlevels, slot_tables=False)
    for k in range(pj.nlevels):
        scj = j_st.build_structured_combine_auto(pj, k)
        lay = {"iface_start": _i0(pj, k)}
        st = t_st.flatten_structured(t_st.build_structured_combine_auto(pt, k), _i0(pt, k))
        x, _ = _inputs(pt, k)
        for mode in (0, 1, 2):
            if mode == 2:
                fn = jax.jit(lambda v: j_st.constrain_structured(v, scj, lay))
            else:
                fn = jax.jit(lambda v, c=mode == 1: j_st.combine_structured(v, scj, lay, constrain=c))
            ref = np.asarray(fn(jnp.asarray(x)))
            got = walk(x, st, mode)
            assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max(), (k, mode)
