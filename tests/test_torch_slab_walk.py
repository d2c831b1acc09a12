"""Kernel K11's walk (K2's kernel with the plane window,
csrc/structured_combine.cu) emulated in NumPy as the kernel takes it, on one
rank's slab of a cube-major state: the rows in order, each row's cube
boundary bits from its GLOBAL plane (x0 + local plane), the head columns
copied, each tail column's group summed over its owner rows in pattern
order from +0, an owner row below the slab read from halo_lo (row
r + rel + h), one at or past its end from halo_hi (row r + rel - B), an
owner skipped where its forbid bits meet the cube's (so a missing halo, at
a domain end, is never read), the group zeroed where the column's box bits
meet the cube's, the mask multiplied at the store.

On hypercube(2, 8) and hypercube(3, 4) in cube order, cut into S = 1, 2
and 4 slabs (every W >= pad = 1), at every level of a 3-level plan, in
every mode, float64 on the CPU, the walk on every slab with the halos cut
from the full state:
  * equals the plain slab forms (combine_structured_slab_plain /
    constrain_structured_slab_plain) bit for bit, up to the sign of a zero:
    the plain forms zero a boundary group by multiplying it by 0 (the JAX
    form's iota mask), which leaves -0.0 where the kernel stores +0.0;
  * equals K2's walk (tests/test_torch_structured_walk.py) on the full
    state's rows bit for bit;
  * is within 1e-12 of the JAX package's combine_structured_slab /
    constrain_structured_slab run in shard_map on S of the conftest's
    virtual CPU devices, as tests/test_torch_slab_ops.py runs them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from homogenization_jl_tpu.mesh.grid import hypercube as j_hypercube
from homogenization_jl_tpu.ops.plan import build_grid_plan as j_build_grid_plan
from homogenization_jl_tpu.ops.structured import (
    combine_structured_slab as j_combine_slab,
    constrain_structured_slab as j_constrain_slab,
)
from homogenization_jl_tpu.solver.multigrid import MultigridSolver as JaxSolver
from homogenization_jl_tpu_torch.interop import join_slabs, slab_rows
from homogenization_jl_tpu_torch.mesh.grid import hypercube as t_hypercube
from homogenization_jl_tpu_torch.ops import structured as t_st
from homogenization_jl_tpu_torch.ops.plan import build_grid_plan as t_build_grid_plan
from test_torch_structured_walk import walk as k2_walk

NLEVELS = 3
CONFIGS = [(2, 8), (3, 4)]
SLABS = (1, 2, 4)
MODES = ("combine", "fold", "constrain", "mask")
MODE_IDS = {"combine": 0, "fold": 1, "constrain": 2, "mask": 0}


def walk(x, lo, hi, st, x0, W, mode, mask=None):
    """K11 on one slab x [B, n_local] (float64 numpy) with its halos
    ([h, n_local - i0], None at a domain end), entry by entry in the
    kernel's order: mode 0 combine (times ``mask``), 1 the fold, 2 the
    constraint."""
    sc = st.sc
    n, d, ept = sc.n, sc.d, sc.ept
    B, nl = x.shape
    i0, tw = st.i0, nl - st.i0
    h = t_st.slab_halo_rows(sc)
    assert B == W * n ** (d - 1) * ept and W >= sc.pad
    tab = st.tab.numpy().astype(np.int64)
    cols = tab[tab[0]:tab[1]].reshape(ept, tw, 4)
    owners = tab[tab[1]:].reshape(-1, 4)
    m = np.ones_like(x) if mask is None else mask.astype(x.dtype)
    out = np.empty_like(x)
    r = np.arange(B)
    cube, t = r // ept, r % ept
    bnd = np.full(B, t_st.OUTSIDE)
    q = cube.copy()
    for k in reversed(range(d)):
        ck = q + x0 if k == 0 else q % n  # axis 0: the global plane
        q //= n
        bnd |= (ck == 0).astype(np.int64) << (2 * k) | (ck == n - 1).astype(np.int64) << (2 * k + 1)
    out[:, :i0] = x[:, :i0] * m[:, :i0]
    empty = np.zeros((0, tw))
    lo_f = (empty if lo is None else lo).reshape(-1)
    hi_f = (empty if hi is None else hi).reshape(-1)
    for tt in range(ept):
        rows, b = r[t == tt], bnd[t == tt]
        for jj in range(tw):
            q0, q1, box, _ = cols[tt, jj]
            j = i0 + jj
            acc = np.zeros(len(rows))
            for qq in range(q0, q1):
                forbid, rel, dcol, _ = owners[qq]
                ok = (forbid & b) == 0
                orow = rows + rel
                below, above = ok & (orow < 0), ok & (orow >= B)
                inside = ok & ~below & ~above
                v = np.zeros(len(rows))
                # a missing halo has no entries: reading it raises
                v[below] = lo_f[(orow[below] + h) * tw + jj + dcol]
                v[above] = hi_f[(orow[above] - B) * tw + jj + dcol]
                v[inside] = x[orow[inside], j + dcol]
                acc = np.where(ok, acc + v, acc)
            if mode == 0:
                out[rows, j] = acc * m[rows, j]
            else:
                out[rows, j] = np.where((box & b) == 0, acc if mode == 1 else x[rows, j], 0.0)
    return out


def _cuts(x, st, S):
    """(r, x0, W, slab, halo_lo, halo_hi) of x cut into S slabs, the halos
    cut from the neighbours (None beyond the domain ends)."""
    h = t_st.slab_halo_rows(st.sc)
    W = st.sc.n // S
    for r in range(S):
        lo = slab_rows(x, r - 1, S)[-h:, st.i0:] if r > 0 else None
        hi = slab_rows(x, r + 1, S)[:h, st.i0:] if r < S - 1 else None
        yield r, r * W, W, slab_rows(x, r, S), lo, hi


def _bits(a):
    return np.asarray(a).view(np.int64)


def _i0(plan, k):
    lay = plan.reference.layout[k]
    return int(min(list(lay.face_offsets) + list(lay.edge_offsets) + list(lay.corner_cols)))


@pytest.fixture(scope="module", params=CONFIGS, ids=lambda c: "%dd-n%d" % c)
def case(request):
    """Per level: the tables, an input and a mask, and every slab's walk
    in every mode for S = 1, 2 and 4."""
    dim, n = request.param
    pt = t_build_grid_plan(t_hypercube(dim, n, order="cube"), NLEVELS, slot_tables=False)
    rng = np.random.default_rng(31 + dim)
    levels = []
    for k in range(NLEVELS):
        st = t_st.flatten_structured(t_st.build_structured_combine_auto(pt, k), _i0(pt, k))
        assert st.sc.order == "cube" and all(n // S >= st.sc.pad for S in SLABS)
        x = rng.standard_normal((pt.base.nelements, pt.n_local(k)))
        m = rng.random(x.shape) < 0.7
        walks = {S: {mode: [] for mode in MODES} for S in SLABS}
        for S in SLABS:
            for r, x0, W, xr, lo, hi in _cuts(x, st, S):
                for mode in MODES:
                    mr = slab_rows(m, r, S) if mode == "mask" else None
                    walks[S][mode].append(walk(xr, lo, hi, st, x0, W, MODE_IDS[mode], mr))
        levels.append(dict(st=st, x=x, m=m, walks=walks))
    return request.param, levels


@pytest.mark.parametrize("mode", MODES)
def test_walk_equals_plain_slab_form(case, mode):
    _, levels = case
    for k, lv in enumerate(levels):
        st, x, m = lv["st"], lv["x"], lv["m"]
        for S in SLABS:
            for (r, x0, W, xr, lo, hi), got in zip(_cuts(x, st, S), lv["walks"][S][mode]):
                xt = torch.as_tensor(xr)
                lt, ht = (None if a is None else torch.as_tensor(np.ascontiguousarray(a))
                          for a in (lo, hi))
                if mode == "constrain":
                    ref = t_st.constrain_structured_slab_plain(xt, st, x0, W)
                else:
                    ref = t_st.combine_structured_slab_plain(xt, lt, ht, st, x0, W,
                                                             constrain=mode == "fold")
                    if mode == "mask":
                        ref = ref * torch.as_tensor(slab_rows(m, r, S))
                # the same additions in the same order; + 0.0 maps the plain
                # form's -0.0 (a multiply by 0) to the kernel's +0.0
                assert np.array_equal(_bits(got + 0.0), _bits(ref.numpy() + 0.0)), (k, S, r)
                assert np.array_equal(got == 0, ref.numpy() == 0), (k, S, r)


@pytest.mark.parametrize("mode", MODES)
def test_walk_equals_k2_walk_on_full_rows(case, mode):
    _, levels = case
    for k, lv in enumerate(levels):
        st, x, m = lv["st"], lv["x"], lv["m"]
        full = k2_walk(x, st, MODE_IDS[mode], m if mode == "mask" else None)
        for S in SLABS:
            joined = join_slabs(lv["walks"][S][mode])
            assert np.array_equal(_bits(joined), _bits(full)), (k, S)


@pytest.mark.parametrize("S", SLABS)
def test_walk_matches_jax(case, S):
    (dim, n), levels = case
    pj = j_build_grid_plan(j_hypercube(dim, n), NLEVELS, slot_tables=False)
    sj = JaxSolver(pj, combine="structured", coarse="cg")
    mesh = Mesh(np.array(jax.devices()[:S]), ("e",))
    W = n // S
    spec = P("e", None)
    for k, lv in enumerate(levels):
        sc, lay = sj.structured[k], sj.row_layout[k]
        assert sc.pad == lv["st"].sc.pad and lay["iface_start"] == lv["st"].i0

        def body(v, mv, sc=sc, lay=lay):
            return (j_combine_slab(v, sc, lay, W, S, "e"),
                    j_combine_slab(v, sc, lay, W, S, "e", constrain=True),
                    j_constrain_slab(v, sc, lay, W, "e"),
                    j_combine_slab(v, sc, lay, W, S, "e") * mv)

        prog = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(spec, spec),
                                     out_specs=(spec,) * 4, check_vma=False))
        want = prog(jnp.asarray(lv["x"]), jnp.asarray(lv["m"].astype(np.float64)))
        for mode, ref in zip(MODES, want):
            ref = np.asarray(ref)
            got = join_slabs(lv["walks"][S][mode])
            assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max(), (k, mode)
