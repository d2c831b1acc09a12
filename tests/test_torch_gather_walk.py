"""Kernel K8's walk over its host tables (ops/interfaces.py::
build_gather_tables), emulated in NumPy as csrc/gather_combine.cu takes it:
the head columns copied; then, class by class, one thread per (group,
column of the cell) adding its group's valid owners' values in table order
from +0 and storing the sum to every valid owner's copy, times the mask at
the store. In float64
on the CPU it writes every output entry exactly once, equals the plain form
bit for bit (the same additions in the same order) and the JAX package's
combine_gather_rows to 1e-12, at every level of small ordered 2D and 3D
bases, with and without the mask, and on every rank's rows of S = 2 and 4
blocks (the gather-sharded solver's tables; the JAX form on the last
rank's). Tables in which a cell is not the owner of exactly its group are
rejected on the host."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from homogenization_jl_tpu.ops import interfaces as j_if
from homogenization_jl_tpu_torch.models.checkerboard import ordered_hypercube
from homogenization_jl_tpu_torch.ops import interfaces as t_if
from homogenization_jl_tpu_torch.ops.plan import build_grid_plan
from homogenization_jl_tpu_torch.parallel.sharding import shard_slice, shard_tables_all

CONFIGS = [(2, 3, 3), (2, 5, 4), (3, 2, 3), (3, 3, 3)]


def walk(x, gt, mask=None):
    """K8 on x [E, n_local] (float64 numpy), in the kernel's order. Also
    returns how often each output entry was stored."""
    E, nl = x.shape
    xf = x.reshape(-1)
    mf = None if mask is None else mask.reshape(-1).astype(x.dtype)
    out = np.zeros(E * nl)
    hits = np.zeros(E * nl, np.int64)
    head = (np.arange(E)[:, None] * nl + np.arange(gt.i0)).reshape(-1)
    out[head] = xf[head] if mf is None else xf[head] * mf[head]
    hits[head] += 1
    for c in gt.classes:
        own = c.own.numpy().astype(np.int64)
        G, M = own.shape
        w = np.arange(c.W)
        acc = np.zeros((G, c.W))
        for q in range(M):  # the kernel's batches load ahead; the adds keep this order
            ok = own[:, q] >= 0
            v = xf[np.where(ok, own[:, q], 0)[:, None] + w]
            acc = np.where(ok[:, None], acc + v, acc)
        for q in range(M):
            ok = own[:, q] >= 0
            idx = own[ok, q][:, None] + w
            out[idx] = acc[ok] if mf is None else acc[ok] * mf[idx]
            np.add.at(hits, idx.reshape(-1), 1)
    return out.reshape(E, nl), hits


def _bits(a):
    return np.asarray(a).view(np.int64)


def jax_combine(x, owners, plan, k):
    """The JAX package's combine_gather_rows on x with the owner tables
    ``owners`` ({class: (oe, ol, om, gmap)})."""
    lay = plan.reference.layout[k]
    row = dict(face_off=tuple(int(v) for v in lay.face_offsets), npf=int(lay.npf),
               edge_off=tuple(int(v) for v in lay.edge_offsets), npe=int(lay.npe),
               corner_cols=tuple(int(v) for v in lay.corner_cols),
               iface_start=int(min(list(lay.face_offsets) + list(lay.edge_offsets)
                                   + list(lay.corner_cols))))
    gt = {name: None if t is None else tuple(jnp.asarray(np.asarray(a)) for a in t)
          for name, t in owners.items()}
    return np.asarray(j_if.combine_gather_rows(jnp.asarray(x), gt, row))


def table_owners(plan, k, gt):
    """{class: (oe, ol, om, gmap)} read back from GatherTables (the plain
    form's arrays), each class named by its first column."""
    lay = plan.reference.layout[k]
    first = {}
    for name, offs, width in (("face", lay.face_offsets, lay.npf),
                              ("edge", lay.edge_offsets, lay.npe),
                              ("corner", lay.corner_cols, 1)):
        if len(offs) and width:
            first[int(min(offs))] = name
    out = dict(face=None, edge=None, corner=None)
    for c in gt.classes:
        flat = c.flat.numpy()
        out[first[c.c0]] = (flat // c.L, flat % c.L, c.om.numpy(), c.gmap.numpy())
    return out


def plan_owners(plan, k):
    g = plan.levels[k].gather
    return dict(face=g.face, edge=g.edge, corner=g.corner)


@pytest.fixture(scope="module", params=CONFIGS, ids=lambda c: "%dd-R%d-L%d" % c)
def plan(request):
    dim, radius, nlevels = request.param
    return build_grid_plan(ordered_hypercube(dim, radius)[0], nlevels, slot_tables=False)


def _inputs(plan, k, rows=None, seed=11):
    rng = np.random.default_rng(seed + k)
    E = plan.base.nelements if rows is None else rows.stop - rows.start
    x = rng.standard_normal((E, plan.n_local(k)))
    bm = plan.levels[k].boundary_mask != 0
    return x, (bm if rows is None else bm[rows])


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "mask"])
def test_walk_equals_plain_form_bitwise(plan, masked):
    for k in range(plan.nlevels):
        gt = t_if.build_gather_tables(plan, k)
        x, bm = _inputs(plan, k)
        m = bm if masked else None
        got, hits = walk(x, gt, m)
        assert np.all(hits == 1), k
        ref = t_if.combine_gather_rows_plain(torch.as_tensor(x), gt,
                                             None if m is None else torch.as_tensor(m))
        assert np.array_equal(_bits(got), _bits(ref.numpy())), k


def test_walk_matches_jax(plan):
    for k in range(plan.nlevels):
        gt = t_if.build_gather_tables(plan, k)
        x, bm = _inputs(plan, k)
        ref = jax_combine(x, plan_owners(plan, k), plan, k)
        got, _ = walk(x, gt)
        assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max(), k
        got, _ = walk(x, gt, bm)
        assert np.abs(got - ref * bm).max() <= 1e-12 * np.abs(ref).max(), k


@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("dim,radius,nlevels", [(2, 3, 3), (3, 2, 3)], ids=["2d", "3d"])
def test_walk_on_shard_tables(dim, radius, nlevels, S):
    pl = build_grid_plan(ordered_hypercube(dim, radius)[0], nlevels, slot_tables=False)
    E = pl.base.nelements
    for k in range(pl.nlevels):
        for r, (gt, _) in enumerate(shard_tables_all(pl, k, S)):
            rows = shard_slice(E, r, S)
            x, bm = _inputs(pl, k, rows, seed=40 + r)
            for m in (None, bm):
                got, hits = walk(x, gt, m)
                assert np.all(hits == 1), (k, r)
                ref = t_if.combine_gather_rows_plain(torch.as_tensor(x), gt,
                                                     None if m is None else torch.as_tensor(m))
                assert np.array_equal(_bits(got), _bits(ref.numpy())), (k, r, m is None)
            if r == S - 1:  # the JAX form on the last (shortest) rank's tables
                ref = jax_combine(x, table_owners(pl, k, gt), pl, k)
                assert np.abs(got - ref * bm).max() <= 1e-12 * np.abs(ref).max(), (k, r)


def _corrupt(plan, k, how):
    """The plan's owner tables at level k with one group of the first class
    broken (its faces in 3D, its edges in 2D)."""
    g = plan_owners(plan, k)
    name = next(n for n in ("face", "edge") if g[n] is not None)
    oe, ol, om, gmap = (np.array(a) for a in g[name])
    two = np.flatnonzero((om != 0).sum(axis=1) == 2)[0]
    if how == "dropped owner":
        om[two, 1] = 0
    elif how == "duplicated owner":
        oe[two, 1], ol[two, 1] = oe[two, 0], ol[two, 0]
    else:  # "other group": the cell's gmap entry names another group
        gmap[oe[two, 0], ol[two, 0]] = (two + 1) % oe.shape[0]
    g[name] = (oe, ol, om, gmap)
    return g


@pytest.mark.parametrize("how", ["dropped owner", "duplicated owner", "other group"])
def test_tables_where_a_cell_is_not_an_owner_of_its_group_are_rejected(how):
    pl = build_grid_plan(ordered_hypercube(2, 3)[0], 3, slot_tables=False)
    k = pl.nlevels - 1
    t_if.build_gather_tables(pl, k, owners=plan_owners(pl, k))  # the plan's own pass
    with pytest.raises(ValueError, match="gather tables"):
        t_if.build_gather_tables(pl, k, owners=_corrupt(pl, k, how))
