"""The port's host copies of the gather-sharded solver's tables
(parallel/sharding.py: ``build_sharded_tables``,
``build_sharded_gather_tables``) against the JAX package's, and the rank
tables the port builds from them.

On the JAX suite's cases (dim, n, levels, S) = (2, 4, 3, 4), (3, 4, 3, 8),
(3, 6, 2, 4) (tests/test_sharded_cross_tables.py:51) and (3, 3, 4, 8)
(E = 162 over 8 shards: blocks of 21 rows, the last of 15), at every level:
every array of both tables is equal, element for element and in dtype; the
rank tables (``shard_tables``) hold every cross slot of the JAX tables
exactly once, on the rank that owns it, with its group, and each rank's
gather tables cover its rows only."""

import numpy as np
import pytest

from homogenization_jl_tpu.mesh.grid import hypercube as j_hypercube
from homogenization_jl_tpu.ops.plan import build_grid_plan as j_build_grid_plan
from homogenization_jl_tpu.parallel import sharding as j_sd
from homogenization_jl_tpu_torch.interop import join_shards, shard_rows
from homogenization_jl_tpu_torch.mesh.grid import hypercube as t_hypercube
from homogenization_jl_tpu_torch.ops.plan import build_grid_plan as t_build_grid_plan
from homogenization_jl_tpu_torch.parallel import sharding as t_sd

CASES = [(2, 4, 3, 4), (3, 4, 3, 8), (3, 6, 2, 4), (3, 3, 4, 8)]
IDS = [f"{d}d-n{n}-L{lv}-S{S}" for d, n, lv, S in CASES]


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def case(request):
    dim, n, levels, S = request.param
    pj = j_build_grid_plan(j_hypercube(dim, n), levels, slot_tables=False)
    pt = t_build_grid_plan(t_hypercube(dim, n), levels, slot_tables=False)
    E = pt.base.nelements
    return pj, pt, S, ((E + S - 1) // S) * S


def _equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def test_cross_tables_equal_jax(case):
    pj, pt, S, E_pad = case
    for k in range(pt.nlevels):
        tj = j_sd.build_sharded_tables(pj, k, S, E_pad)
        tt = t_sd.build_sharded_tables(pt, k, S, E_pad)
        assert tt.n_cross_groups == tj.n_cross_groups, k
        for name in ("cross_gather", "cross_scatter", "cross_group"):
            assert _equal(getattr(tt, name), getattr(tj, name)), (k, name)


def test_gather_tables_equal_jax(case):
    pj, pt, S, E_pad = case
    for k in range(pt.nlevels):
        gj = j_sd.build_sharded_gather_tables(pj, k, S, E_pad)
        gt = t_sd.build_sharded_gather_tables(pt, k, S, E_pad)
        assert sorted(gt) == sorted(gj), k
        for name in gj:
            for a, b in zip(gt[name], gj[name]):
                assert _equal(a, b), (k, name)
    assert _equal(t_sd._pad_rows([[1, 2], [3]], -1), j_sd._pad_rows([[1, 2], [3]], -1))
    a = np.arange(6.0).reshape(3, 2)
    assert _equal(t_sd._pad_elems(a, 5), j_sd._pad_elems(a, 5))


def test_rank_tables_partition_the_cross_slots(case):
    """The rank tables drop only pad slots: every (rank, flat index, group)
    of the JAX tables appears once, each rank's gather tables have its own
    row count, and the row blocks join back to the whole."""
    pj, pt, S, E_pad = case
    E = pt.base.nelements
    B = E_pad // S
    rows = [shard_rows(np.arange(E), r, S) for r in range(S)]
    assert np.array_equal(join_shards(rows), np.arange(E))
    assert all(len(r) == B for r in rows[:-1]) and 0 < len(rows[-1]) <= B
    for k in range(pt.nlevels):
        tj = j_sd.build_sharded_tables(pj, k, S, E_pad)
        want = set()
        for s in range(S):
            ok = tj.cross_group[s] < tj.n_cross_groups - 1
            want |= {(s, int(f), int(g)) for f, g in zip(tj.cross_gather[s][ok], tj.cross_group[s][ok])}
        got = []
        for r in range(S):
            gt, ct = t_sd.shard_tables(pt, k, S, r)
            assert all(c.gmap.shape[0] == len(rows[r]) for c in gt.classes)
            assert ct.n_groups == tj.n_cross_groups - 1
            got += [(r, int(f), int(g)) for f, g in zip(ct.idx, ct.grp)]
            # the scatter's order: the slots by flat index
            assert np.all(np.diff(ct.idx.numpy()) > 0)
            # the kernel's gather order: the host table's slots sorted by
            # group, stable, over the rank's own groups (ascending)
            ok = tj.cross_group[r] < tj.n_cross_groups - 1
            flat, grp = tj.cross_gather[r][ok], tj.cross_group[r][ok]
            assert np.array_equal(ct.perm.numpy(), flat[np.argsort(grp, kind="stable")])
            assert np.array_equal(ct.gid.numpy(), np.unique(grp))
            start = ct.start.numpy()
            assert start[0] == 0 and start[-1] == ct.n_slots and np.all(np.diff(start) > 0)
            # each group's starts bracket exactly its slots
            assert np.array_equal(np.diff(start), np.bincount(grp)[np.unique(grp)])
        assert len(got) == len(set(got)) and set(got) == want, k
