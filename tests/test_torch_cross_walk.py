"""Kernel K12's cross-shard fix-up (csrc/sharded_combine.cu) over its int32
tables (ops/sharded.py::build_cross_tables), emulated in NumPy as the
kernels take it: the level's [G] partial vector zeroed, one thread per
group of the shard summing x at its presorted slots from +0 and storing the
sum at the group's global id, then one thread per slot in flat-address
order storing its group's total (times the mask).

On the ordered 3D base ordered_hypercube(3, 2) (384 tets, 3 levels) cut
into 2 and 4 row blocks, at every level, float64 on the CPU:
  * every cross slot of the JAX host tables appears once, on its rank,
    with its group; the scatter's slots ascend by address;
  * the local groups ascend and are exactly the groups with a slot on the
    rank, each one's CSR range holding its slots in the host table's order;
  * a block of 2^31 entries, or 2^31 groups, raises (the tables are int32);
  * the walk of each rank (K8's plain form on the rank's owner tables, the
    walk's partials added in rank order, the walk's scatter) is bitwise
    equal to the plain forms' result and to the first design's partials
    (one thread per group of the whole level, over a level-wide start), and
    within 1e-12 of the JAX package's ShardedMultigridSolver._combine run
    in shard_map on the conftest's virtual CPU devices, with and without
    the boundary mask."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from homogenization_jl_tpu.models.checkerboard import ordered_hypercube as j_ordered
from homogenization_jl_tpu.ops.interfaces import apply_mask as j_apply_mask
from homogenization_jl_tpu.ops.plan import build_grid_plan as j_build_grid_plan
from homogenization_jl_tpu.parallel.sharding import ShardedMultigridSolver as JaxSharded
from homogenization_jl_tpu_torch.interop import join_shards, shard_rows
from homogenization_jl_tpu_torch.models.checkerboard import ordered_hypercube as t_ordered
from homogenization_jl_tpu_torch.ops import interfaces as t_if
from homogenization_jl_tpu_torch.ops import sharded as t_sh
from homogenization_jl_tpu_torch.ops.plan import build_grid_plan as t_build_grid_plan
from homogenization_jl_tpu_torch.parallel import sharding as t_sd

RADIUS = 2
NLEVELS = 3
BLOCKS = (2, 4)


def walk_partial(x, ct):
    """The partial kernel on x (the rank's block, float64 numpy): [G]
    zeros, then each local group's slots added in CSR order from +0."""
    xf = x.reshape(-1)
    perm, start, gid = (a.numpy().astype(np.int64) for a in (ct.perm, ct.start, ct.gid))
    partial = np.zeros(ct.n_groups)
    counts = np.diff(start)
    acc = np.zeros(len(gid))
    for j in range(int(counts.max()) if len(gid) else 0):  # place j of every group
        ok = j < counts
        slot = np.where(ok, start[:-1] + j, 0)
        acc = np.where(ok, acc + xf[perm[slot]], acc)
    partial[gid] = acc
    return partial


def walk_scatter(out, total, ct, mask=None):
    """The scatter kernel, in place: slot by slot in address order."""
    of = out.reshape(-1)
    idx, grp = ct.idx.numpy().astype(np.int64), ct.grp.numpy().astype(np.int64)
    v = total[grp]
    if mask is not None:
        v = v * mask.reshape(-1)[idx]
    of[idx] = v
    return out


def first_design_partial(x, flat, grp, n_groups):
    """The first design's partials from the host table's slots: one sum per
    group of the whole level over a level-wide start, in the stable group
    order."""
    xf = x.reshape(-1)
    order = np.argsort(grp, kind="stable")
    start = np.concatenate([[0], np.cumsum(np.bincount(grp, minlength=n_groups))])
    vals = xf[flat[order]]
    acc = np.zeros(n_groups)
    counts = np.diff(start)
    for j in range(int(counts.max()) if len(vals) else 0):
        ok = j < counts
        acc = np.where(ok, acc + vals[np.where(ok, start[:-1] + j, 0)], acc)
    return acc


def _bits(a):
    return np.asarray(a).view(np.int64)


@pytest.fixture(scope="module")
def plans():
    pj = j_build_grid_plan(j_ordered(3, RADIUS)[0], NLEVELS, slot_tables=False)
    pt = t_build_grid_plan(t_ordered(3, RADIUS)[0], NLEVELS, slot_tables=False)
    return pj, pt


def _inputs(pt, k, seed=13):
    rng = np.random.default_rng(seed + k)
    x = rng.standard_normal((pt.base.nelements, pt.n_local(k)))
    return x, pt.levels[k].boundary_mask != 0


def rank_results(pt, k, S, x, mask, plain):
    """Every rank's K12 result with the walk (or ``plain``: the plain
    forms), the partials added in rank order as SlabGroup.sum adds them."""
    ranks = t_sd.shard_tables_all(pt, k, S)
    xs = [np.ascontiguousarray(shard_rows(x, r, S)) for r in range(S)]
    ms = [None if mask is None else np.ascontiguousarray(shard_rows(mask, r, S)) for r in range(S)]
    outs, parts = [], []
    for xr, (gt, ct), mr in zip(xs, ranks, ms):
        out = t_if.combine_gather_rows_plain(torch.as_tensor(xr), gt,
                                             None if mr is None else torch.as_tensor(mr))
        if plain:
            parts.append(t_sh.cross_partial_plain(torch.as_tensor(xr), ct).numpy())
        else:
            parts.append(walk_partial(xr, ct))
        outs.append(out.numpy())
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    for out, (_, ct), mr in zip(outs, ranks, ms):
        if plain:
            t_sh.cross_scatter_plain(torch.as_tensor(out), torch.as_tensor(total), ct,
                                     None if mr is None else torch.as_tensor(mr))
        else:
            walk_scatter(out, total, ct, mr)
    return outs, parts


@pytest.mark.parametrize("S", BLOCKS)
def test_tables_hold_every_slot_once_and_the_shard_groups(plans, S):
    pj, pt = plans
    E = pt.base.nelements
    E_pad = t_sd.shard_block(E, S) * S
    for k in range(NLEVELS):
        tj = t_sd.build_sharded_tables(pt, k, S, E_pad)
        G = tj.n_cross_groups - 1
        want, got = set(), []
        for r, (_, ct) in enumerate(t_sd.shard_tables_all(pt, k, S)):
            ok = tj.cross_group[r] < G
            flat, grp = tj.cross_gather[r][ok], tj.cross_group[r][ok]
            want |= {(r, int(f), int(g)) for f, g in zip(flat, grp)}
            idx, sgrp = ct.idx.numpy(), ct.grp.numpy()
            got += [(r, int(f), int(g)) for f, g in zip(idx, sgrp)]
            assert all(a.dtype == torch.int32 for a in (ct.perm, ct.start, ct.gid, ct.idx, ct.grp))
            assert np.all(np.diff(idx) > 0), (k, r)  # address order, each slot once
            gid, start, perm = ct.gid.numpy(), ct.start.numpy(), ct.perm.numpy()
            assert np.all(np.diff(gid) > 0) and set(gid.tolist()) == set(grp.tolist()), (k, r)
            assert start[0] == 0 and start[-1] == len(flat) and np.all(np.diff(start) > 0)
            for l, g in enumerate(gid):  # each range: the group's slots, in table order
                assert np.array_equal(perm[start[l]:start[l + 1]], flat[grp == g]), (k, r, g)
        assert len(got) == len(set(got)) and set(got) == want, k


def test_int32_overflow_raises():
    flat, grp = np.array([0, 5, 9]), np.array([0, 1, 1])
    t_sh.build_cross_tables(flat, grp, 3, 2**31 - 1)  # the largest block that fits
    with pytest.raises(ValueError, match="2\\^31"):
        t_sh.build_cross_tables(flat, grp, 3, 2**31)
    with pytest.raises(ValueError, match="2\\^31"):
        t_sh.build_cross_tables(flat, grp, 2**31 + 1, 10)
    with pytest.raises(ValueError, match="twice"):
        t_sh.build_cross_tables(np.array([4, 4]), np.array([0, 1]), 3, 10)


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "mask"])
@pytest.mark.parametrize("S", BLOCKS)
def test_walk_equals_plain_forms_and_first_design(plans, S, masked):
    pj, pt = plans
    E = pt.base.nelements
    E_pad = t_sd.shard_block(E, S) * S
    for k in range(NLEVELS):
        x, bm = _inputs(pt, k)
        m = bm if masked else None
        got, parts = rank_results(pt, k, S, x, m, plain=False)
        want, want_parts = rank_results(pt, k, S, x, m, plain=True)
        tj = t_sd.build_sharded_tables(pt, k, S, E_pad)
        for r in range(S):
            assert np.array_equal(_bits(got[r]), _bits(want[r])), (k, r)
            assert np.array_equal(_bits(parts[r]), _bits(want_parts[r])), (k, r)
            ok = tj.cross_group[r] < tj.n_cross_groups - 1
            first = first_design_partial(np.ascontiguousarray(shard_rows(x, r, S)),
                                         tj.cross_gather[r][ok], tj.cross_group[r][ok],
                                         tj.n_cross_groups - 1)
            assert np.array_equal(_bits(parts[r]), _bits(first)), (k, r)


@pytest.mark.parametrize("S", BLOCKS)
def test_walk_matches_jax_combine(plans, S):
    pj, pt = plans
    mesh = Mesh(np.array(jax.devices()[:S]), ("e",))
    sh = JaxSharded(pj, mesh, dtype=jnp.float64, coarse="cg")
    E = pt.base.nelements
    spec = P("e", None)
    for k in range(NLEVELS):
        x, bm = _inputs(pt, k)
        statics = sh._level_statics(k)

        def body(v, mv, valid, la, statics=statics, k=k):
            out = sh._combine(v, dict(**la, **statics), k, valid)
            return out, j_apply_mask(out, mv)

        prog = jax.jit(jax.shard_map(body, mesh=mesh,
                                     in_specs=(spec, spec, P("e"), sh._level_specs(k)),
                                     out_specs=(spec, spec), check_vma=False))
        want, want_m = (np.asarray(a) for a in prog(sh.put(x), sh.put(bm.astype(np.float64)),
                                                     sh.valid_mask, sh._level_args(k)))
        got = join_shards(rank_results(pt, k, S, x, None, plain=False)[0])
        got_m = join_shards(rank_results(pt, k, S, x, bm, plain=False)[0])
        scale = np.abs(want[:E]).max()
        assert np.abs(got - want[:E]).max() <= 1e-12 * scale, k
        assert np.abs(got_m - want_m[:E]).max() <= 1e-12 * scale, k
