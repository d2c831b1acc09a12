"""The gather-sharded combine (device, PyTorch + CUDA kernels K8 and K12).

Port of homogenization_jl_tpu/parallel/sharding.py::
ShardedMultigridSolver._combine (:376-405). A rank of the gather-sharded
solver (parallel/sharding.py) holds a block of element rows. Its combine:

  1. the intra-shard combine: ``combine_gather_rows`` (kernel K8) on the
     shard's owner tables, whose owner lists keep in-shard owners only, so
     every group that crosses shards comes out with a partial sum;
  2. ``cross_partial``: partial[g] = the sum of the shard's copies of each
     cross group g, in the host table's order from +0 (kernel K12,
     csrc/sharded_combine.cu);
  3. the sum of the partials over the ranks (``total_fn``: SlabGroup.sum, an
     all_gather added in rank order, so every rank reads the same bits);
  4. ``cross_scatter``: every cross copy receives its group's total, times
     the mask at the store when one is given (K12).

With no cross groups (one shard) steps 2-4 are skipped and the combine is
K8's, as in JAX (:399). ``sharded_combine_local`` (steps 1-2) and
``cross_scatter`` (step 4) are public so a caller can add the partials
itself (chip_smoke.py cuts one state into shards in one process).

``CrossTables`` holds one shard's cross slots, from
``parallel/sharding.py::build_sharded_tables`` (the JAX host tables, copied
unchanged), as int32 tables of the shard's own size: the slots sorted by
group (stable, so each group keeps the host table's order) with the CSR
start and global id of each of the shard's groups (K7's presorted
segment-sum pattern, for the partials), and the slots sorted by their flat
address beside their groups (for the scatter). Only the [n_groups] partial
vector, which the ranks sum, is the level's size.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..csrc.build import LAUNCHES, launch
from .interfaces import combine_gather_rows

_DTYPES = {torch.float32: 0, torch.float64: 1}
_INT32 = 2**31


@dataclasses.dataclass(frozen=True)
class CrossTables:
    """One shard's cross-shard slots at one level, int32. ``n_groups``: the
    level's cross groups over all shards (0: no fix-up), the length of the
    partial vector. The slots sorted by group (stable: within a group, the
    host table's order): ``perm`` [C], their flat indices in the shard's
    [rows, n] block (the order each group is summed in); the shard's own
    groups (those with a slot here), ascending: ``gid`` [Gl], each one's
    global id, and ``start`` [Gl + 1], its first sorted slot. The slots
    sorted by flat index (the scatter's order): ``idx`` [C] and ``grp``
    [C], each one's group. ``size``: the flat size of the shard's block,
    which every slot lies below."""

    n_groups: int
    perm: torch.Tensor
    start: torch.Tensor
    gid: torch.Tensor
    idx: torch.Tensor
    grp: torch.Tensor
    size: int

    def __post_init__(self):
        dev = self.perm.device
        for label in ("perm", "start", "gid", "idx", "grp"):
            _check(f"CrossTables: {label}", getattr(self, label), torch.int32, dev)
        if int(self.start.numel()) != self.gid.numel() + 1:
            raise ValueError(f"CrossTables: {self.start.numel()} group starts for "
                             f"{self.gid.numel()} groups")
        if not self.perm.numel() == self.idx.numel() == self.grp.numel():
            raise ValueError("CrossTables: perm, idx and grp must hold every slot")

    @property
    def n_slots(self) -> int:
        return int(self.idx.numel())

    @property
    def n_local_groups(self) -> int:
        return int(self.gid.numel())


def build_cross_tables(cross_gather, cross_group, n_cross_groups: int, size_local: int,
                       device="cpu") -> CrossTables:
    """CrossTables of one shard from its rows of the JAX host tables
    (``ShardedLevelTables.cross_gather[s]``, ``.cross_group[s]``; pad slots
    have a group of ``n_cross_groups - 1``, the trash group, and are
    dropped). ``size_local``: the flat size of the shard's block
    (rows * n_local), which every real slot must lie below and which must
    stay below 2^31 (the tables are int32)."""
    g = np.asarray(cross_gather, dtype=np.int64).reshape(-1)
    grp = np.asarray(cross_group, dtype=np.int64).reshape(-1)
    n_groups = max(int(n_cross_groups) - 1, 0)
    if size_local >= _INT32 or n_groups >= _INT32:
        raise ValueError(f"cross tables: a block of {size_local} entries or {n_groups} groups "
                         "reaches 2^31 (int32 tables)")
    valid = grp < n_groups
    g, grp = g[valid], grp[valid]
    if g.size and (g.max() >= size_local or g.min() < 0):
        raise ValueError("cross slot beyond the shard's block")
    order = np.argsort(grp, kind="stable")
    gid, counts = np.unique(grp, return_counts=True)
    addr = np.argsort(g, kind="stable")
    if np.any(np.diff(g[addr]) == 0):
        raise ValueError("cross tables: a slot appears twice")

    def i32(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32), device=device)

    return CrossTables(n_groups=n_groups, perm=i32(g[order]),
                       start=i32(np.concatenate([[0], np.cumsum(counts)])), gid=i32(gid),
                       idx=i32(g[addr]), grp=i32(grp[addr]), size=int(size_local))


def cross_partial_plain(x, ct: CrossTables):
    """Plain form: each of the shard's groups summed left to right from +0
    in the presorted order, one pass per place in a group (the kernel's
    order), stored at its global id; zero for the other groups."""
    vals = x.reshape(-1)[ct.perm.long()]
    start = ct.start.long()
    counts = start[1:] - start[:-1]
    # each sorted slot's local group and its place in the group
    loc = torch.repeat_interleave(torch.arange(ct.n_local_groups, device=x.device), counts)
    pos = torch.arange(vals.numel(), device=x.device) - start[loc]
    acc = torch.zeros(ct.n_local_groups, dtype=x.dtype, device=x.device)
    for j in range(int(counts.max()) if ct.n_local_groups else 0):
        sel = pos == j
        g = loc[sel]
        acc[g] = acc[g] + vals[sel]
    partial = torch.zeros(ct.n_groups, dtype=x.dtype, device=x.device)
    partial[ct.gid.long()] = acc
    return partial


def cross_scatter_plain(out, total, ct: CrossTables, mask=None):
    """Plain form: out.flat[idx] = total[grp] (* mask.flat[idx]), in place."""
    idx = ct.idx.long()
    v = total[ct.grp.long()]
    if mask is not None:
        v = v * mask.reshape(-1)[idx]
    out.reshape(-1)[idx] = v
    return out


def _check(name, t, dtype, device):
    if t.dtype != dtype or t.device != device:
        raise ValueError(f"{name}: {t.dtype} on {t.device}, expected {dtype} on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _route(name, x, ct: CrossTables):
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name}: unsupported dtype {x.dtype}")
    _check(f"{name}: x", x, x.dtype, x.device)
    if ct.perm.device != x.device:  # the rest of the tables: CrossTables.__post_init__
        raise ValueError(f"{name}: tables on {ct.perm.device}, x on {x.device}")
    if x.numel() != ct.size:
        raise ValueError(f"{name}: {x.numel()} values, the tables are for a block of {ct.size}")
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    return True


def cross_partial(x, ct: CrossTables):
    """[n_groups] sums of the shard's copies of each cross group (zero for
    a group with none here). Kernel K12 for CUDA tensors (the vector zeroed
    on the stream, then one thread per group of the shard), the plain form
    for CPU tensors."""
    if not _route("cross_partial", x, ct):
        return cross_partial_plain(x, ct)
    partial = torch.empty(ct.n_groups, dtype=x.dtype, device=x.device)
    LAUNCHES["sharded_combine"] += 1
    launch("hz_cross_partial", _DTYPES[x.dtype], x.data_ptr(), ct.perm.data_ptr(),
           ct.start.data_ptr(), ct.gid.data_ptr(), partial.data_ptr(), ct.n_groups,
           ct.n_local_groups)
    return partial


def cross_scatter(out, total, ct: CrossTables, mask=None):
    """In place: every cross slot of ``out`` gets its group's ``total``
    ([n_groups]), times the bool ``mask`` (out's shape) at the store.
    Kernel K12 for CUDA tensors (one thread per slot in address order), the
    plain form for CPU tensors."""
    kern = _route("cross_scatter", out, ct)
    _check("cross_scatter: total", total, out.dtype, out.device)
    if total.shape != (ct.n_groups,):
        raise ValueError(f"cross_scatter: total shape {tuple(total.shape)}, expected ({ct.n_groups},)")
    if mask is not None:
        _check("cross_scatter: mask", mask, torch.bool, out.device)
        if mask.shape != out.shape:
            raise ValueError("cross_scatter: mask must be shaped like out")
    if not kern:
        return cross_scatter_plain(out, total, ct, mask)
    LAUNCHES["sharded_combine"] += 1
    launch("hz_cross_scatter", _DTYPES[out.dtype], out.data_ptr(), total.data_ptr(),
           ct.idx.data_ptr(), ct.grp.data_ptr(), None if mask is None else mask.data_ptr(),
           ct.n_slots)
    return out


def sharded_combine_local(x, gt, ct: CrossTables, mask=None):
    """Steps 1-2: (K8 on the shard's tables, times ``mask``; the cross
    partials, or None without cross groups)."""
    out = combine_gather_rows(x, gt, mask=mask)
    return out, (cross_partial(x, ct) if ct.n_groups else None)


def sharded_combine(x, gt, ct: CrossTables, total_fn, mask=None):
    """The gather-sharded combine of one rank's block x [rows, n]: K8 on the
    shard's owner tables ``gt``, then the cross groups' partials summed over
    the ranks by ``total_fn`` and scattered to every cross copy (the module
    docstring). ``mask`` (bool, x's shape) multiplies the result: the JAX
    form's apply_mask(combine(x), mask)."""
    out, partial = sharded_combine_local(x, gt, ct, mask)
    if partial is not None:
        cross_scatter(out, total_fn(partial), ct, mask)
    return out
