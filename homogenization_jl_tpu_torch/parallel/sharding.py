"""Element-axis sharding of the implicit fine grid over torch.distributed:
the gather-sharded solver.

Port of homogenization_jl_tpu/parallel/sharding.py. ``ShardedMultigridSolver``
splits the element axis of any plan (the driver's reference-order
"ordered" bases included, which the slab solver cannot take) into blocks of
B = ceil(E / S) rows, one per rank of a ``SlabGroup`` (parallel/group.py;
one process per device, SPMD, as JAX's ``shard_map`` over a 1D mesh), and
inherits the whole single-device solver (every smoother but "cg_exact" and
every coarse solve, V-cycles, FMG, PCG, ``pcg_stepper``,
``estimate_lambda_max``, ``solve``) by overriding the primitives JAX's class
writes per shard:

  * ``_combine`` / ``_combine_constrained``: the gather-sharded combine of
    ops/sharded.py (kernel K8 on the shard's owner tables, then K12's
    cross-shard partials, summed in rank order by ``SlabGroup.sum``, and
    their scatter, the mask at its store); the mask constraint ``_constrain``
    is the base class's ``apply_mask`` (kernel K18);
  * ``_sum_partial``: ``SlabGroup.sum``, which the base class applies to the
    rank's partials: the K5 dots of ``_vdot`` and the K7 segment sum of
    ``_to_global``; the coarse solves then run replicated. The level-0
    lattice stencil is not used (a rank's rows are no plane window): the
    global-space coarse solves apply the level-0 operator by distribute,
    K1 and the summed segment sum.

Rank r holds rows [r B, min((r + 1) B, E)): the partition of JAX's padded
``E_pad = S B`` blocks without the inert padding rows (the last block may be
shorter). Its element-leading tensors hold only those rows, cut on the host
(``rows_of``); ``put``, ``zero_states``, ``coefficients`` and ``combine``
take or return them, and ``interop.shard_rows`` / ``join_shards`` cut and
join global arrays. ``join_rows`` joins a state across the ranks (the
ordered driver's shrink).

The host tables are the JAX module's (``ShardedLevelTables``,
``build_sharded_tables``, ``build_sharded_gather_tables``, ``_pad_rows``,
``_pad_elems``), copied unchanged: NumPy, O(surface) for the cross part.

The surface is the JAX class's (sharding.py:225-243). What the single-device
solver takes beyond it raises ValueError: ``smoother="cg_exact"``,
``cycle="W"``, any other option, and per-call ``Ls=`` / ``interior=``;
``direction_dtype`` is inherited from the single-device solver (the
Chebyshev smoothers' half-width directions, K16, run on the rank's rows
unchanged). It has no mixed-precision form: the JAX class has none (only
the JAX slab solver has mixed-precision programs), so
``mixed_precision_setup`` / ``mixed_precision_pcg`` raise
NotImplementedError.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from ..ops.interfaces import build_gather_tables
from ..ops.plan import GridPlan
from ..ops.sharded import build_cross_tables, sharded_combine
from ..solver.multigrid import MultigridSolver
from .group import SlabGroup

NO_MIXED_PRECISION = (
    "the gather-sharded solver has no mixed-precision form: the JAX package's "
    "ShardedMultigridSolver has none either (only its slab-sharded solver has "
    "mixed-precision programs); use SlabShardedMultigridSolver"
)


# ---------------------------------------------------------------------------
# host: split combine tables into intra-shard / cross-shard parts
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ShardedLevelTables:
    """Per-level cross-shard tables; leading-axis-[n_shards] arrays.

    Only the CROSS part of the interface topology needs per-DOF flat
    indices (O(surface)); the intra-shard combine runs on the cell-granular
    gather tables (build_sharded_gather_tables), so no O(volume) slot
    expansion exists anywhere on this path."""

    cross_gather: np.ndarray  # [S, C] local flat idx for gather (pad -> 0)
    cross_scatter: np.ndarray  # [S, C] local flat idx (pad -> OOR, dropped)
    cross_group: np.ndarray  # [S, C] global cross-group id (pad -> trash)
    n_cross_groups: int  # static (+1 trash)


def _pad_rows(rows: list, pad_val: int, width: int | None = None) -> np.ndarray:
    width = max((len(r) for r in rows), default=0) if width is None else width
    out = np.full((len(rows), max(width, 1)), pad_val, dtype=np.int64)
    for s, r in enumerate(rows):
        out[s, : len(r)] = r
    return out


def build_sharded_tables(
    plan: GridPlan, level: int, n_shards: int, E_pad: int
) -> ShardedLevelTables:
    """Cross-shard interface tables derived from the gather (owner) tables.

    A group is cross-shard iff its valid owners' elements span more than
    one block of the element partition. For each such group, every valid
    owner cell (element e, local cell l) expands to its ``width``
    consecutive flat columns in the owning shard's local block — these are
    both the gather sources (partial-sum inputs) and scatter targets
    (every copy receives the psum-med total). O(surface) work and storage;
    the plan's per-DOF slot tables (``slot_tables=True``) are NOT needed —
    the round-2 verdict's flat-slot requirement is gone from this path too
    (the slab solver never had it)."""
    lp = plan.levels[level]
    lay = plan.reference.layout[level]
    assert lay is not None, "sharded combine needs the contiguous layout"
    n_local = plan.n_local(level)
    B = E_pad // n_shards
    size_local = B * n_local  # flat size of one shard's block

    specs = []
    if lp.gather.face is not None:
        specs.append((lp.gather.face, lay.face_offsets, lay.npf))
    if lp.gather.edge is not None and lay.npe > 0:
        specs.append((lp.gather.edge, lay.edge_offsets, lay.npe))
    if lp.gather.corner is not None:
        specs.append((lp.gather.corner, lay.corner_cols, 1))

    cr_g = [[] for _ in range(n_shards)]
    cr_grp = [[] for _ in range(n_shards)]
    next_id = 0
    for (oe, ol, om, _gmap), offsets, width in specs:
        valid = om > 0
        oe64 = oe.astype(np.int64)
        sh = oe64 // B
        mn = np.where(valid, sh, n_shards).min(axis=1)
        mx = np.where(valid, sh, -1).max(axis=1)
        gi = np.nonzero((mx >= 0) & (mn != mx))[0]  # cross groups
        if len(gi) == 0:
            continue
        # one psum segment per (cell group, in-cell position): position i
        # of every owner cell is the SAME fine DOF (the plan's canonical
        # in-cell order aligns owner columns — what the cell-granular
        # gather combine's elementwise owner sum relies on too)
        base_ids = next_id + np.arange(len(gi), dtype=np.int64) * width
        next_id += len(gi) * width
        rsel, jsel = np.nonzero(valid[gi])  # (cross group, valid owner)
        e = oe64[gi[rsel], jsel]
        l = ol[gi[rsel], jsel].astype(np.int64)
        s = e // B
        offs = np.asarray(offsets, dtype=np.int64)
        base = (e - s * B) * n_local + offs[l]  # [K]
        pos = np.arange(width, dtype=np.int64)
        flat = (base[:, None] + pos).ravel()
        grp = (base_ids[rsel][:, None] + pos).ravel()
        # one stable sort by shard instead of n_shards boolean passes
        s_w = np.repeat(s, width)
        order = np.argsort(s_w, kind="stable")
        bounds = np.searchsorted(s_w[order], np.arange(n_shards + 1))
        flat_o, grp_o = flat[order], grp[order]
        for s_i in range(n_shards):
            sl = slice(bounds[s_i], bounds[s_i + 1])
            cr_g[s_i].append(flat_o[sl])
            cr_grp[s_i].append(grp_o[sl])

    cat = lambda rows: [
        np.concatenate(r) if r else np.empty(0, dtype=np.int64) for r in rows
    ]
    cr_g = cat(cr_g)
    cr_grp = cat(cr_grp)
    return ShardedLevelTables(
        cross_gather=_pad_rows(cr_g, 0),
        cross_scatter=_pad_rows(cr_g, size_local),  # OOR pad -> dropped
        cross_group=_pad_rows(cr_grp, next_id),
        n_cross_groups=next_id + 1,
    )


def build_sharded_gather_tables(plan: GridPlan, level: int, n_shards: int, E_pad: int):
    """Per-shard gather-combine tables (see ops/plan.py GatherCombineTables).

    Each shard keeps every cell its block touches, with owner lists masked to
    in-shard owners only — local cells get complete sums, cross-shard cells
    partial ones; the flat cross-group psum fix-up (ShardedLevelTables)
    overwrites the partials with globally summed values afterwards. All
    arrays are padded to common shapes with a leading [n_shards] axis.
    Returns {class: (oe [S,Gmax,M], ol, om, gmap [S,B,L])} with class absent
    when the level has no such DOFs.
    """
    B = E_pad // n_shards
    E = plan.base.nelements
    gt = plan.levels[level].gather
    out = {}
    for name in ("face", "edge", "corner"):
        tabs = getattr(gt, name)
        if tabs is None:
            continue
        o_elem, o_local, o_mask, gmap = tabs
        L = gmap.shape[1]
        M = o_elem.shape[1]
        ncells = o_elem.shape[0]
        gmap_pad = np.zeros((E_pad, L), dtype=np.int64)
        gmap_pad[:E] = gmap
        # fully vectorized over shards (the round-3 per-shard np.unique
        # loop was O(S) host passes — it dominated table build at S=64):
        # key = shard * ncells + cell; one global unique gives every
        # shard's sorted touched-cell list (grouped by shard, cells sorted
        # within — identical to per-shard np.unique), `inv` gives every
        # entry's rank, and rank - shard_start is the per-shard local id.
        s_of_row = np.arange(E_pad, dtype=np.int64) // B
        keys = s_of_row[:, None] * ncells + gmap_pad
        uk, inv = np.unique(keys, return_inverse=True)
        us = uk // ncells  # shard of each unique (shard, cell)
        ucell = uk % ncells
        start = np.searchsorted(us, np.arange(n_shards, dtype=np.int64))
        counts = np.diff(np.append(start, len(uk)))
        Gmax = int(counts.max())
        GM = (inv.reshape(E_pad, L) - start[s_of_row][:, None]).astype(
            np.int32
        ).reshape(n_shards, B, L)
        pos = np.arange(len(uk), dtype=np.int64) - start[us]
        lo = (us * B)[:, None]
        oe_u = o_elem[ucell].astype(np.int64)
        in_shard = (oe_u >= lo) & (oe_u < lo + B)
        OE = np.zeros((n_shards, Gmax, M), dtype=np.int32)
        OL = np.zeros((n_shards, Gmax, M), dtype=np.int32)
        # bool owner mask: 8x less HBM than the f64 round-1 form; the
        # combine's einsum casts to the state dtype on the fly
        OM = np.zeros((n_shards, Gmax, M), dtype=bool)
        OE[us, pos] = np.where(in_shard, oe_u - lo, 0)
        OL[us, pos] = o_local[ucell]
        OM[us, pos] = (o_mask[ucell] > 0) & in_shard
        out[name] = (OE, OL, OM, GM)
    return out


def _pad_elems(a: np.ndarray, E_pad: int, fill=0.0):
    pad = E_pad - a.shape[0]
    if pad == 0:
        return a
    return np.concatenate(
        [a, np.full((pad,) + a.shape[1:], fill, dtype=a.dtype)], axis=0
    )


# ---------------------------------------------------------------------------
# rows of a rank, and the join across ranks
# ---------------------------------------------------------------------------
def shard_block(E: int, size: int) -> int:
    """B = ceil(E / size): the rows of every rank's block but the last."""
    return -(-E // size)


def shard_slice(E: int, rank: int, size: int) -> slice:
    """Rank ``rank``'s rows [rank B, min((rank + 1) B, E)); raises when a
    rank would hold none."""
    B = shard_block(E, size)
    if (size - 1) * B >= E:
        raise ValueError(f"{E} element rows leave a rank of {size} without rows")
    return slice(rank * B, min((rank + 1) * B, E))


def join_rows(group: SlabGroup, x, E: int):
    """The global [E, ...] tensor from every rank's block of rows (each
    rank's ``x``), on every rank: the blocks are padded to B rows,
    all-gathered and joined in rank order."""
    B = shard_block(E, group.size)
    if group.size == 1:
        return x
    pad = x.new_zeros((B,) + tuple(x.shape[1:]))
    pad[: x.shape[0]] = x
    parts = [torch.empty_like(pad) for _ in range(group.size)]
    dist.all_gather(parts, pad)
    return torch.cat(parts)[:E]


def shard_tables_all(plan, k: int, size: int, device="cpu", ranks=None) -> list:
    """[(GatherTables, CrossTables)] of the ``ranks`` (default: all) of
    ``size`` at level k: the owner tables of each rank's rows (owners
    outside them masked out, local element and cell ids;
    ``build_sharded_gather_tables``) for K8, and its cross-shard slots
    (``build_sharded_tables``) for K12."""
    E = plan.base.nelements
    E_pad = shard_block(E, size) * size
    gtabs = build_sharded_gather_tables(plan, k, size, E_pad)
    tabs = build_sharded_tables(plan, k, size, E_pad)
    out = []
    for r in range(size) if ranks is None else ranks:
        rows = shard_slice(E, r, size)
        owners = {name: (oe[r], ol[r], om[r], gm[r][: rows.stop - rows.start])
                  for name, (oe, ol, om, gm) in gtabs.items()}
        cross = build_cross_tables(tabs.cross_gather[r], tabs.cross_group[r], tabs.n_cross_groups,
                                   (rows.stop - rows.start) * plan.n_local(k), device)
        out.append((build_gather_tables(plan, k, device=device, owners=owners), cross))
    return out


def shard_tables(plan, k: int, size: int, rank: int, device="cpu"):
    """(GatherTables, CrossTables) of rank ``rank`` of ``size`` at level k
    (``shard_tables_all``)."""
    return shard_tables_all(plan, k, size, device, ranks=[rank])[0]


# ---------------------------------------------------------------------------
# the sharded solver
# ---------------------------------------------------------------------------
class ShardedMultigridSolver(MultigridSolver):
    """MultigridSolver over a ``SlabGroup``, the element axis split into
    blocks of rows (module docstring). Every rank calls the same methods in
    the same order (SPMD); replicated results are bitwise equal on every
    rank. The solver's device is the group's. The arguments and defaults
    are the JAX class's."""

    def __init__(
        self,
        plan: GridPlan,
        group: SlabGroup,
        dtype=torch.float32,
        smoothing_steps: int = 3,
        coarse_smoothing_steps: int = 2,
        coarse: str = "chol",
        coarse_cg_tol: float = 1e-10,
        coarse_cg_maxiter: int = 200,
        smoother: str = "cg",
        cheb_ratio: float = 30.0,
        coarse_mg_tol: float = 1e-8,
        coarse_mg_maxiter: int = 40,
        coarse_prec_cycles: int = 1,
        coarse_prec_smooth: int = 2,
        coarse_mg_dense_limit: int = 4000,
        apply_precision=None,
        cycle: str = "V",
        direction_dtype=None,
        **beyond,
    ):
        if not isinstance(group, SlabGroup):
            raise TypeError(f"group must be a SlabGroup, got {type(group).__name__}")
        if torch.device(beyond.pop("device", group.device)) != group.device:
            raise ValueError("the sharded solver runs on its group's device")
        if beyond:
            raise ValueError(
                f"{', '.join(sorted(beyond))}: not an option of the gather-sharded solver "
                "(the JAX class's surface, parallel/sharding.py:225-243)"
            )
        if smoother == "cg_exact":
            raise ValueError("smoother='cg_exact' is not a smoother of the gather-sharded solver")
        if cycle != "V":
            raise ValueError("the gather-sharded solver runs V-cycles only")
        self.group = group
        self.n_shards = group.size
        self._rows = shard_slice(plan.base.nelements, group.rank, group.size)
        self._cross = {}  # level -> ops/sharded.py::CrossTables of the rank
        super().__init__(
            plan, dtype=dtype, device=group.device, smoothing_steps=smoothing_steps,
            coarse_smoothing_steps=coarse_smoothing_steps, coarse=coarse,
            coarse_cg_tol=coarse_cg_tol, coarse_cg_maxiter=coarse_cg_maxiter,
            combine="gather", apply_precision=apply_precision, smoother=smoother,
            cheb_ratio=cheb_ratio, coarse_mg_tol=coarse_mg_tol,
            coarse_mg_maxiter=coarse_mg_maxiter, coarse_prec_cycles=coarse_prec_cycles,
            coarse_prec_smooth=coarse_prec_smooth, coarse_mg_dense_limit=coarse_mg_dense_limit,
            direction_dtype=direction_dtype,
        )
        # a rank's rows are no plane window of the lattice: the level-0
        # operator goes through distribute, K1 and the summed segment sum
        self.lattice_stencil = None

    def _gather_tables(self, plan, k, device):
        """The rank's owner tables of level k and, beside them in
        ``_cross``, its cross-shard slots (``shard_tables``)."""
        gt, self._cross[k] = shard_tables(plan, k, self.n_shards, self.group.rank, device)
        return gt

    # -- overridden primitives ---------------------------------------------- #
    def _sum_partial(self, t):
        return self.group.sum(t)

    def _sharded_combine(self, x, k, mask=None):
        return sharded_combine(x, self.levels[k].gather, self._cross[k], self.group.sum,
                               mask=mask)

    def _combine(self, x, k):
        return self._sharded_combine(x, k)

    def _combine_constrained(self, x, k, Ls=None):
        return self._sharded_combine(x, k, mask=self._bmask(k, Ls))

    def _check_Ls(self, Ls):
        if Ls is not None:
            raise ValueError("the gather-sharded solver takes no per-call Ls=")
        return None

    def _check_interior(self, interior):
        if interior is not None:
            raise ValueError("the gather-sharded solver takes no per-call interior=")
        return None

    def cross_slots(self, k=None) -> int:
        """This rank's cross-shard slots at level k (default: finest)."""
        return self._cross[self.nlevels - 1 if k is None else k].n_slots

    def mixed_precision_setup(self, *args, **kwargs):
        """No mixed-precision form: the JAX package has none for this solver
        (only its slab-sharded solver has mixed-precision programs)."""
        raise NotImplementedError(NO_MIXED_PRECISION)

    mixed_precision_pcg = mixed_precision_setup

    def _mixed_pcg_programs(self, inner):
        """``solver/multigrid.py::mixed_precision_pcg`` on this solver: no
        such form (``mixed_precision_setup``)."""
        raise NotImplementedError(NO_MIXED_PRECISION)

    # -- public state helpers ----------------------------------------------- #
    def put(self, a):
        """This rank's rows of a global element-leading host array, on the
        solver's device in its dtype."""
        rows = np.ascontiguousarray(self.rows_of(np.asarray(a)), dtype=self._np_dtype)
        return torch.as_tensor(rows, device=self.device)
