"""Interface combine, constraint and base-grid transfer ops (device,
PyTorch + CUDA kernels K7, K8 and K18).

Port of homogenization_jl_tpu/ops/interfaces.py: apply_mask (kernel K18's
mask entry, ops/elementwise.py), copy_to_base,
distribute and the general-mesh gather combine ``combine_gather_rows``
(kernel K8, csrc/gather_combine.cu; see ``GatherTables``), plus the
coarse-solve plumbing of homogenization_jl_tpu/solver/multigrid.py that
shares their shape: ``_to_global`` (a presorted gather + sorted
segment_sum), the ``aux_correct`` transfers and the interior gathers of the
direct coarse solves. The flat ``combine_interfaces`` form is not ported:
the JAX package keeps it as its counting oracle.

Two primitives carry the transfers, each a plain PyTorch form for CPU
tensors and kernel K7 (csrc/coarse_gather.cu) for CUDA tensors:

  * ``segment_sum``: out[s] = sum of vals[perm[j]] over the contiguous run
    j in [start[s], start[s+1]) of the presorted order, summed left to right
    from +0. One thread per segment and no atomics, so the result does not
    depend on the launch (the JAX ``.at[].add`` scatter and torch's
    ``index_add_`` on CUDA both leave the order to the hardware). The plain
    form sums the same values in the same order, column by column over a
    zero-padded [n_seg, max_len] table, and so gives the same bits.
  * ``gather_scale``: out[i] = src[idx[i]] * mask[i], the mask optional and
    bool (a multiply, as the JAX expressions ``r[node_map] * mask`` are).

Index tables are int32 when they fit (int64 otherwise) and are built once
on the host; the kernels take either type, and nothing is cast per call.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..csrc.build import LAUNCHES, launch
from .elementwise import route, run

_DTYPES = {torch.float32: 0, torch.float64: 1}
_ITYPES = {torch.int32: 0, torch.int64: 1}


def index_tensor(a, device="cpu"):
    """Host index array -> int32 tensor when it fits, else int64."""
    a = np.asarray(a)
    if a.size == 0 or (a.max() < 2**31 and a.min() >= -(2**31)):
        a = a.astype(np.int32)
    else:
        a = a.astype(np.int64)
    return torch.as_tensor(np.ascontiguousarray(a), device=device)


@dataclasses.dataclass
class SegmentTables:
    """Presorted segment-sum tables of a flat key array (host-built).

    perm: [S] stable argsort of the keys; start: [n_seg + 1] CSR starts of
    each key's run in that order (kernel K7). pad_idx/pad_valid: [n_seg,
    max_len] the same runs laid out row by row, zero-padded at the end (the
    plain form)."""

    n_seg: int
    perm: torch.Tensor
    start: torch.Tensor
    pad_idx: torch.Tensor
    pad_valid: torch.Tensor


def build_segment_tables(keys, n_seg: int, device="cpu") -> SegmentTables:
    """Tables summing a flat value array by ``keys`` (e.g. the base mesh's
    element rows: local contributions onto global nodes), in the stable
    presorted order of ``_asm_perm``/``_asm_node`` (multigrid.py:315-318)."""
    keys = np.asarray(keys).reshape(-1)
    perm = np.argsort(keys, kind="stable")
    sk = keys[perm]
    counts = np.bincount(sk, minlength=n_seg)
    if counts.size != n_seg:
        raise ValueError(f"keys reach {counts.size - 1}, n_seg is {n_seg}")
    start = np.concatenate([[0], np.cumsum(counts)])
    width = max(int(counts.max()) if counts.size else 0, 1)
    pos = np.arange(sk.size) - start[sk]
    pad_idx = np.zeros((n_seg, width), np.int64)
    pad_valid = np.zeros((n_seg, width), bool)
    pad_idx[sk, pos] = perm
    pad_valid[sk, pos] = True
    return SegmentTables(
        n_seg=int(n_seg),
        perm=index_tensor(perm, device),
        start=index_tensor(start, device),
        pad_idx=torch.as_tensor(pad_idx, device=device),
        pad_valid=torch.as_tensor(pad_valid, device=device),
    )


def segment_sum_plain(vals, tab: SegmentTables):
    """Plain form: each segment's values summed left to right from +0 in
    the presorted order (padding zeros add nothing)."""
    v = vals.reshape(-1)[tab.pad_idx]
    v = torch.where(tab.pad_valid, v, torch.zeros((), dtype=v.dtype, device=v.device))
    acc = torch.zeros(tab.n_seg, dtype=vals.dtype, device=vals.device)
    for j in range(v.shape[1]):
        acc = acc + v[:, j]
    return acc


def _check_values(name, t):
    if t.dtype not in _DTYPES:
        raise TypeError(f"{name}: unsupported dtype {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_index(name, t, device):
    if t.dtype not in _ITYPES:
        raise TypeError(f"{name}: index dtype {t.dtype}, expected int32 or int64")
    if t.device != device:
        raise ValueError(f"{name}: device {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def segment_sum(vals, tab: SegmentTables):
    """out[s] = sum over segment s of vals.flat[perm[j]] in presorted order;
    vals: any shape with perm.numel() elements. Kernel K7 for CUDA tensors,
    the plain form for CPU tensors."""
    _check_values("segment_sum: vals", vals)
    if vals.numel() != tab.perm.numel():
        raise ValueError(f"segment_sum: {vals.numel()} values, tables for {tab.perm.numel()}")
    dev = vals.device
    for name, t in (("perm", tab.perm), ("start", tab.start)):
        _check_index(f"segment_sum: {name}", t, dev)
    if tab.perm.dtype != tab.start.dtype:
        raise TypeError("segment_sum: perm and start must share one index dtype")
    if dev.type == "cpu":
        return segment_sum_plain(vals, tab)
    if dev.type != "cuda":
        raise ValueError(f"segment_sum: unsupported device {dev}")
    out = torch.empty(tab.n_seg, dtype=vals.dtype, device=dev)
    LAUNCHES["coarse_gather"] += 1
    launch(
        "hz_segment_sum", _DTYPES[vals.dtype], _ITYPES[tab.perm.dtype],
        vals.data_ptr(), tab.perm.data_ptr(), tab.start.data_ptr(),
        out.data_ptr(), tab.n_seg,
    )
    return out


def gather_scale_plain(src, idx, mask=None):
    """Plain form: src.flat[idx] (* mask)."""
    out = src.reshape(-1)[idx]
    return out if mask is None else out * mask


def gather_scale(src, idx, mask=None):
    """out[i] = src.flat[idx[i]] * mask[i] (mask optional, bool, idx's
    shape); out has idx's shape. Kernel K7 for CUDA tensors, the plain form
    for CPU tensors. Indices must lie in [0, src.numel()): the tables are
    built on the host and checked there."""
    _check_values("gather_scale: src", src)
    dev = src.device
    _check_index("gather_scale: idx", idx, dev)
    if mask is not None:
        if mask.dtype != torch.bool or mask.shape != idx.shape or mask.device != dev:
            raise ValueError("gather_scale: mask must be a bool tensor shaped like idx")
        if not mask.is_contiguous():
            raise ValueError("gather_scale: mask must be contiguous")
    if dev.type == "cpu":
        return gather_scale_plain(src, idx, mask)
    if dev.type != "cuda":
        raise ValueError(f"gather_scale: unsupported device {dev}")
    out = torch.empty(idx.shape, dtype=src.dtype, device=dev)
    LAUNCHES["coarse_gather"] += 1
    launch(
        "hz_gather_scale", _DTYPES[src.dtype], _ITYPES[idx.dtype],
        src.data_ptr(), idx.data_ptr(), None if mask is None else mask.data_ptr(),
        out.data_ptr(), idx.numel(),
    )
    return out


def apply_mask(x, mask, out=None):
    """Zero Dirichlet constraint / first-copy selection as a mask multiply,
    x * mask with a bool ``mask`` of x's shape; ``out`` may be ``x``. Kernel
    K18 (ops/elementwise.py) for CUDA tensors, the plain product for CPU
    tensors; both give x * 1 or x * 0.

    Reference: apply_constraint! (src/implicit_fine_grid.jl:94-139),
    zero_out_all_but_one! (:334-386).
    """
    kern = route("apply_mask", x, [("out", out)] if out is not None else [])
    if (not isinstance(mask, torch.Tensor) or mask.dtype != torch.bool
            or mask.shape != x.shape or mask.device != x.device or not mask.is_contiguous()):
        raise ValueError("apply_mask: mask must be a contiguous bool tensor shaped like x")
    if not kern:
        y = x * mask
        return y if out is None else out.copy_(y)
    out = torch.empty_like(x) if out is None else out
    run("hz_ew_mask", x.dtype, x.data_ptr(), mask.data_ptr(), out.data_ptr(), x.numel())
    return out


def copy_to_base(b, asm: SegmentTables):
    """Accumulate the duplicated-layout rhs onto global base-mesh nodes.

    Equivalent to broadcast_interfaces! followed by taking the first copy
    (reference: vcycle! coarsest branch, src/multigrid.jl:75-81): summing all
    copies directly gives the same vector by linearity.
    b: [E, N] -> [n_base_nodes]; ``asm`` = build_segment_tables(elements,
    n_base_nodes). A deterministic segment sum (the JAX form scatter-adds).
    """
    return segment_sum(b, asm)


def distribute(u, base_elements):
    """Scatter a global base-node vector to the duplicated layout
    (reference: distribute!, src/implicit_fine_grid.jl:178-202);
    ``base_elements`` is an int32/int64 index tensor [E, n]."""
    return gather_scale(u, base_elements)


# --------------------------------------------------------------------- #
# gather-form interface combine (kernel K8)
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class GatherClass:
    """One interface class (faces, edges or corners) of a level: the columns
    [c0, c0 + L*W) of every element row, L cells of W DOFs, and G groups of
    at most M owners. Kernel K8 reads ``own`` [G, M]: each owner's cell as
    its offset in the flat x (element * n_local + c0 + local cell * W), -1
    for a padding slot (int32, or int64 when the offsets reach 2^31). The
    plain form reads om [G, M] (bool: a real owner), gmap [E, L] (int32:
    the group of each element's cell) and flat [G, M] (int64) = element * L
    + local cell, the owner rows of the [E*L, W] view."""

    c0: int
    L: int
    W: int
    own: torch.Tensor
    om: torch.Tensor
    gmap: torch.Tensor
    flat: torch.Tensor


@dataclasses.dataclass(frozen=True)
class GatherTables:
    """A level's gather combine: the classes in layout order (faces, edges,
    corners), tiling the columns [i0, n_local); the head columns pass
    through."""

    n_local: int
    i0: int
    classes: tuple

    def descriptor(self) -> np.ndarray:
        """The kernel's host record: 4 int64 per class (W, M, G, then the
        device address of ``own``)."""
        rows = [[c.W, c.own.shape[1], c.own.shape[0], c.own.data_ptr()] for c in self.classes]
        return np.ascontiguousarray(np.asarray(rows, dtype=np.int64))


def _owner_offsets(oe, ol, om, gmap, n_local: int, c0: int, W: int) -> np.ndarray:
    """K8's owner table of one class: the flat offset of each valid owner's
    cell, -1 in the padding slots. Raises ValueError unless every cell
    (e, l) of gmap's rows is a valid owner of exactly one group, and of the
    group gmap[e, l]: then storing each group's sum to its owners writes
    every output entry of the class once, which the kernel relies on."""
    E, L = gmap.shape
    valid = om != 0
    g_of, _ = np.nonzero(valid)
    e_of, l_of = oe[valid].astype(np.int64), ol[valid].astype(np.int64)
    if np.any((e_of < 0) | (e_of >= E) | (l_of < 0) | (l_of >= L)):
        raise ValueError("gather tables: an owner lies outside the element rows or cells")
    cell = e_of * L + l_of
    if cell.size != E * L or np.bincount(cell, minlength=E * L).max(initial=0) != 1:
        raise ValueError("gather tables: a cell is not the owner of exactly one group")
    if not np.array_equal(gmap.reshape(-1)[cell], g_of):
        raise ValueError("gather tables: a cell is an owner of another group than its gmap's")
    return np.where(valid, oe.astype(np.int64) * n_local + c0 + ol.astype(np.int64) * W, -1)


def build_gather_tables(plan, k: int, device="cpu", owners=None) -> GatherTables:
    """The gather-combine tables of level k of ``plan`` on ``device``, from
    its owner tables (ops/plan.py) and contiguous interface layout. Every
    class span must be contiguous (each cell's W columns right after the
    previous cell's), and the spans must tile [i0, n_local) in the order
    faces, edges, corners, as the JAX form's concatenation assumes; every
    cell of every row must be a valid owner of exactly its group (raises
    ValueError otherwise). ``owners`` ({"face"/"edge"/"corner": (oe, ol,
    om, gmap)}) replaces the plan's owner tables: one shard's, for the
    gather-sharded solver, whose owner lists keep the shard's own rows."""
    lay = plan.reference.layout[k]
    if lay is None:
        raise ValueError("the gather combine needs the contiguous interface layout")
    gt = plan.levels[k].gather
    if owners is None:
        owners = dict(face=gt.face, edge=gt.edge, corner=gt.corner)
    n_local = plan.n_local(k)
    i0 = int(min(list(lay.face_offsets) + list(lay.edge_offsets) + list(lay.corner_cols)))
    spans = []
    cursor = i0
    for tables, offsets, width in (
        (owners.get("face"), lay.face_offsets, lay.npf),
        (owners.get("edge"), lay.edge_offsets, lay.npe),
        (owners.get("corner"), lay.corner_cols, 1),
    ):
        if tables is None or width == 0 or len(offsets) == 0:
            continue
        oe, ol, om, gmap = (np.asarray(a) for a in tables)
        L = len(offsets)
        c0 = int(min(offsets))
        if any(int(offsets[l]) != c0 + l * width for l in range(L)):
            raise ValueError("interface layout not contiguous per class")
        if c0 != cursor:
            raise ValueError(f"class span starts at column {c0}, expected {cursor}")
        cursor = c0 + L * width
        spans.append((c0, L, int(width), oe, ol, om, gmap,
                      _owner_offsets(oe, ol, om, gmap, n_local, c0, int(width))))
    if cursor != n_local:
        raise ValueError(f"class spans end at column {cursor}, n_local is {n_local}")
    # 32-bit offsets when the state's entries, and each class's threads (one
    # per group and column, plus a block past the last), count below 2^31
    E = spans[0][6].shape[0] if spans else 0  # gmap's rows
    reach = max([E * n_local] + [own.shape[0] * W + 256 for _, _, W, _, _, _, _, own in spans])
    itype = np.int32 if reach < 2**31 else np.int64
    classes = tuple(
        GatherClass(
            c0=c0, L=L, W=W,
            own=torch.as_tensor(np.ascontiguousarray(own.astype(itype)), device=device),
            om=torch.as_tensor(om != 0, device=device),
            gmap=torch.as_tensor(np.ascontiguousarray(gmap.astype(np.int32)), device=device),
            flat=torch.as_tensor(oe.astype(np.int64) * L + ol.astype(np.int64), device=device),
        )
        for c0, L, W, oe, ol, om, gmap, own in spans
    )
    return GatherTables(n_local=n_local, i0=i0, classes=classes)


def combine_gather_rows_plain(x, gt: GatherTables, mask=None):
    """Plain form of ``combine_gather_rows``: per class, the owner rows
    gathered from the [E*L, W] view, each group's valid owners added in
    table order from +0, and the sums gathered back per (element, cell).
    Kernel K8 adds the same values in the same order, so the two agree bit
    for bit."""
    E = x.shape[0]
    parts = [x[:, : gt.i0]]
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    for c in gt.classes:
        xr = x[:, c.c0 : c.c0 + c.L * c.W].reshape(E * c.L, c.W)
        rows = xr[c.flat]  # [G, M, W]
        acc = torch.zeros((rows.shape[0], c.W), dtype=x.dtype, device=x.device)
        for m in range(rows.shape[1]):
            acc = acc + torch.where(c.om[:, m, None], rows[:, m], zero)
        parts.append(acc[c.gmap].reshape(E, c.L * c.W))
    out = torch.cat(parts, dim=1)
    return out if mask is None else out * mask


def combine_gather_rows(x, gt: GatherTables, mask=None):
    """Interface combine of x [E, n_local] on any base mesh with the
    contiguous layout (reference: broadcast_interfaces!,
    src/implicit_fine_grid.jl:209-328): every copy of a shared face/edge/
    corner DOF gets the sum of all copies. ``mask`` (bool, x's shape)
    multiplies the result: the mask constraint after the combine
    (``apply_mask(combine(x), mask)``), in the same pass. Kernel K8 for
    CUDA tensors, the plain form for CPU tensors."""
    _check_values("combine_gather_rows: x", x)
    if x.dim() != 2 or x.shape[1] != gt.n_local:
        raise ValueError(f"combine_gather_rows: x shape {tuple(x.shape)}, n_local {gt.n_local}")
    dev = x.device
    for c in gt.classes:
        if c.gmap.shape[0] != x.shape[0] or c.gmap.device != dev or c.own.device != dev:
            raise ValueError("combine_gather_rows: tables do not match x (rows or device)")
    if mask is not None:
        if mask.dtype != torch.bool or mask.shape != x.shape or mask.device != dev:
            raise ValueError("combine_gather_rows: mask must be a bool tensor shaped like x")
        if not mask.is_contiguous():
            raise ValueError("combine_gather_rows: mask must be contiguous")
    if dev.type == "cpu":
        return combine_gather_rows_plain(x, gt, mask)
    if dev.type != "cuda":
        raise ValueError(f"combine_gather_rows: unsupported device {dev}")
    out = torch.empty_like(x)
    desc = gt.descriptor()
    LAUNCHES["gather_combine"] += 1
    launch(
        "hz_gather_combine", _DTYPES[x.dtype], _ITYPES[gt.classes[0].own.dtype], x.data_ptr(),
        out.data_ptr(),
        None if mask is None else mask.data_ptr(), x.shape[0], gt.n_local, gt.i0,
        len(gt.classes), desc.ctypes.data,
    )
    return out
