"""Constraint and base-grid transfer ops (device, PyTorch + CUDA kernel K7).

Port of the parts of homogenization_jl_tpu/ops/interfaces.py that the
structured solver path uses: apply_mask, copy_to_base and distribute, plus
the coarse-solve plumbing of homogenization_jl_tpu/solver/multigrid.py that
shares their shape: ``_to_global`` (a presorted gather + sorted
segment_sum), the ``aux_correct`` transfers and the interior gathers of the
direct coarse solves. The general-mesh gather combine (combine_gather_rows)
is not ported yet.

Two primitives carry all of them, each a plain PyTorch form for CPU tensors
and kernel K7 (csrc/coarse_gather.cu) for CUDA tensors:

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


def apply_mask(x, mask):
    """Zero Dirichlet constraint / first-copy selection as a mask multiply.

    Reference: apply_constraint! (src/implicit_fine_grid.jl:94-139),
    zero_out_all_but_one! (:334-386).
    """
    return x * mask


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
