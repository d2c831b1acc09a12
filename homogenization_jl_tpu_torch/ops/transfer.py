"""Grid transfer: prolongation / restriction (device, PyTorch + CUDA kernel K4).

Port of homogenization_jl_tpu/ops/transfer.py. The per-level prolongation
P_k is [n_{k+1}, n_k] (identity prefix + half/half midpoint rows, see
mesh/reference.py). The JAX package applies it as dense einsums batched
over base elements; the plain forms here (``prolong_add_plain``,
``restrict_plain``) are the same dense matrix products.

Kernel K4 (csrc/transfer.cu, CUDA C++) runs for CUDA tensors in gather
form: ``build_transfer_tables`` lists, on the host, each fine row's at most
two (column, weight) pairs and P^T in CSR form (each coarse column's fine
rows, ascending); a block stages its elements' input rows in shared memory
and each thread gathers one output from them. The tables live beside P in
``TransferTables``; the solver builds them at setup and again when its
prolongations are replaced (``MultigridSolver.drop_caches``).

Float32 matmuls on CUDA must not round through TF32 (about three decimal
digits): the flag below is PyTorch's default, set here explicitly because
the plain forms, which chip_smoke.py holds the kernel against, depend on it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..csrc.build import LAUNCHES, launch

torch.backends.cuda.matmul.allow_tf32 = False

_DTYPES = {torch.float32: 0, torch.float64: 1}
_THREADS = 256
_SMEM_BYTES = 32 * 1024  # staged input rows per block


@dataclasses.dataclass
class TransferTables:
    """P [n_f, n_c] and its gather tables, on one device and dtype."""

    P: torch.Tensor  # [n_f, n_c], the plain forms' operand
    cols: torch.Tensor  # [n_f, 2] int32: a fine row's columns, -1 unused
    wts: torch.Tensor  # [n_f, 2] their weights
    colptr: torch.Tensor  # [n_c + 1] int32: P^T in CSR form
    rows: torch.Tensor  # [nnz] int32, ascending within each column
    rwts: torch.Tensor  # [nnz] their weights


def build_transfer_tables(P) -> TransferTables:
    """K4's tables from a prolongation tensor P [n_f, n_c], on P's device
    and dtype. Raises if a fine row has more than two nonzeros."""
    Pn = P.detach().cpu().numpy()
    n_f, n_c = Pn.shape
    nz = Pn != 0
    per_row = nz.sum(axis=1)
    if per_row.max(initial=0) > 2:
        raise ValueError(
            f"prolongation has a fine row with {int(per_row.max())} nonzeros; "
            "the gather transfer takes at most 2"
        )
    cols = np.full((n_f, 2), -1, dtype=np.int32)
    wts = np.zeros((n_f, 2), dtype=Pn.dtype)
    for f in range(n_f):
        c = np.flatnonzero(nz[f])
        cols[f, : len(c)] = c
        wts[f, : len(c)] = Pn[f, c]
    colptr = np.zeros(n_c + 1, dtype=np.int32)
    colptr[1:] = np.cumsum(nz.sum(axis=0))
    rows = np.concatenate([np.flatnonzero(nz[:, c]) for c in range(n_c)]).astype(np.int32)
    rwts = np.concatenate([Pn[np.flatnonzero(nz[:, c]), c] for c in range(n_c)]).astype(Pn.dtype)

    def dev(a, dt=None):
        return torch.as_tensor(a, device=P.device, dtype=dt)

    return TransferTables(
        P=P, cols=dev(cols), wts=dev(wts, P.dtype), colptr=dev(colptr), rows=dev(rows),
        rwts=dev(rwts, P.dtype),
    )


def prolong_add_plain(x_fine, x_coarse, P):
    """x_fine + x_coarse @ P^T (x_fine None: x_coarse @ P^T)."""
    y = torch.matmul(x_coarse, P.T)
    return y if x_fine is None else x_fine + y


def restrict_plain(r_fine, P):
    """P^T r, batched: [E, n_f] @ [n_f, n_c]."""
    return torch.matmul(r_fine, P)


def _group(n_in: int, n_out: int, itemsize: int) -> int:
    """Elements per block: enough outputs for a few rounds of threads,
    within the shared memory of the staged input rows."""
    want = -(-4 * _THREADS // n_out)
    return max(1, min(want, _SMEM_BYTES // (n_in * itemsize)))


def _check(name, t, dtype, device, shape):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"transfer: {name} must be a tensor")
    if t.dtype != dtype:
        raise TypeError(f"transfer: {name} dtype {t.dtype}, expected {dtype}")
    if t.device != device or tuple(t.shape) != tuple(shape):
        raise ValueError(f"transfer: {name} shape {tuple(t.shape)} on {t.device}, expected "
                         f"{tuple(shape)} on {device}")
    if not t.is_contiguous():
        raise ValueError(f"transfer: {name} must be contiguous")


def prolong_add(x_fine, x_coarse, T: TransferTables, out=None):
    """x_fine + x_coarse @ P^T (reference: xk += P x_{k-1}); x_fine None
    prolongs alone. x_fine, out: [E, n_f]; x_coarse: [E, n_c]; the tables'
    dtype and device. ``out`` may be ``x_fine`` (in place). Kernel K4 for
    CUDA tensors, the plain form for CPU tensors."""
    n_f, n_c = T.P.shape
    if x_coarse.dtype not in _DTYPES:
        raise TypeError(f"prolong_add: unsupported dtype {x_coarse.dtype}")
    dt, dev = T.P.dtype, T.P.device
    E = x_coarse.shape[0]
    _check("x_coarse", x_coarse, dt, dev, (E, n_c))
    if x_fine is not None:
        _check("x_fine", x_fine, dt, dev, (E, n_f))
    if out is not None:
        _check("out", out, dt, dev, (E, n_f))
    if dev.type == "cpu":
        y = prolong_add_plain(x_fine, x_coarse, T.P)
        return y if out is None else out.copy_(y)
    if dev.type != "cuda":
        raise ValueError(f"prolong_add: unsupported device {dev}")
    if out is None:
        out = torch.empty((E, n_f), dtype=dt, device=dev)
    G = _group(n_c, n_f, T.P.element_size())
    LAUNCHES["transfer"] += 1
    launch(
        "hz_prolong_add", _DTYPES[dt], None if x_fine is None else x_fine.data_ptr(),
        x_coarse.data_ptr(), out.data_ptr(), T.cols.data_ptr(), T.wts.data_ptr(),
        E, n_f, n_c, G,
    )
    return out


def restrict(r_fine, T: TransferTables):
    """P^T r, batched: [E, n_f] -> [E, n_c] (reference: b_{k-1} = P' r_k).
    Kernel K4 for CUDA tensors, the plain form for CPU tensors."""
    n_f, n_c = T.P.shape
    if r_fine.dtype not in _DTYPES:
        raise TypeError(f"restrict: unsupported dtype {r_fine.dtype}")
    dt, dev = T.P.dtype, T.P.device
    E = r_fine.shape[0]
    _check("r_fine", r_fine, dt, dev, (E, n_f))
    if dev.type == "cpu":
        return restrict_plain(r_fine, T.P)
    if dev.type != "cuda":
        raise ValueError(f"restrict: unsupported device {dev}")
    out = torch.empty((E, n_c), dtype=dt, device=dev)
    G = _group(n_f, n_c, T.P.element_size())
    LAUNCHES["transfer"] += 1
    launch(
        "hz_restrict", _DTYPES[dt], r_fine.data_ptr(), out.data_ptr(), T.colptr.data_ptr(),
        T.rows.data_ptr(), T.rwts.data_ptr(), E, n_f, n_c, G,
    )
    return out
