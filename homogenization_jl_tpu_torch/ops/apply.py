"""Matrix-free element apply (device, PyTorch) — the hot kernel.

Port of homogenization_jl_tpu/ops/apply.py. The reference matrices of one
level are densified and stacked ([P, n, n], fem/local_operators.py), the
per-element geometry coefficients are precomputed ([E, P]), and

    y[e, m] = sum_p coeff[e, p] * sum_n stack[p, m, n] * x[e, n]

The JAX package multiplies the dense stack only to feed the TPU's matrix
unit; the stack is almost empty (at n_local = 969 the union of the seven
slices holds 12.5 nonzeros per row, 1.3% of the dense product). On the card
the product runs over the nonzeros, as the Julia reference applies these
operators (per-element sparse products): ``stack_table`` lists them once per
stack (``StackTable``: for each row, the columns of the union of the P
slices' exact nonzeros and the P values of each, pieces interleaved), and
``element_apply`` launches the hand-written CUDA kernel K1
(csrc/element_apply.cu) over that table for CUDA tensors. A CUDA call must
pass the table: the wrapper never derives it from the stack, which would
read the stack back to the host on every call. CPU tensors run the plain
PyTorch version, which multiplies the dense stack (the JAX function's own
form). Both run full FP32 (or FP64) arithmetic; only the zeros are skipped,
so the two differ by the order of the sums.

The residual form b - A x is computed shifted, in both versions: with
s_e = x[e, 0], A x = A (x - s_e) + s_e * sum_p coeff[e, p] * rowsum_p, where
rowsum_p = S_p 1 (``stack_rowsum``). The algebra is exact. Near convergence
b - A x is a small difference of products of the size of S_p x, and the
rounding of their float32 sum set the floor of the solve's residual; the
shift shrinks the products to the variation of x inside an element.

An optional bool ``mask`` multiplies the result at the store (the mask
constraint after the apply): the kernel's output is the unmasked output
times the mask, bit for bit.

``element_apply_half`` takes an x stored narrower than the state
(``coeff``'s dtype): bfloat16 or float16, or float32 under a float64 state
— the smoothers' half-width direction vectors of ``direction_dtype``
(kernel K16, K1 on a narrower input, csrc/element_apply_half.cu). Its
result is K1's on ``x.to(state dtype)`` bit for bit, in the state dtype;
its plain form casts x up first.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..csrc.build import LAUNCHES, launch
from ..utils.logging import span

_DTYPES = {torch.float32: 0, torch.float64: 1}
# storage codes of a half-width operand (csrc/widen.cuh); which of them a
# state dtype takes: any type narrower than the state's
STORE_CODES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2, torch.float16: 3}
NARROWER = {
    torch.float32: (torch.bfloat16, torch.float16),
    torch.float64: (torch.float32, torch.bfloat16, torch.float16),
}
# the most pieces K1's table slots hold (3D: six conductivity pieces and the
# mass; csrc/element_apply.cuh)
_MAX_PIECES = 8


@dataclasses.dataclass(frozen=True)
class StackTable:
    """The nonzeros of a [P, n, n] stack, row by row (``stack_table``).

    ``cols`` (int32 [n, R]): row m's columns, ascending, of the union of
    the P slices' exact nonzeros; R is the widest row, and a narrower row's
    pad slots point at the row itself. ``vals`` ([n, R, PP], the stack's
    dtype): the P slices' values at each slot, pieces innermost so that one
    slot is one vector load; 0 in pad slots, in a slice's own zeros and in
    the pieces padded up to PP (1, 4 or a multiple of 8). ``counts`` (int32
    [n]): each row's slots before its pads (the kernels walk no pad slot).
    ``nnz``: the union's nonzeros; ``slice_nnz``: the sum of each slice's
    own (the multiply-adds of one element's product).

    ``slot_words`` and ``slot_values`` hold the same slots in K1's layout
    (``slot_layout``), which its kernel keeps in shared memory: the V
    distinct slot vectors, and per slot one word, its column and its
    vector's index, in groups of ITEM_ROWS rows (a warp item's rows side by
    side), each group's row counts after its R slots; both None for a stack
    whose rows or vectors the 16-bit words cannot index (K1 refuses it)."""

    cols: torch.Tensor
    vals: torch.Tensor
    counts: torch.Tensor
    pieces: int
    nnz: int
    slice_nnz: int
    slot_words: torch.Tensor | None
    slot_values: torch.Tensor | None

    def __post_init__(self):
        n, R = self.cols.shape if self.cols.dim() == 2 else (-1, -1)
        PP = _padded_pieces(self.pieces)
        _check("table cols", self.cols, torch.int32, self.vals.device, (n, R))
        _check("table vals", self.vals, self.vals.dtype, self.vals.device, (n, R, PP))
        _check("table counts", self.counts, torch.int32, self.vals.device, (n,))
        if self.slot_words is None and self.slot_values is None:
            return
        VW = slot_width(PP, self.vals.element_size())
        _check("table slot words", self.slot_words, torch.int32, self.vals.device,
               (-(-n // ITEM_ROWS) * (R + 1) + 2, ITEM_ROWS))
        V = self.slot_values.shape[1] if self.slot_values.dim() == 3 else -1
        _check("table slot values", self.slot_values, self.vals.dtype, self.vals.device,
               (PP // VW, V, VW))

    @property
    def n_values(self) -> int:
        """V, the slot vectors K1 holds (``slot_values``, padded)."""
        if self.slot_values is None:
            raise ValueError("element_apply: the stack's rows or slot vectors exceed K1's "
                             "16-bit slot words")
        return self.slot_values.shape[1]

    @property
    def width(self) -> int:
        return self.cols.shape[1]


def _padded_pieces(P: int) -> int:
    return 1 if P == 1 else (4 if P <= 4 else -(-P // 8) * 8)


# the rows of a warp item of K1 (csrc/element_apply.cuh: APPLY_ROWS)
ITEM_ROWS = 16


def slot_width(PP: int, itemsize: int) -> int:
    """The values of a slot vector that one 16-byte read of K1 takes: PP,
    at most 16 bytes of them."""
    return min(PP, 16 // itemsize)


def slot_layout(cols, vals, counts):
    """K1's layout of a row table (numpy cols [n, R], vals [n, R, PP],
    counts [n]): ``slot_words`` [ng * (R + 1) + 2, ITEM_ROWS] and
    ``slot_values`` [PP / VW, V, VW] (VW = ``slot_width``), or (None, None)
    past 0xFFFF rows or 0x7FFF vectors.

    Row m is row m % ITEM_ROWS of group m // ITEM_ROWS (ng = ceil(n /
    ITEM_ROWS) groups, a warp item's rows). Word row g * (R + 1) + k holds
    slot k of group g's rows side by side: a real slot's word is its column
    | its vector's index << 16, a pad's 0; word row g * (R + 1) + R holds
    the rows' counts (0 past n); two zero rows follow the last group (K1
    reads two slots ahead). ``slot_values`` are the distinct vectors of the
    real slots, ascending, padded with zero vectors to whole 16-byte
    units."""
    n, R, PP = vals.shape
    VW = slot_width(PP, vals.itemsize)
    real = np.arange(R)[None, :] < counts[:, None]
    flat = np.ascontiguousarray(vals[real])
    uniq, index = np.unique(flat.view(np.dtype((np.void, flat.itemsize * PP))).ravel(),
                            return_inverse=True)
    V = len(uniq)
    unit = max(1, 16 // (PP * vals.itemsize))
    Vp = max(-(-V // unit) * unit, unit)
    if n > 0xFFFF or Vp > 0x7FFF:
        return None, None
    values = np.zeros((Vp, PP), dtype=vals.dtype)
    values[:V] = uniq.view(vals.dtype).reshape(V, PP)
    words = np.zeros((-(-n // ITEM_ROWS) * ITEM_ROWS, R + 1), dtype=np.int64)
    words[:n, :R][real] = cols[real].astype(np.int64) | (index.reshape(-1).astype(np.int64) << 16)
    words[:n, R] = counts
    words = words.reshape(-1, ITEM_ROWS, R + 1).transpose(0, 2, 1).reshape(-1, ITEM_ROWS)
    words = np.concatenate([words, np.zeros((2, ITEM_ROWS), dtype=np.int64)]).astype(np.int32)
    values = values.reshape(Vp, PP // VW, VW).transpose(1, 0, 2)
    return np.ascontiguousarray(words), np.ascontiguousarray(values)


def stack_table(stack) -> StackTable:
    """The ``StackTable`` of a [P, n, n] stack, on the stack's device and in
    its dtype. Built once per stack, on the host (it reads the stack back):
    build it where the stack is held, from the tensor that is applied (the
    solver's levels hold the interface-layout permutation of the reference
    stack), never per call."""
    if not isinstance(stack, torch.Tensor) or stack.dim() != 3:
        raise ValueError("stack_table: expected a [P, n, n] tensor")
    P, n, _ = stack.shape
    S = stack.detach().cpu().numpy()
    nz = S != 0
    union = nz.any(axis=0)
    counts = union.sum(axis=1)
    R = max(int(counts.max()) if n else 0, 1)
    # each row's nonzero columns first, ascending (stable sort on "is zero")
    order = np.argsort(~union, axis=1, kind="stable")[:, :R]
    rows = np.arange(n)[:, None]
    pad = np.arange(R)[None, :] >= counts[:, None]
    cols = np.where(pad, rows, order).astype(np.int32)
    vals = np.zeros((n, R, _padded_pieces(P)), dtype=S.dtype)
    vals[:, :, :P] = np.where(pad[..., None], 0, S[:, rows, cols].transpose(1, 2, 0))
    dev = stack.device
    words, values = slot_layout(cols, vals, counts)
    return StackTable(
        cols=torch.as_tensor(cols, device=dev), vals=torch.as_tensor(vals, device=dev),
        counts=torch.as_tensor(counts.astype(np.int32), device=dev),
        pieces=P, nnz=int(union.sum()), slice_nnz=int(nz.sum()),
        slot_words=None if words is None else torch.as_tensor(words, device=dev),
        slot_values=None if values is None else torch.as_tensor(values, device=dev))


def stack_rowsum(stack):
    """[P, n] row sums S_p 1 of a [P, n, n] stack, summed in float64 and
    stored at the stack's dtype (the residual form's shift correction)."""
    return stack.to(torch.float64).sum(dim=2).to(stack.dtype)


def element_apply_plain(x, coeff, stack, b=None, rowsum=None):
    """Plain PyTorch form: accumulate the P pieces in order (the JAX
    package's "unroll" form). With ``b``, returns b - A x, shifted as the
    kernel does (module docstring; ``rowsum`` defaults to
    ``stack_rowsum(stack)``)."""
    s = None
    if b is not None:
        s = x[:, :1]
        x = x - s
    y = torch.zeros_like(x)
    for p in range(stack.shape[0]):
        y = y + coeff[:, p : p + 1] * torch.matmul(x, stack[p].T)
    if b is None:
        return y
    rs = stack_rowsum(stack) if rowsum is None else rowsum
    t = torch.zeros_like(y[:1])
    for p in range(stack.shape[0]):
        t = t + coeff[:, p : p + 1] * rs[p]
    return b - (y + s * t)


def _check(name, t, dtype, device, shape=None):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.device != device:
        raise ValueError(f"{name}: device {t.device}, expected {device}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def element_apply(x, coeff, stack, b=None, out=None, rowsum=None, mask=None, table=None):
    """y[e] = sum_p coeff[e, p] * (stack[p] @ x[e]); with ``b``, b - y
    (shifted, module docstring); with ``mask`` (bool [E, n]), that result
    times the mask.

    x: [E, n], coeff: [E, P], stack: [P, n, n] (symmetric slices), b: [E, n]
    or None; float32 or float64, all on one device and contiguous.
    ``table`` is ``stack_table(stack)``, on the stack's device: CUDA calls
    need it (kernel K1 runs over it), CPU calls ignore it.
    ``rowsum`` ([P, n], read with ``b`` only) is ``stack_rowsum(stack)``,
    which callers that apply one stack often pass precomputed.
    ``out`` receives the result and may be ``b`` itself (the in-place
    residual update r -= A p); it must not be ``x``.
    """
    if x.dtype not in _DTYPES:
        raise TypeError(f"element_apply: unsupported dtype {x.dtype}")
    with span("hz.op.element_apply"):
        return _apply(x, coeff, stack, b, out, rowsum, mask, table, x.dtype)


def element_apply_half(x, coeff, stack, b=None, out=None, rowsum=None, mask=None, table=None):
    """``element_apply`` on an x stored narrower than the state dtype
    (coeff's; ``NARROWER``): kernel K16 for CUDA tensors, the result K1's
    on ``x.to(coeff.dtype)`` bit for bit and in coeff's dtype; the plain
    form casts x up first (module docstring)."""
    dt = getattr(coeff, "dtype", None)
    if dt not in _DTYPES or x.dtype not in NARROWER[dt]:
        raise TypeError(f"element_apply_half: x dtype {x.dtype} under a {dt} state")
    with span("hz.op.element_apply"):
        return _apply(x, coeff, stack, b, out, rowsum, mask, table, dt)


def check_table(name, table, n, P, dtype, device):
    """Raise unless ``table`` is a ``StackTable`` of P pieces over n rows in
    ``dtype`` on ``device`` that the kernels take (at most _MAX_PIECES
    pieces; its own layout is checked when it is built). Reads no tensor
    back: the table must be the stack's own."""
    if not isinstance(table, StackTable):
        raise ValueError(f"{name}: a CUDA call needs the stack's table (ops/apply.py::stack_table)")
    if table.cols.shape[0] != n or table.pieces != P:
        raise ValueError(f"{name}: table of {table.pieces} pieces over {table.cols.shape[0]} "
                         f"rows, stack of {P} over {n}")
    if table.vals.dtype != dtype or table.vals.device != device:
        raise TypeError(f"{name}: table in {table.vals.dtype} on {table.vals.device}, "
                        f"expected {dtype} on {device}")
    if table.vals.shape[2] > _MAX_PIECES:
        raise ValueError(f"{name}: the kernel takes at most {_MAX_PIECES} pieces")


def _apply(x, coeff, stack, b, out, rowsum, mask, table, dt):
    """The checks and the route of both wrappers; ``dt`` is the state
    dtype (x's, or narrower for ``element_apply_half``)."""
    if x.dim() != 2 or stack.dim() != 3 or coeff.dim() != 2:
        raise ValueError("element_apply: expected x [E, n], coeff [E, P], stack [P, n, n]")
    E, n = x.shape
    P = stack.shape[0]
    dev = x.device
    half = x.dtype != dt
    _check("x", x, x.dtype, dev)
    _check("coeff", coeff, dt, dev, (E, P))
    _check("stack", stack, dt, dev, (P, n, n))
    if b is not None:
        _check("b", b, dt, dev, (E, n))
        if P > _MAX_PIECES:
            raise ValueError(f"element_apply: the residual form takes at most {_MAX_PIECES} pieces")
        if rowsum is None:
            rowsum = stack_rowsum(stack)
        _check("rowsum", rowsum, dt, dev, (P, n))
    if out is not None:
        _check("out", out, dt, dev, (E, n))
        if out.data_ptr() == x.data_ptr():
            raise ValueError("element_apply: out must not alias x")
    if mask is not None:
        _check("mask", mask, torch.bool, dev, (E, n))
    if dev.type == "cpu":
        y = element_apply_plain(x.to(dt) if half else x, coeff, stack, b, rowsum)
        if mask is not None:
            y = y * mask
        return y if out is None else out.copy_(y)
    if dev.type != "cuda":
        raise ValueError(f"element_apply: unsupported device {dev}")
    check_table("element_apply", table, n, P, dt, dev)
    V = table.n_values  # raises where K1 cannot index the stack
    if out is None:
        out = torch.empty((E, n), dtype=dt, device=dev)
    tail = (coeff.data_ptr(), table.slot_words.data_ptr(), table.slot_values.data_ptr(),
            table.width, table.vals.shape[2], V,
            None if b is None else b.data_ptr(),
            None if b is None else rowsum.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(), E, n, P)
    if half:
        LAUNCHES["direction_apply"] += 1
        launch("hz_element_apply_half", _DTYPES[dt], STORE_CODES[x.dtype], x.data_ptr(), *tail)
    else:
        LAUNCHES["element_apply"] += 1
        launch("hz_element_apply", _DTYPES[dt], x.data_ptr(), *tail)
    return out


def mass_apply(x, mass):
    """y[e] = Mhat @ x[e] with the symmetric reference mass matrix [n, n]
    (plain PyTorch; not on the solver's path)."""
    return torch.matmul(x, mass.T)
