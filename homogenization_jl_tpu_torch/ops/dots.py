"""The solver's dots, mask and scale fused (device, PyTorch + CUDA kernel K5).

Replaces the ``jnp.vdot`` calls of homogenization_jl_tpu/solver/multigrid.py:
``_vdot`` (:510), ``_pcg_rnorm`` (:1177), ``residual_norm`` (:1484), the
first-copy dots of ``_smooth_cg_exact`` (``vdot(rc * w, rc)``, :821, :838)
and the Lanczos ``ddot`` (``vdot(a * w, d * b)``, :600). One function,

    dot(a, b, mask=None, scale=None) = sum_i (a_i * [mask_i]) * (scale_i * b_i),

so no caller writes the masked or scaled temporary.

Kernel K5 (csrc/dots.cu) runs for CUDA tensors, in one launch, in the
port's fixed order (csrc/fixed_sum.cuh; ``fixed_order_sum`` below): it
depends on the length alone, so two launches give the same bits, which the
solver's stopping tests and the CG smoothers' alpha and beta rely on. The
plain form (CPU tensors) takes the same steps in the same order, so the CPU
tests hold the kernel's order too; on the card the two agree bit for bit.
K9's element sums (ops/integrals.py) and K14a's dots (ops/recurrence.py)
sum in this order as well. A launch needs the scratch of its stream
(``sum_scratch``): the block sums and the ticket of the last block.

``dot_half(a, b, ...)`` takes an ``a`` stored narrower than the state (b's
dtype; ops/apply.py::NARROWER): the half-width direction of
``_smooth_cg_exact``'s ``vdot(load(p), A p)`` (kernel K16, K5 widening a
on load, csrc/dots.cu). It is ``dot(a.to(b.dtype), b, ...)`` bit for bit;
its plain form casts a up first.
"""

from __future__ import annotations

import numpy as np
import torch

from ..csrc.build import LAUNCHES, current_stream, launch
from .apply import NARROWER, STORE_CODES

_DTYPES = {torch.float32: 0, torch.float64: 1}
# the fixed order's grid and scratch (csrc/fixed_sum.cuh)
SUM_BLOCKS, SUM_THREADS = 1056, 256
SUM_SCRATCH_BYTES = 2 * SUM_BLOCKS * 8 + 16
# {(device index, stream): the scratch of the fixed-order sums on that stream}
_SCRATCH: dict = {}


def sum_scratch(device, stream: int) -> int:
    """Device pointer of the fixed-order sums' scratch for ``stream`` (a raw
    CUDA stream) on ``device``, allocated and zeroed on first use. One per
    stream: the launches of one stream run one after another, and each
    leaves the last-block ticket at 0 for the next; two streams sharing a
    ticket would race."""
    key = (device.index, stream)
    buf = _SCRATCH.get(key)
    if buf is None:
        buf = _SCRATCH.setdefault(key, torch.zeros(SUM_SCRATCH_BYTES, dtype=torch.uint8,
                                                   device=device))
    return buf.data_ptr()


def fixed_order_sum(v):
    """sum(v) of a 1-d tensor in the kernels' order (csrc/fixed_sum.cuh):
    vectors of V = 16 / itemsize entries, tiles of SUM_THREADS vectors;
    block b of SUM_BLOCKS takes the tiles b, b + SUM_BLOCKS, ...; thread t
    adds the entries of vector t of each of its block's tiles, tile after
    tile and in index order, to a running sum from zero; a pairwise tree
    over the threads; then thread t adds the block sums t, t + SUM_THREADS,
    ... from zero, and the same tree. Returns a 0-d tensor on v's device. A
    CPU tensor is summed in NumPy (the same IEEE adds in the same order):
    its elementwise ops run on one thread, where PyTorch's run a parallel
    region on each [SUM_BLOCKS, SUM_THREADS] add, and those stall when the
    CPU is oversubscribed."""
    if v.device.type == "cpu":
        a = v.numpy()
        return torch.as_tensor(_fixed_order_sum(a, lambda shape: np.zeros(shape, a.dtype)))
    return _fixed_order_sum(v, v.new_zeros)


def _tree(acc):
    """The pairwise tree over the threads, [rows, SUM_THREADS] -> [rows]
    (in place)."""
    s = SUM_THREADS // 2
    while s > 0:
        acc[:, :s] += acc[:, s : 2 * s]
        s //= 2
    return acc[:, 0]


def _fixed_order_sum(v, zeros):
    """fixed_order_sum on a 1-d NumPy array or tensor; ``zeros(shape)``
    makes a zero array of v's kind, dtype and device. The zero pads add
    nothing: a running sum from +0 is never -0."""
    N = v.shape[0]
    V = 16 // (v.itemsize if isinstance(v, np.ndarray) else v.element_size())
    sweep = SUM_BLOCKS * SUM_THREADS * V  # one tile per block
    rounds = max(-(-N // sweep), 1)
    # lanes[r, b, t, l]: entry l of thread t's vector in block b's r-th tile
    flat = zeros((rounds * sweep,))
    flat[:N] = v
    lanes = flat.reshape(rounds, SUM_BLOCKS, SUM_THREADS, V)
    acc = zeros((SUM_BLOCKS, SUM_THREADS))
    for r in range(rounds):
        for lane in range(V):
            acc += lanes[r, :, :, lane]
    slots = zeros((-(-SUM_BLOCKS // SUM_THREADS) * SUM_THREADS,))
    slots[:SUM_BLOCKS] = _tree(acc)
    last = zeros((1, SUM_THREADS))
    for r in slots.reshape(-1, SUM_THREADS):
        last[0] += r
    return _tree(last)[0]


def dot_plain(a, b, mask=None, scale=None):
    """Plain form of ``dot``: the JAX expression's products, summed by
    ``fixed_order_sum``."""
    if scale is not None:
        b = scale * b
    if mask is not None:
        a = a * mask
    return fixed_order_sum((a * b).reshape(-1))


def _check(name, t, ref, dtype=None):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"dot: {name} must be a tensor")
    if t.dtype != (ref.dtype if dtype is None else dtype):
        raise TypeError(f"dot: {name} dtype {t.dtype}, expected {ref.dtype if dtype is None else dtype}")
    if t.shape != ref.shape or t.device != ref.device:
        raise ValueError(f"dot: {name} shape {tuple(t.shape)} on {t.device}, expected "
                         f"{tuple(ref.shape)} on {ref.device}")
    if not t.is_contiguous():
        raise ValueError(f"dot: {name} must be contiguous")


def dot(a, b, mask=None, scale=None):
    """sum(a * [mask] * scale * b) as a 0-d tensor. a, b, scale: one shape,
    float32 or float64, one device, contiguous; mask: a bool tensor of that
    shape. Kernel K5 for CUDA tensors, the plain form for CPU tensors."""
    if not isinstance(a, torch.Tensor) or a.dtype not in _DTYPES:
        raise TypeError(f"dot: unsupported operand {getattr(a, 'dtype', type(a))}")
    _check("a", a, a)
    _check("b", b, a)
    return _dot(a, b, mask, scale)


def dot_half(a, b, mask=None, scale=None):
    """``dot`` with ``a`` stored narrower than b's dtype (module
    docstring); the result in b's dtype."""
    if not isinstance(b, torch.Tensor) or b.dtype not in _DTYPES:
        raise TypeError(f"dot_half: unsupported operand {getattr(b, 'dtype', type(b))}")
    if not isinstance(a, torch.Tensor) or a.dtype not in NARROWER[b.dtype]:
        raise TypeError(f"dot_half: a dtype {getattr(a, 'dtype', type(a))} under {b.dtype}")
    _check("b", b, b)
    _check("a", a, b, a.dtype)
    return _dot(a, b, mask, scale)


def _dot(a, b, mask, scale):
    """The checks of mask and scale against b, and the route of both
    wrappers (a and b checked by the caller)."""
    if mask is not None:
        _check("mask", mask, b, torch.bool)
    if scale is not None:
        _check("scale", scale, b)
    dev, dt = b.device, b.dtype
    half = a.dtype != dt
    if dev.type == "cpu":
        return dot_plain(a.to(dt) if half else a, b, mask, scale)
    if dev.type != "cuda":
        raise ValueError(f"dot: unsupported device {dev}")
    out = torch.empty((), dtype=dt, device=dev)
    stream = current_stream()
    tail = (a.data_ptr(), b.data_ptr(), None if mask is None else mask.data_ptr(),
            None if scale is None else scale.data_ptr(), sum_scratch(dev, stream),
            out.data_ptr(), a.numel())
    if half:
        LAUNCHES["direction_dot"] += 1
        launch("hz_masked_dot_half", _DTYPES[dt], STORE_CODES[a.dtype], *tail, stream=stream)
    else:
        LAUNCHES["masked_dot"] += 1
        launch("hz_masked_dot", _DTYPES[dt], *tail, stream=stream)
    return out
