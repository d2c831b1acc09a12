"""The solver's dots, mask and scale fused (device, PyTorch + CUDA kernel K5).

Replaces the ``jnp.vdot`` calls of homogenization_jl_tpu/solver/multigrid.py:
``_vdot`` (:510), ``_pcg_rnorm`` (:1177), ``residual_norm`` (:1484), the
first-copy dots of ``_smooth_cg_exact`` (``vdot(rc * w, rc)``, :821, :838)
and the Lanczos ``ddot`` (``vdot(a * w, d * b)``, :600). One function,

    dot(a, b, mask=None, scale=None) = sum_i (a_i * [mask_i]) * (scale_i * b_i),

so no caller writes the masked or scaled temporary.

Kernel K5 (csrc/dots.cu) runs for CUDA tensors: a fixed grid of
RED_BLOCKS blocks over contiguous chunks, RED_THREADS strided running sums
per block, a fixed tree in each block and one more over the block sums. No
atomics: two launches give the same bits, which the solver's stopping tests
and the CG smoothers' alpha and beta rely on. The plain form (CPU tensors)
takes the same steps in the same order, so the CPU tests hold the kernel's
order too; on the card the two agree bit for bit (up to the sign of a zero).
K9 (ops/integrals.py) sums its rows in this order as well.

``dot_half(a, b, ...)`` takes an ``a`` stored narrower than the state (b's
dtype; ops/apply.py::NARROWER): the half-width direction of
``_smooth_cg_exact``'s ``vdot(load(p), A p)`` (kernel K16, K5 widening a
on load, csrc/dots.cu). It is ``dot(a.to(b.dtype), b, ...)`` bit for bit;
its plain form casts a up first.
"""

from __future__ import annotations

import numpy as np
import torch

from ..csrc.build import LAUNCHES, launch
from .apply import NARROWER, STORE_CODES

_DTYPES = {torch.float32: 0, torch.float64: 1}
# the kernels' fixed reduction grid (csrc/dots.cu, csrc/integrals.cu)
RED_BLOCKS, RED_THREADS = 264, 256


def fixed_order_sum(v):
    """sum(v) of a 1-d tensor in the kernels' order: RED_BLOCKS contiguous
    chunks; within a chunk, RED_THREADS strided running sums, then a
    pairwise tree; the block sums the same way in one block. Returns a 0-d
    tensor on v's device. A CPU tensor is summed in NumPy (the same IEEE
    adds in the same order): its elementwise ops run on one thread, where
    PyTorch's run a parallel region on each [RED_BLOCKS, RED_THREADS] add,
    and those stall when the CPU is oversubscribed."""
    if v.device.type == "cpu":
        a = v.numpy()
        return torch.as_tensor(_fixed_order_sum(a, lambda shape: np.zeros(shape, a.dtype)))
    return _fixed_order_sum(v, v.new_zeros)


def _fixed_order_sum(v, zeros):
    """fixed_order_sum on a 1-d NumPy array or tensor; ``zeros(shape)``
    makes a zero array of v's kind, dtype and device."""

    def block(parts):  # [B, k * RED_THREADS] -> [B]
        lanes = parts.reshape(parts.shape[0], -1, RED_THREADS)
        acc = zeros((parts.shape[0], RED_THREADS))
        acc[:] = lanes[:, 0]
        for j in range(1, lanes.shape[1]):
            acc += lanes[:, j]
        s = RED_THREADS // 2
        while s > 0:
            acc[:, :s] += acc[:, s : 2 * s]
            s //= 2
        return acc[:, 0]

    N = v.shape[0]
    chunk = max(-(-N // RED_BLOCKS), 1)
    # block b's chunk [b * chunk, (b + 1) * chunk) in row b, zero-padded to
    # whole rounds of RED_THREADS
    parts = zeros((RED_BLOCKS, -(-chunk // RED_THREADS) * RED_THREADS))
    full = N // chunk
    parts[:full, :chunk] = v[: full * chunk].reshape(full, chunk)
    if full < RED_BLOCKS:
        parts[full, : N - full * chunk] = v[full * chunk :]
    sums = zeros((1, -(-RED_BLOCKS // RED_THREADS) * RED_THREADS))
    sums[0, :RED_BLOCKS] = block(parts)
    return block(sums)[0]


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
    blocksum = torch.empty(RED_BLOCKS, dtype=dt, device=dev)
    out = torch.empty((), dtype=dt, device=dev)
    tail = (a.data_ptr(), b.data_ptr(), None if mask is None else mask.data_ptr(),
            None if scale is None else scale.data_ptr(), blocksum.data_ptr(), out.data_ptr(),
            a.numel())
    if half:
        LAUNCHES["direction_dot"] += 1
        launch("hz_masked_dot_half", _DTYPES[dt], STORE_CODES[a.dtype], *tail)
    else:
        LAUNCHES["masked_dot"] += 1
        launch("hz_masked_dot", _DTYPES[dt], *tail)
    return out
