"""Spectral random coefficient fields (device, PyTorch + CUDA kernel K17).

Port of homogenization_jl_tpu/utils/fft_field.py (reference: tools/
generate_st1_field.jl): white noise -> real FFT -> spectral filter
1/(1 + |k|)^p -> inverse FFT -> exp(alpha |.|), the log-normal-ish "st1"
conductivity fields with power-law correlations.

The FFTs are ``torch.fft.rfftn`` / ``irfftn`` (cuFFT on the card; they
stand where the JAX function calls XLA's FFT). The two elementwise passes
around them are kernel K17 (CUDA C++, csrc/fft_field.cu, CUDA tensors):
  * K17a ``spectral_filter(F, shape, p)``: F / (1 + |k|)^p on the complex64
    half spectrum, |k| computed from the indices in the kernel under the
    reference's folded convention (coord(m, i) = abs(abs(i - m - 1) - m),
    tools/generate_st1_field.jl:39: every axis but the last folds around
    its Nyquist index; the last, the rfft axis, runs 0..n/2), the offset
    decoded over [D0, D1, L] (``filter_dims``);
  * K17b ``exp_abs(f, alpha)``: exp(alpha * |f|).
Each is one pass over a grid of 32^3 at setup, far below a microsecond of
bytes: what it costs is its launch, so each is one thread per entry
launched through the ctypes launcher (csrc/build.py::launch). The square
root, quotient, power and exponential are the CUDA math library's
correctly rounded or full-range forms (no fast math), so the kernels
follow the plain forms (the JAX expressions in PyTorch, which run for CPU
tensors) to a few ulp.

The noise: JAX draws it with its own PRNG (threefry), which PyTorch does
not have. ``generate_field`` draws with a ``torch.Generator`` (or a seed),
or takes ``noise=`` as given: through that seam the tests hand both
packages JAX's draw, and ``pinned_noise`` serves the draw of the TPU
record's field (``jax.random.normal(PRNGKey(3), (32, 32, 32), float32)``,
data/st1_noise_key3_32.npy), so the card solves that very field.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from ..csrc.build import LAUNCHES, launch

_DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")
# (seed, shape) -> the JAX draw jax.random.normal(PRNGKey(seed), shape, float32)
_PINNED = {(3, (32, 32, 32)): "st1_noise_key3_32.npy"}


def pinned_noise(seed: int, shape) -> np.ndarray | None:
    """The JAX package's noise for (seed, shape), where the port keeps a
    copy (data/), else None."""
    name = _PINNED.get((int(seed), tuple(int(s) for s in shape)))
    return None if name is None else np.load(os.path.join(_DATA, name))


def folded_k2(shape, device=None):
    """|k|^2 on the half spectrum of ``shape`` (float32, the JAX form's
    sum over axes in order)."""
    dim = len(shape)
    fshape = tuple(shape[:-1]) + (shape[-1] // 2 + 1,)
    k2 = torch.zeros(fshape, dtype=torch.float32, device=device)
    for ax in range(dim):
        n = shape[ax]
        if ax == dim - 1:  # the rfft axis: 0..n//2
            k = torch.arange(fshape[ax], dtype=torch.float32, device=device)
        else:
            i = torch.arange(n, dtype=torch.float32, device=device)
            k = torch.abs(torch.abs(i - n // 2) - n // 2)
        sh = [1] * dim
        sh[ax] = fshape[ax]
        k2 = k2 + k.reshape(sh) ** 2
    return k2


def spectral_filter_plain(F, shape, p):
    """Plain form of ``spectral_filter``: F / (1 + sqrt(k2))^p."""
    return F / (1.0 + torch.sqrt(folded_k2(shape, F.device))) ** p


def exp_abs_plain(f, alpha):
    """Plain form of ``exp_abs``."""
    return torch.exp(alpha * torch.abs(f))


def _route(fn, t, dtype):
    if t.dtype != dtype:
        raise TypeError(f"{fn}: dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{fn}: the input must be contiguous")
    kind = t.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"{fn}: unsupported device {t.device}")
    return kind == "cuda"


@functools.lru_cache(maxsize=64)
def filter_dims(shape: tuple):
    """(D0, D1, L, total) of K17a's decode for a real grid of ``shape`` (a
    tuple of up to 3 ints): its half spectrum as [D0, D1, L], leading axes
    of 1 for fewer than 3, and the entries D0 D1 L (below 2^31: the kernel
    decodes in 32 bits). Cached: the wrapper's host time is the pass's
    cost."""
    if not 1 <= len(shape) <= 3:
        raise ValueError("spectral_filter: the kernel takes 1 to 3 axes")
    D0, D1 = ((1, 1) + shape[:-1])[-2:]
    L = shape[-1] // 2 + 1
    total = D0 * D1 * L
    if total >= 2**31:
        raise ValueError(f"spectral_filter: {total} entries, the kernel takes below 2^31")
    return D0, D1, L, total


def spectral_filter(F, shape, p: float = 1.5):
    """K17a: F / (1 + |k|)^p for the complex64 half spectrum F of a real
    grid of ``shape`` (F.shape = shape[:-1] + (shape[-1] // 2 + 1,)), as a
    new tensor. Kernel K17a for CUDA tensors (up to 3 axes), the plain form
    for CPU tensors."""
    shape = tuple(int(s) for s in shape)
    fshape = shape[:-1] + (shape[-1] // 2 + 1,)
    if F.shape != fshape:
        raise ValueError(f"spectral_filter: F {tuple(F.shape)}, expected {fshape}")
    if not _route("spectral_filter", F, torch.complex64):
        return spectral_filter_plain(F, shape, p)
    D0, D1, L, total = filter_dims(shape)
    out = torch.empty_like(F)
    LAUNCHES["spectral_filter"] += 1
    launch("hz_spectral_filter", F.data_ptr(), out.data_ptr(), total, D0, D1, L, float(p))
    return out


def exp_abs(f, alpha: float):
    """K17b: exp(alpha * |f|) for a float32 tensor, as a new tensor. Kernel
    K17b for CUDA tensors, the plain form for CPU tensors."""
    if not _route("exp_abs", f, torch.float32):
        return exp_abs_plain(f, alpha)
    N = f.numel()
    if N >= 2**31:
        raise ValueError(f"exp_abs: {N} entries, the kernel takes below 2^31")
    out = torch.empty_like(f)
    LAUNCHES["exp_abs"] += 1
    launch("hz_exp_abs", f.data_ptr(), out.data_ptr(), N, float(alpha))
    return out


def generate_field(generator, shape: tuple, p: float = 1.5, alpha: float = 100.0, noise=None,
                   device=None):
    """Random positive field on an n^d grid (reference: generate_field,
    tools/generate_st1_field.jl:86-120), float32 on ``device`` (the card
    unless the caller asks for the CPU).

    ``generator``: a ``torch.Generator`` on that device, or an int seed;
    ignored when ``noise`` (an array of ``shape``, JAX's draw for example)
    is given."""
    from ..solver.multigrid import resolve_device

    dev = resolve_device(device)
    shape = tuple(int(s) for s in shape)
    if any(s % 2 for s in shape):
        raise ValueError("generate_field: even sizes required")
    if noise is None:
        if not isinstance(generator, torch.Generator):
            generator = torch.Generator(device=dev).manual_seed(int(generator))
        noise = torch.randn(shape, generator=generator, dtype=torch.float32, device=dev)
    else:
        noise = torch.tensor(np.asarray(noise, dtype=np.float32)).to(dev)
        if tuple(noise.shape) != shape:
            raise ValueError(f"generate_field: noise {tuple(noise.shape)}, expected {shape}")
    F = spectral_filter(torch.fft.rfftn(noise).contiguous(), shape, p)
    field = torch.fft.irfftn(F, s=shape).contiguous()
    return exp_abs(field, alpha)


def st1_conductivity(generator, n: int, dim: int, p: float = 1.5, alpha: float = 100.0,
                     noise=None, device=None):
    """Per-cell isotropic conductivity on an n^dim unit-cell grid."""
    return generate_field(generator, (n,) * dim, p=p, alpha=alpha, noise=noise, device=device)
