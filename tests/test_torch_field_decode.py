"""Kernel K17 (csrc/fft_field.cu) on the CPU: K17a's offset decode over
[D0, D1, L] emulated in NumPy as the kernel takes it (32-bit quotients and
remainders, the folded |k| of each leading axis, the rfft axis's index,
the squares summed in float32), and the arguments the wrappers hand the
ctypes launcher.

  * For 2D and 3D even grids (32^3, non-cubic ones) the emulated |k|^2
    equals ``folded_k2`` (the plain form's) and the JAX expression's k2
    (homogenization_jl_tpu/utils/fft_field.py:30-42) exactly: both are sums
    of squares of small integers, exact in float32.
  * With ``launch`` captured, ``spectral_filter`` passes the (D0, D1, L,
    total) the decode expects and a fresh output, ``exp_abs`` the entries
    and alpha, and each counts one launch.
The kernels themselves run on the card (tests/test_torch_multishift_kernels.py,
``cuda`` marker)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from homogenization_jl_tpu_torch.csrc.build import LAUNCHES
from homogenization_jl_tpu_torch.utils import fft_field as t_ff

SHAPES = [(16, 16), (8, 6), (12, 20), (8, 8, 8), (8, 6, 10), (32, 32, 32), (4, 12, 8)]


def decode_k2(D0, D1, L, total):
    """K17a's |k|^2 for every offset, in the kernel's arithmetic."""
    i = np.arange(total, dtype=np.int32)
    t = i // np.int32(L)
    i2 = i - t * np.int32(L)
    i0 = t // np.int32(D1)
    i1 = t - i0 * np.int32(D1)

    def folded(v, D):
        h = np.int32(D // 2)
        return np.abs(np.abs(v - h) - h).astype(np.float32)

    k0, k1, k2 = folded(i0, D0), folded(i1, D1), i2.astype(np.float32)
    return (k0 * k0 + k1 * k1) + k2 * k2


def jax_k2(shape):
    """The JAX function's k2 (fft_field.py:30-42)."""
    fshape = shape[:-1] + (shape[-1] // 2 + 1,)
    k2 = jnp.zeros(fshape, jnp.float32)
    for ax in range(len(shape)):
        n = shape[ax]
        if ax == len(shape) - 1:
            k = jnp.arange(fshape[ax], dtype=jnp.float32)
        else:
            i = jnp.arange(n, dtype=jnp.float32)
            k = jnp.abs(jnp.abs(i - n // 2) - n // 2)
        sh = [1] * len(shape)
        sh[ax] = fshape[ax]
        k2 = k2 + k.reshape(sh) ** 2
    return np.asarray(k2)


@pytest.mark.parametrize("shape", SHAPES, ids=["x".join(map(str, s)) for s in SHAPES])
def test_decode_equals_folded_k2_and_jax(shape):
    D0, D1, L, total = t_ff.filter_dims(shape)
    fshape = shape[:-1] + (shape[-1] // 2 + 1,)
    assert (D0 * D1, L, total) == (int(np.prod(shape[:-1])), fshape[-1], int(np.prod(fshape)))
    got = decode_k2(D0, D1, L, total).reshape(fshape)
    assert np.array_equal(got, t_ff.folded_k2(shape).numpy())
    assert np.array_equal(got, jax_k2(shape))


def test_filter_dims_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="1 to 3 axes"):
        t_ff.filter_dims((4, 4, 4, 4))
    with pytest.raises(ValueError, match="2\\^31"):
        t_ff.filter_dims((2048, 2048, 2048))


@pytest.fixture
def captured(monkeypatch):
    """``launch`` replaced by a recorder, and CPU tensors routed to the
    kernel path (the route's checks still run)."""
    calls = []
    route = t_ff._route

    def to_kernel(fn, t, dtype):
        route(fn, t, dtype)
        return True

    monkeypatch.setattr(t_ff, "launch", lambda name, *args: calls.append((name, args)))
    monkeypatch.setattr(t_ff, "_route", to_kernel)
    return calls


@pytest.mark.parametrize("shape", [(16, 16), (32, 32, 32), (8, 6, 10)], ids=str)
def test_spectral_filter_launch_arguments(captured, shape):
    fshape = shape[:-1] + (shape[-1] // 2 + 1,)
    F = torch.zeros(fshape, dtype=torch.complex64)
    n0 = LAUNCHES["spectral_filter"]
    out = t_ff.spectral_filter(F, shape, 1.5)
    assert LAUNCHES["spectral_filter"] == n0 + 1
    [(name, (f_ptr, out_ptr, total, D0, D1, L, p))] = captured
    assert name == "hz_spectral_filter" and p == 1.5
    assert (D0, D1, L, total) == t_ff.filter_dims(shape)
    assert f_ptr == F.data_ptr() and out_ptr == out.data_ptr() != F.data_ptr()
    assert out.shape == F.shape and out.dtype == torch.complex64 and out.is_contiguous()
    got = decode_k2(D0, D1, L, total).reshape(fshape)
    assert np.array_equal(got, t_ff.folded_k2(shape).numpy())


def test_exp_abs_launch_arguments(captured):
    f = torch.zeros((8, 6, 10), dtype=torch.float32)
    n0 = LAUNCHES["exp_abs"]
    out = t_ff.exp_abs(f, 100.0)
    assert LAUNCHES["exp_abs"] == n0 + 1
    [(name, (f_ptr, out_ptr, N, alpha))] = captured
    assert (name, N, alpha) == ("hz_exp_abs", 480, 100.0)
    assert f_ptr == f.data_ptr() and out_ptr == out.data_ptr() != f.data_ptr()
    assert out.shape == f.shape and out.dtype == torch.float32


def test_wrappers_refuse_before_launching(captured):
    with pytest.raises(TypeError):
        t_ff.exp_abs(torch.zeros(4, dtype=torch.float64), 1.0)
    with pytest.raises(ValueError, match="expected"):
        t_ff.spectral_filter(torch.zeros((4, 4), dtype=torch.complex64), (4, 4))
    with pytest.raises(ValueError, match="1 to 3 axes"):
        t_ff.spectral_filter(torch.zeros((2, 2, 2, 2), dtype=torch.complex64), (2, 2, 2, 2))
    assert captured == []
