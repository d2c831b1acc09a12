"""The st1 path of the port (utils/fft_field.py with kernel K17's plain
forms, models/st1.py) against the JAX package's, on the CPU, with JAX's
own noise handed to the port through ``noise=`` (the two packages' PRNGs
differ).

Tolerances (measured on the CPU, pocketfft against XLA's FFT, float32):
  * ``generate_field``: 2e-5 relative at alpha = 100 (measured 2.5e-6 at
    32^3, 5.7e-6 at (16, 16): the FFTs' float32 rounding, multiplied by
    alpha in exp(alpha |f|)), 1e-6 at alpha = 3 (measured 2.7e-7);
  * K17's plain forms against the JAX expressions: 1e-6 relative (the
    same float32 expressions; pow and the complex quotient may round
    differently);
  * ``st1_example`` / ``st1_multigrid`` (tests/test_utils.py:92-160's
    sizes, float64 solves of float32 fields): the solutions within 1e-6
    relative of JAX's (measured 2e-8), the residual histories within 1e-4
    relative while above 1e-9 of the first (measured 2e-4 at 1e-12 of it:
    the fields differ by 1.2e-7);
  * the pinned noise (data/st1_noise_key3_32.npy) bitwise equal to JAX's
    draw."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from homogenization_jl_tpu.models import st1 as j_st1
from homogenization_jl_tpu.utils import fft_field as j_ff
from homogenization_jl_tpu_torch.models import st1 as t_st1
from homogenization_jl_tpu_torch.utils import fft_field as t_ff


def _noise(seed, shape):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape, dtype=jnp.float32))


def _rel(a, b):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.abs(a / b - 1).max())


def test_pinned_noise_is_the_jax_draw():
    pinned = t_ff.pinned_noise(3, (32, 32, 32))
    assert pinned.dtype == np.float32 and pinned.nbytes == 131_072
    assert np.array_equal(pinned, _noise(3, (32, 32, 32)))
    assert t_ff.pinned_noise(4, (32, 32, 32)) is None


@pytest.mark.parametrize("shape,alpha,tol", [((16, 16), 100.0, 2e-5), ((8, 8, 8), 100.0, 2e-5),
                                             ((32, 32, 32), 100.0, 2e-5), ((16, 16), 3.0, 1e-6)],
                         ids=["16x16", "8^3", "32^3", "16x16-alpha3"])
def test_generate_field_matches_jax(shape, alpha, tol):
    key = jax.random.PRNGKey(3)
    fj = np.asarray(j_ff.generate_field(key, shape, alpha=alpha))
    ft = t_ff.generate_field(None, shape, alpha=alpha, noise=_noise(3, shape), device="cpu")
    assert ft.dtype == torch.float32 and tuple(ft.shape) == shape
    assert _rel(ft.numpy(), fj) <= tol


def test_st1_record_field_contrast():
    """The TPU record's field (ACCURACY.md:153-159): contrast 60,793."""
    f = t_ff.st1_conductivity(3, 32, 3, alpha=100.0, noise=t_ff.pinned_noise(3, (32,) * 3),
                              device="cpu").numpy()
    assert abs(f.max() / f.min() / 60_793.07 - 1) < 1e-3


def test_kernel_plain_forms_match_jax_expressions():
    rng = np.random.default_rng(31)
    for shape in ((16, 16), (8, 6, 10)):
        fshape = shape[:-1] + (shape[-1] // 2 + 1,)
        F = (rng.standard_normal(fshape) + 1j * rng.standard_normal(fshape)).astype(np.complex64)
        # fft_field.py:30-45's expression
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
        ref = np.asarray(jnp.asarray(F) / (1.0 + jnp.sqrt(k2)) ** 1.5)
        out = t_ff.spectral_filter(torch.as_tensor(F), shape, 1.5).numpy()
        assert np.abs(out - ref).max() <= 1e-6 * np.abs(ref).max()
    f = rng.standard_normal((8, 8)).astype(np.float32) * 0.1
    ref = np.asarray(jnp.exp(100.0 * jnp.abs(jnp.asarray(f))))
    assert _rel(t_ff.exp_abs(torch.as_tensor(f), 100.0).numpy(), ref) <= 1e-6


def test_st1_example_matches_jax():
    mj, uj, sj = j_st1.st1_example(n=8, dim=2, lam=1.0, alpha=2.0, seed=1)
    mt, ut, st = t_st1.st1_example(n=8, dim=2, lam=1.0, alpha=2.0, seed=1,
                                   noise=_noise(1, (8, 8)), device="cpu")
    assert st.shape == (mt.nelements,) and (st >= 1.0).all()
    assert _rel(st, sj) <= 1e-6
    assert np.isfinite(ut).all() and np.abs(ut).max() > 0
    assert np.abs(ut - uj).max() <= 1e-6 * np.abs(uj).max()


@pytest.mark.parametrize("method", ["vcycle", "pcg"])
def test_st1_multigrid_matches_jax(method):
    kw = dict(n=6, dim=2, refinements=2, lam=1.0, alpha=2.0, seed=3, max_cycles=14, method=method)
    hj, xj, _, sj = j_st1.st1_multigrid(**kw)
    timings = {}
    ht, xt, solver, st = t_st1.st1_multigrid(noise=_noise(3, (6, 6)), device="cpu",
                                             timings=timings, **kw)
    assert set(timings) == {"field_s", "plan_s", "solver_s", "setup_s", "solve_s"}
    assert solver.device.type == "cpu" and len(ht) == len(hj)
    assert ht[-1] < 1e-6 * ht[0]
    keep = np.asarray(hj) > 1e-9 * hj[0]
    assert _rel(np.asarray(ht)[keep], np.asarray(hj)[keep]) <= 1e-4
    xj = np.asarray(xj)
    assert np.abs(xt.numpy() - xj).max() <= 1e-6 * np.abs(xj).max()
    assert _rel(st, sj) <= 1e-6


def test_the_field_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_ff.generate_field(0, (4, 4))


def test_run_st1_entry_point(monkeypatch, capsys):
    """``python -m homogenization_jl_tpu_torch.run_st1``: the script's
    arguments and ST1_* knobs reach st1_multigrid (pinned noise at n = 32,
    seed 3), and it prints the script's JSON line; the solve itself is
    stood in for by a CPU-sized 2D one."""
    import json

    from homogenization_jl_tpu_torch import run_st1

    seen = {}

    def small(n, **kw):
        seen.update(kw, n=n)
        kw.update(dim=2, coarse="chol", noise=_noise(3, (6, 6)))
        return t_st1.st1_multigrid(6, **kw)

    monkeypatch.setattr(run_st1, "st1_multigrid", small)
    monkeypatch.setenv("ST1_METHOD", "pcg")
    monkeypatch.setenv("ST1_COARSE_MG_TOL", "0.05")
    rec = run_st1.main(["32", "2", "2.0", "5"], device="cpu")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(rec))
    for key in ("n", "refinements", "alpha", "dofs", "contrast", "sigma_min", "sigma_max",
                "residuals", "contraction_last5", "wall_s"):
        assert key in line
    assert seen["n"] == 32 and seen["dim"] == 3 and seen["refinements"] == 2
    assert seen["seed"] == 3 and seen["max_cycles"] == 5 and seen["method"] == "pcg"
    assert seen["coarse"] == "mg" and seen["dtype"] == torch.float32
    assert seen["solver_opts"]["smoother"] == "chebyshev"
    assert seen["solver_opts"]["coarse_mg_tol"] == 0.05
    assert np.array_equal(seen["noise"], _noise(3, (32, 32, 32))) and line["noise"] == "jax"
    assert len(line["residuals"]) == 6
