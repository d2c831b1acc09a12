"""The port's multishift recurrence (models/multishift.py) against the JAX
package's, in float64 on the CPU (the plain forms of kernels K13, K14 and
the kernels beneath them).

  * ``homogenization_multishift(1, dim=2, refinements=1, lanczos_iters=60,
    seed=3)``, one-pass and two-pass: sigma within 1e-10 relative of JAX's
    (measured 1.2e-15: the same recurrence, the dots summed in another
    order), the stats (``A_applies``, ``M_applies``, ``lanczos_iters``)
    equal; the port's two modes bitwise equal (K14c adds in one order);
  * the driver's ``solver="multishift"`` dispatch equal to the direct call
    (tests/test_multishift_recurrence.py:49), ``return_trace`` its stats,
    and ``inner="pcg"`` refused;
  * ``multishift_demo`` (test_utils.py's call): one Krylov pass within
    1e-6 of per-shift CG in both packages, the port's worst gap within
    1e-9 of JAX's.
The JAX results are computed once per module (about 45 s of the JAX
package's eager while-loops on the CPU)."""

import numpy as np
import pytest
import torch

from homogenization_jl_tpu.models import multishift as j_ms
from homogenization_jl_tpu_torch.models import checkerboard as t_cb
from homogenization_jl_tpu_torch.models import multishift as t_ms

CALL = dict(dim=2, refinements=1, lanczos_iters=60, seed=3, return_stats=True)
STAT_KEYS = ("A_applies", "M_applies", "lanczos_iters")


@pytest.fixture(scope="module")
def jax_runs():
    return {mode: j_ms.homogenization_multishift(1, two_pass=mode == "two", **CALL)
            for mode in ("one", "two")}


@pytest.fixture(scope="module")
def port_runs():
    return {mode: t_ms.homogenization_multishift(1, two_pass=mode == "two", device="cpu", **CALL)
            for mode in ("one", "two")}


@pytest.mark.parametrize("mode", ["one", "two"])
def test_multishift_recurrence_matches_jax(jax_runs, port_runs, mode):
    sj, stj = jax_runs[mode]
    st, stt = port_runs[mode]
    assert abs(st - sj) <= 1e-10 * abs(sj), (st, sj)
    for key in STAT_KEYS:
        assert stt[key] == stj[key], key
    assert len(stt["sigma_steps"]) == len(stj["sigma_steps"])
    assert np.allclose(stt["sigma_steps"], stj["sigma_steps"], rtol=1e-10, atol=0)


def test_two_pass_equals_one_pass_bitwise(port_runs):
    s1, st1 = port_runs["one"]
    s2, st2 = port_runs["two"]
    assert s1 == s2
    assert st1["lanczos_iters"] == st2["lanczos_iters"]
    # pass 2 re-runs the mat-vec stream: about twice the applies
    assert st2["A_applies"] < 2 * st1["A_applies"] + 2


def test_driver_dispatch_equals_direct_call(port_runs):
    s_direct = port_runs["one"][0]
    s = t_cb.checkerboard_homogenization(1, dim=2, refinements=1, seed=3, solver="multishift",
                                         lanczos_iters=60, device="cpu")
    assert s == s_direct
    s_t, stats = t_cb.checkerboard_homogenization(
        1, dim=2, refinements=1, seed=3, solver="multishift", lanczos_iters=60,
        return_trace=True, device="cpu")
    assert s_t == s_direct and isinstance(stats, dict)
    for key in STAT_KEYS:
        assert stats[key] == port_runs["one"][1][key]


def test_driver_refuses_inner_pcg_with_multishift():
    with pytest.raises(ValueError, match="multishift"):
        t_cb.checkerboard_homogenization(1, dim=2, refinements=1, solver="multishift",
                                         inner="pcg", smoother="chebyshev", device="cpu")


def test_multishift_demo_matches_jax():
    kw = dict(dim=2, n=3, levels=2, n_shifts=3, iters=120)
    wj, rj = j_ms.multishift_demo(**kw)
    wt, rt = t_ms.multishift_demo(device="cpu", **kw)
    assert wt < 1e-6 and wj < 1e-6
    assert abs(wt - wj) < 1e-9
    assert (rt < 1e-6).all() and rt.shape == np.asarray(rj).shape


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_ms.homogenization_multishift(1, dim=2, refinements=1, lanczos_iters=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_ms.multishift_demo(dim=2, n=2, levels=2)


def test_run_multishift_compare_entry_point(monkeypatch, capsys):
    """``python -m homogenization_jl_tpu_torch.run_multishift_compare`` at a
    CPU size: the script's record (three driver runs and the direct call,
    their sigma, counts and gaps to the V-cycle driver)."""
    import json

    from homogenization_jl_tpu_torch import run_multishift_compare

    monkeypatch.setenv("MS_LANCZOS", "20")
    rec = run_multishift_compare.main(["1", "2", "1", "1e-6"], device="cpu")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(rec))
    assert line["lanczos_iters_budget"] == 20 and line["dtype"] == "float64"
    assert set(line["vcycle"]) >= {"sigma", "wall_s", "cycles_per_step", "sigma_steps"}
    for name in ("multishift", "multishift_direct"):
        assert line[name]["lanczos_iters"] == 20 and "rel_diff_vs_vcycle" in line[name]
    assert line["multishift"]["sigma"] == line["multishift_direct"]["sigma"]
    assert line["pcg"]["rel_diff_vs_vcycle"] < 1e-5
