"""``python -m homogenization_jl_tpu_torch.run_flagship`` (the port of
scripts/run_flagship.py) on the CPU.

  * its defaults and its call: refinements 4, n 2, tolerance 1e-4, and the
    JAX script's driver arguments (3D, lattice, float32, coarse "mg", seed
    7, the Chebyshev smoother with inner="pcg", or cg_exact with
    FLAGSHIP_INNER=vcycle), the driver stood in for;
  * the entry point at a small size (n = 1, 1 refinement, the schedule
    patched to compute_boundary_layer = floor(lam**-0.5): two outer steps on
    a 6^3 box, 12,960 DOFs): one JSON line with every key of the JAX
    script's line, equal to the returned record; with FLAGSHIP_INNER=vcycle
    the JAX driver's sigma within 1e-5 relative (float32; measured 3.2e-7)
    in as many cycles per step, and with the default inner="pcg" within 50
    x the tolerance of it (the JAX suite's bar between inner modes)."""

import json
import math

import jax.numpy as jnp
import pytest
import torch

from homogenization_jl_tpu.models import checkerboard as jcb
from homogenization_jl_tpu_torch import run_flagship
from homogenization_jl_tpu_torch.models import checkerboard as tcb

# scripts/run_flagship.py's line
KEYS = {"sigma", "sigma_steps", "cycles_per_step", "residuals", "wall_s", "n", "refinements",
        "tolerance"}
TOL = 1e-4


def _layer(lam, n):
    return int(math.floor(lam**-0.5))


@pytest.fixture(scope="module")
def jax_vcycle():
    """The JAX script's call with FLAGSHIP_INNER=vcycle at the small size."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcb, "compute_boundary_layer", _layer)
        return jcb.checkerboard_homogenization(
            1, dim=3, refinements=1, tolerance=TOL, seed=7, dtype=jnp.float32,
            geometry="lattice", coarse="mg", smoother="cg_exact", inner="vcycle",
            solver_opts=dict(smooth_precision="high", coarse_mg_tol=5e-2), return_trace=True)


def test_defaults_and_the_drivers_call(monkeypatch, capsys):
    seen = {}

    def stand_in(n, **kw):
        seen.update(kw, n=n)
        return 1.25, tcb.HomogenizationTrace(1.25, [1.25], [0.5], [3])

    monkeypatch.setattr(run_flagship, "checkerboard_homogenization", stand_in)
    monkeypatch.delenv("FLAGSHIP_INNER", raising=False)
    rec = run_flagship.main([])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == rec and set(line) == KEYS
    assert (line["refinements"], line["n"], line["tolerance"]) == (4, 2, 1e-4)
    assert line["sigma"] == 1.25 and line["cycles_per_step"] == [3]
    assert seen == dict(n=2, dim=3, refinements=4, tolerance=1e-4, seed=7,
                        dtype=torch.float32, geometry="lattice", coarse="mg",
                        smoother="chebyshev", inner="pcg",
                        solver_opts=dict(smooth_precision="high", coarse_mg_tol=5e-2),
                        verbose=True, return_trace=True, device=None)
    monkeypatch.setenv("FLAGSHIP_INNER", "vcycle")
    run_flagship.main(["3", "1", "1e-3"], device="cpu")
    assert (seen["refinements"], seen["n"], seen["tolerance"]) == (3, 1, 1e-3)
    assert (seen["smoother"], seen["inner"], seen["device"]) == ("cg_exact", "vcycle", "cpu")


def test_entry_point_line_at_a_small_size(monkeypatch, capsys, jax_vcycle):
    monkeypatch.setattr(tcb, "compute_boundary_layer", _layer)
    monkeypatch.delenv("FLAGSHIP_INNER", raising=False)
    rec = run_flagship.main(["1", "1", "1e-4"], device="cpu")
    out = capsys.readouterr().out.strip().splitlines()
    line = json.loads(out[-1])
    assert line == json.loads(json.dumps(rec)) and set(line) == KEYS
    assert any(ln.startswith("[step 1]") for ln in out)  # verbose, as the script
    assert (line["n"], line["refinements"], line["tolerance"]) == (1, 1, 1e-4)
    assert len(line["sigma_steps"]) == len(line["cycles_per_step"]) == 2
    assert line["sigma_steps"][-1] == line["sigma"] and line["wall_s"] >= 0
    sj, _ = jax_vcycle
    assert abs(line["sigma"] - sj) <= 50 * TOL, (line["sigma"], sj)


def test_inner_vcycle_matches_the_jax_driver(monkeypatch, jax_vcycle):
    monkeypatch.setattr(tcb, "compute_boundary_layer", _layer)
    monkeypatch.setenv("FLAGSHIP_INNER", "vcycle")
    rec, trace = run_flagship.flagship(1, 1, TOL, device="cpu", verbose=False)
    sj, tj = jax_vcycle
    assert abs(rec["sigma"] - sj) <= 1e-5 * abs(sj), (rec["sigma"], sj)
    assert rec["cycles_per_step"] == tj.cycles_per_step == trace.cycles_per_step
    assert len(trace.iteration_seconds) == 2 and trace.init_seconds > 0
