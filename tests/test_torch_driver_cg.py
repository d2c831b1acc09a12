"""The port's homogenization driver with the CG smoothers against the JAX
driver, in float64 on the CPU.

  * every default (the ordered geometry, smoother="cg", inner="vcycle",
    coarse="chol", float64): ``checkerboard_homogenization(2, dim=2,
    refinements=1, seed=0)`` in both packages, the port with
    ``device="cpu"``: sigma to 1e-10 relative and equal cycles per step;
  * the driver estimates lambda_max for the Chebyshev smoothers only, as
    the JAX driver does: no estimate_lambda_max call for "cg" / "cg_exact".
The lattice geometry with smoother="cg_exact" is in
test_torch_driver_cg_lattice.py."""

import math

import numpy as np
import pytest

from homogenization_jl_tpu.models import checkerboard as jcb
from homogenization_jl_tpu_torch.models import checkerboard as tcb
from homogenization_jl_tpu_torch.solver.multigrid import MultigridSolver as TorchSolver

TOL = 1e-10


def _layer(lam, n):
    return int(math.floor(lam**-0.5))


def _check(tj, tt):
    assert tt.cycles_per_step == tj.cycles_per_step
    rel = np.abs(np.array(tt.sigma_steps) - np.array(tj.sigma_steps)) / np.abs(tj.sigma_steps)
    assert rel.max() <= TOL, (tt.sigma_steps, tj.sigma_steps)
    assert abs(tt.sigma - tj.sigma) <= TOL * abs(tj.sigma)


def test_driver_defaults_match_jax():
    sj, tj = jcb.checkerboard_homogenization(2, dim=2, refinements=1, seed=0, return_trace=True)
    st, tt = tcb.checkerboard_homogenization(2, dim=2, refinements=1, seed=0, return_trace=True,
                                             device="cpu")
    assert sj == tj.sigma and st == tt.sigma
    assert math.isfinite(st) and tt.cycles_per_step[0] > 1
    _check(tj, tt)


@pytest.mark.parametrize("smoother", ["cg", "cg_exact", "chebyshev"])
def test_driver_estimates_lambda_max_for_chebyshev_only(monkeypatch, smoother):
    monkeypatch.setattr(tcb, "compute_boundary_layer", _layer)
    calls = []
    real = TorchSolver.estimate_lambda_max

    def counted(self, *a, **kw):
        calls.append(1)
        return real(self, *a, **kw)

    monkeypatch.setattr(TorchSolver, "estimate_lambda_max", counted)
    inner = "pcg" if smoother == "chebyshev" else "vcycle"
    for geometry in ("ordered", "lattice"):
        calls.clear()
        _, tr = tcb.checkerboard_homogenization(
            1, dim=2, refinements=1, seed=1, smoother=smoother, inner=inner,
            geometry=geometry, return_trace=True, device="cpu",
        )
        steps = len(tr.sigma_steps)
        assert steps == 2 and math.isfinite(tr.sigma)
        assert len(calls) == (steps if smoother == "chebyshev" else 0)
