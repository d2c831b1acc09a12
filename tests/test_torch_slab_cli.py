"""``run_slab``'s command line for the gather-sharded solver (``--kind sharded``
and ``--kind ordered_driver``) and its ``--coarse``, on the CPU.

  * ``python -m torch.distributed.run --standalone --nproc-per-node=2 -m
    homogenization_jl_tpu_torch.parallel.run_slab --device cpu`` (2 gloo
    ranks, as the cards' torchrun starts them): rank 0 alone prints one
    JSON line; ``--kind sharded`` (float64 V-cycles on the JAX suite's
    problem, tests/test_sharding.py:23-35) gives the JAX single-device
    solver's residual norms within 1e-9 (the JAX suite's sharded == single
    bar), and with ``--compare`` the port's single device within 1e-9 in x;
    ``--kind ordered_driver --coarse mg`` the JAX ordered driver's sigma
    within 1e-9;
  * ``--coarse`` reaches the slab run (``--kind run``, one rank in this
    process, as tests/test_torch_slab.py drives main())."""

import json
import os
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np

from homogenization_jl_tpu.fem.local_operators import load_vector
from homogenization_jl_tpu.mesh.grid import affine_maps, hypercube
from homogenization_jl_tpu.models.checkerboard import (
    checkerboard_homogenization as j_checkerboard,
    conductivity_per_element,
    generate_conductivity,
)
from homogenization_jl_tpu.ops.plan import build_grid_plan
from homogenization_jl_tpu.solver.multigrid import MultigridSolver as JaxSolver
from homogenization_jl_tpu_torch.parallel import run_slab

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-9


def torchrun(*args):
    """rank 0's JSON line of run_slab under torchrun with 2 CPU ranks."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node=2",
         "-m", "homogenization_jl_tpu_torch.parallel.run_slab", "--device", "cpu", *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240,
    )
    assert res.returncode == 0, res.stderr[-4000:]
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("{")]
    assert len(lines) == 1, res.stdout
    return json.loads(lines[0])


def jax_vcycles(dim, n, nlevels, cycles):
    """The JAX single-device solver on run_slab.sharded_problem: V-cycles
    from zero, the residual norm after each."""
    base = hypercube(dim, n)
    sigma = conductivity_per_element(
        base, generate_conductivity(dim, n, np.random.default_rng(3)), np.zeros(dim))
    plan = build_grid_plan(base, nlevels, slot_tables=False)
    _, _, detJ, _ = affine_maps(base)
    b = jnp.asarray(detJ[:, None] * load_vector(plan.reference.levels[nlevels - 1])[None, :])
    s = JaxSolver(plan, dtype=jnp.float64)
    coeff = s.coefficients(sigma, 0.0)
    setup = s.coarse_setup(sigma, 0.0)
    x, _ = s.zero_states()
    hist = []
    for _ in range(cycles):
        x, r = s.vcycle(x, b, coeff, setup)
        hist.append(float(s.residual_norm(r)))
    return hist


def test_kind_sharded_on_two_ranks():
    out = torchrun("--kind", "sharded", "--dim", "2", "--cubes", "4", "--levels", "3",
                   "--cycles", "3", "--compare")
    assert (out["rank"], out["device"], out["rows"]) == (0, "cpu", 16)
    assert sum(out["cross_slots"]) > 0 and "x" not in out
    ref = jax_vcycles(2, 4, 3, 3)
    np.testing.assert_allclose(out["hist"], ref, rtol=TOL)
    np.testing.assert_allclose(out["hist_single"], ref, rtol=TOL)
    assert out["x_rel_diff"] <= TOL and out["hist"][-1] < out["hist"][0]


def test_kind_ordered_driver_with_coarse_mg_on_two_ranks():
    out = torchrun("--kind", "ordered_driver", "--dim", "2", "--cubes", "1", "--levels", "2",
                   "--smoother", "chebyshev", "--coarse", "mg", "--tol", "1e-6", "--compare")
    sigma, trace = j_checkerboard(1, dim=2, refinements=1, tolerance=1e-6, seed=0,
                                  smoother="chebyshev", inner="pcg", coarse="mg",
                                  geometry="ordered", return_trace=True)
    assert abs(out["sigma"] - sigma) <= TOL * abs(sigma), (out["sigma"], sigma)
    assert out["cycles_per_step"] == trace.cycles_per_step
    assert out["sigma_rel_err"] <= TOL and abs(out["sigma_single"] - sigma) <= TOL * abs(sigma)


def test_coarse_reaches_the_slab_run(monkeypatch, capsys):
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = dict(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK="0", WORLD_SIZE="1",
               LOCAL_RANK="0")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    run_slab.main(["--device", "cpu", "--n", "4", "--levels", "2", "--cycles", "2",
                   "--coarse", "cg", "--compare"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (out["coarse"], out["slabs"], out["dim"]) == ("cg", 1, 3)
    assert out["residuals"] == out["residuals_single"] and out["residuals"][1] < out["residuals"][0]
