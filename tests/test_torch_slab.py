"""The port's slab-sharded solver (parallel/slab.py) on 2 and 4 spawned gloo
ranks against the JAX package's single-device MultigridSolver on the same
cube-order plan, in float64 on the CPU (the kernels' plain forms).

A subset of the JAX suite's own slab == single tests
(tests/test_slab_sharding.py:78-124): (dim, n, levels, coarse, smoother) =
(3, 8, 3, chol, cg_exact), (3, 8, 2, mg, cg_exact) and (2, 8, 3, cg,
cg_exact), lam = 0.3. x and r after 3 V-cycles from zero and the residual
norm after each cycle agree within 1e-9 relative (JAX's own slab == single
bar), and every rank reads the same residual norms bit for bit (the rank
order sum). One Chebyshev PCG run (8 iterations, coarse="chol"): lam_max,
the history and x within 1e-9. A world of one (in-process gloo group,
destroyed after the test) against the port's single-device solver: the
combine bitwise equal at every level, x and r within 1e-12.

The ranks are spawned by ``run_slab.spawn_ranks`` (torch.multiprocessing,
a FileStore rendezvous, one thread each) and import no JAX; the JAX
reference runs in the test process."""

import json
import os
import socket

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from homogenization_jl_tpu.fem.local_operators import load_vector
from homogenization_jl_tpu.mesh.grid import affine_maps, hypercube as j_hypercube
from homogenization_jl_tpu.models.checkerboard import (
    conductivity_per_element,
    generate_conductivity,
)
from homogenization_jl_tpu.ops.plan import build_grid_plan as j_build_grid_plan
from homogenization_jl_tpu.solver.multigrid import MultigridSolver as JaxSolver
from homogenization_jl_tpu_torch.interop import join_slabs
from homogenization_jl_tpu_torch.parallel import run_slab
from homogenization_jl_tpu_torch.parallel.group import SlabGroup
from homogenization_jl_tpu_torch.parallel.slab import SlabShardedMultigridSolver
from homogenization_jl_tpu_torch.solver.multigrid import MultigridSolver

TOL = 1e-9
LAM = 0.3
OPTS = dict(coarse_mg_dense_limit=4, coarse_mg_tol=1e-12)
CONFIGS = [(3, 8, 3, "chol", "cg_exact"), (3, 8, 2, "mg", "cg_exact"), (2, 8, 3, "cg", "cg_exact")]
_REF: dict = {}


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / max(np.abs(np.asarray(b)).max(), 1e-300)


def _setup(dim, n, levels):
    """The JAX suite's _setup (tests/test_slab_sharding.py:33-43)."""
    base = j_hypercube(dim, n)
    sigma = conductivity_per_element(base, generate_conductivity(dim, n, np.random.default_rng(0)),
                                     np.zeros(dim))
    plan = j_build_grid_plan(base, levels, slot_tables=False)
    _, _, detJ, _ = affine_maps(base)
    return plan, sigma, detJ[:, None] * load_vector(plan.reference.levels[levels - 1])[None, :]


def jax_vcycles(cfg):
    """x, r and the residual norms of 3 JAX V-cycles from zero (cached per
    configuration: both slab counts compare against one run)."""
    if cfg not in _REF:
        dim, n, levels, coarse, smoother = cfg
        plan, sigma, b = _setup(dim, n, levels)
        ref = JaxSolver(plan, dtype=jnp.float64, coarse=coarse, smoother=smoother, **OPTS)
        coeff = ref.coefficients(sigma, LAM)
        setup = ref.coarse_setup(sigma, LAM)
        x, _ = ref.zero_states()
        hist = []
        for _ in range(3):
            x, r = ref.vcycle(x, jnp.asarray(b), coeff, setup)
            hist.append(float(ref.residual_norm(r)))
        _REF[cfg] = dict(x=np.asarray(x), r=np.asarray(r), hist=hist)
    return _REF[cfg]


@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("cfg", CONFIGS, ids=["-".join(map(str, c)) for c in CONFIGS])
def test_slab_vcycles_match_jax_single_device(cfg, S):
    dim, n, levels, coarse, smoother = cfg
    want = jax_vcycles(cfg)
    outs = run_slab.spawn_ranks(S, dict(kind="run", kwargs=dict(
        dim=dim, n=n, nlevels=levels, cycles=3, smoother=smoother, coarse=coarse,
        dtype=torch.float64, lam=LAM, keep_states=True, solver_opts=OPTS)))
    assert [o["rank"] for o in outs] == list(range(S))
    assert all(o["residuals"] == outs[0]["residuals"] for o in outs)
    assert _rel(join_slabs([o["x"] for o in outs]), want["x"]) <= TOL
    assert _rel(join_slabs([o["r"] for o in outs]), want["r"]) <= TOL
    for a, b in zip(outs[0]["residuals"], want["hist"]):
        assert abs(a - b) <= TOL * b


def test_slab_pcg_matches_jax_single_device():
    """The JAX suite's test_slab_pcg_matches_single_device on 4 ranks."""
    plan, sigma, b = _setup(3, 8, 3)
    ref = JaxSolver(plan, dtype=jnp.float64, coarse="chol", smoother="chebyshev")
    coeff = ref.coefficients(sigma, 0.0)
    lam_max = ref.estimate_lambda_max(coeff)
    x, hist = ref.pcg(jnp.asarray(b), coeff, ref.coarse_cholesky(sigma, 0.0), lam_max=lam_max,
                      iters=8)
    outs = run_slab.spawn_ranks(4, dict(kind="run", kwargs=dict(
        dim=3, n=8, nlevels=3, cycles=0, smoother="chebyshev", coarse="chol",
        dtype=torch.float64, pcg_iters=8, keep_states=True)))
    assert abs(outs[0]["lam_max"] - lam_max) <= TOL * lam_max
    h = outs[0]["pcg_history"]
    assert len(h) == len(hist) and all(o["pcg_history"] == h for o in outs)
    for a, c in zip(h, hist):
        assert abs(a - c) <= TOL * c
    assert _rel(join_slabs([o["pcg_x"] for o in outs]), np.asarray(x)) <= TOL
    assert h[-1] < 1e-5 * h[0]


@pytest.fixture
def world_of_one(tmp_path):
    group = SlabGroup.from_file(os.path.join(tmp_path, "store"), 0, 1, device="cpu")
    yield group
    SlabGroup.destroy()


def test_world_of_one_equals_single_device(world_of_one):
    g = world_of_one
    assert (g.rank, g.size) == (0, 1)
    t = torch.arange(6.0).reshape(2, 3)
    assert torch.equal(g.sum(t), t)
    # both sides are domain ends: nothing is sent and there is no halo
    assert not (g.has_lo or g.has_hi)
    assert g.exchange(None, None) == (None, None)
    assert g.exchange(t.clone(), t.clone()) == (None, None)
    with pytest.raises(ValueError, match="nccl"):  # CUDA tensors need NCCL
        SlabGroup(device="cuda")

    dim, n, levels = 3, 8, 3
    plan, sigma, b = run_slab.problem(dim, n, levels)[:3]
    kw = dict(dtype=torch.float64, coarse="chol", smoother="cg_exact")
    slab = SlabShardedMultigridSolver(plan, g, **kw)
    single = MultigridSolver(plan, device="cpu", **kw)
    rng = np.random.default_rng(5)
    for k in range(levels):
        x = torch.as_tensor(rng.standard_normal((plan.base.nelements, plan.n_local(k))))
        assert torch.equal(slab.combine(x, k), single.combine(x, k))
        assert torch.equal(slab.constrain(x, k), single._constrain(x, k))
    out = []
    for s in (slab, single):
        coeff = s.coefficients(sigma, LAM)
        setup = s.coarse_setup(sigma, LAM)
        x, _ = s.zero_states()
        bt = torch.as_tensor(b)
        for _ in range(3):
            x, r = s.vcycle(x, bt, coeff, setup)
        out.append((x, r))
    assert _rel(out[0][0], out[1][0]) <= 1e-12
    assert _rel(out[0][1], out[1][1]) <= 1e-12


def test_slab_solver_checks_its_arguments(world_of_one):
    plan = run_slab.problem(2, 4, 2)[0]
    with pytest.raises(TypeError, match="SlabGroup"):
        SlabShardedMultigridSolver(plan, object(), dtype=torch.float64)
    from homogenization_jl_tpu_torch import build_grid_plan, hypercube

    with pytest.raises(ValueError, match="cube"):
        SlabShardedMultigridSolver(build_grid_plan(hypercube(2, 4, order="type"), 2,
                                                   slot_tables=False), world_of_one)
    s = SlabShardedMultigridSolver(plan, world_of_one, dtype=torch.float64)
    # mixed precision pairs a slab outer with a slab inner only (JAX's
    # messages; tests/test_torch_mixed_slab.py runs the pair)
    from homogenization_jl_tpu_torch.solver.multigrid import mixed_precision_pcg

    single = MultigridSolver(plan, dtype=torch.float32, device="cpu", smoother="chebyshev")
    with pytest.raises(AssertionError, match="same solver kind"):
        mixed_precision_pcg(s, single, s.zero_states()[1], np.ones((plan.base.nelements, 2)))
    with pytest.raises(AssertionError, match="slab inner"):
        s._mixed_pcg_programs(single)


def test_torchrun_entry_point_on_one_cpu_rank(monkeypatch, capsys):
    """run_slab's main() as torchrun starts it (the env:// rendezvous on
    localhost), one gloo rank: one JSON line, the slab leg equal to the
    single-device leg."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = dict(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK="0", WORLD_SIZE="1",
               LOCAL_RANK="0")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    run_slab.main(["--device", "cpu", "--n", "4", "--levels", "2", "--cycles", "2",
                   "--smoother", "chebyshev", "--compare"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (out["slabs"], out["device"], out["dofs"]) == (1, "cpu", 384 * 10)
    assert out["residuals"] == out["residuals_single"] and out["integral_rel_err"] == 0.0
    assert out["residuals"][1] < out["residuals"][0]
