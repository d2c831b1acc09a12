"""The port's gather-sharded solver (parallel/sharding.py) on 2 and 4
spawned gloo ranks against the JAX package's single-device MultigridSolver
on the same plan, in float64 on the CPU (the kernels' plain forms).

A subset of the JAX suite's own sharded == single tests
(tests/test_sharding.py), on its problem (hypercube(dim, n), a checkerboard
conductivity from default_rng(3), the load-vector rhs): V-cycles with
coarse="chol" in 2D and in 3D with E = 162 (blocks of 41 rows on 4 ranks,
the last of 39), coarse="cg", the Chebyshev smoother with its lambda_max
estimate, and coarse="mg". x and r after the cycles and the residual norm
after each cycle agree within 1e-9 relative (JAX's own bar; MULTICHIP_r05:
9.2e-14), lambda_max too, and every rank reads the same residual norms bit
for bit (the rank-order sums). A world of one (in-process gloo group)
equals the port's single-device solver bit for bit, and the solver rejects
what the JAX class does not take. PCG, FMG and solve() are in
test_torch_sharding_solve.py.

The ranks are spawned by ``run_slab.spawn_ranks`` (torch.multiprocessing,
a FileStore rendezvous, one thread each) and import no JAX; the JAX
reference runs in the test process."""

import os

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
from homogenization_jl_tpu_torch.interop import join_shards
from homogenization_jl_tpu_torch.parallel import run_slab
from homogenization_jl_tpu_torch.parallel.group import SlabGroup
from homogenization_jl_tpu_torch.parallel.sharding import ShardedMultigridSolver, shard_slice
from homogenization_jl_tpu_torch.solver.multigrid import MultigridSolver

TOL = 1e-9


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def jax_setup(dim, n, levels, seed=3):
    """The JAX suite's _setup (tests/test_sharding.py:23-35)."""
    base = j_hypercube(dim, n)
    sigma = conductivity_per_element(base, generate_conductivity(dim, n, np.random.default_rng(seed)),
                                     np.zeros(dim))
    plan = j_build_grid_plan(base, levels, slot_tables=False)
    _, _, detJ, _ = affine_maps(base)
    return plan, sigma, detJ[:, None] * load_vector(plan.reference.levels[levels - 1])[None, :]


def spawn(S, **kwargs):
    outs = run_slab.spawn_ranks(S, dict(kind="sharded", kwargs=kwargs))
    assert [o["rank"] for o in outs] == list(range(S))
    assert all(o["hist"] == outs[0]["hist"] for o in outs)  # the same bits on every rank
    assert not any(v for o in outs for v in o["job_launches"].values())  # plain forms on the CPU
    return outs


# (dim, n, levels, lam, cycles, solver options, ranks)
VCYCLES = [
    (2, 4, 3, 0.3, 3, dict(coarse="chol"), 2),
    (3, 3, 4, 0.3, 3, dict(coarse="chol"), 4),
    (2, 4, 3, 0.3, 3, dict(coarse="cg"), 4),
    (2, 4, 3, 0.2, 4, dict(coarse="chol", smoother="chebyshev"), 2),
    (2, 8, 2, 0.1, 3, dict(coarse="mg", coarse_mg_dense_limit=4, coarse_mg_tol=1e-12), 2),
]
IDS = ["2d-chol-S2", "3d-E162-chol-S4", "2d-cg-S4", "2d-chebyshev-S2", "2d-mg-S2"]


@pytest.mark.parametrize("dim,n,levels,lam,cycles,opts,S", VCYCLES, ids=IDS)
def test_sharded_vcycles_match_jax_single_device(dim, n, levels, lam, cycles, opts, S):
    plan, sigma, b = jax_setup(dim, n, levels)
    ref = JaxSolver(plan, dtype=jnp.float64, **opts)
    coeff = ref.coefficients(sigma, lam)
    setup = ref.coarse_setup(sigma, lam)
    lam_max = ref.estimate_lambda_max(coeff) if "smoother" in opts else None
    x, _ = ref.zero_states()
    hist = []
    for _ in range(cycles):
        x, r = ref.vcycle(x, jnp.asarray(b), coeff, setup, lam_max=lam_max)
        hist.append(float(ref.residual_norm(r)))
    outs = spawn(S, dim=dim, n=n, nlevels=levels, mode="vcycle", lam=lam, cycles=cycles,
                 solver_opts=opts)
    assert rel(join_shards([o["x"] for o in outs]), x) <= TOL
    assert rel(join_shards([o["r"] for o in outs]), r) <= TOL
    for a, c in zip(outs[0]["hist"], hist):
        assert abs(a - c) <= TOL * c
    if lam_max is not None:
        assert abs(outs[0]["lam_max"] - lam_max) <= TOL * lam_max
    # the blocks: ceil(E / S) rows, the last one shorter where S does not divide E
    E = plan.base.nelements
    assert [o["rows"] for o in outs[:-1]] == [-(-E // S)] * (S - 1)
    assert sum(o["rows"] for o in outs) == E
    assert any(sum(o["cross_slots"]) for o in outs)


@pytest.fixture
def world_of_one(tmp_path):
    group = SlabGroup.from_file(os.path.join(tmp_path, "store"), 0, 1, device="cpu")
    yield group
    SlabGroup.destroy()


def test_world_of_one_equals_single_device(world_of_one):
    """One rank: the combine is the single-device gather combine bit for
    bit at every level (no cross groups), and a Chebyshev solve gives the
    single-device history and solution bit for bit."""
    plan, sigma, b = run_slab.sharded_problem(3, 3, 3)
    kw = dict(dtype=torch.float64, coarse="chol", smoother="chebyshev")
    sh = ShardedMultigridSolver(plan, world_of_one, **kw)
    single = MultigridSolver(plan, device="cpu", combine="gather", **kw)
    rng = np.random.default_rng(5)
    for k in range(plan.nlevels):
        assert sh.cross_slots(k) == 0
        x = torch.as_tensor(rng.standard_normal((plan.base.nelements, plan.n_local(k))))
        assert torch.equal(sh.combine(x, k), single.combine(x, k))
    out = [s.solve(torch.as_tensor(b), sigma, 0.0, tol=1e-8) for s in (sh, single)]
    assert out[0][1] == out[1][1]
    assert torch.equal(out[0][0], out[1][0])


def test_sharded_solver_checks_its_arguments(world_of_one):
    plan = run_slab.sharded_problem(2, 2, 2)[0]
    with pytest.raises(TypeError, match="SlabGroup"):
        ShardedMultigridSolver(plan, object())
    for bad in (dict(smoother="cg_exact"), dict(cycle="W"), dict(constraint="mask"),
                dict(smooth_precision="high")):
        with pytest.raises(ValueError):
            ShardedMultigridSolver(plan, world_of_one, **bad)
    s = ShardedMultigridSolver(plan, world_of_one, dtype=torch.float64, smoother="chebyshev",
                               coarse="cg")
    assert (s.coarse_cg_tol, s.coarse_cg_maxiter, s.combine_kind) == (1e-10, 200, "gather")
    x, b = s.zero_states()
    m = [torch.ones_like(x, dtype=torch.bool)]
    with pytest.raises(ValueError, match="Ls"):
        s.vcycle(x, b, s.coefficients(np.ones((plan.base.nelements, 2)), 0.0), None,
                 lam_max=1.0, Ls=m)
    with pytest.raises(ValueError, match="interior"):
        s.vcycle(x, b, s.coefficients(np.ones((plan.base.nelements, 2)), 0.0), None,
                 lam_max=1.0, interior=torch.ones(plan.base.nnodes, dtype=torch.bool))
    with pytest.raises(NotImplementedError, match="no mixed-precision form"):
        s.mixed_precision_pcg()
    with pytest.raises(ValueError, match="without rows"):  # 10 rows in blocks of 2 on 8 ranks
        shard_slice(10, 0, 8)
