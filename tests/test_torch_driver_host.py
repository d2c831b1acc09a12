"""The host layer of the port's homogenization driver against the JAX
package's copy (array for array), the entry points' device default, the
arguments the driver refuses, and an import check of the driver's
modules with jax blocked.

The schedule, the ordered mesh and its radius queries, the initial
right-hand side, the lattice DOF norms and the consistent random start are
NumPy in both packages and must be equal, not close."""

import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from homogenization_jl_tpu.models import checkerboard as jcb
from homogenization_jl_tpu.ops.plan import build_grid_plan as j_build_grid_plan
from homogenization_jl_tpu_torch.models import checkerboard as tcb
from homogenization_jl_tpu_torch.ops.plan import build_grid_plan as t_build_grid_plan


def test_schedule_matches_jax():
    for n in range(0, 7):
        for k in range(0, n + 2):
            assert tcb.compute_box_radius(k, n) == jcb.compute_box_radius(k, n)
            assert tcb.compute_box_radius(k, n, 0.1) == jcb.compute_box_radius(k, n, 0.1)
        for lam in (1.0, 0.5, 0.25, 0.125, 1 / 1024):
            assert tcb.compute_boundary_layer(lam, n) == jcb.compute_boundary_layer(lam, n)


@pytest.mark.parametrize("dim,radius", [(2, 5), (3, 3)])
def test_ordered_mesh_and_radius_queries_match_jax(dim, radius):
    mt, nt, ct = tcb.ordered_hypercube(dim, radius)
    mj, nj, cj = jcb.ordered_hypercube(dim, radius)
    assert np.array_equal(mt.nodes, mj.nodes)
    assert np.array_equal(mt.elements, mj.elements)
    assert np.array_equal(nt, nj) and np.array_equal(ct, cj)
    for r in (0, 1, radius - 1, radius, radius + 0.5):
        for eps in (0.0, 1e-12):
            assert tcb.prefix_in_radius(nt, r, eps) == jcb.prefix_in_radius(nj, r, eps)
            assert tcb.prefix_in_radius(ct, r, eps) == jcb.prefix_in_radius(cj, r, eps)


@pytest.mark.parametrize("dim,radius,nlevels", [(2, 3, 3), (3, 2, 2)])
def test_rhs_norms_and_random_start_match_jax(dim, radius, nlevels):
    mesh, _, _ = tcb.ordered_hypercube(dim, radius)
    pt = t_build_grid_plan(mesh, nlevels, slot_tables=False)
    pj = j_build_grid_plan(mesh, nlevels, slot_tables=False)
    field = tcb.generate_conductivity(dim, 2 * radius, np.random.default_rng(4))
    assert np.array_equal(field, jcb.generate_conductivity(dim, 2 * radius, np.random.default_rng(4)))
    off = np.full(dim, float(radius))
    sig = tcb.conductivity_per_element(mesh, field, off)
    assert np.array_equal(sig, jcb.conductivity_per_element(mesh, field, off))
    xi = np.ones(dim) / np.sqrt(dim)
    for dt in (np.float64, np.float32):
        assert np.array_equal(tcb.initial_rhs(pt, sig, xi, dt), jcb.initial_rhs(pj, sig, xi, dt))
    for k in range(nlevels):
        assert np.array_equal(tcb.lattice_dof_norms(pt, k, chunk=7), jcb.lattice_dof_norms(pj, k))
        assert np.array_equal(
            tcb.consistent_random(pt, k, np.random.default_rng(k)),
            jcb.consistent_random(pj, k, np.random.default_rng(k)),
        )


def test_driver_looks_up_the_schedule_as_a_module_global(monkeypatch):
    """Patching compute_boundary_layer changes the run (the JAX tests patch
    it the same way); n = 1 with the patched layer floor(lam**-0.5) runs
    two outer steps on a 6 x 6 box instead of one on a 20 x 20 box."""
    monkeypatch.setattr(tcb, "compute_boundary_layer", lambda lam, n: int(lam**-0.5))
    _, tr = tcb.checkerboard_homogenization(
        1, dim=2, refinements=1, smoother="chebyshev", inner="pcg", seed=1,
        return_trace=True, device="cpu", geometry="lattice",
    )
    assert len(tr.sigma_steps) == 2


def test_compare_refinements_runs_each_level_on_one_field(monkeypatch):
    """compare_refinements_on_same_material samples one field and runs the
    driver on it at each refinement: the same sigma as the driver given that
    field."""
    monkeypatch.setattr(tcb, "compute_boundary_layer", lambda lam, n: int(lam**-0.5))
    kw = dict(dim=2, tolerance=1e-8, seed=2, smoother="chebyshev", inner="pcg", device="cpu")
    got = tcb.compare_refinements_on_same_material(1, refinements=(1, 2), **kw)
    R0 = tcb.compute_box_radius(0, 1) + tcb.compute_boundary_layer(1.0, 1)
    field = tcb.generate_conductivity(2, 2 * R0, np.random.default_rng(2))
    assert sorted(got) == [1, 2]
    for r, sigma in got.items():
        assert sigma == tcb.checkerboard_homogenization(1, refinements=r, cond_field=field, **kw)
    assert got[1] != got[2]


def test_entry_points_default_to_the_card():
    """Without a CUDA device the default (the card) raises; device="cpu"
    runs on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    from homogenization_jl_tpu_torch import MultigridSolver, build_grid_plan, hypercube

    plan = build_grid_plan(hypercube(2, 2), 2, slot_tables=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MultigridSolver(plan)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcb.checkerboard_homogenization(1, dim=2, refinements=1, smoother="chebyshev")
    assert MultigridSolver(plan, device="cpu").device.type == "cpu"


@pytest.mark.parametrize(
    "kw,exc,match",
    [
        # the ordered geometry takes a SlabGroup now (the gather-sharded
        # solver); anything else is refused
        (dict(device_mesh=object()), TypeError, "SlabGroup"),
        # solver="multishift" runs (models/multishift.py); what it still
        # refuses is an inner solve, as the JAX driver does
        (dict(solver="multishift", inner="pcg", smoother="chebyshev"), ValueError,
         "multishift"),
    ],
    ids=["device_mesh", "multishift"],
)
def test_unported_arguments_raise(kw, exc, match):
    with pytest.raises(exc, match=match):
        tcb.checkerboard_homogenization(1, dim=2, refinements=1, device="cpu", **kw)


def test_cg_smoother_is_the_default():
    """The driver's defaults run: smoother="cg" with inner="vcycle", the
    same sigma as when they are named."""
    sigma = tcb.checkerboard_homogenization(1, dim=2, refinements=1, seed=4, device="cpu")
    named = tcb.checkerboard_homogenization(
        1, dim=2, refinements=1, seed=4, device="cpu", smoother="cg", inner="vcycle"
    )
    assert math.isfinite(sigma) and sigma == named
    with pytest.raises(ValueError, match="linear SPD"):
        tcb.checkerboard_homogenization(1, dim=2, refinements=1, device="cpu", inner="pcg")


def test_driver_modules_load_with_jax_blocked():
    """The driver, the integrals, the gather combine and the slab-sharded
    solver (parallel/) import neither jax nor the JAX package, even where
    jax is installed."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['homogenization_jl_tpu'] = None\n"
        "import homogenization_jl_tpu_torch.models.checkerboard\n"
        "import homogenization_jl_tpu_torch.ops.integrals\n"
        "import homogenization_jl_tpu_torch.ops.interfaces\n"
        "import homogenization_jl_tpu_torch.solver.multigrid\n"
        "import homogenization_jl_tpu_torch.ops.cg\n"
        "import homogenization_jl_tpu_torch.ops.dots\n"
        "import homogenization_jl_tpu_torch.ops.transfer\n"
        "import homogenization_jl_tpu_torch.parallel.group\n"
        "import homogenization_jl_tpu_torch.parallel.slab\n"
        "import homogenization_jl_tpu_torch.parallel.run_slab\n"
        "from homogenization_jl_tpu_torch import SlabGroup, SlabShardedMultigridSolver\n"
        "from homogenization_jl_tpu_torch.models.checkerboard import checkerboard_homogenization\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=root)
    assert res.returncode == 0, res.stderr


def test_device_mesh_must_be_a_slab_group():
    """The lattice geometry takes a SlabGroup as device_mesh (the ordered
    one still raises, above); anything else is a TypeError."""
    with pytest.raises(TypeError, match="SlabGroup"):
        tcb.checkerboard_homogenization(1, dim=2, refinements=1, device="cpu",
                                        geometry="lattice", device_mesh=object())
