"""The driver's step files, resume and VTK export through ``device_mesh``: 2
spawned gloo ranks (``run_slab.spawn_ranks``) against the port's single
device, in float64 on the CPU.

The run of tests/test_torch_checkpoint.py (n = 1, 2D, 2 refinements, the
driver's defaults, tolerance 1e-8, seed 5, the schedule patched to
compute_boundary_layer = floor(lam**-0.5) in each rank: two steps on the
radii 3 -> 2) with ``checkpoint_dir`` and ``save_level=1``:

  * the ordered geometry on the gather-sharded solver: the ranks' rows
    joined in rank order, rank 0 alone writes, and its step files and
    solution files hold the single-device run's (scalars, field and xi
    equal; sigma, x, b, v_prev and the solution values within 1e-9, the
    sharded == single bar; the conductivity file byte for byte); the run
    resumed on 2 ranks from the ranks' step_0.npz gives the single
    device's resumed sigma within 1e-9, the same on every rank;
  * the lattice geometry on the slab-sharded solver (cube order on both
    sides): the same files against the single device's, and the run
    resumed on 2 ranks equal to the ranks' uninterrupted sigma bit for bit
    (the JAX suite's sharded resume test, tests/test_homogenization.py:
    383-397)."""

import math

import numpy as np
import pytest

from homogenization_jl_tpu_torch.models import checkerboard as tcb
from homogenization_jl_tpu_torch.parallel import run_slab
from homogenization_jl_tpu_torch.utils.checkpoint import load_step
from test_torch_utils import parse_vtu

TOL = 1e-9
N = 1
KW = dict(dim=2, refinements=2, tolerance=1e-8, seed=5)


def _layer(lam, n):
    return int(math.floor(lam**-0.5))


def patched_worker(rank, size, init_file, out_dir, job):
    """run_slab.worker with the patched schedule (a spawned rank imports the
    driver anew)."""
    tcb.compute_boundary_layer = _layer
    run_slab.worker(rank, size, init_file, out_dir, job)


def _ranks(monkeypatch, kind, **kwargs):
    monkeypatch.setattr(run_slab, "worker", patched_worker)
    outs = run_slab.spawn_ranks(2, dict(kind=kind, kwargs=dict(n=N, **KW, **kwargs)))
    assert all(o["sigma"] == outs[0]["sigma"] for o in outs)
    return outs[0]


def _files(path):
    return dict(checkpoint_dir=str(path / "ck"), save_level=1, save_prefix=str(path / "v"))


def _close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    assert np.abs(a - b).max() <= TOL * max(np.abs(b).max(), 1e-300)


def _same_files(ranks_dir, single_dir):
    for k in (0, 1):
        t, s = (load_step(str(d / "ck" / f"step_{k}.npz")) for d in (ranks_dir, single_dir))
        assert set(t) == set(s)
        for key in ("k", "n", "refinements", "box_radius", "total_radius", "lam"):
            assert t[key] == s[key]
        assert abs(t["sigma"] - s["sigma"]) <= TOL * abs(s["sigma"])
        for key in ("cond_field", "xi"):
            assert np.array_equal(t[key], s[key])
        for key in ("x", "b") + (("v_prev",) if k else ()):
            _close(t[key], s[key])
        vt, vs = parse_vtu(ranks_dir / f"v_{k}.vtu"), parse_vtu(single_dir / f"v_{k}.vtu")
        for key in ("Points", "connectivity", "offsets", "types", "_points", "_cells"):
            assert np.array_equal(vt[key], vs[key])
        _close(vt["v"], vs["v"])
    with open(ranks_dir / "checkerboard.vtu", "rb") as ft, \
            open(single_dir / "checkerboard.vtu", "rb") as fs:
        assert ft.read() == fs.read()


@pytest.mark.parametrize("geometry", ["ordered", "lattice"])
def test_sharded_driver_writes_the_single_device_files_and_resumes(tmp_path, monkeypatch,
                                                                   geometry):
    kind, extra = ("ordered_driver", {}) if geometry == "ordered" else (
        "driver", dict(lattice_order="cube"))
    monkeypatch.setattr(tcb, "compute_boundary_layer", _layer)
    (tmp_path / "ranks").mkdir()
    (tmp_path / "single").mkdir()
    monkeypatch.chdir(tmp_path / "single")
    single = tcb.checkerboard_homogenization(N, geometry=geometry, device="cpu",
                                             **KW, **extra, **_files(tmp_path / "single"))
    single_resumed = tcb.checkerboard_homogenization(
        N, geometry=geometry, device="cpu", **KW, **extra,
        resume_from=str(tmp_path / "single" / "ck" / "step_0.npz"))
    assert single_resumed == single

    monkeypatch.chdir(tmp_path / "ranks")  # the spawned ranks start here
    full = _ranks(monkeypatch, kind, **extra, **_files(tmp_path / "ranks"))
    assert len(full["sigma_steps"]) == 2
    assert abs(full["sigma"] - single) <= TOL * abs(single)
    _same_files(tmp_path / "ranks", tmp_path / "single")

    resumed = _ranks(monkeypatch, kind, **extra,
                     resume_from=str(tmp_path / "ranks" / "ck" / "step_0.npz"))
    assert len(resumed["sigma_steps"]) == 1
    assert abs(resumed["sigma"] - single_resumed) <= TOL * abs(single_resumed)
    if geometry == "lattice":
        assert resumed["sigma"] == full["sigma"]
