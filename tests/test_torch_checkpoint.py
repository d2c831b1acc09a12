"""The driver's step files, resume and VTK export against the JAX driver's,
in float64 on the CPU, in both geometries.

Both drivers run n = 1 in 2D with 2 refinements, the driver's default
smoother and inner loop (tolerance 1e-8, seed 5) on the schedule patched to
compute_boundary_layer = floor(lam**-0.5), as the JAX package's driver
tests patch it: two outer steps on the radii 3 -> 2, one shrink. With
``checkpoint_dir`` each writes step_0.npz and step_1.npz, with
``save_level=1`` checkerboard.vtu and one solution file per step.

  * a step file written by the JAX driver, resumed by the port, gives the
    JAX driver's resumed sigma within 1e-10 relative (and its cycle count);
  * the port's step files hold what the JAX driver's hold: the same keys,
    dtypes and scalars, the field, xi and the step-0 rhs equal, sigma, x,
    b and v_prev within 1e-10; the conductivity file byte for byte, the
    solution files' geometry equal and values within 1e-10;
  * a port-written step file resumes in the JAX driver with the JAX
    driver's resumed sigma within 1e-10, and in the port with the port's
    uninterrupted sigma bit for bit.

The sharded drivers' files: tests/test_torch_checkpoint_sharded.py."""

import contextlib
import math
import os

import numpy as np
import pytest

from homogenization_jl_tpu.models import checkerboard as jcb
from homogenization_jl_tpu_torch.models import checkerboard as tcb
from homogenization_jl_tpu_torch.utils.checkpoint import load_step
from test_torch_utils import parse_vtu

TOL = 1e-10
N = 1
KW = dict(dim=2, refinements=2, tolerance=1e-8, seed=5)
GEOMETRIES = ["ordered", "lattice"]


def _layer(lam, n):
    return int(math.floor(lam**-0.5))


@contextlib.contextmanager
def _in(path):
    """The schedule patched in both drivers, the working directory at path
    (save_level writes checkerboard.vtu there)."""
    old = os.getcwd()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcb, "compute_boundary_layer", _layer)
        mp.setattr(tcb, "compute_boundary_layer", _layer)
        os.chdir(path)
        try:
            yield
        finally:
            os.chdir(old)


def _run(mod, path, geometry, **extra):
    kw = dict(KW, device="cpu") if mod is tcb else KW
    with _in(path):
        return mod.checkerboard_homogenization(N, geometry=geometry, return_trace=True,
                                               **kw, **extra)


def _files(path):
    return dict(checkpoint_dir=str(path / "ck"), save_level=1, save_prefix=str(path / "v"))


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """Per geometry: the JAX driver's uninterrupted run with its files and
    its run resumed from its step_0.npz."""
    runs = {}

    def get(geometry):
        if geometry not in runs:
            d = tmp_path_factory.mktemp(f"jax_{geometry}")
            full, ftr = _run(jcb, d, geometry, **_files(d))
            resumed, rtr = _run(jcb, d, geometry, resume_from=str(d / "ck" / "step_0.npz"))
            assert len(ftr.sigma_steps) == 2 and len(rtr.sigma_steps) == 1
            assert resumed == full
            runs[geometry] = dict(dir=d, sigma=resumed, cycles=rtr.cycles_per_step)
        return runs[geometry]

    return get


@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_jax_step_file_resumes_in_the_port(tmp_path, jax_runs, geometry):
    ref = jax_runs(geometry)
    sigma, tr = _run(tcb, tmp_path, geometry, resume_from=str(ref["dir"] / "ck" / "step_0.npz"))
    assert abs(sigma - ref["sigma"]) <= TOL * abs(ref["sigma"]), (sigma, ref["sigma"])
    assert tr.cycles_per_step == ref["cycles"] and len(tr.sigma_steps) == 1
    assert not os.listdir(tmp_path)  # no save_level, no checkpoint_dir: no file


def _close(a, b, tol=TOL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    assert np.abs(a - b).max() <= tol * max(np.abs(b).max(), 1e-300)


@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_port_step_files_match_jax_and_resume_in_both(tmp_path, jax_runs, geometry):
    ref = jax_runs(geometry)
    full, tr = _run(tcb, tmp_path, geometry, **_files(tmp_path))
    assert len(tr.sigma_steps) == 2
    for k in (0, 1):
        t, j = (load_step(str(d / "ck" / f"step_{k}.npz")) for d in (tmp_path, ref["dir"]))
        assert set(t) == set(j)
        for key in ("k", "n", "refinements", "box_radius", "total_radius", "lam"):
            assert t[key] == j[key]
        assert abs(t["sigma"] - j["sigma"]) <= TOL * abs(j["sigma"])
        for key in ("cond_field", "xi"):
            assert np.array_equal(t[key], j[key])
        for key in ("x", "b"):
            _close(t[key], j[key])
        if k == 0:
            assert np.array_equal(t["b"], j["b"]) and t["v_prev"] is j["v_prev"] is None
        else:
            _close(t["v_prev"], j["v_prev"])
        vt, vj = parse_vtu(tmp_path / f"v_{k}.vtu"), parse_vtu(ref["dir"] / f"v_{k}.vtu")
        for key in ("Points", "connectivity", "offsets", "types", "_points", "_cells"):
            assert np.array_equal(vt[key], vj[key])
        _close(vt["v"], vj["v"])
    with open(tmp_path / "checkerboard.vtu", "rb") as ft, \
            open(ref["dir"] / "checkerboard.vtu", "rb") as fj:
        assert ft.read() == fj.read()

    step0 = str(tmp_path / "ck" / "step_0.npz")
    sigma_j, _ = _run(jcb, tmp_path, geometry, resume_from=step0)
    assert abs(sigma_j - ref["sigma"]) <= TOL * abs(ref["sigma"]), (sigma_j, ref["sigma"])
    resumed, rtr = _run(tcb, tmp_path, geometry, resume_from=step0)
    assert resumed == full and rtr.residuals == tr.residuals[1:]


def test_resume_checks_the_run_and_an_ordered_file_resumes_sliced(tmp_path, jax_runs):
    """A step file of another n or refinements is refused; the ordered
    geometry resumes on the mesh sliced to the file's radius (step_1's:
    the run ends after its shrink test, with the file's sigma)."""
    ref = jax_runs("ordered")
    step0 = str(ref["dir"] / "ck" / "step_0.npz")
    with pytest.raises(ValueError, match="refinements=2"):
        tcb.checkerboard_homogenization(N, dim=2, refinements=1, resume_from=step0,
                                        device="cpu")
    step1 = load_step(str(ref["dir"] / "ck" / "step_1.npz"))
    sigma, tr = _run(tcb, tmp_path, "ordered", resume_from=str(ref["dir"] / "ck" / "step_1.npz"))
    assert sigma == step1["sigma"] and tr.sigma_steps == []
    assert step1["total_radius"] == 2 and step1["x"].shape[0] == 2 * 4 * 4
