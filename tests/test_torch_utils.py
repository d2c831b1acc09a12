"""The port's utils/ (vtk.py, checkpoint.py, logging.py) and st1's ``save=``
against the JAX package's, on the CPU.

  * the .vtu writer: the port's files byte for byte equal to the JAX
    writer's on the same inputs (meshes in 2D and 3D, point and cell data of
    every dtype the writer maps, the exploded grid of ``export_solution``
    from an array and from a tensor, ``export_conductivity``), and
    parseable: the binary DataArrays decode to the exact values;
  * ``construct_full_grid`` against tests/fixtures/vtk_golden.npz (the
    geometry, connectivity and an interpolated affine field);
  * the step files: a round trip through the port, and files written by
    either package read by the other with the same arrays and dtypes;
  * ``StepLogger`` (JSONL and echo) and ``profile_trace`` (a no-op for None,
    a Chrome trace of the CPU's activity under a directory);
  * ``st1_example(save=)`` and ``st1_multigrid(save=)``: the files parse,
    carry the solution, and match the JAX package's files within the
    solutions' tolerance (tests/test_torch_st1.py)."""

import base64
import glob
import json
import os
import re
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from homogenization_jl_tpu.mesh.grid import hypercube as j_hypercube
from homogenization_jl_tpu.models import st1 as j_st1
from homogenization_jl_tpu.ops.plan import build_grid_plan as j_build_grid_plan
from homogenization_jl_tpu.utils import checkpoint as j_ckpt
from homogenization_jl_tpu.utils import logging as j_log
from homogenization_jl_tpu.utils import vtk as j_vtk
from homogenization_jl_tpu_torch.mesh.grid import Mesh, affine_maps, hypercube
from homogenization_jl_tpu_torch.models import st1 as t_st1
from homogenization_jl_tpu_torch.ops.plan import build_grid_plan
from homogenization_jl_tpu_torch.utils import checkpoint as t_ckpt
from homogenization_jl_tpu_torch.utils import logging as t_log
from homogenization_jl_tpu_torch.utils import vtk as t_vtk

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "vtk_golden.npz")
_NP = {"Float64": np.float64, "Float32": np.float32, "Int64": np.int64, "Int32": np.int32,
       "UInt8": np.uint8}


def parse_vtu(path):
    """{name: values} of every binary DataArray of a .vtu file, with the
    piece's point and cell counts under "_points" / "_cells"."""
    text = open(path).read()
    out = {}
    for t, name, payload in re.findall(
            r'<DataArray type="(\w+)" Name="([^"]+)"[^>]*format="binary">([^<]+)<', text):
        raw = base64.b64decode(payload)
        (nbytes,) = struct.unpack("<I", raw[:4])
        assert len(raw) == 4 + nbytes
        out[name] = np.frombuffer(raw[4:], dtype=_NP[t])
    piece = re.search(r'<Piece NumberOfPoints="(\d+)" NumberOfCells="(\d+)">', text)
    out["_points"], out["_cells"] = int(piece.group(1)), int(piece.group(2))
    return out


def _same_file(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def _mesh_data(dim):
    m = hypercube(dim, 3)
    rng = np.random.default_rng(dim)
    point = {"u": rng.standard_normal(m.nnodes),
             "grad": rng.standard_normal((m.nnodes, dim)).astype(np.float32),
             "id": np.arange(m.nnodes, dtype=np.int32)}
    cell = {"sigma": rng.choice([1.0, 9.0], size=(m.nelements, dim)),
            "tag": (np.arange(m.nelements) % 7).astype(np.uint8),
            "n": np.arange(m.nelements, dtype=np.int64)}
    return m, point, cell


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("data", ["none", "point", "cell", "both"])
def test_write_vtu_bytes_equal_jax(tmp_path, dim, data):
    m, point, cell = _mesh_data(dim)
    kw = dict(point_data=point if data in ("point", "both") else None,
              cell_data=cell if data in ("cell", "both") else None)
    ft = t_vtk.write_vtu(str(tmp_path / "t"), m, **kw)
    fj = j_vtk.write_vtu(str(tmp_path / "j"), j_hypercube(dim, 3), **kw)
    assert ft == str(tmp_path / "t.vtu")
    assert _same_file(ft, fj)
    arrs = parse_vtu(ft)
    assert (arrs["_points"], arrs["_cells"]) == (m.nnodes, m.nelements)
    assert np.array_equal(arrs["Points"].reshape(-1, 3)[:, :dim], m.nodes)
    assert np.array_equal(arrs["connectivity"].reshape(m.elements.shape), m.elements)
    for name, v in {**(kw["point_data"] or {}), **(kw["cell_data"] or {})}.items():
        assert arrs[name].dtype == v.dtype and np.array_equal(arrs[name], v.reshape(-1))


@pytest.mark.parametrize("dim,n,nlevels", [(2, 2, 3), (3, 1, 3)])
def test_export_solution_bytes_equal_jax_from_a_tensor(tmp_path, dim, n, nlevels):
    """Every level of a finest-level state, from a host array and from a
    tensor (float64 and float32), byte for byte the JAX export."""
    plan = build_grid_plan(hypercube(dim, n), nlevels, slot_tables=False)
    jplan = j_build_grid_plan(j_hypercube(dim, n), nlevels, slot_tables=False)
    E, top = plan.base.nelements, nlevels - 1
    x = np.random.default_rng(0).standard_normal((E, plan.n_local(top)))
    for level in range(nlevels):
        for dt in (np.float64, np.float32):
            xs = x.astype(dt)
            fj = j_vtk.export_solution(str(tmp_path / f"j{level}"), jplan, level, xs)
            fa = t_vtk.export_solution(str(tmp_path / f"a{level}"), plan, level, xs)
            ft = t_vtk.export_solution(str(tmp_path / f"t{level}"), plan, level,
                                       torch.as_tensor(xs))
            assert _same_file(fa, fj) and _same_file(ft, fj)
            arrs = parse_vtu(ft)
            sel = plan.reference.level_in_level(level, top)
            assert arrs["_points"] == E * plan.n_local(level)
            assert np.array_equal(arrs["v"], xs[:, sel].reshape(-1))
        # the level's columns alone (what the driver joins across ranks)
        # export the same file as the whole state
        cols = t_vtk.level_columns(plan, level, torch.as_tensor(x))
        assert tuple(cols.shape) == (E, plan.n_local(level))
        fc = t_vtk.export_solution(str(tmp_path / f"c{level}"), plan, level, cols)
        fj = j_vtk.export_solution(str(tmp_path / f"j{level}"), jplan, level, x)
        assert _same_file(fc, fj)


def test_export_conductivity_and_full_grid_equal_jax(tmp_path):
    base = hypercube(3, 2)
    sigma = np.random.default_rng(1).choice([1.0, 9.0], size=(base.nelements, 3))
    ft = t_vtk.export_conductivity(str(tmp_path / "t"), base, sigma)
    fj = j_vtk.export_conductivity(str(tmp_path / "j"), j_hypercube(3, 2), sigma)
    assert _same_file(ft, fj)
    plan = build_grid_plan(base, 3, slot_tables=False)
    jplan = j_build_grid_plan(j_hypercube(3, 2), 3, slot_tables=False)
    for level in range(3):
        gt, gj = t_vtk.construct_full_grid(plan, level), j_vtk.construct_full_grid(jplan, level)
        assert np.array_equal(gt.nodes, gj.nodes) and np.array_equal(gt.elements, gj.elements)
        assert gt.nnodes == base.nelements * plan.n_local(level)


def test_construct_full_grid_matches_golden(tmp_path):
    """tests/test_vtk_golden.py's exploded 2D grid built by the port: the
    fixture's nodes, elements and affine field, exactly, and its .vtu
    carries them."""
    base = hypercube(2, 2)
    plan = build_grid_plan(base, 3)
    k = plan.nlevels - 1
    full = t_vtk.construct_full_grid(plan, k)
    E, n_local = base.nelements, plan.n_local(k)
    nodes = full.nodes.reshape(E, n_local, 2)
    nodes = (0.75 * nodes + 0.25 * nodes.mean(axis=1, keepdims=True)).reshape(-1, 2)
    J, shift, _, _ = affine_maps(base)
    coords = np.einsum("eij,nj->eni", J, plan.reference.levels[k].nodes) + shift[:, None, :]
    u = (1.0 + 2.0 * coords[..., 0] + 3.0 * coords[..., 1]).reshape(-1)
    g = np.load(FIXTURE)
    assert np.array_equal(g["elements"], full.elements)
    assert np.abs(g["nodes"] - nodes).max() == 0.0
    assert np.abs(g["u"] - u).max() == 0.0
    path = t_vtk.write_vtu(str(tmp_path / "g"), Mesh(nodes, full.elements), point_data={"u": u})
    arrs = parse_vtu(path)
    assert np.array_equal(arrs["Points"].reshape(-1, 3)[:, :2], nodes)
    assert np.array_equal(arrs["u"], u)


def _state(rng, dt):
    x = rng.standard_normal((10, 6)).astype(dt)
    return dict(k=1, sigma=1.23, lam=0.5, box_radius=8, total_radius=24, x=x, b=2 * x,
                cond_field=rng.choice([1.0, 9.0], size=(4, 4, 2)), xi=np.ones(2) / np.sqrt(2),
                n=3, refinements=1)


@pytest.mark.parametrize("dt", [np.float64, np.float32])
@pytest.mark.parametrize("v_prev", [False, True])
def test_checkpoint_round_trip_and_jax_interchange(tmp_path, dt, v_prev):
    st = _state(np.random.default_rng(0), dt)
    st["v_prev"] = 3 * st["x"] if v_prev else None
    as_tensors = dict(st, x=torch.as_tensor(st["x"]), b=torch.as_tensor(st["b"]),
                      v_prev=None if st["v_prev"] is None else torch.as_tensor(st["v_prev"]))
    pt = t_ckpt.save_step(str(tmp_path / "t"), **as_tensors)
    pj = j_ckpt.save_step(str(tmp_path / "j"), **st)
    assert pt == str(tmp_path / "t.npz")
    for path in (pt, pj):
        for load in (t_ckpt.load_step, j_ckpt.load_step):
            got = load(path)
            assert set(got) == set(st)
            for key in ("k", "n", "refinements", "box_radius", "total_radius", "sigma", "lam"):
                assert got[key] == st[key] and type(got[key]) is type(st[key])
            for key in ("x", "b", "cond_field", "xi"):
                assert got[key].dtype == np.asarray(st[key]).dtype
                assert np.array_equal(got[key], st[key])
            if v_prev:
                assert got["v_prev"].dtype == dt and np.array_equal(got["v_prev"], st["v_prev"])
            else:
                assert got["v_prev"] is None


def test_step_logger_writes_jsonl_and_echoes(tmp_path, capsys):
    path = str(tmp_path / "log.jsonl")
    for mod in (t_log, j_log):
        lg = mod.StepLogger(path, echo=True)
        lg.log(cycle=1, residual=0.125, label="a")
        lg.log(cycle=2, residual=3e-5, t=9.0)
        lg.close()
        assert [r["cycle"] for r in lg.records] == [1, 2] and lg.records[1]["t"] == 9.0
        assert isinstance(lg.records[0]["t"], float)
    err = capsys.readouterr().err.strip().splitlines()
    assert err[0].startswith("cycle=1 residual=0.125 label=a t=") and err[1] == err[3] == \
        "cycle=2 residual=3e-05 t=9"
    lines = [json.loads(ln) for ln in open(path)]
    assert len(lines) == 4 and lines[1] == lines[3] == {"cycle": 2, "residual": 3e-5, "t": 9.0}
    quiet = t_log.StepLogger(None, echo=False)
    quiet.log(x=1)
    quiet.close()
    assert quiet.records == [{"x": 1, "t": quiet.records[0]["t"]}]
    assert capsys.readouterr().err == ""


def test_profile_trace_none_is_a_no_op_and_a_directory_gets_a_trace(tmp_path):
    with t_log.profile_trace(None):
        y = torch.ones(4) * 2
    assert float(y.sum()) == 8.0 and not os.listdir(tmp_path)
    logdir = str(tmp_path / "prof")
    with t_log.profile_trace(logdir):
        torch.mm(torch.ones(8, 8), torch.ones(8, 8))
    files = glob.glob(os.path.join(logdir, "trace_*.json"))
    assert len(files) == 1
    events = json.load(open(files[0]))["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
    with t_log.profile_trace(logdir):
        pass
    assert len(glob.glob(os.path.join(logdir, "trace_*.json"))) == 2


def _noise(seed, shape):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape, dtype=jnp.float32))


def test_st1_example_save_matches_jax(tmp_path):
    j_st1.st1_example(n=8, dim=2, lam=1.0, alpha=2.0, seed=1, save=str(tmp_path / "j"))
    mesh, u, sigma = t_st1.st1_example(n=8, dim=2, lam=1.0, alpha=2.0, seed=1,
                                       save=str(tmp_path / "t"), noise=_noise(1, (8, 8)),
                                       device="cpu")
    at, aj = parse_vtu(tmp_path / "t.vtu"), parse_vtu(tmp_path / "j.vtu")
    assert set(at) == set(aj)
    for key in ("Points", "connectivity", "offsets", "types"):
        assert np.array_equal(at[key], aj[key])
    assert np.array_equal(at["x"], u) and np.array_equal(at["sigma"], sigma)
    assert at["sigma"].dtype == aj["sigma"].dtype == np.float32
    assert np.abs(at["x"] - aj["x"]).max() <= 1e-6 * np.abs(aj["x"]).max()


def test_st1_multigrid_save_matches_jax(tmp_path):
    kw = dict(n=6, dim=2, refinements=2, lam=1.0, alpha=2.0, seed=3, max_cycles=14)
    j_st1.st1_multigrid(save=str(tmp_path / "j"), **kw)
    _, x, solver, _ = t_st1.st1_multigrid(save=str(tmp_path / "t"), noise=_noise(3, (6, 6)),
                                          device="cpu", **kw)
    at, aj = parse_vtu(tmp_path / "t.vtu"), parse_vtu(tmp_path / "j.vtu")
    for key in ("Points", "connectivity", "offsets", "types"):
        assert np.array_equal(at[key], aj[key])
    assert at["_points"] == solver.plan.base.nelements * solver.plan.n_local(2)
    assert np.array_equal(at["v"], x.numpy().reshape(-1))
    assert np.abs(at["v"] - aj["v"]).max() <= 1e-6 * np.abs(aj["v"]).max()


def test_new_modules_load_with_jax_blocked():
    """The Poisson demos, utils/ and the flagship entry point import neither
    jax nor the JAX package, even where jax is installed."""
    import subprocess
    import sys

    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['homogenization_jl_tpu'] = None\n"
        "import homogenization_jl_tpu_torch.models.poisson\n"
        "import homogenization_jl_tpu_torch.utils.checkpoint\n"
        "import homogenization_jl_tpu_torch.utils.vtk\n"
        "import homogenization_jl_tpu_torch.utils.logging\n"
        "import homogenization_jl_tpu_torch.run_flagship\n"
        "import homogenization_jl_tpu_torch.parallel.run_slab\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=root)
    assert res.returncode == 0, res.stderr
