"""The mixed cell's harness on the CPU at a small size: its own copy of the
configuration cut to a box of 4^3 cubes and 3 levels (both solvers' coarse
"mg" with a dense limit of 4, as conftest.py's ``tiny`` cuts the solve
cell), one judged answer, and a benchmark file that holds that cell alone.
The last line, ``correct`` false under each fault the kind can have, the
control held in float32, no jax in a whole run, and K15's counts."""

import io
import json
import os
import shutil
import subprocess
import sys
from contextlib import redirect_stdout

import pytest

from hzbench import control, run
from hzbench.counts import bound_seconds, mixed_boundary

from .conftest import REPO, ROOT
from .test_hzbench_spans import APPLY, _launch, _Run, _x, solve_events

CELL = "mixed_rhs.cb3d_n48_r4_mixed"
TINY = "mixed_rhs.tiny_mixed"
SEED = 3_000_000_019
# 4^3 cubes, 3 levels: the program reads 1.2e-9 to 1.5e-9 (tol 1e-8) and
# copy gaps of 3e-16, the answer held in float32 3.3e-7 to 5.0e-7 (CPU,
# seeds 5, 6 and 7); the cell's own limits sit farther apart (PERF.md §2)
LIMITS = {"residual": 2e-8, "copy_gap": 1e-10, "unconverged": 0}


def _load(path):
    with open(path) as f:
        return json.load(f)


@pytest.fixture
def tiny_mixed(tmp_path):
    """(benchmark path, root) of the mixed cell's small copy."""
    root = tmp_path / "hz"
    for d in ("configs", "traffic", "limits"):
        (root / d).mkdir(parents=True)
    shutil.copytree(os.path.join(ROOT, "metrics"), root / "metrics")
    cfg = _load(os.path.join(ROOT, "configs", "cb3d_n48_r4_mixed.json"))
    cfg.update(base_cells=4, levels=3)
    for key in ("solver", "inner_solver"):
        cfg[key] = dict(cfg[key], coarse_mg_dense_limit=4)
    (root / "configs" / "tiny_mixed.json").write_text(json.dumps(cfg))
    tr = _load(os.path.join(ROOT, "traffic", "mixed_rhs.json"))
    tr.update(sample=1, sample_from=1)
    (root / "traffic" / "mixed_rhs.json").write_text(json.dumps(tr))
    (root / "limits" / f"{TINY}.json").write_text(json.dumps(LIMITS))
    bench = _load(os.path.join(REPO, "BENCHMARK.json"))
    bench["workloads"] = [dict(w, name=TINY, config="tiny_mixed")
                          for w in bench["workloads"] if w["name"] == CELL]
    for key in ("end_to_end", "per_layer"):
        kept = []
        for m in bench[key]:
            if "workloads" not in m:
                kept.append(m)
            elif CELL in m["workloads"]:
                kept.append(dict(m, workloads=[TINY]))
        bench[key] = kept
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    return str(path), str(root)


def run_tiny(tiny_mixed, seconds=0.5):
    bench, root = tiny_mixed
    out = io.StringIO()
    with redirect_stdout(out):
        rc = run.main(["--workload", TINY, "--seed", str(SEED), "--seconds", str(seconds)],
                      benchmark=bench, root=root, device="cpu", require_card=False)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_last_line(tiny_mixed):
    line = run_tiny(tiny_mixed)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert set(line["metrics"]) == {"solve_s", "peak_gib", "setup_s"}
    assert set(line["checks"]) == set(LIMITS)
    for k, c in line["checks"].items():
        assert c["value"] <= c["limit"] == LIMITS[k]
    assert line["card"]["stats"]["pcg_iters"] > 0  # outer iterations, mixed_iters.mixed


def _pcg_then(fault):
    import homogenization_jl_tpu_torch.solver.multigrid as mg

    orig = mg.mixed_precision_pcg

    def pcg(*args, **kwargs):
        x, hist = orig(*args, **kwargs)
        fault(x)
        return x, hist

    return pcg


def _half_left_out(x):
    x[: len(x) // 2] = 0


def _one_row_altered(x):
    x[3] += 1e-3 * x.abs().max()


def _unchanged_programs(orig):
    def programs(outer, inner):
        init, _ = orig(outer, inner)
        return init, lambda x, r, p, rz, su: (x, r, p, rz, outer._pcg_rnorm(r))

    return programs


@pytest.mark.parametrize("name", ["step returns its state unchanged",
                                  "half the answer left out",
                                  "an answer altered where it is produced"])
def test_fault_reads_not_correct(tiny_mixed, monkeypatch, name):
    import homogenization_jl_tpu_torch.solver.multigrid as mg

    if name.startswith("step"):
        monkeypatch.setattr(mg.MultigridSolver, "_mixed_pcg_programs",
                            _unchanged_programs(mg.MultigridSolver._mixed_pcg_programs))
    else:
        fault = _half_left_out if name.startswith("half") else _one_row_altered
        monkeypatch.setattr(mg, "mixed_precision_pcg", _pcg_then(fault))
    line = run_tiny(tiny_mixed)
    assert line["correct"] is False, name
    assert line["failed"] >= 1
    if name.startswith("step"):
        assert line["checks"]["unconverged"]["value"] >= 1


def test_control_held_in_float32_fails_and_program_passes(tiny_mixed):
    bench, root = tiny_mixed
    out = io.StringIO()
    with redirect_stdout(out):
        control.main(["--workload", TINY, "--seeds", "5", "6", "--faults"], benchmark=bench,
                     root=root, device="cpu")
    lines = [json.loads(s) for s in out.getvalue().strip().splitlines()]
    summary = lines[-1]
    assert summary["lower"]["residual"] <= LIMITS["residual"] / 5
    assert summary["control_least"]["residual"] > 5 * LIMITS["residual"]
    for r in lines[:-1]:
        faults = r["faults"]
        assert faults["altered"][0][0]["copy_gap"] > LIMITS["copy_gap"]
        assert faults["half"][0][0]["residual"] > LIMITS["residual"]
        assert faults["unchanged_step"][1]["unconverged"] >= 1


def test_nothing_loads_jax(tiny_mixed):
    bench, root = tiny_mixed
    code = ("import sys, json; from hzbench import run; "
            f"rc = run.main(['--workload', '{TINY}', '--seed', '7', '--seconds', '0.2'], "
            f"benchmark={bench!r}, root={root!r}, device='cpu', require_card=False); "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules}))); sys.exit(rc)")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    tops = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert "homogenization_jl_tpu_torch" in tops
    assert not tops & set(run.FORBIDDEN)


@pytest.mark.parametrize("kind, nbytes", [("downcast_scale", 16), ("downcast", 12),
                                          ("upcast", 12)])
def test_mixed_boundary_bytes(kind, nbytes):
    N = 642_981_888
    w = mixed_boundary.work(N, kind)
    assert w.bytes == nbytes * N
    assert w.flops == (N if kind == "downcast_scale" else 0)
    # bandwidth bound at every size: at 190,513,152 entries (PERF.md's K15
    # row) downcast_scale's bound is 0.910 ms and upcast's 0.682 ms
    t, which = bound_seconds(mixed_boundary.work(190_513_152, kind), "float32")
    assert which == "bytes"
    assert round(1e3 * t, 3) == {"downcast_scale": 0.910, "downcast": 0.682,
                                 "upcast": 0.682}[kind]


def test_mixed_boundary_describe():
    import torch

    c = torch.zeros(3, 5, dtype=torch.float64)
    s = torch.ones(3, 5, dtype=torch.float32)
    assert mixed_boundary.describe(c, s) == dict(N=15, kind="downcast_scale", itemsize=4)
    assert mixed_boundary.describe(c) == dict(N=15, kind="downcast", itemsize=4)
    z = torch.zeros(7, dtype=torch.float32)
    assert mixed_boundary.resolve(mixed_boundary.describe_upcast(z), {}) == dict(
        N=7, kind="upcast", itemsize=4)


# -- the new readers on hand-made traces (test_hzbench_spans.py's form) -- #
def mixed_events(with_spans=True):
    """A window of 100 us holding one mixed solve of two outer steps (38
    and 47 us), each a downcast and an upcast (one kernel each inside their
    op spans: 23.5 + 24 and 12 + 21.5 us of device time) and, as a
    solve_field window would hold, a field's set-up before it
    (hz.coefficients [101, 103), hz.coarse_setup [103, 113) with
    hz.coefficients and hz.lambda_max nested in it) while a kernel with no
    op span keeps the device busy."""
    from hzbench import trace

    ev = [_x(trace.WINDOW, "user_annotation", 100, 100),
          _x("hzbench.solve", "user_annotation", 100, 99.8)]
    ev += _launch(100.2, 1, "coefficients_kernel", 100.8, 15.7)
    ev += _launch(116, 2, "downcast_scale_vec_kernel", 116.5, 23.5)
    ev += _launch(140, 3, "upcast_vec_kernel", 140, 12)
    ev += _launch(153.5, 4, "downcast_scale_vec_kernel", 154, 24)
    ev += _launch(178, 5, "upcast_vec_kernel", 178, 21.5)
    if with_spans:
        ev += [_x("hz.coefficients", "cpu_op", 101, 2),
               _x("hz.coarse_setup", "cpu_op", 103, 10),
               _x("hz.coefficients", "cpu_op", 104, 2),
               _x("hz.lambda_max", "cpu_op", 107, 3),
               _x("hz.mixed_pcg", "cpu_op", 114, 86),
               _x("hz.mixed_iter", "cpu_op", 115, 38),
               _x("hz.mixed_iter", "cpu_op", 153, 47)]
        for t, name in ((116, "downcast_scale"), (140, "upcast"), (153.5, "downcast_scale"),
                        (178, "upcast")):
            ev.append(_x(f"hz.op.{name}", "cpu_op", t - 0.2, 1.5))
    return ev


N_CAST = 1_000_000
DOWN = dict(N=N_CAST, kind="downcast_scale", itemsize=4)
UP = dict(N=N_CAST, kind="upcast", itemsize=4)


def test_mixed_readers_read_the_trace():
    from hzbench import trace
    from hzbench.cell import metric_reader

    tl = trace.Timeline(mixed_events())
    assert tl.sound
    name = "mixed_boundary_roofline.mixed"
    run = _Run(tl, {name: [DOWN, UP, DOWN, UP]}, {"pcg_iters": 2.0})
    assert metric_reader("mixed_iter_ms.mixed", ROOT)(run) == pytest.approx(0.0425)
    assert metric_reader("mixed_iters.mixed", ROOT)(run) == 2.0
    bound = 2 * (bound_seconds(mixed_boundary.work(**DOWN), "float32")[0]
                 + bound_seconds(mixed_boundary.work(**UP), "float32")[0])
    assert metric_reader(name, ROOT)(run) == pytest.approx(100 * bound / 81e-6)
    # the set-up's union [101, 113), nested spans once
    assert metric_reader("field_setup_ms.solve_field", ROOT)(run) == pytest.approx(0.012)


def test_mixed_readers_read_nothing_from_a_program_without_them():
    """The parent's program opens none of the new spans: each new reader of
    a span returns None and raises nothing, as does mixed_iters.mixed where
    the window gave no stats."""
    from hzbench import trace
    from hzbench.cell import metric_reader

    tl = trace.Timeline(mixed_events(with_spans=False))
    assert tl.sound
    run = _Run(tl, {"mixed_boundary_roofline.mixed": [DOWN, UP, DOWN, UP]})
    for name in ("mixed_iter_ms.mixed", "mixed_iters.mixed", "mixed_boundary_roofline.mixed",
                 "element_apply_roofline.mixed", "field_setup_ms.solve_field",
                 "reads_per_solve.mixed", "launches_per_solve.mixed", "pcg_iters.solve_field",
                 "pcg_iter_ms.solve_field", "coarse_solve_ms.solve_field",
                 "reads_per_solve.solve_field", "launches_per_solve.solve_field",
                 "element_apply_roofline.solve_field"):
        assert metric_reader(name, ROOT)(run) is None
        assert metric_reader(name, ROOT)(_Run(None)) is None


@pytest.mark.parametrize("twin, of", [
    ("launches_per_solve.mixed", "launches_per_solve"),
    ("reads_per_solve.mixed", "reads_per_solve"),
    ("pcg_iters.solve_field", "pcg_iters"),
    ("pcg_iter_ms.solve_field", "pcg_iter_ms"),
    ("coarse_solve_ms.solve_field", "coarse_solve_ms.solve"),
    ("reads_per_solve.solve_field", "reads_per_solve"),
    ("launches_per_solve.solve_field", "launches_per_solve"),
    ("element_apply_roofline.solve_field", "element_apply_roofline.solve"),
    ("idle_share.solve_field", "idle_share.solve")])
def test_new_cells_read_as_the_solve_cell(twin, of):
    """Each metric of the new cells reads a solve window as the solve
    cell's metric of the same quantity does."""
    from hzbench import trace
    from hzbench.cell import metric_reader

    tl = trace.Timeline(solve_events())
    stats = dict(pcg_iters=6.0, pcg_iter_ms=59.0, launches_per_solve=2775.0)

    def run(name):
        return _Run(tl, {name: [APPLY, APPLY]}, stats)

    want = metric_reader(of, ROOT)(run(of))
    assert want is not None
    assert metric_reader(twin, ROOT)(run(twin)) == want


def test_solve_cell_fixture_reads_its_own_cells():
    """hzbench/conftest.py hands tests/conftest.py's ``tiny`` the benchmark
    of the two cells it maps: their configurations, and every metric of
    theirs with its list cut to them."""
    from hzbench.conftest import known_cells

    from . import conftest as tiny

    bench = _load(os.path.join(REPO, "BENCHMARK.json"))
    cells = {tiny.CELL, tiny.SIGMA_CELL}
    got = known_cells(bench, cells)
    assert [w["name"] for w in got["workloads"]] == [tiny.CELL, tiny.SIGMA_CELL]
    assert {c["name"] for c in got["configs"]} == {"cb3d_n32_r4_f32", "ms3d_n1_r4_f64"}
    for key in ("end_to_end", "per_layer"):
        theirs = [m for m in bench[key] if "workloads" not in m or cells & set(m["workloads"])]
        assert [m["name"] for m in got[key]] == [m["name"] for m in theirs]
        for m in got[key]:
            assert set(m.get("workloads", cells)) <= cells
    assert CELL in [w["name"] for w in bench["workloads"]]  # the file itself is left whole
