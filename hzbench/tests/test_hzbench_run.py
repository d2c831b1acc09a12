"""Whole runs of the harness on the CPU at a small size: the last line's
keys, and ``correct`` false under each fault the solve cells can have,
planted in the program underneath a run (the look for a card skipped).
Runs on the card: test_hzbench_cuda.py and PERF.md."""

import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout

import pytest
import torch

from hzbench import control, run
from homogenization_jl_tpu_torch.solver.multigrid import MultigridSolver

from .conftest import REPO, SIGMA_LIMITS, SIGMA_TINY, TINY, TINY_LIMITS

SEED = 3_000_000_019  # past 2^31: a seed need not fit 32 signed bits


def run_tiny(tiny, seconds=0.5):
    bench, root = tiny
    out = io.StringIO()
    with redirect_stdout(out):
        rc = run.main(["--workload", TINY, "--seed", str(SEED), "--seconds", str(seconds)],
                      benchmark=bench, root=root, device="cpu", require_card=False)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_last_line(tiny):
    line = run_tiny(tiny)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert set(line["metrics"]) == {"solve_s", "peak_gib", "setup_s"}
    for m in line["metrics"].values():
        assert m["value"] > 0 or m["unit"] == "GiB"
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(line["checks"]) == set(TINY_LIMITS)
    for k, c in line["checks"].items():
        assert c["value"] <= c["limit"] == TINY_LIMITS[k]


def _unchanged_step(self, x, r, p, rz, *args, **kwargs):
    return x, r, p, rz, self._pcg_rnorm(r)


def _pcg_then(fault):
    orig = MultigridSolver.pcg

    def pcg(self, *args, **kwargs):
        x, hist = orig(self, *args, **kwargs)
        fault(x)
        return x, hist

    return pcg


def _half_left_out(x):
    x[: len(x) // 2] = 0


def _one_row_altered(x):
    x[3] += 1e-3 * x.abs().max()


@pytest.mark.parametrize("name, attr, fault", [
    ("step returns its state unchanged", "_pcg_step_impl", _unchanged_step),
    ("half the answer left out", "pcg", _pcg_then(_half_left_out)),
    ("an answer altered where it is produced", "pcg", _pcg_then(_one_row_altered)),
])
def test_fault_reads_not_correct(tiny, monkeypatch, name, attr, fault):
    monkeypatch.setattr(MultigridSolver, attr, fault)
    line = run_tiny(tiny)
    assert line["correct"] is False, name
    assert line["failed"] >= 1


def test_control_fails_and_program_passes(tiny):
    bench, root = tiny
    out = io.StringIO()
    with redirect_stdout(out):
        control.main(["--workload", TINY, "--seeds", "5", str(SEED)], benchmark=bench,
                     root=root, device="cpu")
    summary = json.loads(out.getvalue().strip().splitlines()[-1])
    assert summary["lower"]["residual"] <= TINY_LIMITS["residual"]
    assert summary["control_least"]["residual"] > 3 * TINY_LIMITS["residual"]


def test_no_card_no_result(tiny, capsys):
    bench, root = tiny
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = run.main(["--workload", TINY, "--seed", "1", "--seconds", "1"], benchmark=bench,
                  root=root)
    assert rc == 2 and capsys.readouterr().out == ""


def test_benchmark_alone_fails(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files holds
    no program: the run ends with an error and prints no result."""
    import shutil

    shutil.copytree(os.path.join(REPO, "hzbench"), tmp_path / "hzbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    code = ("import sys; from hzbench import run; sys.exit(run.main(['--workload', "
            "'pcg_rhs.cb3d_n32_r4_f32', '--seed', '1', '--seconds', '1'], device='cpu', "
            "require_card=False))")
    env = dict(os.environ, PYTHONPATH="")
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                       text=True, env=env, timeout=120)
    assert p.returncode != 0 and p.stdout == ""
    assert "homogenization_jl_tpu_torch" in p.stderr


def test_nothing_loads_jax(tiny):
    """A whole run in a fresh process: no module whose top-level name is
    jax, jaxlib, flax or homogenization_jl_tpu (compared whole) is loaded."""
    bench, root = tiny
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


def test_reference_loads_nothing_of_the_program():
    code = ("import sys, json; import hzbench.reference.poisson, hzbench.reference.mesh; "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    tops = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert not tops & (set(run.FORBIDDEN) | {"homogenization_jl_tpu_torch"})


def run_sigma_tiny(tiny):
    bench, root = tiny
    out = io.StringIO()
    with redirect_stdout(out):
        rc = run.main(["--workload", SIGMA_TINY, "--seed", str(SEED), "--seconds", "0.1"],
                      benchmark=bench, root=root, device="cpu", require_card=False)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_sigma_last_line(tiny):
    line = run_sigma_tiny(tiny)
    assert line["correct"] is True and line["attempted"] == 1
    assert set(line["metrics"]) == {"sigma_s", "peak_gib", "setup_s"}
    assert set(line["checks"]) == set(SIGMA_LIMITS) and list(line)[-1] == "checks"


def _lanczos_update_unchanged(u, v, v_prev, alpha, beta, out=None):
    return u


def _sigma_altered(fn):
    def estimate(*args, **kwargs):
        sigma, stats = fn(*args, **kwargs)
        stats["sigma_steps"] = [s * (1 + 1e-6) for s in stats["sigma_steps"]]
        return sigma * (1 + 1e-6), stats
    return estimate


@pytest.mark.parametrize("name", ["step returns its state unchanged",
                                  "an answer altered where it is produced"])
def test_sigma_fault_reads_not_correct(tiny, monkeypatch, name):
    import homogenization_jl_tpu_torch.models.multishift as ms

    if name.startswith("step"):
        monkeypatch.setattr(ms, "lanczos_update", _lanczos_update_unchanged)
    else:
        monkeypatch.setattr(ms, "homogenization_multishift",
                            _sigma_altered(ms.homogenization_multishift))
    line = run_sigma_tiny(tiny)
    assert line["correct"] is False, name
