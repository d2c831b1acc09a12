"""The port's entry points on the CPU, small: ``homogenization_jl_tpu_torch.
bench`` (bench.py's child), ``run_mixed_pcg`` and ``run_slab --kind mixed``.

  * the bench at BENCH_N=2 and two levels (``BENCH_DEVICE=cpu``): a partial
    line, then the final line with bench.py's metric, unit and every key of
    its ``detail`` (and the port's: power limit, the precision it ran, the
    repeats and their spread), in the "fmg_pcg" (default), "pcg" and
    "vcycle" modes, the last with ``BENCH_DIRECTION_DTYPE=bfloat16``;
  * run_mixed_pcg's lines (the JAX script's) and a solve to its tolerance;
  * run_slab's torchrun entry point with ``--kind mixed`` on one gloo rank:
    one JSON line, the slab history equal to the single-device one."""

import json
import socket

import pytest

from homogenization_jl_tpu_torch import bench, run_mixed_pcg
from homogenization_jl_tpu_torch.parallel import run_slab

# bench.py's detail keys (BENCH_r05.json), then the solve's
COMMON_KEYS = {"dofs", "sec_per_vcycle", "base_elements", "n_local", "levels", "coarse",
               "smoother", "dtype", "apply_precision", "smooth_precision", "device",
               "residual_norm", "degraded"}
PCG_KEYS = {"solve_mode", "iters_to_1e3", "sec_to_1e3", "iters_to_1e4", "sec_to_1e4",
            "sec_per_iter", "dof_per_s_solve", "fmg_start_rel_residual"}
VCYCLE_KEYS = {"solve_mode", "iters_to_1e3", "sec_to_1e3", "iters_to_1e4", "sec_to_1e4",
               "sec_per_iter"}
PORT_KEYS = {"power_limit", "precision_run", "precision_note", "direction_dtype",
             "sec_per_vcycle_repeats", "sec_per_vcycle_spread"}


def _bench(monkeypatch, capsys, **knobs):
    monkeypatch.setenv("BENCH_DEVICE", "cpu")
    monkeypatch.setenv("BENCH_N", "2")
    monkeypatch.setenv("BENCH_LEVELS", "2")
    for k, v in knobs.items():
        monkeypatch.setenv(f"BENCH_{k}", v)
    bench.main()
    lines = [json.loads(ln) for ln in capsys.readouterr().out.strip().splitlines()]
    assert len(lines) == 2
    for line in lines:
        assert line["metric"] == "gmg_vcycle_dof_per_s_per_chip_3d_checkerboard"
        assert line["unit"] == "DOF/s" and line["value"] > 0
        assert line["vs_baseline"] == line["value"] / bench.REFERENCE_CPU_DOF_PER_S
    assert lines[0]["detail"]["partial"] is True
    return lines[1]["detail"]


@pytest.mark.parametrize("mode", ["fmg_pcg", "pcg"])
def test_bench_pcg_modes_print_the_line(monkeypatch, capsys, mode):
    d = _bench(monkeypatch, capsys, SOLVE_MODE=mode)
    assert COMMON_KEYS | PCG_KEYS | PORT_KEYS <= set(d), set(d) ^ (COMMON_KEYS | PCG_KEYS)
    assert "partial" not in d and d["degraded"] is None
    assert (d["dofs"], d["base_elements"], d["n_local"], d["levels"]) == (480, 48, 10, 2)
    assert (d["coarse"], d["smoother"], d["dtype"], d["device"]) == ("chol", "chebyshev",
                                                                     "float32", "cpu")
    assert d["precision_run"] == "fp32 CUDA cores" and d["power_limit"] is None
    assert len(d["sec_per_vcycle_repeats"]) == 10 and len(d["sec_per_iter_repeats"]) == 26
    assert d["iters_to_1e3"] is not None and d["iters_to_1e4"] >= d["iters_to_1e3"]
    h = d["history"]  # relative residuals after each PCG iteration
    assert h[d["iters_to_1e3"] - 1] < 1e-3 and h[d["iters_to_1e4"] - 1] < 1e-4
    if mode == "fmg_pcg":
        assert 0 < d["fmg_start_rel_residual"] < 1
    else:
        assert d["fmg_start_rel_residual"] is None


def test_bench_vcycle_mode_with_bf16_directions(monkeypatch, capsys):
    d = _bench(monkeypatch, capsys, SOLVE_MODE="vcycle", DIRECTION_DTYPE="bfloat16",
               LEVELS="3", CYCLES="4", MAX_CYCLES="20")
    assert COMMON_KEYS | VCYCLE_KEYS | PORT_KEYS <= set(d)
    assert (d["smoother"], d["direction_dtype"], d["n_local"]) == ("cg_exact", "bfloat16", 35)
    assert d["iters_to_1e3"] is not None and d["sec_per_iter"] == d["sec_per_vcycle"]
    assert len(d["sec_per_vcycle_repeats"]) == 4


def test_run_mixed_pcg_prints_the_scripts_lines(capsys):
    x, hist = run_mixed_pcg.main(["2", "3", "30", "1e-10"], device="cpu")
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0] == "n=2 levels=3 dofs=1,680 slab=0"
    assert out[1].startswith("setup (coeffs+coarse+lam_max): ")
    assert out[2].startswith("compile+2 iters: ")
    assert out[3].startswith("  iter 0: |r| = ") and out[3].endswith("rel = 1.0000e+00")
    assert len(out) == 3 + len(hist) + 1
    assert out[-1].startswith(f"mixed pcg: {len(hist) - 1} iters, rel residual ")
    assert hist[-1] <= 1e-10 * hist[0] and x.shape == (48, 35)


def test_run_slab_mixed_entry_point_on_one_cpu_rank(monkeypatch, capsys):
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    for k, v in dict(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK="0",
                     WORLD_SIZE="1", LOCAL_RANK="0").items():
        monkeypatch.setenv(k, v)
    run_slab.main(["--kind", "mixed", "--device", "cpu", "--n", "4", "--levels", "2",
                   "--iters", "30", "--tol", "1e-10", "--compare"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (out["slabs"], out["device"], out["coarse"], out["dofs"]) == (1, "cpu", "chol", 3840)
    assert out["history"] == out["history_single"] and out["x_rel_diff"] == 0.0
    assert out["history"][-1] <= 1e-10 * out["history"][0]
    assert out["launches"] == {k: 0 for k in out["launches"]}  # CPU: plain forms only
