"""One run of one cell: ``python3 -m hzbench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout.

Set-up (the program's build, the cell's inputs from the seed, one warm-up
solve at the window's shapes) runs from process start to the window, which
measures for ``--seconds`` and closes when the last unit of work returns.
Then the peak memory is read, the program's state freed, and the sampled
answers judged by the plain reference against limits/<cell>.json. The last
line of standard output is one JSON object: with ``--trace 0`` the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics, the device's
busy time and the breakdown of the traced window. The numbers compared are
printed last on standard error and under ``checks``, the line's last key.

The run exits with 2 and prints no result without a CUDA card (or with
fewer than the cell asks for), and with 3 if jax, jaxlib, flax or the JAX
package is loaded when the window has closed.
"""

from __future__ import annotations

import argparse
import importlib
import json
import math
import os
import sys
import time

T_IMPORT = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "homogenization_jl_tpu")


def _process_age() -> float:
    """Seconds since this process started (/proc), or since this module was
    imported where /proc cannot say."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - T_IMPORT


def cache_dirs(checkout: str = CHECKOUT) -> None:
    """Triton's and CUDA's caches in fixed directories inside the checkout
    (nvcc's build already goes to build/kernels/), so that only a cell's
    first run in a checkout compiles."""
    build = os.path.join(checkout, "build")
    os.environ["TRITON_HOME"] = os.path.join(build, "triton")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton", "cache")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(build, "cuda_cache")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card(device):
    """(name, power limit as nvidia-smi gives it)."""
    import subprocess

    import torch

    if device.type != "cuda":
        return "cpu", None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout.split("\n")
        limit = out[device.index or 0].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        limit = None
    return torch.cuda.get_device_name(device), limit


def _fmt(v):
    return v if isinstance(v, (int, float)) and math.isfinite(v) else str(v)


def main(argv=None, *, benchmark="BENCHMARK.json", root=HERE, device="cuda",
         require_card=True):
    ap = argparse.ArgumentParser(prog="hzbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_dirs()

    import torch

    from . import trace as tr
    from .cell import find_cell, metric_reader, metric_spec

    if require_card and not torch.cuda.is_available():
        print("hzbench: no CUDA card", file=sys.stderr)
        return 2
    cell = find_cell(args.workload, benchmark, root)
    if require_card and torch.cuda.device_count() < cell.chips:
        print(f"hzbench: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    dev = torch.device(device)
    kind = importlib.import_module(f"hzbench.kinds.{cell.traffic['kind']}")
    run = kind.Run(cell, args.seed, dev)
    run.setup()
    setup_s = _process_age()

    names = [m["name"] for m in cell.per_layer]
    if not args.trace:
        run.timed(args.seconds)
    else:
        if dev.type != "cuda":
            raise RuntimeError("--trace 1 reads the card's trace")
        for attempt in range(tr.ATTEMPTS):
            logs, targets = {}, []
            for name in names:
                spec = metric_spec(name, root)
                if "calls" in spec:
                    mod = importlib.import_module(f"hzbench.counts.{spec['count']}")
                    logs[name] = []
                    targets += [(m, a, getattr(mod, d), logs[name]) for m, a, d in spec["calls"]]
            with tr.recording(targets):
                run.timeline = tr.profiled(lambda: run.timed(args.seconds, keep=attempt == 0),
                                           lead_s=tr.LEAD_S * 2**attempt)
            run.call_logs = logs
            if run.timeline.sound:
                break
            print(f"hzbench: trace attempt {attempt}: coverage {run.timeline.coverage:.3f}, "
                  f"{run.timeline.lost_launches} launches lost", file=sys.stderr)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    name, limit = card(dev)

    metrics = {}
    if not args.trace:
        e2e = dict(run.end_to_end(), setup_s=setup_s, peak_gib=peak / 2**30)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            v = metric_reader(m["name"], root)(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    run.release()
    t_check = time.perf_counter()
    answers, counts = run.check()
    check_s = time.perf_counter() - t_check
    numbers = {k: max(a[k] for a in answers) if answers else float("inf")
               for k in cell.limits if k not in counts}
    numbers.update(counts)
    fails = [k for k, v in numbers.items() if not v <= cell.limits[k]]
    failed = sum(1 for a in answers if any(not a[k] <= cell.limits[k] for k in cell.limits
                                           if k in a)) \
        + int(counts.get("unconverged", 0))
    correct = bool(answers) and not fails

    found = forbidden_modules()
    if found:
        print(f"hzbench: loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3

    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type, "kind": name,
                   "count": 1, "memory_peak_bytes": int(peak)}
    line = {"correct": correct, "attempted": int(run.attempted), "failed": int(failed),
            "metrics": metrics, "device": device_info}
    if args.trace:
        tl = run.timeline
        device_info.update(busy_s=tl.busy_s, window_s=tl.window_s)
        line["breakdown"] = {"device_ops": tl.top_ops(10), "idle_gaps": tl.idle_by_host(10)}
    line["card"] = {"power_limit": limit, "judged": len(answers), "check_s": check_s,
                    "stats": run.stats}
    line["checks"] = {k: {"value": _fmt(v), "limit": cell.limits[k]} for k, v in numbers.items()}
    for k, v in numbers.items():
        print(f"check {k} {v!r} limit {cell.limits[k]!r} {'ok' if k not in fails else 'FAIL'}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
