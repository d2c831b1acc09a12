"""The readings that the limits of ``correct`` are set from (never run by
the benchmark's own runs):

    python3 -m hzbench.control --workload <cell> --seeds 11 12 ... [--override JSON]
                               [--control-seeds k]

In one process, for each seed: the cell's inputs, the window's units of
work up to the last judged one (one unit at least), and the reference's
numbers for each judged answer as the program gave it (the lower reading)
and for the control in the program's place (the upper reading), in the
precision below the configuration's:
  solve  the same answer held in bfloat16 (below float32; the program has
         no solve path below float32: its ``direction_dtype`` keeps x and
         the Krylov state in the state's dtype)
  sigma  the plain reference computed in float32 (below float64)
``--override`` sets solver (solve) or driver (sigma) options, e.g.
'{"direction_dtype": "bfloat16"}' to read that path as a program run. One
JSON line per seed, then a summary line.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys

from .run import HERE, cache_dirs


def readings(cell, seeds, device, override=None, control_seeds=None, faults=False):
    """Yield one dict per seed: {"seed", "program": [answers], "control":
    [answers] (the first ``control_seeds`` seeds; all by default),
    "counts", "stats", and with ``faults`` the kind's fault readings at the
    cell's size}."""
    import torch

    key = "solver" if cell.traffic["kind"] == "solve" else "driver"
    if override:
        cell.traffic = dict(cell.traffic, **{key: dict(cell.traffic.get(key, {}), **override)})
    kind = importlib.import_module(f"hzbench.kinds.{cell.traffic['kind']}")
    run = kind.Run(cell, seeds[0], torch.device(device))
    run.setup()
    for i, seed in enumerate(seeds):
        run.reseed(seed)
        run.timed(0.0)
        while any(j not in run.kept for j in getattr(run, "sample", ())):
            run.timed(0.0)
        answers, counts = run.check()
        ctrl = run.check(control=True)[0] if control_seeds is None or i < control_seeds else []
        out = dict(seed=seed, program=answers, control=ctrl, counts=counts, stats=run.stats)
        if faults and hasattr(run, "faults"):
            out["faults"] = run.faults()
        yield out


def main(argv=None, *, benchmark="BENCHMARK.json", root=HERE, device="cuda"):
    ap = argparse.ArgumentParser(prog="hzbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--override", default="",
                    help="JSON: options over the traffic's solver (solve) or driver (sigma)")
    ap.add_argument("--control-seeds", type=int, default=None,
                    help="read the control on the first k seeds only")
    ap.add_argument("--faults", action="store_true",
                    help="also read the kind's planted faults at the cell's size")
    args = ap.parse_args(argv)
    cache_dirs()
    from .cell import find_cell

    cell = find_cell(args.workload, benchmark, root)
    override = json.loads(args.override) if args.override else None
    worst_p, least_c = {}, {}
    for r in readings(cell, args.seeds, device, override, args.control_seeds, args.faults):
        print(json.dumps(r), flush=True)
        for a in r["program"]:
            for k in cell.limits:
                if k in a:
                    worst_p[k] = max(worst_p.get(k, 0.0), a[k])
        for a in r["control"]:
            for k in cell.limits:
                if k in a:
                    least_c[k] = min(least_c.get(k, float("inf")), a[k])
    print(json.dumps({"lower": worst_p, "control_least": least_c}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
