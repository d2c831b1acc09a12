"""Find a cell's files by the names BENCHMARK.json gives them."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # BENCHMARK.json entries this cell reports
    per_layer: list


def _load(path):
    with open(path) as f:
        return json.load(f)


def applies(metric: dict, cell: str) -> bool:
    """A metric with a ``workloads`` list is reported in those cells only."""
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, benchmark_path: str = "BENCHMARK.json", root: str = HERE) -> Cell:
    """The cell ``name`` of BENCHMARK.json, with its configuration, traffic
    mix and limits read from their files under ``root``."""
    bench = _load(benchmark_path)
    cells = [w for w in bench["workloads"] if w["name"] == name]
    if len(cells) != 1:
        raise KeyError(f"no workload {name!r} in {benchmark_path}")
    w = cells[0]
    return Cell(
        name=name, chips=int(w["chips"]),
        config_name=w["config"], traffic_name=w["traffic"],
        config=_load(os.path.join(root, "configs", w["config"] + ".json")),
        traffic=_load(os.path.join(root, "traffic", w["traffic"] + ".json")),
        limits=_load(os.path.join(root, "limits", name + ".json")),
        end_to_end=[m for m in bench["end_to_end"] if applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if applies(m, name)],
    )


def metric_reader(name: str, root: str = HERE):
    """``read(run) -> value or None`` of the per-layer metric ``name``:
    metrics/<name>.py's own ``read``, or the reader that
    metrics/<name>.json names, called with the file's parameters."""
    py = os.path.join(root, "metrics", name + ".py")
    if os.path.exists(py):
        spec = importlib.util.spec_from_file_location(f"hzbench_metric_{name}", py)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
    spec = _load(os.path.join(root, "metrics", name + ".json"))
    from . import readers

    fn = getattr(readers, spec["reader"])
    params = {k: v for k, v in spec.items() if k not in ("reader", "about")}
    return lambda run: fn(run, name=name, **params)


def metric_spec(name: str, root: str = HERE) -> dict:
    """metrics/<name>.json (empty for a metric with a .py reader)."""
    path = os.path.join(root, "metrics", name + ".json")
    return _load(path) if os.path.exists(path) else {}
