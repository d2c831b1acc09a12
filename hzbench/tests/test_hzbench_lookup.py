"""The harness finds every cell's configuration, traffic mix, limits and
per-layer metrics by the names in BENCHMARK.json, and the file keeps to
the benchmark's format."""

import json
import os
import re

import pytest

from hzbench.cell import find_cell, metric_reader, metric_spec

from .conftest import REPO, ROOT

with open(os.path.join(REPO, "BENCHMARK.json")) as f:
    BENCH = json.load(f)
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    c = find_cell(cell, os.path.join(REPO, "BENCHMARK.json"), ROOT)
    assert c.config["dtype"] in ("float32", "float64")
    assert os.path.exists(os.path.join(ROOT, "kinds", c.traffic["kind"] + ".py"))
    assert c.limits and all(v >= 0 for v in c.limits.values())
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert callable(metric_reader(m["name"], ROOT))


def test_every_metric_has_a_reader_and_its_counts():
    import importlib

    for m in BENCH["per_layer"]:
        spec = metric_spec(m["name"], ROOT)
        if "count" in spec:
            mod = importlib.import_module(f"hzbench.counts.{spec['count']}")
            for module, attr, describe in spec["calls"]:
                assert callable(getattr(mod, describe))
                assert callable(getattr(importlib.import_module(module), attr))


def test_benchmark_format():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["hzbench"] and 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("hzbench/") and os.path.exists(os.path.join(REPO, c["file"]))
        with open(os.path.join(REPO, c["file"])) as f:
            assert json.load(f)["reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4) and len(w["why"]) <= 200
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= set(CELLS)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for cell in CELLS:
        for m in BENCH["per_layer"]:
            if cell in m["workloads"]:
                moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
                assert cell in moved.get("workloads", [cell])
