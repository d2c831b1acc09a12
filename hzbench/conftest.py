"""The harness tests' view of BENCHMARK.json.

tests/conftest.py's ``tiny`` fixture maps each cell of BENCHMARK.json to
its small copy by name, and knows the solve and the sigma cells alone. The
cells added after it (``mixed_rhs``, ``solve_field``) have their own small
copies (tests/test_hzbench_mixed.py). So that fixture reads the benchmark
with the cells it maps, the configurations they use and the metrics
reported in them; no cell's files change.
"""

import os

HERE = os.path.dirname(os.path.abspath(__file__))
TINY_CONFTEST = os.path.join(HERE, "tests", "conftest.py")


def known_cells(bench: dict, cells) -> dict:
    """``bench`` with the cells ``cells`` alone: the metrics with a
    ``workloads`` list keep those of ``cells`` (and go where none is
    left), the configurations those the kept cells use."""
    out = dict(bench)
    out["workloads"] = [w for w in bench["workloads"] if w["name"] in cells]
    used = {w["config"] for w in out["workloads"]}
    out["configs"] = [c for c in bench["configs"] if c["name"] in used]
    for key in ("end_to_end", "per_layer"):
        kept = []
        for m in bench[key]:
            if "workloads" in m:
                m = dict(m, workloads=[c for c in m["workloads"] if c in cells])
                if not m["workloads"]:
                    continue
            kept.append(m)
        out[key] = kept
    return out


def pytest_plugin_registered(plugin, manager):
    """Hand tests/conftest.py's fixture the benchmark of its own cells."""
    path = getattr(plugin, "__file__", None)
    if not path or os.path.abspath(path) != TINY_CONFTEST:
        return
    load, cells = plugin._load, {plugin.CELL, plugin.SIGMA_CELL}

    def _load(p):
        data = load(p)
        return known_cells(data, cells) if os.path.basename(p) == "BENCHMARK.json" else data

    plugin._load = _load
