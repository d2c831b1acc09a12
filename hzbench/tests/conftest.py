"""A small copy of the benchmark's files for CPU runs of the harness: the
solve cell's configuration cut to a box of 4^3 cubes and 3 levels, its
traffic with one judged answer; the sigma cell's cut to one refinement and
20 Lanczos steps; and limits for those sizes."""

import json
import os
import shutil

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(ROOT)
CELL = "pcg_rhs.cb3d_n32_r4_f32"
TINY = "pcg_rhs.tiny32"
SIGMA_CELL = "lanczos188.ms3d_n1_r4_f64"
SIGMA_TINY = "lanczos_tiny.ms_tiny"
# float64, one refinement, 20 steps: the program reads ~1e-8 float32 errors
# (CPU), a float32 computation about 1
SIGMA_LIMITS = {"sigma_err": 1e-2}
# float32 at 4^3 cubes, 3 levels: the program reads ~3.5e-5 and the
# bfloat16 control ~2e-2 (CPU, seeds 5 and 6)
TINY_LIMITS = {"residual": 1e-3, "copy_gap": 1e-6, "unconverged": 0}


def _load(path):
    with open(path) as f:
        return json.load(f)


@pytest.fixture
def tiny(tmp_path):
    """(benchmark path, root) of the small copy."""
    root = tmp_path / "hz"
    for d in ("configs", "traffic", "limits"):
        (root / d).mkdir(parents=True)
    shutil.copytree(os.path.join(ROOT, "metrics"), root / "metrics")
    cfg = _load(os.path.join(ROOT, "configs", "cb3d_n32_r4_f32.json"))
    cfg.update(base_cells=4, levels=3)
    cfg["solver"] = dict(cfg["solver"], coarse_mg_dense_limit=4)
    (root / "configs" / "tiny32.json").write_text(json.dumps(cfg))
    tr = _load(os.path.join(ROOT, "traffic", "pcg_rhs.json"))
    tr.update(sample=1, sample_from=1, max_iters=20)
    (root / "traffic" / "pcg_rhs.json").write_text(json.dumps(tr))
    (root / "limits" / f"{TINY}.json").write_text(json.dumps(TINY_LIMITS))
    cfg = _load(os.path.join(ROOT, "configs", "ms3d_n1_r4_f64.json"))
    cfg.update(refinements=1)
    cfg["driver"] = dict(cfg["driver"], lanczos_iters=20)
    (root / "configs" / "ms_tiny.json").write_text(json.dumps(cfg))
    tr = _load(os.path.join(ROOT, "traffic", "lanczos188.json"))
    tr["warmup"] = {"lanczos_iters": 2}
    (root / "traffic" / "lanczos_tiny.json").write_text(json.dumps(tr))
    (root / "limits" / f"{SIGMA_TINY}.json").write_text(json.dumps(SIGMA_LIMITS))
    bench = _load(os.path.join(REPO, "BENCHMARK.json"))
    names = {CELL: (TINY, "tiny32", "pcg_rhs"),
             SIGMA_CELL: (SIGMA_TINY, "ms_tiny", "lanczos_tiny")}
    bench["workloads"] = [dict(w, name=names[w["name"]][0], config=names[w["name"]][1],
                               traffic=names[w["name"]][2]) for w in bench["workloads"]]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [names[c][0] for c in m["workloads"]]
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    return str(path), str(root)
