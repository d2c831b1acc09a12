"""On the card: a traced run of the small cell reads every per-layer
metric from a sound trace, the rooflines at most 100%.

    python3 -m pytest hzbench/tests -m cuda -q
"""

import io
import json
from contextlib import redirect_stdout

import pytest
import torch

from hzbench import run

from .conftest import TINY


@pytest.mark.cuda
def test_traced_run_on_the_card(tiny):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    bench, root = tiny
    out = io.StringIO()
    with redirect_stdout(out):
        rc = run.main(["--workload", TINY, "--seed", "11", "--seconds", "2", "--trace", "1"],
                      benchmark=bench, root=root)
    assert rc == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert line["correct"] is True
    with open(bench) as f:
        wanted = {m["name"] for m in json.load(f)["per_layer"] if TINY in m["workloads"]}
    assert set(line["metrics"]) == wanted
    for name, m in line["metrics"].items():
        if name.endswith("roofline.solve"):
            assert 0 < m["value"] <= 100
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
    assert line["breakdown"]["device_ops"] and line["breakdown"]["idle_gaps"]
