"""The readers of the program's spans (spans.py) on hand-made Chrome
traces: span rooflines against the kernel-name ones, the pairing of launch
calls with device operations, idle attribution over every gap, units of
work from the trace, and a program without spans (the parent's)."""

import os

import pytest
import torch

from hzbench import spans, trace
from hzbench.cell import metric_reader
from hzbench.counts import bound_seconds, element_apply
from hzbench.readers import roofline

from .conftest import ROOT


def _x(name, cat, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _launch(ts, corr, kernel, k0, kdur, span=None, ldur=1.0):
    """A launch call at ``ts`` (inside a span of its own when named: the
    program's spans are operator events) and its device operation at
    ``k0``."""
    ev = [_x("cudaLaunchKernel", "cuda_runtime", ts, ldur, corr=corr),
          _x(kernel, "kernel", k0, kdur, tid=7, corr=corr)]
    if span is not None:
        ev.append(_x(span, "cpu_op", ts - 0.5, 2))
    return ev


def solve_events(extra=()):
    """A window of two solves: in each an element apply (one kernel inside
    hz.op.element_apply), a combine, and a coarse solve with a host read;
    every gap ends with a late launch (the device waited on the host)."""
    ev = [_x(trace.WINDOW, "user_annotation", 100, 200)]
    for i, t in enumerate((100, 200)):
        c = 10 * i
        ev += [_x("hzbench.solve", "user_annotation", t, 95),
               _x("hz.pcg", "cpu_op", t + 1, 90),
               _x("hz.coarse_solve", "cpu_op", t + 40, 30),
               _x("hz.read", "cpu_op", t + 50, 12)]
        ev += _launch(t + 2, c + 1, "element_apply_kernel<float>", t + 3, 20,
                      span="hz.op.element_apply")
        ev += _launch(t + 5, c + 2, "structured_combine_kernel<float>", t + 23, 10,
                      span="hz.op.combine_structured")
        ev += _launch(t + 41, c + 3, "lattice_apply_kernel", t + 41.5, 18)
        # the read: the device idles from t + 59.5 until the next launch
        ev += _launch(t + 70, c + 4, "dot_kernel", t + 70.5, 20)
    return ev + list(extra)


class _Run:
    def __init__(self, tl, logs=None, stats=None):
        self.timeline, self.call_logs, self.stats = tl, logs or {}, stats or {}


STACK = torch.zeros(2, 10, 10)
STACK.view(-1)[:50] = 1.0
APPLY = dict(E=1000, n=10, P=2, itemsize=4, stack=STACK)  # a call's summary
WORK = element_apply.work(E=1000, n=10, P=2, itemsize=4, stack_nnz=50)


def test_span_roofline_equals_the_kernel_name_roofline():
    tl = trace.Timeline(solve_events())
    assert tl.sound
    run = _Run(tl, {"m": [APPLY, APPLY]})
    by_kernel = roofline(run, name="m", kernel="element_apply_kernel", count="element_apply",
                         calls=[])
    by_span = spans.roofline(run, "m", ["hz.op.element_apply"], "element_apply")
    assert by_kernel is not None and by_span == pytest.approx(by_kernel, rel=1e-12)
    combine = dict(E=1000, n=10, itemsize=4, mask=False)
    run = _Run(tl, {"c": [combine, combine]})
    assert spans.roofline(run, "c", ["hz.op.combine_structured", "hz.op.constrain_structured"],
                          "structured_combine") == pytest.approx(roofline(
                              run, name="c", kernel="structured_combine_kernel",
                              count="structured_combine", calls=[]), rel=1e-12)


def test_span_roofline_reads_two_kernels_of_another_name():
    ev = [e for e in solve_events() if e.get("args", {}).get("correlation") != 1]
    # the first apply split in two kernels that no kernel-name metric
    # knows, both launched inside its span [101.5, 103.5)
    ev += _launch(101.6, 0, "apply_part_a", 103, 12, ldur=0.7)
    ev += _launch(102.4, 1, "apply_part_b", 115, 8, ldur=0.7)
    tl = trace.Timeline(ev)
    assert tl.sound
    run = _Run(tl, {"m": [APPLY, APPLY]})
    assert roofline(run, name="m", kernel="element_apply_kernel", count="element_apply",
                    calls=[]) is None
    got = spans.roofline(run, "m", ["hz.op.element_apply"], "element_apply")
    seconds, counts = spans.op_device_seconds(tl)
    assert seconds["hz.op.element_apply"] == pytest.approx(40e-6)  # 12 + 8 + 20
    assert counts["hz.op.element_apply"] == 2
    assert got == pytest.approx(
        100 * 2 * bound_seconds(WORK, "float32")[0] / 40e-6)


def test_span_roofline_reads_nothing_when_counts_differ_or_unsound():
    # a device operation with no launch call in the window
    tl = trace.Timeline(solve_events([_x("stray_kernel", "kernel", 290, 1, tid=7, corr=99)]))
    assert tl.sound and spans.op_device_seconds(tl) is None
    assert spans.roofline(_Run(tl, {"m": [APPLY, APPLY]}), "m", ["hz.op.element_apply"],
                          "element_apply") is None
    # a launch whose device operation was lost
    tl = trace.Timeline(solve_events([_x("cudaLaunchKernel", "cuda_runtime", 280, 1, corr=98)]))
    assert not tl.sound
    assert spans.roofline(_Run(tl, {"m": [APPLY, APPLY]}), "m", ["hz.op.element_apply"],
                          "element_apply") is None
    # one span per logged call, or nothing
    tl = trace.Timeline(solve_events())
    assert spans.roofline(_Run(tl, {"m": [APPLY]}), "m", ["hz.op.element_apply"],
                          "element_apply") is None


def test_idle_counts_every_gap():
    """599 gaps of 1 us inside one coarse solve, and three longer ones
    outside it (11, 90 and 5 us): the breakdown's 500 longest miss a
    hundred of the short ones, the span reader none."""
    ev = [_x(trace.WINDOW, "user_annotation", 0, 2000),
          _x("hzbench.solve", "user_annotation", 0, 1990),
          _x("hz.coarse_solve", "cpu_op", 10, 1800)]
    t = 10.0
    for i in range(600):
        ev += _launch(t + 0.5, i, "k", t + 1, 2)
        t += 3
    ev += _launch(1900, 1000, "k", 1900, 95)
    tl = trace.Timeline(ev)
    assert tl.sound and len(tl.gaps) > 600
    idle = spans.idle_by_span(tl)
    assert idle == {"hz.coarse_solve": pytest.approx(599e-6), None: pytest.approx(106e-6)}
    assert dict(tl.idle_by_host(10))["hz.coarse_solve"] == pytest.approx(497e-6)
    ms = spans.idle_ms(_Run(tl), "i", "hzbench.solve", "hz.coarse_solve")
    assert ms == pytest.approx(0.599)


def test_units_come_from_the_trace_not_the_stats():
    tl = trace.Timeline(solve_events())
    run = _Run(tl, stats={"solves": 99})
    assert spans.span_count(run, "r", "hzbench.solve", "hz.read") == 1.0
    assert spans.span_ms(run, "c", "hzbench.solve", "hz.coarse_solve") == pytest.approx(0.030)
    # the gap of each read: [t + 59.5, t + 70.5)
    assert spans.idle_ms(run, "i", "hzbench.solve", "hz.coarse_solve") == pytest.approx(0.011)
    idle = spans.idle_by_span(tl)
    assert idle["hz.read"] == idle["hz.coarse_solve"] == pytest.approx(22e-6)
    assert spans.span_count(run, "e", "hz.estimate", "hz.read") is None


def test_nested_spans_of_one_name_count_the_outermost():
    ev = solve_events([_x("hz.coarse_solve", "cpu_op", 145, 10),
                       _x("hz.coarse_solve", "cpu_op", 245, 10)])
    tl = trace.Timeline(ev)
    assert spans.span_ms(_Run(tl), "c", "hzbench.solve", "hz.coarse_solve") == \
        pytest.approx(0.030)


def test_a_program_without_spans_reads_nothing():
    ev = [e for e in solve_events() if not e["name"].startswith("hz.")]
    tl = trace.Timeline(ev)
    assert tl.sound
    run = _Run(tl, {n: [APPLY, APPLY] for n in ("element_apply_roofline.solve",)})
    for name in ("coarse_solve_ms.solve", "coarse_idle_ms.solve", "reads_per_solve",
                 "element_apply_roofline.solve", "structured_combine_roofline.solve",
                 "estimate_setup_ms.lanczos", "reads_per_estimate",
                 "element_apply_roofline.lanczos", "jacobi_cg_step_roofline.lanczos"):
        assert metric_reader(name, ROOT)(run) is None
        assert metric_reader(name, ROOT)(_Run(None)) is None


def test_metric_files_read_the_solve_trace():
    tl = trace.Timeline(solve_events())
    run = _Run(tl, {"element_apply_roofline.solve": [APPLY, APPLY]})
    assert metric_reader("reads_per_solve", ROOT)(run) == 1.0
    assert metric_reader("coarse_solve_ms.solve", ROOT)(run) == pytest.approx(0.030)
    assert metric_reader("element_apply_roofline.solve", ROOT)(run) == pytest.approx(
        spans.roofline(run, "element_apply_roofline.solve", ["hz.op.element_apply"],
                       "element_apply"))
    assert os.path.exists(os.path.join(ROOT, "metrics", "element_apply_roofline.solve.json"))
