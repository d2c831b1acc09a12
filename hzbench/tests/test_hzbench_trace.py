"""The trace arithmetic (trace.py) on a hand-made Chrome trace, and the
call records that a roofline reads."""

import pytest

from hzbench import trace
from hzbench.readers import idle_share, roofline


def _x(name, cat, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def events():
    return [
        _x(trace.WINDOW, "user_annotation", 100, 100),
        _x("hzbench.solve", "user_annotation", 100, 95),
        _x("aten::empty", "cpu_op", 160, 20),
        _x("cudaLaunchKernel", "cuda_runtime", 101, 2, corr=1),
        _x("cudaLaunchKernel", "cuda_runtime", 104, 2, corr=2),
        _x("cudaLaunchKernel", "cuda_runtime", 185, 2, corr=3),
        _x("element_apply_kernel<float>", "kernel", 110, 20, tid=7, corr=1),
        _x("structured_combine_kernel<float>", "kernel", 125, 15, tid=7, corr=2),
        # the host launched this one late: the device waited on it
        _x("element_apply_kernel<float>", "kernel", 190, 5, tid=7, corr=3),
        _x("element_apply_kernel<float>", "kernel", 300, 5, tid=7, corr=9),  # outside
    ]


def test_timeline_arithmetic():
    tl = trace.Timeline(events())
    assert tl.window_s == pytest.approx(100e-6)
    # union [110, 140) and [190, 195): 35 us
    assert tl.busy_s == pytest.approx(35e-6)
    # gaps: [100, 110) and [140, 190), each ending with a kernel whose
    # launch had not returned when the device went idle (waits), [195, 200)
    assert tl.gaps == [(100.0, 10.0), (140.0, 50.0), (195.0, 5.0)]
    assert tl.wait_us == pytest.approx(60.0)
    assert tl.lost_launches == 0
    assert tl.coverage == pytest.approx(0.95) and tl.sound
    assert tl.kernels("element_apply_kernel") == (pytest.approx(25e-6), 2)
    assert tl.top_ops(1) == [["element_apply_kernel<float>", pytest.approx(25e-6)]]
    by_host = dict((n, s) for n, s in tl.idle_by_host())
    # the gaps at 100 and 140 open inside the solve's range, the last one
    # after it closed
    assert by_host == {"hzbench.solve": pytest.approx(60e-6),
                       "host (no range)": pytest.approx(5e-6)}


def test_lost_launch_is_not_sound():
    ev = events() + [_x("cudaLaunchKernel", "cuda_runtime", 150, 2, corr=5)]
    tl = trace.Timeline(ev)
    assert tl.lost_launches == 1 and not tl.sound


class _Run:
    def __init__(self, tl, logs):
        self.timeline, self.call_logs, self.stats = tl, logs, {}


def test_roofline_reads_only_a_sound_matching_trace():
    tl = trace.Timeline(events())
    desc = dict(E=1000, n=100, itemsize=4, mask=False)
    got = roofline(_Run(tl, {"m": [desc]}), name="m", kernel="structured_combine_kernel",
                   count="structured_combine", calls=[])
    # 800 kB at 3.35 TB/s over 15 us
    assert got == pytest.approx(100 * 800e3 / 3.35e12 / 15e-6)
    # two calls logged, one kernel in the trace: nothing to read
    assert roofline(_Run(tl, {"m": [desc, desc]}), name="m", kernel="structured_combine_kernel",
                    count="structured_combine", calls=[]) is None
    assert idle_share(_Run(tl, {}), name="i") == pytest.approx(65.0)


def test_recording_wraps_and_restores():
    import homogenization_jl_tpu_torch.solver.multigrid as mg

    orig = mg.combine_structured
    log = []
    with trace.recording([(mg.__name__, "combine_structured", lambda *a, **k: len(a), log)]):
        assert mg.combine_structured is not orig
        with pytest.raises(Exception):
            mg.combine_structured(None, None)
    assert mg.combine_structured is orig and log == [2]
