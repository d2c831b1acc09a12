"""Host-clock milliseconds per outer iteration of mixed-precision PCG: the
mean duration of the program's ``hz.mixed_iter`` spans in the traced window
(one per outer step, its residual read included: a float64 fine apply, the
combine and K15's casts, one float32 V-cycle, the dots and updates)."""

from hzbench.spans import _say, program

NAME = "mixed_iter_ms.mixed"
SPAN = "hz.mixed_iter"


def read(run):
    spans = program(run, NAME)
    if spans is None:
        return None
    steps = spans.get(SPAN, [])
    if not steps:
        _say(NAME, f"no '{SPAN}' span in the window")
        return None
    return sum(t1 - t0 for t0, t1 in steps) / 1e3 / len(steps)
