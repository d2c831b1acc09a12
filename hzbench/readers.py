"""The general readers of per-layer metrics. A metric's file
(metrics/<name>.json) names one and gives its parameters; the harness calls
``reader(run, name=<metric>, **parameters)`` after the window. A reader that
finds nothing to read returns None, and the metric is left out of the line;
none returns 0 for a share of a roofline or of a peak.

``run`` is the traffic kind's run object: ``stats`` (its own numbers from
the window: spans, counts), ``timeline`` (trace.Timeline of the traced
window, or None) and ``call_logs`` (per metric, the call summaries that
``calls`` in its file asked for).
"""

from __future__ import annotations

import importlib
import sys

from .counts import bound_seconds

_DTYPE = {4: "float32", 8: "float64"}


def _say(name, msg):
    print(f"hzbench: {name}: {msg}", file=sys.stderr)


def stat(run, name, key, **_):
    """One of the kind's own numbers from the window (``run.stats[key]``)."""
    v = run.stats.get(key)
    return None if v is None else float(v)


def idle_share(run, name, **_):
    """100 (1 - device busy / window) of a sound trace (trace.Timeline)."""
    tl = run.timeline
    if tl is None or not tl.sound:
        _say(name, "no sound trace")
        return None
    return 100.0 * (1.0 - tl.busy_s / tl.window_s)


def roofline(run, name, kernel, count, calls, **_):
    """100 x (least time of the logged calls at the card's peaks) / (device
    time of the kernels named ``kernel``), from a sound trace whose number
    of such kernels equals the number of logged calls (one launch each)."""
    tl = run.timeline
    log = run.call_logs.get(name) or []
    if tl is None or not tl.sound:
        _say(name, "no sound trace")
        return None
    seconds, launches = tl.kernels(kernel)
    if not log or launches != len(log):
        _say(name, f"{launches} '{kernel}' kernels in the trace for {len(log)} calls")
        return None
    mod = importlib.import_module(f"hzbench.counts.{count}")
    cache, bound = {}, 0.0
    for desc in log:
        args = mod.resolve(desc, cache)
        bound += bound_seconds(mod.work(**args), _DTYPE[args["itemsize"]])[0]
    return 100.0 * bound / seconds
