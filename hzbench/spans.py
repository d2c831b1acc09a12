"""The program's own spans in a traced window.

While a profiler records, homogenization_jl_tpu_torch opens a range at each
of its layer boundaries (``hz.*``: utils/logging.py::span). They land in the
trace on the calling thread, the window's, so ``trace.Timeline.host`` holds
them beside the runtime's launch calls. The per-layer metrics that read them
(metrics/<name>.py) share these rules:

  * units of work are counted in the same traced window: the benchmark's
    ``hzbench.solve`` ranges, or the program's ``hz.estimate`` spans;
  * spans of one name may nest (the coarse "mg" solve holds a second
    solver): a duration sums the outermost spans of the name only;
  * an idle gap of the device belongs to every span open on the window's
    thread when it began; all of ``Timeline.gaps`` is walked;
  * a device operation belongs to the innermost ``hz.op.*`` span around the
    call that launched it. The launch calls (the window's runtime and driver
    calls that launch a kernel, a copy or a memset) are paired in order with
    ``Timeline.device``'s launches, by correlation id (or in start order:
    the program launches on one stream); nothing is read unless the two
    counts agree and the trace is sound.

A window without any ``hz.*`` span (a program that opens none) reads
nothing: every reader here returns None for it, and never raises.
"""

from __future__ import annotations

import importlib
import json
import os
import sys

from .counts import bound_seconds
from .readers import _DTYPE

PREFIX = "hz."
OP = "hz.op."
LAUNCHES = ("LaunchKernel", "Memcpy", "Memset")


def _say(name, msg):
    print(f"hzbench: {name}: {msg}", file=sys.stderr)


def window_ranges(tl, prefix: str = PREFIX):
    """{name: [(t0, t1)]} of the window's host ranges whose name starts
    with ``prefix``, in start order (us)."""
    out = {}
    for t0, t1, name in tl.host:
        if name.startswith(prefix) and tl.w0 <= t0 < tl.w1:
            out.setdefault(name, []).append((t0, t1))
    return out


def outermost(intervals):
    """The intervals (in start order) that no other one of them encloses."""
    out, reach = [], float("-inf")
    for t0, t1 in sorted(intervals, key=lambda s: (s[0], -s[1])):
        if t0 >= reach:
            out.append((t0, t1))
            reach = t1
    return out


def program(run, name):
    """The ``hz.*`` ranges of a sound traced window, or None (said on
    standard error) where there is no such window or the program opened
    no span in it."""
    tl = run.timeline
    if tl is None or not tl.sound:
        _say(name, "no sound trace")
        return None
    spans = window_ranges(tl)
    if not spans:
        _say(name, "the program opened no hz.* span in the window")
        return None
    return spans


def units(run, name, unit):
    """How many outermost ``unit`` ranges (``hzbench.solve``, ``hz.estimate``)
    the traced window holds; None for none."""
    found = window_ranges(run.timeline, unit).get(unit, [])
    k = len(outermost(found))
    if not k:
        _say(name, f"no '{unit}' range in the window")
        return None
    return k


def _open_at(events, points):
    """For each of ``points`` (ascending), the names of the ranges of
    ``events`` ([(t0, t1, name)], properly nested, in (t0, -t1) order)
    open at that point: t0 <= point < t1."""
    out, stack, i = [], [], 0
    for p in points:
        while i < len(events) and events[i][0] <= p:
            while stack and stack[-1][1] <= events[i][0]:
                stack.pop()
            stack.append(events[i])
            i += 1
        while stack and stack[-1][1] <= p:
            stack.pop()
        out.append([e[2] for e in stack if e[1] > p])
    return out


def idle_by_span(tl, prefix: str = PREFIX):
    """{span name: seconds of device idle in gaps that began inside a span
    of that name}, every gap of the window counted under each name open
    (once per name), and under None when no ``prefix`` span was open."""
    events = [h for h in tl.host if h[2].startswith(prefix)]
    gaps = tl.gaps
    tot = {}
    for (g0, glen), names in zip(gaps, _open_at(events, [g0 for g0, _ in gaps])):
        for n in set(names) or {None}:
            tot[n] = tot.get(n, 0.0) + glen / 1e6
    return tot


def launch_seconds(tl):
    """Device seconds of each launch call of the window, in call order, or
    None where the calls and the device's launches do not number alike.
    A device operation's launch is its correlation id (ids grow with the
    calls; a copy split into several operations shares one), or, where the
    trace gives none, its place in start order (the program launches on
    one stream)."""
    calls = [(t0, t1) for t0, t1, name in tl.host
             if tl.w0 <= t0 < tl.w1 and any(k in name for k in LAUNCHES)]
    calls = outermost(calls)  # a driver call inside a runtime call is one launch
    if all(corr is not None for *_, corr in tl.device):
        by_corr = {}
        for d0, d1, _, corr in tl.device:
            by_corr[corr] = by_corr.get(corr, 0.0) + (d1 - d0) / 1e6
        seconds = [by_corr[c] for c in sorted(by_corr)]
    else:
        seconds = [(d1 - d0) / 1e6 for d0, d1, _, _ in tl.device]
    if len(seconds) != len(calls):
        return None
    return calls, seconds


def op_device_seconds(tl):
    """({op span name: device seconds of the operations launched inside
    it}, {op span name: spans in the window}), or None (``launch_seconds``)."""
    got = launch_seconds(tl)
    if got is None:
        return None
    calls, secs = got
    ops = [h for h in tl.host if h[2].startswith(OP)]
    seconds = {}
    for names, s in zip(_open_at(ops, [t0 for t0, _ in calls]), secs):
        if names:
            seconds[names[-1]] = seconds.get(names[-1], 0.0) + s
    counts = {n: len(v) for n, v in window_ranges(tl, OP).items()}
    return seconds, counts


def roofline(run, name, spans, count):
    """100 x (least time of the logged calls at the card's peaks) / (device
    time of the operations launched inside the spans named ``spans``), from
    a sound trace with one such span per logged call."""
    if program(run, name) is None:
        return None
    log = run.call_logs.get(name) or []
    got = op_device_seconds(run.timeline)
    if got is None:
        _say(name, "the window's launch calls and device operations do not pair")
        return None
    seconds, counts = got
    n_spans = sum(counts.get(s, 0) for s in spans)
    device_s = sum(seconds.get(s, 0.0) for s in spans)
    if not log or n_spans != len(log) or device_s <= 0:
        _say(name, f"{n_spans} spans {list(spans)} for {len(log)} calls")
        return None
    mod = importlib.import_module(f"hzbench.counts.{count}")
    cache, bound = {}, 0.0
    for desc in log:
        args = mod.resolve(desc, cache)
        bound += bound_seconds(mod.work(**args), _DTYPE[args["itemsize"]])[0]
    return 100.0 * bound / device_s


def roofline_file(run, path):
    """``roofline`` with the parameters of the metric's .json beside its
    reader ``path`` (metrics/<name>.py): ``spans`` and ``count``."""
    base = os.path.splitext(path)[0]
    with open(base + ".json") as f:
        spec = json.load(f)
    return roofline(run, os.path.basename(base), spec["spans"], spec["count"])


def per_unit(run, name, unit, value):
    """``value(spans)`` over the window's units of work, or None."""
    spans = program(run, name)
    if spans is None:
        return None
    k = units(run, name, unit)
    v = None if k is None else value(spans)
    return None if v is None else v / k


def span_ms(run, name, unit, span):
    """Milliseconds of the outermost ``span`` ranges per unit of work."""
    def total(spans):
        if span not in spans:
            _say(name, f"no '{span}' span in the window")
            return None
        return sum(t1 - t0 for t0, t1 in outermost(spans[span])) / 1e3

    return per_unit(run, name, unit, total)


def span_count(run, name, unit, span):
    """``span`` ranges per unit of work (0 where the program opened others
    but none of this name)."""
    return per_unit(run, name, unit, lambda spans: float(len(spans.get(span, []))))


def idle_ms(run, name, unit, span):
    """Milliseconds of device idle per unit of work in gaps that began
    inside a ``span`` range."""
    def total(spans):
        if span not in spans:
            _say(name, f"no '{span}' span in the window")
            return None
        return 1e3 * idle_by_span(run.timeline).get(span, 0.0)

    return per_unit(run, name, unit, total)
