"""The device trace of a window and the records of calls into the port.

``profiled(window, lead_s)`` runs ``window()`` under torch.profiler (CPU
and CUDA activity) inside the range ``hzbench.window``, with ``lead_s`` of
idle trace before it, and returns the ``Timeline`` read from the exported
Chrome trace (written under TMPDIR, read, deleted). The arithmetic is
chip_smoke.py's (``device_timeline``, ``profile_table``): the union of the
kernels and copies is the device's busy time, a gap that ends with an
operation whose launch call had not returned when the device went idle is
the device waiting on the host, and a profile is read only when no launch
lost its device record and the busy time with those waits covers
``MIN_COVERAGE`` of the window (torch.profiler has dropped a prefix of a
step's kernels on the H100; a later attempt waits longer first).

``recording(targets)`` wraps functions of the port's modules for the
length of a window and logs a summary of every call (the shapes a count
function needs), so that a roofline counts each launch at its own shape.
"""

from __future__ import annotations

import bisect
import contextlib
import importlib
import json
import os
import tempfile
import time

MIN_COVERAGE = 0.9
ATTEMPTS = 3
LEAD_S = 2.0
MARGIN_S = 0.5
WINDOW = "hzbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


class Timeline:
    """The device and host events of one profiled window (times in us)."""

    def __init__(self, events):
        win = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW
               and e.get("cat") == "user_annotation"]
        if len(win) != 1:
            raise RuntimeError(f"trace: {len(win)} '{WINDOW}' ranges")
        self.w0 = float(win[0]["ts"])
        self.w1 = self.w0 + float(win[0]["dur"])
        tid = win[0].get("tid")
        self.device, launches, host = [], {}, []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat")
            t0 = float(e["ts"])
            t1 = t0 + float(e.get("dur", 0.0))
            corr = e.get("args", {}).get("correlation")
            if cat in DEVICE_CATS:
                if self.w0 <= t0 < self.w1:
                    self.device.append((t0, min(t1, self.w1), e["name"], corr))
                continue
            if cat in ("cuda_runtime", "cuda_driver") and corr is not None and any(
                    k in e["name"] for k in ("LaunchKernel", "Memcpy", "Memset")):
                launches[corr] = (t0, t1)
            if cat in HOST_CATS and e.get("tid") == tid and e["name"] != WINDOW:
                host.append((t0, t1, e["name"]))
        self.device.sort()
        host.sort(key=lambda h: (h[0], -h[1]))
        self.host = host
        recorded = {c for *_, c in self.device}
        self.lost_launches = sum(1 for c, (t0, _) in launches.items()
                                 if self.w0 <= t0 < self.w1 and c not in recorded)
        # the union of the device's operations, its gaps, and the gaps in
        # which it waited on the host
        busy = wait = 0.0
        gaps = []
        reach = self.w0
        for t0, t1, _, corr in self.device:
            if t0 > reach:
                gaps.append((reach, t0 - reach))
                if launches.get(corr, (0.0, -1.0))[1] >= reach:
                    wait += t0 - reach
            busy += max(0.0, t1 - max(t0, reach))
            reach = max(reach, t1)
        if self.w1 > reach:
            gaps.append((reach, self.w1 - reach))
        self.busy_us, self.wait_us, self.gaps = busy, wait, gaps

    @property
    def window_s(self) -> float:
        return (self.w1 - self.w0) / 1e6

    @property
    def busy_s(self) -> float:
        return self.busy_us / 1e6

    @property
    def coverage(self) -> float:
        return (self.busy_us + self.wait_us) / max(self.w1 - self.w0, 1e-9)

    @property
    def sound(self) -> bool:
        return self.lost_launches == 0 and self.coverage >= MIN_COVERAGE

    def kernels(self, pattern: str):
        """(seconds, count) of the device operations whose name holds
        ``pattern``."""
        ts = [t1 - t0 for t0, t1, name, _ in self.device if pattern in name]
        return sum(ts) / 1e6, len(ts)

    def top_ops(self, k: int = 10):
        tot = {}
        for t0, t1, name, _ in self.device:
            tot[name] = tot.get(name, 0.0) + (t1 - t0) / 1e6
        return sorted(([n[:160], s] for n, s in tot.items()), key=lambda r: -r[1])[:k]

    def idle_by_host(self, k: int = 10, longest: int = 500):
        """The ``longest`` idle gaps, grouped by the innermost host range
        open when each began (what the host was doing): [[name, seconds]]."""
        gaps = sorted(self.gaps, key=lambda g: -g[1])[:longest]
        gaps.sort()
        tot = {}
        stack = []
        starts = [h[0] for h in self.host]
        i = 0
        for g0, glen in gaps:
            j = bisect.bisect_right(starts, g0)
            for h in self.host[i:j]:
                while stack and stack[-1][1] <= h[0]:
                    stack.pop()
                stack.append(h)
            i = max(i, j)
            while stack and stack[-1][1] <= g0:
                stack.pop()
            name = stack[-1][2][:160] if stack else "host (no range)"
            tot[name] = tot.get(name, 0.0) + glen / 1e6
        return sorted(([n, s] for n, s in tot.items()), key=lambda r: -r[1])[:k]


def profiled(window, lead_s: float = LEAD_S) -> Timeline:
    """``window()`` under torch.profiler; its Timeline."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.ones(1, device="cuda")
        torch.cuda.synchronize()
        time.sleep(lead_s)
        with record_function(WINDOW):
            window()
            torch.cuda.synchronize()
        time.sleep(MARGIN_S)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        del prof
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return Timeline(events)


@contextlib.contextmanager
def recording(targets):
    """``targets``: [(module name, attribute, describe, log)]. While open,
    each call of ``module.attribute`` appends ``describe(*args, **kwargs)``
    to ``log`` and then runs the function."""
    saved = []
    try:
        for mod_name, attr, describe, log in targets:
            mod = importlib.import_module(mod_name)
            orig = getattr(mod, attr)

            def wrapper(*args, _orig=orig, _describe=describe, _log=log, **kwargs):
                _log.append(_describe(*args, **kwargs))
                return _orig(*args, **kwargs)

            setattr(mod, attr, wrapper)
            saved.append((mod, attr, orig))
        yield
    finally:
        for mod, attr, orig in reversed(saved):
            setattr(mod, attr, orig)
