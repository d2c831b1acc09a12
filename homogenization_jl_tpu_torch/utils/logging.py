"""Step metrics and profiling hooks (port of
homogenization_jl_tpu/utils/logging.py).

The reference logs per-V-cycle residual norms and per-step domain stats via
@info (SURVEY.md §5); here: a structured StepLogger (stdout or JSONL) plus an
optional torch.profiler trace context that writes a Chrome trace (the JAX
package's jax.profiler trace context, for the card's timeline).
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time


class StepLogger:
    """Collects per-cycle / per-step metrics; optionally writes JSONL."""

    def __init__(self, path: str | None = None, echo: bool = True):
        self.path = path
        self.echo = echo
        self.records = []
        self._fh = open(path, "a") if path else None
        self._t0 = time.perf_counter()

    def log(self, **fields):
        fields.setdefault("t", round(time.perf_counter() - self._t0, 4))
        self.records.append(fields)
        if self._fh:
            self._fh.write(json.dumps(fields) + "\n")
            self._fh.flush()
        if self.echo:
            msg = " ".join(
                f"{key}={v:.4g}" if isinstance(v, float) else f"{key}={v}"
                for key, v in fields.items()
            )
            print(msg, file=sys.stderr)

    def close(self):
        if self._fh:
            self._fh.close()


@contextlib.contextmanager
def profile_trace(logdir: str | None):
    """torch.profiler trace context: the host's and (with a card) the
    device's activity inside it, written as a Chrome trace
    ``trace_<pid>_<ns>.json`` under ``logdir`` (view in chrome://tracing or
    Perfetto). No-op when logdir is None."""
    if logdir is None:
        yield
        return
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
