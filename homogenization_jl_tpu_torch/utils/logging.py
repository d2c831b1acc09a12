"""Step metrics and profiling hooks (port of
homogenization_jl_tpu/utils/logging.py).

The reference logs per-V-cycle residual norms and per-step domain stats via
@info (SURVEY.md §5); here: a structured StepLogger (stdout or JSONL) plus an
optional torch.profiler trace context that writes a Chrome trace (the JAX
package's jax.profiler trace context, for the card's timeline).

The program's spans: ``span(name)`` (and the decorator ``spanned(name)``)
opens a range while a torch profiler records (``profile_trace``, or any
``torch.profiler.profile``) and is one shared no-op context otherwise, so
tracing costs one flag check per span when nothing records. The range is
the profiler's fast record-function form, in the trace as an operator
event (category ``cpu_op``) named ``name``: a ``record_function`` range
costs several times as much per span with the profiler on (PERF.md §6 has
the measured costs), and a solve opens ~1,000 spans. The ranges land in
the profiler's trace on the calling thread, on the clock of the device's
operations.
Their names (``hz.*``) are read by the benchmark's per-layer metrics: the
layer boundaries of the solver (``hz.fmg``, ``hz.pcg``, ``hz.pcg_iter``,
``hz.level.<k>``, ``hz.coarse_solve``), its set-up (``hz.plan``,
``hz.solver_init``, ``hz.coefficients``, ``hz.coarse_setup``,
``hz.lambda_max``), mixed-precision PCG (``hz.mixed_setup``,
``hz.mixed_pcg``, ``hz.mixed_iter``), the multishift estimate (``hz.estimate``,
``hz.estimate_setup``, ``hz.lanczos_step``, ``hz.mass_solve``,
``hz.basis_combine``, ``hz.sigma_integrals``), the driver
(``hz.driver.init``, ``hz.driver.step_setup``, ``hz.driver.iteration``),
the wrappers of the JAX functions whose work a roofline counts
(``hz.op.<function>``), and each device-to-host read of the solver and
the recurrence (``hz.read``, through ``host_read``).
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import sys
import time

import torch
from torch.autograd import profiler as _profiler

_NO_SPAN = contextlib.nullcontext()
_RANGE = torch._C._profiler._RecordFunctionFast


def span(name: str):
    """A range ``name`` in the trace while a torch profiler records, else
    the shared no-op context (the flag is read at every call)."""
    if _profiler._is_profiler_enabled:
        return _RANGE(name)
    return _NO_SPAN


def spanned(name: str):
    """Decorator: every call of the function inside ``span(name)`` (for
    functions called a few times a step; the op wrappers that run per
    launch open ``span`` inline, which costs less per call)."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with _RANGE(name):
                return fn(*args, **kwargs)

        return call

    return wrap


def host_read(t, convert=float):
    """``convert(t)`` inside the span ``hz.read``: a device-to-host read
    (the host waits for the device), counted by the benchmark per unit of
    work."""
    with span("hz.read"):
        return convert(t)


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
