"""Traffic kind ``sigma``: one caller asks for sigma estimates back to back
(a closed loop), each a full call of ``checkerboard_homogenization`` on a
new conductivity field.

The configuration file gives the driver's problem: ``n``, ``refinements``,
``dtype``, ``conductivity`` (the two per-axis values of the checkerboard,
at equal odds per cube and axis) and ``driver`` (its keyword arguments,
such as ``solver`` and ``lanczos_iters``). The traffic file gives:

  driver           keyword arguments that override the configuration's
  warmup           keyword arguments of set-up's one call at the window's
                   shapes (e.g. a few Lanczos steps)
  judge            how many of the window's estimates are judged (all where
                   fewer completed): their sigma and sigma_steps against the
                   plain reference (reference/lanczos.py) on the same field

Field j is drawn from (seed, 0, j); set-up's call takes (seed, 3); the
judged estimates are drawn from (seed, 2) once the window has closed.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..reference.lanczos import Problem, domain_radius


class Run:
    def __init__(self, cell, seed: int, device):
        self.cfg = cell.config
        self.tr = cell.traffic
        self.seed = int(seed) % 2**64
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.stats = {}
        self.timeline = None
        self.call_logs = {}
        self.attempted = 0
        # estimate index -> (sigma, sigma_steps, Lanczos steps, mass applies)
        self.kept = {}
        self.R0 = domain_radius(self.cfg["n"])
        self.dtype = getattr(torch, self.cfg["dtype"])
        self.xi = np.ones(3) / np.sqrt(3.0)

    def field(self, j):
        lo, hi = self.cfg["conductivity"]
        draw = [self.seed, 3] if j < 0 else [self.seed, 0, j]
        f = np.random.default_rng(draw).random((2 * self.R0,) * 3 + (3,))
        return np.where(f < 0.5, lo, hi)

    def _kwargs(self, **over):
        kw = dict(self.cfg["driver"])
        kw.update(self.tr.get("driver", {}))
        kw.update(over)
        return kw

    def estimate(self, field, **over):
        from homogenization_jl_tpu_torch.models.checkerboard import checkerboard_homogenization

        return checkerboard_homogenization(
            self.cfg["n"], dim=3, refinements=self.cfg["refinements"], dtype=self.dtype,
            xi=self.xi, cond_field=field, return_trace=True, device=self.device,
            **self._kwargs(**over))

    def setup(self):
        self.estimate(self.field(-1), **self.tr.get("warmup", {}))
        self.sync()

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def reseed(self, seed: int):
        self.seed = int(seed) % 2**64
        self.attempted = 0
        self.kept = {}

    def timed(self, seconds: float, keep: bool = True):
        """Estimates back to back until ``seconds`` have passed (no new one
        starts after that); the window closes when the last one returns."""
        count, lanczos_s, steps, m_applies = 0, 0.0, 0, 0
        self.sync()
        t_open = time.perf_counter()
        deadline = t_open + seconds
        while True:
            j = self.attempted
            sigma, st = self.estimate(self.field(j))
            self.sync()
            if keep:
                self.kept[j] = (float(sigma), [float(s) for s in st["sigma_steps"]],
                                int(st["lanczos_iters"]), int(st["M_applies"]))
            self.attempted += 1
            count += 1
            lanczos_s += st["lanczos_seconds"]
            steps += st["lanczos_iters"]
            m_applies += st["M_applies"]
            if time.perf_counter() >= deadline:
                break
        window = time.perf_counter() - t_open
        if keep:
            self.stats = dict(estimates=count, window_s=window, sigma_s=window / count,
                              lanczos_step_ms=1e3 * lanczos_s / steps,
                              m_applies=m_applies / count)

    def end_to_end(self):
        return dict(sigma_s=self.stats["sigma_s"])

    def release(self):
        if self.cuda:
            torch.cuda.empty_cache()

    def check(self, control: bool = False):
        """Each judged estimate against the reference on its field, which
        runs the recurrence twice (reference/lanczos.py): in the
        configuration's float64 (the judge) and in float32 (the scale of a
        precision's error on this field: the recurrence amplifies rounding
        by a factor that changes from field to field by orders of
        magnitude). {"sigma_err": the largest |sigma_steps - float64's|
        over the steps, in units of float32's largest such distance (at
        least float32's unit round-off times |sigma|); "sigma_gap": the
        program's distance over |sigma|, not compared; "mass_applies": the
        program's and the float64 reference's, not compared}. With
        ``control`` another float32 run of the reference stands in the
        program's place (control.py)."""
        answers = []
        done = sorted(self.kept)
        k = int(self.tr.get("judge", len(done)))
        if k < len(done):
            rng = np.random.default_rng([self.seed, 2])
            done = sorted(int(j) for j in rng.choice(done, size=k, replace=False))
        m_iters = self._kwargs()["lanczos_iters"]

        def reference(problem, dtype):
            out = problem.astype(dtype).sigma(m_iters)
            if self.cuda:
                torch.cuda.empty_cache()
            return out

        def distance(steps, m, steps_ref, m_ref):
            if m != m_ref or len(steps) != len(steps_ref):
                return float("inf")
            return max(abs(a - b) for a, b in zip(steps, steps_ref))

        for j in done:
            sigma, steps, m, m_applies = self.kept[j]
            problem = Problem(self.cfg["n"], self.cfg["refinements"], self.field(j), self.xi,
                              dtype=torch.float64, device=self.device)
            s64, steps64, m64, ma64 = reference(problem, torch.float64)
            _, steps32, m32, _ = reference(problem, torch.float32)
            unit = max(distance(steps32, m32, steps64, m64), 2.0**-24 * abs(s64))
            if control:
                _, steps, m, m_applies = reference(problem, torch.float32)
            del problem
            d = distance(steps, m, steps64, m64)
            answers.append(dict(sigma_err=d / unit, sigma_gap=d / abs(s64),
                                mass_applies=[m_applies, ma64]))
        return answers, {}
