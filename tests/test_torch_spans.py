"""The port's spans (utils/logging.py: ``span``, ``spanned``, ``host_read``)
on the CPU, small:

  * with no profiler recording, ``span`` is one shared no-op context and a
    solve opens no range;
  * one FMG + PCG solve with the tolerance-stopped coarse kind "cg" on
    hypercube(3, 2) with 3 levels, under ``profile_trace(dir)``: the file
    holds the ``hz.*`` names, one ``hz.pcg_iter`` per history entry, one
    outermost ``hz.coarse_solve`` per coarse solve the solver counts, one
    ``hz.op.element_apply`` / ``hz.op.combine_structured`` per call a
    wrapper of the solver module's names sees (as the benchmark wraps
    them), at least as many ``hz.read`` as ``host_syncs``, and a history and
    an iterate bit for bit the untraced solve's;
  * a multishift estimate under ``torch.profiler.profile``: one
    ``hz.estimate``, one ``hz.estimate_setup``, a ``hz.lanczos_step`` per
    Lanczos step, and the untraced sigma bit for bit;
  * the driver (2D, one refinement): one ``hz.driver.init``, a
    ``hz.driver.step_setup`` per outer step and a ``hz.driver.iteration``
    per inner iteration, and the untraced sigma;
  * ``jacobi_cg_step`` opens ``hz.op.jacobi_cg_step``."""

import glob
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import homogenization_jl_tpu_torch.solver.multigrid as mg
from homogenization_jl_tpu_torch.fem.local_operators import load_vector
from homogenization_jl_tpu_torch.mesh.grid import affine_maps, hypercube
from homogenization_jl_tpu_torch.models.checkerboard import (
    checkerboard_homogenization,
    conductivity_per_element,
    generate_conductivity,
)
from homogenization_jl_tpu_torch.models.multishift import homogenization_multishift
from homogenization_jl_tpu_torch.ops.plan import build_grid_plan
from homogenization_jl_tpu_torch.ops.recurrence import jacobi_cg_step
from homogenization_jl_tpu_torch.utils import logging as t_log


def _spans(events):
    """{name: [(start, end)]} of the trace's ``hz.*`` ranges (us)."""
    out = {}
    for e in events:
        if e.get("ph") == "X" and e.get("name", "").startswith("hz."):
            t0 = float(e["ts"])
            out.setdefault(e["name"], []).append((t0, t0 + float(e["dur"])))
    return out


def _outermost(intervals):
    """The intervals that no other one of the list encloses."""
    out, reach = [], -np.inf
    for t0, t1 in sorted(intervals, key=lambda s: (s[0], -s[1])):
        if t0 >= reach:
            out.append((t0, t1))
            reach = t1
    return out


def _traced(fn):
    """(fn's result, the ``hz.*`` spans it opened) under torch.profiler."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    path = os.path.join(os.environ.get("TMPDIR", "/tmp"), f"spans_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return out, _spans(events)


class Problem:
    """A small 3D FMG + PCG solve (coarse "cg", stopped on a tolerance)."""

    def __init__(self):
        base = hypercube(3, 2, order="type")
        plan = build_grid_plan(base, 3, slot_tables=False)
        sigma = conductivity_per_element(
            base, generate_conductivity(3, 2, np.random.default_rng(0)), np.zeros(3))
        self.s = mg.MultigridSolver(plan, dtype=torch.float64, device="cpu",
                                    smoother="chebyshev", coarse="cg")
        _, _, dJ, _ = affine_maps(base)
        self.b = torch.as_tensor(dJ[:, None] * load_vector(plan.reference.levels[2])[None, :])
        self.coeff = self.s.coefficients(sigma, 0.0)
        self.setup = self.s.coarse_setup(sigma, 0.0)
        self.lam = self.s.estimate_lambda_max(self.coeff)

    def solve(self):
        s, args = self.s, (self.coeff, self.setup)
        x0, _ = s.fmg(self.b, *args, lam_max=self.lam)
        return s.pcg(self.b, *args, lam_max=self.lam, x=x0, iters=20, tol=1e-8)


@pytest.fixture(scope="module")
def solved(tmp_path_factory):
    """The untraced solve, then the same solve under ``profile_trace`` with
    the solver module's element_apply / combine_structured calls counted."""
    pb = Problem()
    plain = pb.solve()
    calls = {"element_apply": 0, "element_apply_half": 0, "combine_structured": 0}
    saved = {name: getattr(mg, name) for name in calls}

    def counted(name):
        def call(*args, **kwargs):
            calls[name] += 1
            return saved[name](*args, **kwargs)
        return call

    coarse0, syncs0 = len(pb.s.coarse_iterations), pb.s.host_syncs
    logdir = str(tmp_path_factory.mktemp("prof"))
    try:
        for name in calls:
            setattr(mg, name, counted(name))
        with t_log.profile_trace(logdir):
            traced = pb.solve()
    finally:
        for name, fn in saved.items():
            setattr(mg, name, fn)
    (path,) = glob.glob(os.path.join(logdir, "trace_*.json"))
    with open(path) as f:
        spans = _spans(json.load(f)["traceEvents"])
    return dict(plain=plain, traced=traced, spans=spans, calls=calls,
                coarse=len(pb.s.coarse_iterations) - coarse0,
                syncs=pb.s.host_syncs - syncs0, levels=pb.s.nlevels)


def test_span_without_a_profiler_is_one_shared_no_op(monkeypatch):
    assert t_log.span("hz.a") is t_log.span("hz.b")
    opened = []
    monkeypatch.setattr(t_log, "_RANGE", lambda name: opened.append(name))
    x, hist = Problem().solve()
    assert opened == [] and len(hist) > 1
    assert t_log.host_read(torch.tensor(2.5)) == 2.5
    assert t_log.host_read(torch.tensor(1.0) > 0, bool) is True


def test_profile_trace_file_holds_the_solver_spans(solved):
    names = set(solved["spans"])
    assert {"hz.fmg", "hz.pcg", "hz.pcg_iter", "hz.coarse_solve", "hz.read",
            "hz.op.element_apply", "hz.op.combine_structured"} <= names
    assert {f"hz.level.{k}" for k in range(1, solved["levels"])} <= names
    assert "hz.level.0" not in names
    assert len(solved["spans"]["hz.fmg"]) == len(solved["spans"]["hz.pcg"]) == 1


def test_pcg_iter_spans_number_the_history(solved):
    _, hist = solved["traced"]
    assert len(solved["spans"]["hz.pcg_iter"]) == len(hist)


def test_outermost_coarse_solve_spans_number_the_coarse_solves(solved):
    assert solved["coarse"] > 0
    assert len(_outermost(solved["spans"]["hz.coarse_solve"])) == solved["coarse"]


def test_op_spans_number_the_wrapped_calls(solved):
    calls, spans = solved["calls"], solved["spans"]
    assert calls["element_apply"] > 0
    assert len(spans["hz.op.element_apply"]) == calls["element_apply"] \
        + calls["element_apply_half"]
    assert len(spans["hz.op.combine_structured"]) == calls["combine_structured"]


def test_read_spans_cover_the_host_syncs(solved):
    assert solved["syncs"] > 0
    assert len(solved["spans"]["hz.read"]) >= solved["syncs"]


def test_traced_solve_is_bitwise_the_untraced(solved):
    (x, hist), (xt, hist_t) = solved["plain"], solved["traced"]
    assert hist_t == hist and torch.equal(xt, x)


def test_multishift_estimate_spans():
    def estimate():
        return homogenization_multishift(1, dim=2, refinements=1, lanczos_iters=12, seed=3,
                                         return_stats=True, device="cpu")

    sigma, stats = estimate()
    (sigma_t, stats_t), spans = _traced(estimate)
    assert sigma_t == sigma and stats_t["sigma_steps"] == stats["sigma_steps"]
    assert len(spans["hz.estimate"]) == len(spans["hz.estimate_setup"]) == 1
    assert len(spans["hz.lanczos_step"]) == stats["lanczos_iters"]
    assert len(spans["hz.sigma_integrals"]) == len(spans["hz.basis_combine"]) == 1
    assert len(spans["hz.mass_solve"]) == stats["lanczos_iters"] + 1
    assert len(spans["hz.op.jacobi_cg_step"]) == stats["M_applies"] - len(spans["hz.mass_solve"])
    # the set-up holds the plan and the solver, and ends before the first step
    (s0, s1), = spans["hz.estimate_setup"]
    assert all(s0 <= t0 and t1 <= s1 for t0, t1 in spans["hz.plan"] + spans["hz.solver_init"])
    assert s1 <= min(t0 for t0, _ in spans["hz.lanczos_step"])
    assert len(spans["hz.read"]) >= 2 * stats["lanczos_iters"] + stats["M_applies"]


def test_driver_spans():
    def run():
        return checkerboard_homogenization(2, dim=2, refinements=1, smoother="chebyshev",
                                           inner="pcg", seed=0, dtype=torch.float64,
                                           return_trace=True, device="cpu")

    sigma, trace = run()
    (sigma_t, trace_t), spans = _traced(run)
    assert sigma_t == sigma and trace_t.sigma_steps == trace.sigma_steps
    assert len(spans["hz.driver.init"]) == 1
    assert len(spans["hz.driver.step_setup"]) == len(trace.cycles_per_step)
    assert len(spans["hz.driver.iteration"]) == sum(trace.cycles_per_step)
    (i0, i1), = spans["hz.driver.init"]
    assert i1 <= min(t0 for t0, _ in spans["hz.driver.step_setup"])


def test_jacobi_cg_step_opens_its_op_span():
    g = torch.Generator().manual_seed(1)
    x, r, p, Ap = (torch.rand(64, generator=g, dtype=torch.float64) for _ in range(4))
    d = torch.rand(64, generator=g, dtype=torch.float64) + 1.0
    num, den = torch.tensor(0.5, dtype=torch.float64), torch.tensor(2.0, dtype=torch.float64)
    _, spans = _traced(lambda: jacobi_cg_step(x, r, p, Ap, d, None, num, den))
    assert len(spans["hz.op.jacobi_cg_step"]) == 1
