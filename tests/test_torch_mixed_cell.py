"""Mixed-precision PCG as the benchmark's mixed cell runs it, on the CPU at
a small size: a box of 4^3 cubes with 3 levels (coarse "mg" on both
solvers, dense limit 4), a seeded checkerboard field and a seeded
per-cube right-hand side, the pair of ``parallel/run_slab.py::mixed_pair``
to ``history[-1] <= 1e-8 history[0]``.

  * the answer, judged by the benchmark's plain reference
    (hzbench/reference/poisson.py: the float64 residual of the refined
    problem, assembled from scratch), is under ``LIMIT``; the float32 FMG +
    PCG answer of the same problem and the mixed answer held in float32
    both fail it;
  * under a profiler the call opens ``hz.mixed_setup`` (with ``setup=``
    left out), ``hz.mixed_pcg``, one ``hz.mixed_iter`` per outer step, and
    an ``hz.op.downcast_scale`` / ``hz.op.upcast`` per K15 call;
  * the traced solve's history and x are bitwise the untraced ones, and a
    second solve on the same pair repeats the first bit for bit."""

import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from homogenization_jl_tpu_torch.fem.local_operators import load_vector
from homogenization_jl_tpu_torch.mesh.grid import affine_maps, hypercube
from homogenization_jl_tpu_torch.ops.plan import build_grid_plan
from homogenization_jl_tpu_torch.solver.multigrid import (
    MultigridSolver,
    mixed_precision_pcg,
    mixed_precision_setup,
)
from hzbench.reference.poisson import FineProblem

N, LEVELS, TOL = 4, 3, 1e-8
# the reference's residual at this size (CPU, seeds 5-7 of the cell's
# harness): the mixed answer 1.2e-9 to 1.5e-9, the same answer held in
# float32 3.3e-7 to 5.0e-7; 2e-8 sits more than 10x from each
LIMIT = 2e-8


def _pair(plan):
    opts = dict(smoother="chebyshev", coarse="mg", coarse_mg_dense_limit=4)
    outer = MultigridSolver(plan, dtype=torch.float64, device="cpu", **opts)
    inner = MultigridSolver(plan, dtype=torch.float32, device="cpu", smooth_precision="high",
                            coarse_mg_tol=5e-2, **opts)
    return outer, inner


class Problem:
    def __init__(self, seed=11):
        rng = np.random.default_rng(seed)
        self.base = hypercube(3, N, order="type")
        self.plan = build_grid_plan(self.base, LEVELS, slot_tables=False)
        E = self.base.nelements
        self.sigma = rng.choice([1.0, 9.0], size=(E, 3))
        _, _, detJ, _ = affine_maps(self.base)
        f = rng.uniform(-1.0, 1.0, E)
        load = load_vector(self.plan.reference.levels[LEVELS - 1])
        self.b = torch.as_tensor((f * detJ)[:, None] * load[None, :], dtype=torch.float64)
        self.col_ref = np.array(self.plan.reference.levels[LEVELS - 1].nodes)

    def judge(self, x):
        ref = FineProblem(self.base.nodes, self.base.elements, LEVELS, self.col_ref, self.sigma)
        return ref.check(x, self.b)


def _spans(events):
    out = {}
    for e in events:
        if e.get("ph") == "X" and e.get("name", "").startswith("hz."):
            out.setdefault(e["name"], []).append(float(e["ts"]))
    return out


@pytest.fixture(scope="module")
def solved(tmp_path_factory):
    """The problem, the solver pair, an untraced solve (x, history) and a
    traced one from a fresh set-up (x, history, {span name: starts})."""
    pb = Problem()
    outer, inner = _pair(pb.plan)
    su = mixed_precision_setup(outer, inner, pb.sigma)
    x, hist = mixed_precision_pcg(outer, inner, pb.b, setup=su, iters=60, tol=TOL)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        xt, ht = mixed_precision_pcg(outer, inner, pb.b, pb.sigma, iters=60, tol=TOL)
    path = str(tmp_path_factory.mktemp("trace") / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    return dict(pb=pb, outer=outer, inner=inner, x=x, hist=hist, xt=xt, ht=ht,
                spans=_spans(events))


def test_mixed_answer_passes_the_reference(solved):
    assert solved["hist"][-1] <= TOL * solved["hist"][0]
    got = solved["pb"].judge(solved["x"])
    assert got["residual"] <= LIMIT / 10
    assert got["copy_gap"] <= 1e-12


def _float32_fmg_pcg(pb):
    s = MultigridSolver(pb.plan, dtype=torch.float32, device="cpu", smoother="chebyshev",
                        coarse="mg", coarse_mg_dense_limit=4, smooth_precision="high",
                        coarse_mg_tol=5e-2)
    x, _ = s.solve(pb.b.to(torch.float32), pb.sigma, 0.0, tol=1e-4, method="fmg+pcg")
    return x


@pytest.mark.parametrize("control", ["float32 FMG + PCG", "mixed answer held in float32"])
def test_float32_answers_fail_the_reference(solved, control):
    pb = solved["pb"]
    x = _float32_fmg_pcg(pb) if control.startswith("float32 FMG") else \
        solved["x"].to(torch.float32)
    assert pb.judge(x)["residual"] > 10 * LIMIT


def test_mixed_spans_open_under_a_profiler(solved):
    sp = solved["spans"]
    assert len(sp["hz.mixed_setup"]) == 1
    assert len(sp["hz.mixed_pcg"]) == 1
    assert sp["hz.mixed_setup"][0] > sp["hz.mixed_pcg"][0]  # inside the call


def test_mixed_iter_spans_number_the_outer_steps(solved):
    assert len(solved["spans"]["hz.mixed_iter"]) == len(solved["ht"]) - 1


def test_op_spans_number_the_casts(solved):
    """A downcast and an upcast per preconditioner call (the start's and
    each step's), and the set-up's downcast of the multiplicities."""
    k = len(solved["ht"])
    assert len(solved["spans"]["hz.op.downcast_scale"]) == k + 1
    assert len(solved["spans"]["hz.op.upcast"]) == k


def test_second_solve_repeats_the_first(solved):
    """The pair carries nothing from one call to the next: a new set-up and
    the same rhs give the first solve's history and x, bit for bit."""
    pb, outer, inner = solved["pb"], solved["outer"], solved["inner"]
    su = mixed_precision_setup(outer, inner, pb.sigma)
    x, hist = mixed_precision_pcg(outer, inner, pb.b, setup=su, iters=60, tol=TOL)
    assert hist == solved["hist"]
    assert torch.equal(x, solved["x"])


def test_traced_mixed_solve_is_bitwise_the_untraced(solved):
    assert solved["ht"] == solved["hist"]
    assert torch.equal(solved["xt"], solved["x"])
