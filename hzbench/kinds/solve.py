"""Traffic kind ``solve``: one caller solves A u = b for one right-hand
side after another through ``MultigridSolver``'s public methods (a closed
loop: the next solve starts when the last one has returned).

The configuration file gives the problem and the solver's options:
``base_cells`` (a box of n^3 cubes, 6 tetrahedra each, ``order``),
``levels``, ``dtype``, ``conductivity`` (the two per-axis values of the
checkerboard, at equal odds per cube and axis) and ``solver`` (keyword
arguments of ``MultigridSolver``). The traffic file gives:

  new_field_every  0: one conductivity field for the run, made in set-up;
                   k: a new field (its coefficients, coarse set-up and
                   lambda_max inside the window) before every k-th solve
  field_seed       draw the fields from this number instead of the seed
                   (the coarse solves stop on a tolerance, so a field sets
                   how much work a solve takes: a fixed field gives every
                   seed the same work, and the seed draws the rest)
  start            "fmg" (the FMG start, then PCG) or "zero" (PCG from 0)
  tol              stop when ||r|| <= tol ||b||, the norms and the rule of
                   ``solve_driver``'s "fmg+pcg" / "pcg"
  max_iters        PCG iterations at most (a solve that stops short of tol
                   is a failure)
  rhs_factor       [lo, hi]: b is the load vector of f, f uniform in
                   [lo, hi] and constant on each cube of the base box
  solver           options that override the configuration's (such as
                   ``direction_dtype``)
  sample, sample_from  how many answers are judged, drawn from the seed
                   among the first ``sample_from`` solves of the window

Every input is drawn from the seed: field j from (seed, 0, j) (or
(field_seed, 0, j)), the factors of solve i from (seed, 1, i), the sample
from (seed, 2). The warm-up solve of set-up takes solve index -1's draw
(seed, 3).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..reference.mesh import affine, box_mesh
from ..reference.poisson import FineProblem, reference_element


def _rf(name):
    from torch.profiler import record_function

    return record_function(name)


class Run:
    def __init__(self, cell, seed: int, device):
        self.cell = cell
        self.cfg = cell.config
        self.tr = cell.traffic
        self.seed = int(seed) % 2**64
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.stats = {}
        self.timeline = None
        self.call_logs = {}
        self.attempted = 0
        self.unconverged = 0
        self.kept = {}  # solve index -> (answer on the host, field index)

    # -- inputs ---------------------------------------------------------- #
    def field(self, j):
        """sigma_el [E, 3] of field j: per cube and axis lo or hi."""
        n = self.cfg["base_cells"]
        lo, hi = self.cfg["conductivity"]
        src = self.tr.get("field_seed")
        rng = np.random.default_rng([self.seed if src is None else int(src), 0, j])
        f = np.where(rng.random((n, n, n, 3)) < 0.5, lo, hi)
        return f[self.cube_idx[:, 0], self.cube_idx[:, 1], self.cube_idx[:, 2]]

    def rhs(self, i):
        """b [E, n_local] of solve i on the device, in the solve's dtype."""
        n = self.cfg["base_cells"]
        lo, hi = self.tr["rhs_factor"]
        draw = [self.seed, 3] if i < 0 else [self.seed, 1, i]
        f = np.random.default_rng(draw).uniform(lo, hi, n**3)[self.cube_of]
        fe = torch.as_tensor(f * self.detJ, device=self.device)
        return ((fe[:, None] * self.load[None, :]).to(self.dtype)).contiguous()

    # -- set-up ---------------------------------------------------------- #
    def setup(self):
        from homogenization_jl_tpu_torch.mesh.grid import Mesh
        from homogenization_jl_tpu_torch.ops.plan import build_grid_plan
        from homogenization_jl_tpu_torch.solver.multigrid import MultigridSolver

        cfg = self.cfg
        n, L = cfg["base_cells"], cfg["levels"]
        self.dtype = getattr(torch, cfg["dtype"])
        self.nodes, self.elements = box_mesh(n, cfg.get("order", "type"))
        v0, J = affine(self.nodes, self.elements)
        self.detJ = np.abs(np.linalg.det(J))
        cube = np.floor(self.nodes[self.elements].mean(axis=1)).astype(np.int64)
        self.cube_idx = cube
        self.cube_of = (cube[:, 0] * n + cube[:, 1]) * n + cube[:, 2]
        plan = build_grid_plan(Mesh(self.nodes, self.elements), L, slot_tables=False)
        if not np.array_equal(plan.base.elements, self.elements):
            raise RuntimeError("the plan reordered the base elements")
        # the address of the answer's columns (reference/poisson.py)
        self.col_ref = np.array(plan.reference.levels[L - 1].nodes)
        self.load = torch.as_tensor(reference_element(L, self.col_ref)["load"],
                                    device=self.device)
        opts = dict(cfg["solver"])
        opts.update(self.tr.get("solver", {}))
        self.solver = MultigridSolver(plan, dtype=self.dtype, device=self.device, **opts)
        self.every = int(self.tr.get("new_field_every", 0))
        self.reseed(self.seed)
        shape = (len(self.elements), plan.n_local(L - 1))
        self.buffers = [torch.empty(shape, dtype=self.dtype, pin_memory=self.cuda)
                        for _ in self.sample]
        # warm-up: one whole solve at the window's shapes
        self.solve(self.rhs(-1))
        self.sync()

    def set_field(self, j):
        from homogenization_jl_tpu_torch.solver.multigrid import CHEBYSHEV_SMOOTHERS

        s = self.solver
        self.field_index = j
        sigma = self.field(j)
        self.coeff = s.coefficients(sigma, 0.0)
        self.setup_payload = s.coarse_setup(sigma, 0.0)
        self.lam_max = s.estimate_lambda_max(self.coeff) \
            if s.smoother in CHEBYSHEV_SMOOTHERS else None

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)

    # -- one solve ------------------------------------------------------- #
    def solve(self, b):
        """(x, pcg iterations, fmg seconds, pcg seconds, converged)."""
        s, tol = self.solver, float(self.tr["tol"])
        args = (self.coeff, self.setup_payload)
        t0 = time.perf_counter()
        bn = float(s.residual_norm(b))
        x = None
        if self.tr.get("start", "fmg") == "fmg":
            with _rf("hzbench.fmg"):
                x, r = s.fmg(b, *args, lam_max=self.lam_max)
                rel = float(s.residual_norm(r)) / bn
                del r
        else:
            rel = float(s.initial_residual_norm(b, self.coeff)) / bn
        t1 = time.perf_counter()
        iters, ok = 0, rel <= tol
        if not ok:
            with _rf("hzbench.pcg"):
                x, hist = s.pcg(b, *args, lam_max=self.lam_max, x=x,
                                iters=int(self.tr["max_iters"]), tol=tol / rel)
            iters = len(hist) - 1
            ok = hist[-1] <= tol / rel * hist[0]
        elif x is None:
            x = s.zero_states()[0]
        return x, iters, t1 - t0, time.perf_counter() - t1, ok

    # -- the window ------------------------------------------------------ #
    def timed(self, seconds: float, keep: bool = True):
        """Solves back to back until ``seconds`` have passed (no new solve
        starts after that); the window closes when the last one returns.
        With ``keep``: the sampled answers are copied to the host, and
        ``stats`` get the window's numbers."""
        from homogenization_jl_tpu_torch.csrc.build import LAUNCHES

        count, iters, fmg_s, pcg_s, each = 0, [], 0.0, 0.0, []
        launches0 = sum(LAUNCHES.values())
        coarse0, reads0 = sum(self.solver.coarse_iterations), self.solver.host_syncs
        self.sync()
        t_open = time.perf_counter()
        deadline = t_open + seconds
        while True:
            i = self.attempted
            if self.every and i % self.every == 0:
                self.set_field(i // self.every)
            t0 = time.perf_counter()
            with _rf("hzbench.solve"):
                x, it, tf, tp, ok = self.solve(self.rhs(i))
                self.sync()
            each.append(time.perf_counter() - t0)
            if keep and i in self.sample:
                j = self.sample.index(i)
                self.buffers[j].copy_(x, non_blocking=True)
                self.kept[i] = (self.buffers[j], self.field_index)
            del x
            self.attempted += 1
            self.unconverged += 0 if ok else 1
            count += 1
            iters.append(it)
            fmg_s += tf
            pcg_s += tp
            if time.perf_counter() >= deadline:
                break
        self.sync()
        window = time.perf_counter() - t_open
        if keep:
            self.window_s = window
            self.solves = count
            self.stats = dict(
                solves=count, window_s=window, solve_s=window / count,
                pcg_iters=float(np.mean(iters)),
                pcg_iter_ms=1e3 * pcg_s / max(sum(iters), 1),
                fmg_ms=1e3 * fmg_s / count,
                launches_per_solve=(sum(LAUNCHES.values()) - launches0) / count,
                solve_ms_min_median_max=[1e3 * min(each), 1e3 * float(np.median(each)),
                                         1e3 * max(each)],
                coarse_iters_per_solve=(sum(self.solver.coarse_iterations) - coarse0) / count,
                host_reads_per_solve=(self.solver.host_syncs - reads0) / count,
            )

    def end_to_end(self):
        return dict(solve_s=self.stats["solve_s"])

    def release(self):
        """Free the program's state before the reference runs."""
        for name in ("solver", "coeff", "setup_payload", "lam_max"):
            setattr(self, name, None)
        if self.cuda:
            torch.cuda.empty_cache()

    # -- correct --------------------------------------------------------- #
    def reseed(self, seed: int):
        """Start over with another seed on the same solver (the control's
        readings, control.py): field 0 and the sample of the new seed."""
        self.seed = int(seed) % 2**64
        self.attempted = self.unconverged = 0
        self.kept = {}
        self.set_field(0)
        rng = np.random.default_rng([self.seed, 2])
        self.sample = sorted(int(i) for i in rng.choice(
            self.tr["sample_from"], size=self.tr["sample"], replace=False))

    def check(self, control: bool = False, fault=None):
        """The judged answers, each {"residual", "copy_gap"} of the
        reference (reference/poisson.py), and the window's counts that are
        compared too: {"unconverged": solves that stopped short of tol}.
        With ``control`` each answer is held in bfloat16 first, the
        precision below float32; ``fault`` (control.py) changes each
        answer first: "altered" adds 1e-3 max|x| to one element's row,
        "half" zeroes the first half of the rows."""
        answers, problem, pj = [], None, None
        for i in self.sample:
            if i not in self.kept:
                continue
            x, j = self.kept[i]
            if j != pj:
                problem = None
                problem = FineProblem(self.nodes, self.elements, self.cfg["levels"],
                                      self.col_ref, self.field(j), device=self.device)
                pj = j
            if control:
                x = x.to(torch.bfloat16)
            if fault is not None:
                x = x.clone()
                if fault == "altered":
                    x[3] += 1e-3 * x.abs().max()
                else:
                    x[: len(x) // 2] = 0
            answers.append(problem.check(x, self.rhs(i)))
        return answers, dict(unconverged=float(self.unconverged))

    def faults(self):
        """{fault: (answers, counts)} at the cell's size (control.py): the
        answer altered where it is produced, half the answer left out, and
        a PCG step that returns its state unchanged (one more solve)."""
        from homogenization_jl_tpu_torch.solver.multigrid import MultigridSolver

        out = {name: self.check(fault=name) for name in ("altered", "half")}
        orig = MultigridSolver._pcg_step_impl

        def unchanged(solver, x, r, p, rz, *args, **kwargs):
            return x, r, p, rz, solver._pcg_rnorm(r)

        MultigridSolver._pcg_step_impl = unchanged
        try:
            self.kept, self.unconverged = {}, 0
            self.sample = [self.attempted]
            self.timed(0.0)
        finally:
            MultigridSolver._pcg_step_impl = orig
        out["unchanged_step"] = self.check()
        return out
