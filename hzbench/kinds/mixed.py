"""Traffic kind ``mixed``: one caller solves A u = b to float64 depth for
one right-hand side after another through the port's mixed-precision PCG
(``solver/multigrid.py``: ``mixed_precision_setup`` once per field, then
``mixed_precision_pcg`` per right-hand side), a closed loop as in
``solve``.

The configuration file gives the problem as ``solve``'s does (``base_cells``,
``order``, ``levels``, ``conductivity``), the outer solver's ``dtype`` and
``solver`` options (float64: the Krylov state, the fine apply and the dots),
the inner solver's ``inner_dtype`` and ``inner_solver`` options (float32:
the preconditioning V-cycle), and the answers: ``tol`` (stop when
``history[-1] <= tol * history[0]``, ``mixed_precision_pcg``'s rule and
norms, from a zero start), ``keep_best`` and ``divergence_stop``. The
traffic file gives ``solve``'s ``new_field_every``, ``field_seed``,
``max_iters`` (outer iterations at most; a solve that stops above tol is a
failure), ``rhs_factor``, ``sample`` and ``sample_from``.

Everything else is ``solve``'s ``Run``: the inputs from the seed (the rhs in
float64), the window, the sampled answers and their judge
(reference/poisson.py). Set-up builds both solvers on one plan, the mixed
set-up of field 0, and runs one warm-up solve. The control answer of
``control.py`` is the answer held in float32, the precision below the
configuration's.
"""

from __future__ import annotations

import time

import torch

from . import solve


def _mg():
    """The port's solver module, looked up at each call (so that a fault
    planted there is seen)."""
    import homogenization_jl_tpu_torch.solver.multigrid as mg

    return mg


class Run(solve.Run):
    inner = None
    mixed = None

    # -- set-up ---------------------------------------------------------- #
    def set_field(self, j):
        """Field j's mixed set-up (both solvers' coefficients, the inner
        coarse set-up and lambda_max, the multiplicities); the inner solver
        is built on the outer one's plan the first time."""
        mg = _mg()
        if self.inner is None:
            opts = dict(self.cfg["inner_solver"])
            opts.update(self.tr.get("inner_solver", {}))
            self.inner = mg.MultigridSolver(
                self.solver.plan, dtype=getattr(torch, self.cfg["inner_dtype"]),
                device=self.device, **opts)
        self.field_index = j
        self.mixed = None
        self.mixed = mg.mixed_precision_setup(self.solver, self.inner, self.field(j))

    # -- one solve ------------------------------------------------------- #
    def solve(self, b):
        """(x, outer iterations, 0, seconds, converged)."""
        cfg = self.cfg
        tol = float(cfg["tol"])
        t0 = time.perf_counter()
        x, hist = _mg().mixed_precision_pcg(
            self.solver, self.inner, b, setup=self.mixed, iters=int(self.tr["max_iters"]),
            tol=tol, keep_best=bool(cfg["keep_best"]),
            divergence_stop=int(cfg["divergence_stop"]))
        return x, len(hist) - 1, 0.0, time.perf_counter() - t0, hist[-1] <= tol * hist[0]

    def release(self):
        self.inner = self.mixed = None
        super().release()

    # -- correct --------------------------------------------------------- #
    def check(self, control: bool = False, fault=None):
        """``solve``'s judge; with ``control`` each answer is held in
        float32 first."""
        if not control:
            return super().check(fault=fault)
        kept = self.kept
        self.kept = {i: (x.to(torch.float32), j) for i, (x, j) in kept.items()}
        try:
            return super().check(fault=fault)
        finally:
            self.kept = kept

    def faults(self):
        """``solve``'s faults, the unchanged step being the outer one."""
        mg = _mg()
        out = {name: self.check(fault=name) for name in ("altered", "half")}
        orig = mg.MultigridSolver._mixed_pcg_programs

        def programs(outer, inner):
            init, _ = orig(outer, inner)
            return init, lambda x, r, p, rz, su: (x, r, p, rz, outer._pcg_rnorm(r))

        mg.MultigridSolver._mixed_pcg_programs = programs
        try:
            self.kept, self.unconverged = {}, 0
            self.sample = [self.attempted]
            self.timed(0.0)
        finally:
            mg.MultigridSolver._mixed_pcg_programs = orig
        out["unchanged_step"] = self.check()
        return out
