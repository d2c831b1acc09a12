"""Matrix-free geometric multigrid on the implicit fine grid (device, PyTorch).

Port of the main-path subset of homogenization_jl_tpu/solver/multigrid.py:
the structured interface combine with the structured (mask-free) Dirichlet
constraint, the Jacobi-preconditioned first-kind Chebyshev smoother, the
dense Cholesky coarse solve, V-cycles, the FMG initializer, V-cycle-
preconditioned CG and the one-call ``solve`` driver (``method="auto"`` =
FMG start + PCG).

Every device kernel on this path is a hand kernel on CUDA tensors:
  * K1 ``element_apply`` (ops/apply.py, CUDA C++);
  * K2 ``combine_structured`` / ``constrain_structured`` (ops/structured.py,
    CUDA C++);
  * K3 ``chebyshev_update`` (ops/chebyshev.py, Triton).
Restriction/prolongation are ``torch.matmul`` (ops/transfer.py), dots are
``torch.dot``, the coarse solve is ``torch.cholesky_solve`` — the JAX
package leaves the same three to XLA and ``cho_solve``.

PyTorch runs eagerly: where the JAX package relies on dead-code elimination
inside one jitted program (the post-smooth residual that no caller reads),
this port skips the computation explicitly (``need_r``). State updates of
the smoother and of PCG run in place.

Not in this slice (raise on construction): the cg / cg_exact / chebyshev4
smoothers, W-cycles, the inv / cg / mg coarse solves, the gather combine and
the mask constraint, direction_dtype and mixed precision.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..fem.assembly import assemble_operator
from ..fem.local_operators import build_level_operators, element_coefficients
from ..mesh.reference import prolongation_dense
from ..ops.apply import element_apply
from ..ops.chebyshev import chebyshev_update
from ..ops.interfaces import apply_mask, copy_to_base, distribute
from ..ops.plan import GridPlan
from ..ops.structured import (
    build_structured_combine_auto,
    combine_structured,
    constrain_structured,
    detect_structured,
    flatten_structured,
)
from ..ops.transfer import prolong_add, restrict

CHEBYSHEV_SMOOTHERS = ("chebyshev",)
_PRECISIONS = (None, "default", "high", "highest")
# safety margin on the Lanczos lambda_max estimate: underestimating lets
# the Chebyshev polynomial amplify the top modes (the JAX package's value)
_LAM_SAFETY = 1.1


def _inv_positive(d):
    """1/d where d > 0, else 0 (the Jacobi inverse diagonal)."""
    pos = d > 0
    return torch.where(pos, 1.0 / torch.where(pos, d, torch.ones_like(d)), torch.zeros_like(d))


@dataclasses.dataclass
class LevelDevice:
    """Per-level device tensors."""

    stack: torch.Tensor  # [P, n, n]
    diag_ref: torch.Tensor  # [P, n] diagonals of the stack slices
    first_copy_mask: torch.Tensor  # [E, n] bool
    P_up: torch.Tensor | None  # prolongation to this level from below [n_k, n_{k-1}]
    structured: object  # ops/structured.py::StructuredTables


class MultigridSolver:
    """Owns the device tensors of one (base mesh, nlevels) hierarchy.

    ``device`` places every tensor; ``dtype`` is torch.float32 or
    torch.float64. Coefficients (sigma, lambda) are arguments of the cycle
    methods, as in the JAX class.

    Precision knobs (``apply/smooth/restrict/krylov_precision``) are
    accepted for signature parity: "high" and "highest" (and None) all run
    full FP32 on the CUDA cores in this port; TF32 / 3xTF32 tensor-core
    choices are later work.
    """

    def __init__(
        self,
        plan: GridPlan,
        dtype=torch.float64,
        device="cpu",
        smoothing_steps: int = 3,
        coarse_smoothing_steps: int = 2,
        coarse: str = "chol",
        combine: str = "auto",
        apply_precision=None,
        smoother: str = "chebyshev",
        cheb_ratio: float = 30.0,
        constraint: str = "auto",
        smooth_precision=None,
        cycle: str = "V",
        restrict_precision=None,
        krylov_precision=None,
    ):
        if smoother not in CHEBYSHEV_SMOOTHERS:
            raise NotImplementedError(f"smoother={smoother!r} is not ported yet")
        if coarse != "chol":
            raise NotImplementedError(f"coarse={coarse!r} is not ported yet")
        if cycle != "V":
            raise NotImplementedError("cycle='W' is not ported yet")
        if constraint != "auto":
            raise NotImplementedError("constraint='mask' is not ported yet")
        if combine not in ("auto", "structured"):
            raise NotImplementedError(f"combine={combine!r} is not ported yet")
        for p in (apply_precision, smooth_precision, restrict_precision, krylov_precision):
            if p not in _PRECISIONS:
                raise ValueError(f"precision {p!r} not in {_PRECISIONS}")
        if dtype not in (torch.float32, torch.float64):
            raise TypeError(f"dtype {dtype} not supported")
        self.plan = plan
        self.dtype = dtype
        self.device = torch.device(device)
        self.nlevels = plan.nlevels
        self.smoothing_steps = smoothing_steps
        self.coarse_smoothing_steps = coarse_smoothing_steps
        self.cheb_ratio = cheb_ratio
        self._np_dtype = np.float32 if dtype == torch.float32 else np.float64

        det = detect_structured(plan.base)
        if det is None or plan.reference.layout is None:
            raise NotImplementedError(
                "the port needs a full-box hypercube base (structured combine); "
                "the gather combine is not ported yet"
            )

        ref_ops = build_level_operators(plan.reference, dtype=np.float64)
        dev = self.device

        def tens(a, dt=dtype):
            return torch.as_tensor(np.ascontiguousarray(a), device=dev).to(dt)

        self.levels: list[LevelDevice] = []
        for k in range(self.nlevels):
            lay = plan.reference.layout[k]
            i0 = int(
                min(
                    list(lay.face_offsets) + list(lay.edge_offsets)
                    + list(lay.corner_cols)
                )
            )
            sc = build_structured_combine_auto(plan, k, det=det)
            stack = ref_ops[k].stack
            self.levels.append(
                LevelDevice(
                    stack=tens(stack),
                    diag_ref=tens(np.diagonal(stack, axis1=1, axis2=2)),
                    first_copy_mask=tens(plan.levels[k].first_copy_mask, torch.bool),
                    P_up=tens(prolongation_dense(plan.reference, k - 1)) if k > 0 else None,
                    structured=flatten_structured(sc, i0, device=dev),
                )
            )

        self.base_elements = tens(plan.base.elements, torch.int64)
        self.n_base_nodes = plan.base.nnodes
        self.interior_idx = tens(plan.interior_base_nodes, torch.int64)
        self._dinv_key = None
        self._dinv = None
        self._cheb_key = None
        self._cheb_ab = None

    # ------------------------------------------------------------------ #
    # coefficient / coarse-operator setup (host precompute per field)
    # ------------------------------------------------------------------ #
    def coefficients(self, sigma_el, lam: float):
        """[E, P] apply coefficients, shared by all levels."""
        c = element_coefficients(self.plan.base, sigma_el, lam, dtype=self._np_dtype)
        return torch.as_tensor(c, device=self.device)

    def coarse_cholesky(self, sigma_el, lam: float):
        """Cholesky factor of the interior coarse operator: the dense f64
        operator is assembled on the host, factored by
        ``torch.linalg.cholesky`` in f64 on the solver's device, and stored
        at the solver dtype (the JAX package factors in numpy; same math)."""
        A = assemble_operator(self.plan.base, sigma_el, lam, dtype=np.float64)
        ii = self.plan.interior_base_nodes
        A_int = torch.as_tensor(A[np.ix_(ii, ii)].toarray(), device=self.device)
        L = torch.linalg.cholesky(A_int)
        del A_int
        return L.to(self.dtype)

    def coarse_setup(self, sigma_el, lam: float):
        """Per-(sigma, lam) coarse payload passed to the cycles: the factor."""
        return self.coarse_cholesky(sigma_el, lam)

    # ------------------------------------------------------------------ #
    # building blocks
    # ------------------------------------------------------------------ #
    def _combine(self, x, k):
        return combine_structured(x, self.levels[k].structured)

    def _constrain(self, x, k):
        return constrain_structured(x, self.levels[k].structured)

    def _combine_constrained(self, x, k):
        """combine(constrain(x)) in one pass (the zero-Dirichlet fold)."""
        return combine_structured(x, self.levels[k].structured, constrain=True)

    @staticmethod
    def _vdot(a, b):
        return torch.dot(a.reshape(-1), b.reshape(-1))

    @staticmethod
    def _safe_div(num, den):
        """num / den, but 0 when den == 0 (converged-exactly guard)."""
        zero = den == 0
        return torch.where(zero, torch.zeros_like(num), num / torch.where(zero, torch.ones_like(den), den))

    def _apply_op(self, x, coeff, k, b=None, out=None):
        return element_apply(x, coeff, self.levels[k].stack, b=b, out=out)

    def _local_residual(self, x, b, coeff, k):
        """r = constrain(b - A x)."""
        return self._constrain(self._apply_op(x, coeff, k, b=b), k)

    def diagonal(self, coeff, k):
        """Assembled diagonal on the duplicated layout: each copy gets the
        full assembled diagonal entry."""
        d = torch.matmul(coeff, self.levels[k].diag_ref)
        return self._combine(d.contiguous(), k)

    def _dinv_all(self, coeff):
        """Inverse diagonals of every level, computed once per coefficient
        tensor (the JAX smoother recomputes them on every call)."""
        if self._dinv_key is not coeff:
            self._dinv = [_inv_positive(self.diagonal(coeff, k)) for k in range(self.nlevels)]
            self._dinv_key = coeff
        return self._dinv

    def _cheb_coeffs(self, lam_max: float):
        """[steps, 2] device table of the Chebyshev (a, b) per step: row 0 is
        the first step (p = b z), row j-1 step j (p = a p + b z). Scalars
        follow the JAX recurrence operation for operation."""
        steps = max(self.smoothing_steps, self.coarse_smoothing_steps)
        key = (float(lam_max), steps)
        if self._cheb_key != key:
            lam_max = float(lam_max)
            lam_min = lam_max / self.cheb_ratio
            theta = 0.5 * (lam_max + lam_min)
            delta = 0.5 * (lam_max - lam_min)
            rows = [(0.0, 1.0 / theta)]
            sigma = theta / delta
            rho = 1.0 / sigma
            for _ in range(2, steps + 1):
                rho_new = 1.0 / (2.0 * sigma - rho)
                rows.append((rho_new * rho, 2.0 * rho_new / delta))
                rho = rho_new
            self._cheb_ab = torch.tensor(rows, dtype=self.dtype, device=self.device)
            self._cheb_key = key
        return self._cheb_ab

    # ------------------------------------------------------------------ #
    # lambda_max estimate (D-inner-product Lanczos)
    # ------------------------------------------------------------------ #
    @staticmethod
    def _lanczos_top(alphas, betas):
        """Top eigenvalue of the Lanczos tridiagonal (host, numpy)."""
        a = np.asarray(alphas, np.float64)
        b_ = np.asarray(betas, np.float64)[:-1]
        T = np.diag(a) + np.diag(b_, 1) + np.diag(b_, -1)
        return float(np.linalg.eigvalsh(T)[-1])

    def estimate_lambda_max(self, coeff, k=None, iters: int = 30, seed: int = 0):
        """Estimate the largest eigenvalue of D^{-1} A on the constrained,
        interface-consistent subspace, times a 1.1 safety margin. Lanczos
        in the D inner product on the first-copy subspace (the JAX
        package's default method; its power iteration is not ported); the
        start vector is ``default_rng(seed).standard_normal`` as in the JAX
        package, so both see the same numbers."""
        k = self.nlevels - 1 if k is None else k
        rng = np.random.default_rng(seed)
        v = torch.as_tensor(
            rng.standard_normal((self.plan.base.nelements, self.plan.n_local(k))),
            device=self.device,
        ).to(self.dtype)
        d = self.diagonal(coeff, k)
        dinv = _inv_positive(d)
        w = self.levels[k].first_copy_mask
        v = self._constrain(self._combine(v, k), k)

        def matvec(u):
            return dinv * self._combine(self._constrain(self._apply_op(u, coeff, k), k), k)

        def ddot(a, b_):
            return self._vdot(a * w, d * b_)

        def nz(s):
            return torch.where(s == 0, torch.ones_like(s), s)

        v = v / nz(torch.sqrt(ddot(v, v)))
        v_prev = torch.zeros_like(v)
        beta_prev = torch.zeros((), dtype=v.dtype, device=v.device)
        alphas, betas = [], []
        for _ in range(iters):
            u = matvec(v)
            alpha = ddot(u, v)
            u = u - alpha * v - beta_prev * v_prev
            beta = torch.sqrt(torch.clamp(ddot(u, u), min=0.0))
            v_prev, v = v, u / nz(beta)
            beta_prev = beta
            alphas.append(alpha)
            betas.append(beta)
        lam = self._lanczos_top(
            torch.stack(alphas).cpu().numpy(), torch.stack(betas).cpu().numpy()
        )
        return lam * _LAM_SAFETY

    # ------------------------------------------------------------------ #
    # smoother, coarse solve, cycles
    # ------------------------------------------------------------------ #
    def _smooth_chebyshev(
        self, x, b, coeff, lam_max, *, k, steps, need_r=True, x_zero=False
    ):
        """Jacobi-preconditioned first-kind Chebyshev smoother on D^{-1}A over
        [lam_max/cheb_ratio, lam_max]. Updates x in place; returns
        (x, r_loc) with the LOCAL residual maintained incrementally (None
        when ``need_r`` is False: the final r -= A p is skipped).
        ``x_zero``: the caller guarantees x == 0, so the entry residual
        b - A x is b itself and its apply is skipped (same values)."""
        dinv = self._dinv_all(coeff)[k]
        ab = self._cheb_coeffs(lam_max)
        # entry residual, then incremental r_loc -= A p (fused epilogue)
        r_loc = b.clone() if x_zero else self._apply_op(x, coeff, k, b=b)
        p = torch.empty_like(x)
        chebyshev_update(x, p, self._combine_constrained(r_loc, k), dinv, ab[0], first=True)
        for j in range(2, steps + 1):
            self._apply_op(p, coeff, k, b=r_loc, out=r_loc)
            chebyshev_update(x, p, self._combine_constrained(r_loc, k), dinv, ab[j - 1])
        if not need_r:
            return x, None
        self._apply_op(p, coeff, k, b=r_loc, out=r_loc)
        return x, r_loc

    def _coarse_solve_chol(self, b0, chol):
        """Direct coarse solve (reference: vcycle! k==1 branch,
        src/multigrid.jl:74-93)."""
        u = copy_to_base(b0, self.base_elements, self.n_base_nodes)
        b_int = u[self.interior_idx]
        sol_int = torch.cholesky_solve(b_int[:, None], chol)[:, 0]
        sol = torch.zeros(self.n_base_nodes, dtype=b0.dtype, device=b0.device)
        sol[self.interior_idx] = sol_int
        return distribute(sol, self.base_elements)

    def _vcycle_impl(
        self, x_top, b_top, coeff, chol, lam_max, top=None, need_r=True,
        x_zero=False,
    ):
        """One V-cycle from level ``top``; x_top is updated in place.
        Returns (x_top, r_finest) with r_finest the combined, constrained
        residual after the post-smooth (None when ``need_r`` is False).
        ``x_zero``: x_top is known to be zero (the preconditioner cycles of
        PCG); every sub-top pre-smooth starts from zero anyway."""
        top = self.nlevels - 1 if top is None else top
        E = x_top.shape[0]
        xs = [None] * self.nlevels
        bs = [None] * self.nlevels
        xs[top], bs[top] = x_top, b_top

        def descend(k):
            if k == 0:
                xs[0] = self._coarse_solve_chol(bs[0], chol)
                return None
            steps = self.smoothing_steps if k == top else self.coarse_smoothing_steps
            x, r_local = self._smooth_chebyshev(
                xs[k], bs[k], coeff, lam_max, k=k, steps=steps,
                x_zero=x_zero or k != top,
            )
            bs[k - 1] = restrict(r_local, self.levels[k].P_up)
            del r_local
            if k - 1 > 0:
                xs[k - 1] = torch.zeros(
                    (E, self.plan.n_local(k - 1)), dtype=x.dtype, device=x.device
                )
            descend(k - 1)
            x = prolong_add(x, xs[k - 1], self.levels[k].P_up)
            xs[k - 1] = None
            want = need_r and k == top
            x, r_local = self._smooth_chebyshev(
                x, bs[k], coeff, lam_max, k=k, steps=steps, need_r=want
            )
            xs[k] = x
            return self._combine_constrained(r_local, k) if want else None

        r_fine = descend(top)
        return xs[top], r_fine

    # ------------------------------------------------------------------ #
    # public API
    # ------------------------------------------------------------------ #
    def zero_states(self):
        """(x, b) zeros at the finest level."""
        E = self.plan.base.nelements
        shape = (E, self.plan.n_local(self.nlevels - 1))
        return (
            torch.zeros(shape, dtype=self.dtype, device=self.device),
            torch.zeros(shape, dtype=self.dtype, device=self.device),
        )

    def vcycle(self, x, b, coeff, chol, lam_max):
        """One V-cycle: (x, b) -> (x, r_finest), both [E, n_local(finest)].
        ``x`` is not modified (the cycle runs on a copy)."""
        return self._vcycle_impl(x.clone(), b, coeff, chol, float(lam_max))

    def _pcg_rnorm(self, r):
        """Exact first-copy residual norm from a local-form residual."""
        top = self.nlevels - 1
        rr = apply_mask(self._combine(r, top), self.levels[top].first_copy_mask)
        return torch.sqrt(self._vdot(rr, rr))

    def _pcg_init_impl(self, x, b, coeff, chol, lam_max):
        top = self.nlevels - 1
        r = self._local_residual(x, b, coeff, top)
        z, _ = self._vcycle_impl(
            torch.zeros_like(x), r, coeff, chol, lam_max, need_r=False, x_zero=True
        )
        rz = self._vdot(z, r)
        return x, r, z, rz, self._pcg_rnorm(r)

    def _pcg_step_impl(self, x, r, p, rz, coeff, chol, lam_max):
        """One PCG iteration; x, r and p are updated in place. Exact global
        dots without combines: p and z are interface-consistent, Ap and r
        stay in local form (see the JAX method for the identity). The beta
        is the classic one: with the direct coarse solve the V-cycle is a
        fixed SPD operator (the JAX package's flexible beta serves its
        tolerance-stopped coarse solves, not ported yet)."""
        top = self.nlevels - 1
        Ap = self._constrain(self._apply_op(p, coeff, top), top)
        alpha = self._safe_div(rz, self._vdot(p, Ap))
        x.addcmul_(p, alpha)
        r.addcmul_(Ap, alpha, value=-1.0)
        del Ap
        z, _ = self._vcycle_impl(
            torch.zeros_like(x), r, coeff, chol, lam_max, need_r=False, x_zero=True
        )
        rz_new = self._vdot(z, r)
        p.mul_(self._safe_div(rz_new, rz)).add_(z)
        return x, r, p, rz_new, self._pcg_rnorm(r)

    def pcg(self, b, coeff, chol, lam_max, x=None, *, iters: int = 50,
            tol: float = 0.0):
        """Solve A u = b by V-cycle-preconditioned CG; one V-cycle plus one
        fine-level apply per iteration. ``b`` is the local (duplicated-
        contribution) rhs. Returns (x, history), history = exact first-copy
        residual norms (index 0 = initial residual). ``x`` is not modified."""
        lam_max = float(lam_max)
        x = self.zero_states()[0] if x is None else x.clone()
        x, r, p, rz, rn = self._pcg_init_impl(x, b, coeff, chol, lam_max)
        history = [float(rn)]
        for _ in range(iters):
            x, r, p, rz, rn = self._pcg_step_impl(x, r, p, rz, coeff, chol, lam_max)
            history.append(float(rn))
            if tol and history[-1] <= tol * history[0]:
                break
        return x, history

    def _fmg_impl(self, b_top, coeff, chol, lam_max, nu):
        top = self.nlevels - 1
        bs = [None] * self.nlevels
        bs[top] = b_top
        for k in range(top, 0, -1):
            bs[k - 1] = restrict(self._constrain(bs[k], k), self.levels[k].P_up)
        x = self._coarse_solve_chol(bs[0], chol)
        r = None
        for k in range(1, top + 1):
            x = torch.matmul(x, self.levels[k].P_up.T)
            for i in range(nu):
                x, r = self._vcycle_impl(
                    x, bs[k], coeff, chol, lam_max, top=k,
                    need_r=(k == top and i == nu - 1),
                )
        return x, r

    def fmg(self, b, coeff, chol, lam_max, nu: int = 1):
        """Full-multigrid (F-cycle) initializer: restrict the rhs down the
        hierarchy, solve at the base, then ascend — prolong and run ``nu``
        V-cycles per level. Returns (x, r_finest) like ``vcycle``."""
        assert nu >= 1, "fmg needs at least one V-cycle per ascent level"
        assert self.nlevels >= 2, "fmg needs a hierarchy"
        return self._fmg_impl(b, coeff, chol, float(lam_max), int(nu))

    def solve(self, b, sigma_el, lam: float = 0.0, *, tol: float = 1e-8,
              max_cycles: int = 100, method: str = "auto", x=None,
              verbose: bool = False):
        """One-call solve of (lam - div sigma grad) u = b to a relative
        residual tolerance; returns (x, history). See ``solve_driver``."""
        return solve_driver(
            self, b, sigma_el, lam, tol=tol, max_cycles=max_cycles,
            method=method, x=x, verbose=verbose,
        )

    def initial_residual_norm(self, b, coeff, x=None):
        """Exact first-copy norm of the constrained combined residual
        b - A x (x=None means zero)."""
        top = self.nlevels - 1
        r = b if x is None else self._apply_op(x, coeff, top, b=b)
        return self.residual_norm(self._combine_constrained(r, top))

    def combine(self, x, k=None):
        """Interface combine at level k (default: finest)."""
        k = self.nlevels - 1 if k is None else k
        return self._combine(x, k)

    def residual_norm(self, r, k=None):
        """Norm with each fine DOF counted once (reference:
        zero_out_all_but_one! + norm, src/implicit_fine_grid.jl:334-386)."""
        k = self.nlevels - 1 if k is None else k
        rr = apply_mask(r, self.levels[k].first_copy_mask)
        return torch.sqrt(self._vdot(rr, rr))


def solve_driver(
    solver, b, sigma_el, lam: float = 0.0, *, tol: float = 1e-8,
    max_cycles: int = 100, method: str = "auto", x=None, verbose: bool = False,
):
    """The one-call tolerance-driven solve (same stopping logic and
    normalization as the JAX package's ``solve_driver``).

    ``method``: "vcycle", "fmg", "pcg", "fmg+pcg", or "auto" = "fmg+pcg"
    from a zero start and "pcg" from a caller's ``x``."""
    if method == "auto":
        method = "pcg" if x is not None else "fmg+pcg"
    coeff = solver.coefficients(sigma_el, lam)
    setup = solver.coarse_setup(sigma_el, lam)
    lam_max = solver.estimate_lambda_max(coeff)
    b_norm = float(solver.residual_norm(b))
    if b_norm == 0.0:
        return (solver.zero_states()[0] if x is None else x), [0.0]
    if x is None and method in ("vcycle", "pcg"):
        x, _ = solver.zero_states()
    history = [float(solver.initial_residual_norm(b, coeff, x=x)) / b_norm]
    if verbose:
        print(f"initial: rel residual {history[0]:.3e}", flush=True)
    if history[0] <= tol:
        return (solver.zero_states()[0] if x is None else x), history
    if method in ("fmg", "fmg+pcg"):
        assert x is None, (
            "method includes 'fmg', which starts from scratch and would "
            "ignore x=; drop x= or use method='pcg'/'vcycle'"
        )
        x, r = solver.fmg(b, coeff, setup, lam_max=lam_max)
        history.append(float(solver.residual_norm(r)) / b_norm)
        if verbose:
            print(f"fmg: rel residual {history[-1]:.3e}", flush=True)
    if method in ("pcg", "fmg+pcg"):
        if history[-1] > tol:
            x, hist_p = solver.pcg(
                b, coeff, setup, lam_max=lam_max, x=x,
                iters=max_cycles, tol=tol / history[-1],
            )
            history.extend(h / b_norm for h in hist_p[1:])
            if verbose:
                print(f"pcg: rel residual {history[-1]:.3e} "
                      f"after {len(hist_p) - 1} iters", flush=True)
    else:
        while len(history) - 1 < max_cycles and history[-1] > tol:
            x, r = solver.vcycle(x, b, coeff, setup, lam_max=lam_max)
            history.append(float(solver.residual_norm(r)) / b_norm)
            if verbose:
                print(f"cycle {len(history) - 1}: rel residual "
                      f"{history[-1]:.3e}", flush=True)
    return x, history
