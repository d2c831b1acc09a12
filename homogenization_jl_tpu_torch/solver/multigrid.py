"""Matrix-free geometric multigrid on the implicit fine grid (device, PyTorch).

Port of the main-path subset of homogenization_jl_tpu/solver/multigrid.py:
the structured interface combine with the structured (mask-free) Dirichlet
constraint, the Jacobi-preconditioned first-kind Chebyshev smoother, the
coarse solves (``coarse=``):

  * ``"chol"``: dense Cholesky of the interior base operator;
  * ``"inv"``:  dense interior inverse, applied as one GEMV;
  * ``"cg"``:   tolerance-stopped CG on the global base-node vector;
  * ``"mg"``:   tolerance-stopped PCG on the global base-node vector,
    preconditioned by Chebyshev smoothing on the exact level-0 operator
    around one V-cycle of an auxiliary hierarchy on the coarsened box
    (solver/coarse.py; the aux solver is a ``coarse="inv"`` instance of
    this class);

V-cycles, the FMG initializer, V-cycle-preconditioned CG (flexible beta for
the tolerance-stopped coarse solves) and the one-call ``solve`` driver
(``method="auto"`` = FMG start + PCG).

Every device kernel on this path is a hand kernel on CUDA tensors:
  * K1 ``element_apply`` (ops/apply.py, CUDA C++);
  * K2 ``combine_structured`` / ``constrain_structured`` (ops/structured.py,
    CUDA C++);
  * K3 ``chebyshev_update`` (ops/chebyshev.py, Triton), also the level-0
    junction smoother of ``coarse="mg"``;
  * K6 ``lattice_*`` (ops/stencil.py, CUDA C++): the level-0 operator of the
    global-space coarse solves;
  * K7 ``segment_sum`` / ``gather_scale`` (ops/interfaces.py, CUDA C++): the
    local/global transfers of every coarse solve.
Restriction/prolongation are ``torch.matmul`` (ops/transfer.py), dots are
``torch.dot``, the direct coarse solves ``torch.cholesky_solve`` and a
``torch.mv`` with the inverse — the JAX package leaves the same to XLA and
``cho_solve``.

PyTorch runs eagerly: where the JAX package relies on dead-code elimination
inside one jitted program (the post-smooth residual that no caller reads),
this port skips the computation explicitly (``need_r``). State updates of
the smoother and of PCG run in place. The tolerance-stopped coarse loops
(``lax.while_loop`` in JAX) are Python loops that read one device scalar
per iteration (``host_syncs`` counts the reads).

Not in this slice (raise on construction): the cg / cg_exact / chebyshev4
smoothers, W-cycles, the gather combine and the mask constraint,
direction_dtype and mixed precision.
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
from ..ops.interfaces import (
    apply_mask,
    build_segment_tables,
    copy_to_base,
    distribute,
    gather_scale,
    index_tensor,
)
from ..ops.plan import GridPlan
from ..ops.structured import (
    build_structured_combine_auto,
    combine_structured,
    constrain_structured,
    detect_structured,
    flatten_structured,
)
from ..ops.stencil import (
    build_lattice_stencil,
    lattice_apply,
    lattice_assemble,
    lattice_distribute,
    lattice_weights,
)
from ..ops.transfer import prolong_add, restrict
from .coarse import build_coarse_geometry

CHEBYSHEV_SMOOTHERS = ("chebyshev",)
COARSE_SOLVES = ("chol", "inv", "cg", "mg")
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


@dataclasses.dataclass
class MGCoarseSetup:
    """Per-(sigma, lam) payload of ``coarse="mg"`` (the JAX package's dict
    minus the level tensors, which the aux solver owns)."""

    coeff: torch.Tensor  # aux apply coefficients [E0, P]
    inv: torch.Tensor  # aux interior inverse (its coarse="inv" payload)
    lam_max: float  # aux Chebyshev bound
    lam_max0: float  # junction Chebyshev bound (exact level-0 operator)
    dinv: torch.Tensor  # [N] inverse assembled level-0 diagonal * interior mask


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
        coarse_cg_tol: float = 1e-12,
        coarse_cg_maxiter: int = 500,
        combine: str = "auto",
        apply_precision=None,
        smoother: str = "chebyshev",
        cheb_ratio: float = 30.0,
        coarse_mg_tol: float = 1e-8,
        coarse_mg_maxiter: int = 40,
        coarse_prec_cycles: int = 1,
        coarse_prec_smooth: int = 2,
        coarse_mg_dense_limit: int = 4000,
        constraint: str = "auto",
        smooth_precision=None,
        cycle: str = "V",
        restrict_precision=None,
        krylov_precision=None,
    ):
        if smoother not in CHEBYSHEV_SMOOTHERS:
            raise NotImplementedError(f"smoother={smoother!r} is not ported yet")
        if coarse not in COARSE_SOLVES:
            raise ValueError(f"coarse={coarse!r} not in {COARSE_SOLVES}")
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
        self.coarse_kind = coarse
        self.coarse_cg_tol = coarse_cg_tol
        self.coarse_cg_maxiter = coarse_cg_maxiter
        self.coarse_mg_tol = coarse_mg_tol
        self.coarse_mg_maxiter = coarse_mg_maxiter
        self.coarse_prec_cycles = coarse_prec_cycles
        self.coarse_prec_smooth = coarse_prec_smooth
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

        base = plan.base
        N = base.nnodes
        self.n_base_nodes = N
        ii = plan.interior_base_nodes
        # level-0 transfer tables (kernel K7): the base element rows as an
        # index table (distribute), their presorted segment sum (local
        # contributions -> global nodes, the JAX _asm_perm/_asm_node), and
        # for the direct coarse solves the interior gather plus the interior
        # solution's way back to the duplicated layout in one gather
        # (boundary nodes read an appended zero)
        self._base_idx = index_tensor(base.elements, dev)
        self._asm = build_segment_tables(base.elements, N, dev)
        im = np.zeros(N, dtype=bool)
        im[ii] = True
        self._interior_mask_N = torch.as_tensor(im, device=dev)
        pos = np.full(N, len(ii), dtype=np.int64)
        pos[ii] = np.arange(len(ii))
        self._int_idx = index_tensor(ii, dev)
        self._int_dist = index_tensor(pos[base.elements], dev)
        # on box bases the global-space coarse solves apply the level-0
        # operator as a lattice stencil (kernel K6, ops/stencil.py)
        self.lattice_stencil = build_lattice_stencil(base)

        self._dinv_key = None
        self._dinv = None
        self._lat_key = None
        self._lat_W = None
        self._cheb_ab = {}
        # instrumentation of the tolerance-stopped coarse loops: iterations
        # of each coarse solve, and device scalars read by the host
        self.coarse_iterations: list[int] = []
        self.host_syncs = 0

        # base-mesh coarsening below level 0 (coarse="mg"): an auxiliary
        # implicit hierarchy on the coarsened box preconditions PCG on the
        # exact level-0 operator (solver/coarse.py)
        self.coarse_geom = None
        self.aux_solver = None
        if coarse == "mg":
            g = build_coarse_geometry(plan, dense_limit=coarse_mg_dense_limit)
            if g is None:
                raise ValueError(
                    "coarse='mg' requires a full-box hypercube base mesh with an "
                    "even cell count; use coarse='chol' or 'cg' otherwise"
                )
            self.coarse_geom = g
            self.aux_solver = MultigridSolver(
                g.plan, dtype=dtype, device=dev, smoother="chebyshev", coarse="inv"
            )
            self._node_map = index_tensor(g.node_map, dev)
            self._aux_first_flat = index_tensor(g.aux_first_flat, dev)
            self._aux_first_mask = torch.as_tensor(g.aux_first_mask != 0, device=dev)

    # ------------------------------------------------------------------ #
    # coefficient / coarse-operator setup (host precompute per field)
    # ------------------------------------------------------------------ #
    def coefficients(self, sigma_el, lam: float):
        """[E, P] apply coefficients, shared by all levels."""
        c = element_coefficients(self.plan.base, sigma_el, lam, dtype=self._np_dtype)
        return torch.as_tensor(c, device=self.device)

    def _interior_operator(self, sigma_el, lam: float):
        """The dense f64 interior base operator, on the solver's device
        (rows, then columns: scipy's fancy ``A[np.ix_(ii, ii)]`` is orders of
        magnitude slower at a 36k-node base)."""
        A = assemble_operator(self.plan.base, sigma_el, lam, dtype=np.float64).tocsr()
        ii = self.plan.interior_base_nodes
        return torch.as_tensor(A[ii][:, ii].toarray(), device=self.device)

    def coarse_cholesky(self, sigma_el, lam: float):
        """Cholesky factor of the interior coarse operator: the dense f64
        operator is assembled on the host, factored by
        ``torch.linalg.cholesky`` in f64 on the solver's device, and stored
        at the solver dtype (the JAX package factors in numpy; same math)."""
        return torch.linalg.cholesky(self._interior_operator(sigma_el, lam)).to(self.dtype)

    def coarse_inverse(self, sigma_el, lam: float):
        """Dense inverse of the interior coarse operator, taken by
        ``torch.linalg.inv`` in f64 on the solver's device and stored at the
        solver dtype (the JAX package inverts in numpy; same math). Applying
        it is one GEMV — the aux hierarchy's coarse solve."""
        return torch.linalg.inv(self._interior_operator(sigma_el, lam)).to(self.dtype)

    def coarse_setup(self, sigma_el, lam: float):
        """Per-(sigma, lam) coarse payload passed to the cycles: the Cholesky
        factor ("chol"), the interior inverse ("inv"), None ("cg"), or an
        ``MGCoarseSetup`` ("mg": the aux hierarchy's coefficients, inverse
        and Chebyshev bound, and the junction smoother's bound and inverse
        diagonal on the exact level-0 operator)."""
        if self.coarse_kind == "chol":
            return self.coarse_cholesky(sigma_el, lam)
        if self.coarse_kind == "inv":
            return self.coarse_inverse(sigma_el, lam)
        if self.coarse_kind == "cg":
            return None
        aux = self.aux_solver
        sigma_aux = self.coarse_geom.average_sigma(sigma_el)
        coeff_a = aux.coefficients(sigma_aux, lam)
        inv_a = aux.coarse_setup(sigma_aux, lam)
        lam_max = aux.estimate_lambda_max(coeff_a)
        coeff0 = self.coefficients(sigma_el, lam)
        lam_max0 = self.estimate_lambda_max(coeff0, k=0)
        dinv_g = _inv_positive(self._diag_global(coeff0))
        return self.mg_setup(coeff_a, inv_a, lam_max, lam_max0, dinv_g)

    def mg_setup(self, coeff, inv, lam_max, lam_max0, dinv_g) -> MGCoarseSetup:
        """The ``coarse="mg"`` payload from its parts (also the entry point
        of interop.py, which carries the JAX package's parts across)."""
        return MGCoarseSetup(
            coeff=coeff, inv=inv, lam_max=float(lam_max), lam_max0=float(lam_max0),
            dinv=dinv_g * self._interior_mask_N,
        )

    def _diag_global(self, coeff0):
        """Assembled global diagonal of the level-0 operator, [N]."""
        return self._to_global(torch.matmul(coeff0, self.levels[0].diag_ref))

    def drop_caches(self) -> None:
        """Forget the per-coefficient device caches (inverse diagonals,
        lattice weights): needed after the level tensors are replaced."""
        self._dinv_key = self._dinv = None
        self._lat_key = self._lat_W = None

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

    def _cheb_coeffs(self, lam_max: float, steps: int | None = None):
        """[steps, 2] device table of the Chebyshev (a, b) per step: row 0 is
        the first step (p = b z), row j-1 step j (p = a p + b z). Scalars
        follow the JAX recurrence operation for operation. Cached by
        (lam_max, steps): the V-cycle's smoother and the level-0 junction
        smoother of coarse="mg" alternate between two keys."""
        if steps is None:
            steps = max(self.smoothing_steps, self.coarse_smoothing_steps)
        key = (float(lam_max), int(steps))
        if key not in self._cheb_ab:
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
            if len(self._cheb_ab) >= 8:  # a new field per solve: stay bounded
                self._cheb_ab.clear()
            self._cheb_ab[key] = torch.tensor(rows, dtype=self.dtype, device=self.device)
        return self._cheb_ab[key]

    # ------------------------------------------------------------------ #
    # level-0 global-space operators (coarse "cg" / "mg")
    # ------------------------------------------------------------------ #
    def _to_global(self, y):
        """Sum duplicated-layout local contributions onto global base nodes:
        [E, d+1] -> [N], the presorted segment sum (kernel K7)."""
        return copy_to_base(y, self._asm)

    def _lattice_weights(self, coeff):
        """Stencil weights of the level-0 operator (kernel K6), computed
        once per coefficient tensor (the JAX package rebuilds them in every
        coarse solve, outside its while_loop)."""
        if self._lat_key is not coeff:
            self._lat_W = lattice_weights(coeff, self.levels[0].stack, self.lattice_stencil)
            self._lat_key = coeff
        return self._lat_W

    def _level0_ops(self, coeff, m):
        """(apply, to_global, distribute) for the global-space level-0
        solves; ``apply(u, b=None)`` is m * (A u), or b - m * (A u). On box
        bases: the lattice-stencil forms (K6); otherwise distribute + element
        apply + segment sum (K7, K1)."""
        st = self.lattice_stencil
        if st is not None:
            W = self._lattice_weights(coeff)
            return (
                lambda u, b=None: lattice_apply(u, W, st, m=m, b=b),
                lambda y0: lattice_assemble(y0, st),
                lambda u: lattice_distribute(u, st),
            )
        stack0 = self.levels[0].stack

        def apply(u, b=None):
            yd = element_apply(distribute(u, self._base_idx), coeff, stack0)
            y = self._to_global(yd) * m
            return y if b is None else b - y

        return apply, self._to_global, lambda u: distribute(u, self._base_idx)

    def _continue(self, rs, eps2, it, maxiter):
        """The while_loop condition of the coarse loops: one device scalar
        read by the host per iteration."""
        if it >= maxiter:
            return False
        self.host_syncs += 1
        return bool(rs > eps2)

    def _eps2(self, tol, rs):
        """tol**2 * (rs + 1e-300) in the state dtype on the device, as the
        JAX expression (in float32, rs + 1e-300 rounds to rs)."""
        return torch.tensor(tol, dtype=rs.dtype, device=rs.device) ** 2 * (rs + 1e-300)

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

    def _coarse_solve(self, b0, coeff, setup):
        """Level-0 solve of the V-cycle / FMG: [E, d+1] local rhs -> [E, d+1]
        consistent solution, by the solver's ``coarse`` kind."""
        kind = self.coarse_kind
        if kind == "chol":
            return self._coarse_solve_direct(
                b0, lambda u: torch.cholesky_solve(u[:, None], setup)[:, 0]
            )
        if kind == "inv":
            return self._coarse_solve_direct(b0, lambda u: torch.mv(setup, u))
        if kind == "mg":
            return self._coarse_solve_mg(b0, coeff, setup)
        return self._coarse_solve_cg(b0, coeff)

    def _coarse_solve_direct(self, b0, solve):
        """Direct interior solve (reference: vcycle! k==1 branch,
        src/multigrid.jl:74-93): assemble onto base nodes (K7 segment sum),
        gather the interior (K7), solve, and gather the solution straight
        back to the duplicated layout (K7; boundary nodes read the appended
        zero)."""
        u = copy_to_base(b0, self._asm)
        sol = solve(gather_scale(u, self._int_idx))
        return gather_scale(torch.cat((sol, sol.new_zeros(1))), self._int_dist)

    def _coarse_solve_cg(self, b0, coeff):
        """Matrix-free coarse solve: CG on the GLOBAL base-node vector to
        ``coarse_cg_tol`` (JAX multigrid.py:884-917), one host read of the
        stopping test per iteration."""
        m = self._interior_mask_N
        Aop, to_g, dist = self._level0_ops(coeff, m)
        b = to_g(b0) * m
        x = torch.zeros_like(b)
        r = b
        p = r
        rs = self._vdot(r, r)
        eps2 = self._eps2(self.coarse_cg_tol, rs)
        it = 0
        while self._continue(rs, eps2, it, self.coarse_cg_maxiter):
            Ap = Aop(p)
            alpha = self._safe_div(rs, self._vdot(p, Ap))
            x = x + alpha * p
            r = r - alpha * Ap
            rs_new = self._vdot(r, r)
            p = r + self._safe_div(rs_new, rs) * p
            rs = rs_new
            it += 1
        self.coarse_iterations.append(it)
        return dist(x)

    def _coarse_solve_mg(self, b0, coeff, setup: MGCoarseSetup):
        """Coarse solve via PCG on the exact level-0 operator in the GLOBAL
        base-node space (JAX multigrid.py:945-1041), preconditioned by
        Chebyshev junction smoothing on the exact operator around one aux-
        hierarchy V-cycle (the sigma-averaged operator on the coarsened box);
        stopped at ``coarse_mg_tol`` with one host read per iteration."""
        m = self._interior_mask_N
        Aop, to_g, dist = self._level0_ops(coeff, m)
        aux = self.aux_solver
        nu = self.coarse_prec_smooth
        ab = self._cheb_coeffs(setup.lam_max0, nu) if nu > 0 else None

        def aux_correct(r):
            # global residual -> aux finest layout in local-contribution
            # form (whole nodal value on the first aux copy) -> aux V-cycle
            b_aux = gather_scale(r, self._node_map, self._aux_first_mask)
            x_a = torch.zeros_like(b_aux)
            for c in range(self.coarse_prec_cycles):
                x_a, _ = aux._vcycle_impl(
                    x_a, b_aux, setup.coeff, setup.inv, setup.lam_max,
                    need_r=False, x_zero=c == 0,
                )
            # aux copies are interface-consistent: read any (the first)
            return gather_scale(x_a, self._aux_first_flat, m)

        def cheb(x, b, x_zero=False):
            # Jacobi-preconditioned Chebyshev on the global vector (the
            # recurrence of _smooth_chebyshev, kernel K3), x updated in
            # place; r = b - A x is one K6 launch. With x == 0 the entry
            # residual is b itself.
            r = b if x_zero else Aop(x, b=b)
            p = torch.empty_like(x)
            chebyshev_update(x, p, r, setup.dinv, ab[0], first=True)
            for j in range(2, nu + 1):
                chebyshev_update(x, p, Aop(x, b=b), setup.dinv, ab[j - 1])
            return x

        def prec(r):
            # one MG cycle at level 0: Chebyshev smoothing on the EXACT
            # operator around the sigma-averaged aux correction (symmetric,
            # linear -> an SPD preconditioner)
            x1 = torch.zeros_like(r)
            if nu > 0:
                cheb(x1, r, x_zero=True)
            x1 = x1 + aux_correct(Aop(x1, b=r))
            if nu > 0:
                cheb(x1, r)
            return x1

        b = to_g(b0) * m
        x = torch.zeros_like(b)
        r = b
        z = prec(r)
        p = z
        rz = self._vdot(r, z)
        rs = self._vdot(r, r)
        eps2 = self._eps2(self.coarse_mg_tol, rs)
        it = 0
        while self._continue(rs, eps2, it, self.coarse_mg_maxiter):
            Ap = Aop(p)
            alpha = self._safe_div(rz, self._vdot(p, Ap))
            x = x + alpha * p
            r = r - alpha * Ap
            z = prec(r)
            rz_new = self._vdot(r, z)
            p = z + self._safe_div(rz_new, rz) * p
            rz = rz_new
            rs = self._vdot(r, r)
            it += 1
        self.coarse_iterations.append(it)
        return dist(x)

    def _vcycle_impl(
        self, x_top, b_top, coeff, chol, lam_max, top=None, need_r=True,
        x_zero=False,
    ):
        """One V-cycle from level ``top``. The pre-smooth updates x_top in
        place; the result is a new tensor (prolongation adds out of place):
        returns (x, r_finest) with r_finest the combined, constrained
        residual after the post-smooth (None when ``need_r`` is False).
        ``x_zero``: x_top is known to be zero (the preconditioner cycles of
        PCG); every sub-top pre-smooth starts from zero anyway."""
        top = self.nlevels - 1 if top is None else top
        E = x_top.shape[0]
        xs = [None] * self.nlevels
        bs = [None] * self.nlevels
        xs[top], bs[top] = x_top, b_top

        def steps(k):
            return self.smoothing_steps if k == top else self.coarse_smoothing_steps

        # the recursion of the JAX form as two loops: a self-referencing
        # closure would be a reference cycle that keeps every level's
        # buffers alive until Python's cycle collector runs (measured: the
        # peak device memory grew by ~1 GB per PCG iteration at 190M DOFs)
        for k in range(top, 0, -1):
            xs[k], r_local = self._smooth_chebyshev(
                xs[k], bs[k], coeff, lam_max, k=k, steps=steps(k),
                x_zero=x_zero or k != top,
            )
            bs[k - 1] = restrict(r_local, self.levels[k].P_up)
            del r_local
            if k - 1 > 0:
                xs[k - 1] = torch.zeros(
                    (E, self.plan.n_local(k - 1)), dtype=x_top.dtype, device=x_top.device
                )
        xs[0] = self._coarse_solve(bs[0], coeff, chol)
        r_fine = None
        for k in range(1, top + 1):
            x = prolong_add(xs[k], xs[k - 1], self.levels[k].P_up)
            xs[k - 1] = bs[k - 1] = None
            want = need_r and k == top
            x, r_local = self._smooth_chebyshev(
                x, bs[k], coeff, lam_max, k=k, steps=steps(k), need_r=want
            )
            xs[k] = x
            if want:
                r_fine = self._combine_constrained(r_local, k)
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

    def vcycle(self, x, b, coeff, chol=None, lam_max=None):
        """One V-cycle: (x, b) -> (x, r_finest), both [E, n_local(finest)].
        ``chol`` is ``coarse_setup(sigma, lam)`` (None for coarse="cg").
        ``x`` is not modified (the cycle runs on a copy)."""
        self._check_setup(chol, lam_max)
        return self._vcycle_impl(x.clone(), b, coeff, chol, float(lam_max))

    def _check_setup(self, chol, lam_max):
        if chol is None and self.coarse_kind != "cg":
            raise ValueError("pass coarse_setup(sigma, lam) as chol")
        if lam_max is None:
            raise ValueError("pass lam_max=estimate_lambda_max(coeff)")

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

    def _pcg_step_impl(self, x, r, p, rz, coeff, chol, lam_max, flexible=False):
        """One PCG iteration; x and p are updated in place, and r too unless
        ``flexible``. Exact global dots without combines: p and z are
        interface-consistent, Ap and r stay in local form (see the JAX method
        for the identity).

        ``flexible``: the Polak-Ribiere beta (rz_new - <z, r_old>) / rz that
        tolerates the mildly nonlinear preconditioner of a tolerance-stopped
        coarse solve; otherwise the classic rz_new / rz. It needs r_old after
        the V-cycle: the new residual goes to a new buffer and r_old lives
        through the V-cycle in place of Ap (freed first), which keeps the
        JAX package's arithmetic — the same peak memory as keeping Ap for
        the algebraically equal -alpha <z, Ap>, and no extra copy pass."""
        top = self.nlevels - 1
        Ap = self._constrain(self._apply_op(p, coeff, top), top)
        alpha = self._safe_div(rz, self._vdot(p, Ap))
        x.addcmul_(p, alpha)
        if flexible:
            r_old, r = r, torch.addcmul(r, Ap, alpha, value=-1.0)
        else:
            r.addcmul_(Ap, alpha, value=-1.0)
        del Ap
        z, _ = self._vcycle_impl(
            torch.zeros_like(x), r, coeff, chol, lam_max, need_r=False, x_zero=True
        )
        rz_new = self._vdot(z, r)
        num = rz_new - self._vdot(z, r_old) if flexible else rz_new
        if flexible:
            del r_old
        p.mul_(self._safe_div(num, rz)).add_(z)
        return x, r, p, rz_new, self._pcg_rnorm(r)

    def pcg(self, b, coeff, chol=None, lam_max=None, x=None, *, iters: int = 50,
            tol: float = 0.0, flexible: bool | None = None):
        """Solve A u = b by V-cycle-preconditioned CG; one V-cycle plus one
        fine-level apply per iteration. ``b`` is the local (duplicated-
        contribution) rhs. ``flexible`` (Polak-Ribiere beta) defaults to
        True for the tolerance-stopped coarse solves ("cg", "mg") and False
        for the direct ones. Returns (x, history), history = exact first-copy
        residual norms (index 0 = initial residual). ``x`` is not modified."""
        self._check_setup(chol, lam_max)
        if flexible is None:
            flexible = self.coarse_kind not in ("chol", "inv")
        lam_max = float(lam_max)
        x = self.zero_states()[0] if x is None else x.clone()
        x, r, p, rz, rn = self._pcg_init_impl(x, b, coeff, chol, lam_max)
        history = [float(rn)]
        for _ in range(iters):
            x, r, p, rz, rn = self._pcg_step_impl(
                x, r, p, rz, coeff, chol, lam_max, flexible=flexible
            )
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
        x = self._coarse_solve(bs[0], coeff, chol)
        r = None
        for k in range(1, top + 1):
            x = torch.matmul(x, self.levels[k].P_up.T)
            for i in range(nu):
                x, r = self._vcycle_impl(
                    x, bs[k], coeff, chol, lam_max, top=k,
                    need_r=(k == top and i == nu - 1),
                )
        return x, r

    def fmg(self, b, coeff, chol=None, lam_max=None, nu: int = 1):
        """Full-multigrid (F-cycle) initializer: restrict the rhs down the
        hierarchy, solve at the base, then ascend — prolong and run ``nu``
        V-cycles per level. Returns (x, r_finest) like ``vcycle``."""
        assert nu >= 1, "fmg needs at least one V-cycle per ascent level"
        assert self.nlevels >= 2, "fmg needs a hierarchy"
        self._check_setup(chol, lam_max)
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
