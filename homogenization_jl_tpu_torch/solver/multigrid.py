"""Matrix-free geometric multigrid on the implicit fine grid (device, PyTorch).

Port of homogenization_jl_tpu/solver/multigrid.py: the interface combines
(``combine=``: the structured slice-add form on lexicographic full-box
hypercube bases, the gather form on any other base with the contiguous
layout), the Dirichlet constraints (``constraint=``: the structured
mask-free form, or a resident bool mask; the gather combine always takes
the mask), the smoothers (``smoother=``):

  * ``"cg"`` (the default, as in the JAX package and the reference):
    ``steps`` CG iterations with the reference's duplicated-DOF dots, wrong
    on purpose (src/multigrid.jl:46-71);
  * ``"cg_exact"``: CG with first-copy (exact) dots, one combine per step
    and the local residual maintained incrementally;
  * ``"chebyshev"`` / ``"chebyshev4"``: Jacobi-preconditioned first- /
    fourth-kind Chebyshev (need ``lam_max``; the only smoothers that keep
    the V-cycle a linear SPD preconditioner for PCG);

V-cycles and W-cycles (``cycle=``), the coarse solves (``coarse=``):

  * ``"chol"``: dense Cholesky of the interior base operator;
  * ``"inv"``:  dense interior inverse, applied as one GEMV;
  * ``"cg"``:   tolerance-stopped CG on the global base-node vector;
  * ``"mg"``:   tolerance-stopped PCG on the global base-node vector,
    preconditioned by Chebyshev smoothing on the exact level-0 operator
    around one V-cycle of an auxiliary hierarchy on the coarsened box
    (solver/coarse.py; the aux solver is a ``coarse="inv"`` instance of
    this class);

the FMG initializer, V-cycle-preconditioned CG (flexible beta for the
tolerance-stopped coarse solves), its stepwise form ``pcg_stepper`` and the
one-call ``solve`` driver (``method="auto"`` = FMG start + PCG for the
Chebyshev smoothers, FMG start + V-cycles for the CG ones), and
mixed-precision PCG (``mixed_precision_setup`` / ``mixed_precision_pcg``:
a float64 Krylov loop around a float32 Chebyshev V-cycle).

Precision surface, as the JAX class's: ``direction_dtype`` stores the
Chebyshev and ``cg_exact`` smoothers' direction vectors narrower than the
state (bfloat16, float16, or float32 under float64) while their updates
run in the state dtype; ``lam_max`` is a scalar or an [nlevels] tensor
(``estimate_lambda_max_levels``: each level's smoother on its own
spectrum); ``estimate_lambda_max`` takes ``method="lanczos"`` (default) or
``"power"``, each with its own safety margin.

Per-call Dirichlet masks, as the JAX package's ``Ls=``/``interior=``
arguments: ``Ls`` is a list of per-level bool boundary masks ([E, n_k],
True on interior DOFs) that replace the solver's constraint for that call
(the lattice-geometry driver shrinks its Dirichlet box this way without a
rebuild), and ``interior`` an [N] bool interior-node mask for the
global-space coarse solves ("cg", "mg"). The port takes the masks alone
where the JAX package takes whole ``LevelDevice`` tuples whose other
fields are the solver's own.

Every device kernel on this path is a hand kernel on CUDA tensors:
  * K1 ``element_apply`` (ops/apply.py, CUDA C++);
  * K2 ``combine_structured`` / ``constrain_structured`` (ops/structured.py,
    CUDA C++), with the mask constraint folded into its store;
  * K8 ``combine_gather_rows`` (ops/interfaces.py, CUDA C++): the gather
    combine, with the mask constraint folded into its store;
  * K3 ``chebyshev_update`` (ops/chebyshev.py, Triton), also the level-0
    junction smoother of ``coarse="mg"``;
  * K4 ``prolong_add`` / ``restrict`` (ops/transfer.py, CUDA C++);
  * K5 ``dot`` (ops/dots.py, CUDA C++): every dot and norm, with the
    first-copy mask and the Lanczos scale fused, in a fixed order;
  * K10 ``cg_step`` / ``cg_direction`` (ops/cg.py, CUDA C++): the CG
    smoothers' and PCG's updates, alpha and beta read from K5's device
    scalars;
  * K18 (ops/elementwise.py, ``apply_mask`` in ops/interfaces.py; CUDA
    C++): the mask constraint, the Lanczos estimate's scale, three-term
    update and normalization, the assembled diagonal and the Jacobi
    inverse; K1 takes the mask at its store where the mask constraint
    follows an apply;
  * K6 ``lattice_*`` (ops/stencil.py, CUDA C++): the level-0 operator of the
    global-space coarse solves;
  * K7 ``segment_sum`` / ``gather_scale`` (ops/interfaces.py, CUDA C++): the
    local/global transfers of every coarse solve;
  * K16, the half-width direction forms of K1, K3, K5 and K10
    (``element_apply_half``, ``chebyshev_update_half``, ``dot_half``,
    ``cg_step_half`` / ``cg_direction_half``): the smoothers under
    ``direction_dtype``;
  * K15 ``downcast_scale`` / ``upcast`` (ops/mixed.py, CUDA C++): the
    float64/float32 boundary of mixed-precision PCG.
The direct coarse solves are ``torch.cholesky_solve`` and a ``torch.mv``
with the inverse — the JAX package leaves the same to ``cho_solve`` and XLA.

PyTorch runs eagerly: where the JAX package relies on dead-code elimination
inside one jitted program (the post-smooth residual that no caller reads),
this port skips the computation explicitly (``need_r``). State updates of
the smoothers and of PCG run in place. A cycle's zero iterates are never
zeroed: the first smoothing update writes them (``x_zero``), as XLA folds
``zeros_like`` into that first use. The tolerance-stopped coarse loops
(``lax.while_loop`` in JAX) are Python loops that read one device scalar
per iteration (``host_syncs`` counts the reads).

Not ported yet (raise on construction): the flat combine of meshes without
the contiguous layout.

The solver's tensors live on ``device``: the card (``"cuda"``) unless the
caller asks for the CPU; without a CUDA device the default raises.

Hooks of the sharded subclasses (parallel/slab.py, parallel/sharding.py),
which hold a block of element rows per rank: ``_rows`` (the rows this
solver holds; None = all, cut on the host by ``rows_of`` before any
element-leading array reaches the device), ``_lattice_window`` (the level-0
lattice planes of those rows), ``_gather_tables`` (a level's gather-combine
tables: the rank's own for the gather-sharded solver) and ``_sum_partial``
(the sum over the ranks of a partial from the rows: every dot of
element-leading states in ``_vdot``, the segment sum of ``_to_global``, the
lattice weights and assembly). The dots of the replicated global-space
coarse loops call K5 directly.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..fem.assembly import assemble_operator
from ..fem.local_operators import build_level_operators, element_coefficients
from ..mesh.reference import prolongation_dense
from ..ops.apply import NARROWER, element_apply, element_apply_half, stack_rowsum, stack_table
from ..ops.cg import cg_direction, cg_direction_half, cg_step, cg_step_half, safe_div
from ..ops.chebyshev import chebyshev_update, chebyshev_update_half
from ..ops.dots import dot, dot_half
from ..ops.elementwise import (
    diagonal as diagonal_sum,
    div_nz,
    inv_positive,
    lanczos_update,
    mul,
)
from ..ops.mixed import downcast_scale, upcast
from ..ops.interfaces import (
    apply_mask,
    build_gather_tables,
    build_segment_tables,
    combine_gather_rows,
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
from ..ops.transfer import build_transfer_tables, prolong_add, restrict
from ..utils.logging import host_read, span, spanned
from .coarse import build_coarse_geometry

# the polynomial (dot-free, linear) smoothers: valid SPD V-cycle
# preconditioners for PCG, and the ones that need lam_max
CHEBYSHEV_SMOOTHERS = ("chebyshev", "chebyshev4")
SMOOTHERS = ("cg", "cg_exact") + CHEBYSHEV_SMOOTHERS
COARSE_SOLVES = ("chol", "inv", "cg", "mg")
_PRECISIONS = (None, "default", "high", "highest")
# safety margins on the lambda_max estimate per method: underestimating
# lets the Chebyshev polynomial amplify the top modes; Lanczos Ritz values
# converge faster on the clustered top spectrum than the power iteration,
# so a smaller margin suffices (the JAX package's values)
_LAM_SAFETY = {"power": 1.15, "lanczos": 1.1}


def _numpy(t):
    """A device tensor's copy on the host, as a NumPy array (``host_read``)."""
    return t.cpu().numpy()


# direction_dtype's names, as jnp.dtype takes them
_DIRECTION_NAMES = {
    "bfloat16": torch.bfloat16, "float16": torch.float16, "half": torch.float16,
    "float32": torch.float32, "single": torch.float32, "float64": torch.float64,
    "double": torch.float64,
}


def direction_dtype_of(direction_dtype, dtype):
    """The torch dtype of a ``direction_dtype`` argument (None, a torch
    dtype or its name) under a state of ``dtype``: None, the state's own, or
    a narrower one; a wider one raises."""
    if direction_dtype is None:
        return None
    dd = _DIRECTION_NAMES.get(direction_dtype, direction_dtype) \
        if isinstance(direction_dtype, str) else direction_dtype
    if dd not in _DIRECTION_NAMES.values():
        raise ValueError(f"direction_dtype {direction_dtype!r} not in {sorted(_DIRECTION_NAMES)}")
    if dd != dtype and dd not in NARROWER[dtype]:
        raise ValueError(f"direction_dtype {dd} is wider than the state's {dtype}")
    return dd


def resolve_device(device=None) -> torch.device:
    """The device of an entry point: the card unless the caller asks for
    another. A CUDA device without a card raises instead of running on the
    CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; pass "
            "device='cpu' to run on the CPU"
        )
    return dev


@dataclasses.dataclass
class LevelDevice:
    """Per-level device tensors."""

    stack: torch.Tensor  # [P, n, n]
    rowsum: torch.Tensor  # [P, n] row sums of the stack slices (K1's shift)
    table: object  # ops/apply.py::StackTable of the stack (K1's nonzeros)
    diag_ref: torch.Tensor  # [P, n] diagonals of the stack slices
    first_copy_mask: torch.Tensor  # [E, n] bool
    P_up: torch.Tensor | None  # prolongation to this level from below [n_k, n_{k-1}]
    transfer: object  # ops/transfer.py::TransferTables of P_up (K4), or None
    structured: object  # ops/structured.py::StructuredTables, or None
    gather: object  # ops/interfaces.py::GatherTables, or None
    boundary_mask: torch.Tensor | None  # [E, n] bool (mask constraint), or None


@dataclasses.dataclass
class MGCoarseSetup:
    """Per-(sigma, lam) payload of ``coarse="mg"`` (the JAX package's dict
    minus the level tensors, which the aux solver owns)."""

    coeff: torch.Tensor  # aux apply coefficients [E0, P]
    inv: torch.Tensor  # aux interior inverse (its coarse="inv" payload)
    lam_max: float  # aux Chebyshev bound
    lam_max0: float  # junction Chebyshev bound (exact level-0 operator)
    dinv_g: torch.Tensor  # [N] inverse assembled level-0 diagonal
    dinv: torch.Tensor  # [N] dinv_g * the solver's interior mask


@dataclasses.dataclass
class _Cycle:
    """The state of one cycle: per-level iterates and right-hand sides
    (None outside the levels in use) and the cycle's arguments."""

    xs: list
    bs: list
    coeff: torch.Tensor
    chol: object
    lam_max: float | tuple | None  # a tuple: one per level
    top: int
    Ls: list | None
    interior: torch.Tensor | None


class MultigridSolver:
    """Owns the device tensors of one (base mesh, nlevels) hierarchy.

    ``device`` places every tensor (default: the card; see
    ``resolve_device``); ``dtype`` is torch.float32 or torch.float64.
    Coefficients (sigma, lambda) are arguments of the cycle methods, as in
    the JAX class.

    ``smoother`` defaults to "cg" and ``cycle`` to "V", as in the JAX
    class. Precision knobs (``apply/smooth/restrict/krylov_precision``) are
    accepted for signature parity: "high" and "highest" (and None) all run
    full FP32 on the CUDA cores in this port; TF32 / 3xTF32 tensor-core
    choices are later work. ``direction_dtype`` (None, torch.bfloat16,
    torch.float16, torch.float32 under float64, or their names) stores the
    smoothers' direction vectors narrower, as the JAX class does.
    """

    # the element rows this solver holds, None for all of them, and the
    # level-0 lattice planes they cover (first plane, count; None = all);
    # the slab subclass sets its rank's before this class's constructor runs
    _rows: slice | None = None
    _lattice_window: tuple[int, int | None] = (0, None)

    @spanned("hz.solver_init")
    def __init__(
        self,
        plan: GridPlan,
        dtype=torch.float64,
        device="cuda",
        smoothing_steps: int = 3,
        coarse_smoothing_steps: int = 2,
        coarse: str = "chol",
        coarse_cg_tol: float = 1e-12,
        coarse_cg_maxiter: int = 500,
        combine: str = "auto",
        apply_precision=None,
        smoother: str = "cg",
        cheb_ratio: float = 30.0,
        coarse_mg_tol: float = 1e-8,
        coarse_mg_maxiter: int = 40,
        coarse_prec_cycles: int = 1,
        coarse_prec_smooth: int = 2,
        coarse_mg_dense_limit: int = 4000,
        constraint: str = "auto",
        smooth_precision=None,
        direction_dtype=None,
        cycle: str = "V",
        restrict_precision=None,
        krylov_precision=None,
    ):
        if smoother not in SMOOTHERS:
            raise ValueError(f"smoother={smoother!r} not in {SMOOTHERS}")
        if coarse not in COARSE_SOLVES:
            raise ValueError(f"coarse={coarse!r} not in {COARSE_SOLVES}")
        if cycle not in ("V", "W"):
            raise ValueError(f"cycle={cycle!r} not in ('V', 'W')")
        if constraint not in ("auto", "mask"):
            raise ValueError(f"constraint={constraint!r} not in ('auto', 'mask')")
        if combine not in ("auto", "structured", "gather"):
            raise NotImplementedError(f"combine={combine!r} is not ported yet")
        for p in (apply_precision, smooth_precision, restrict_precision, krylov_precision):
            if p not in _PRECISIONS:
                raise ValueError(f"precision {p!r} not in {_PRECISIONS}")
        if dtype not in (torch.float32, torch.float64):
            raise TypeError(f"dtype {dtype} not supported")
        # storage dtype of the smoothers' direction vectors between steps
        # (e.g. bfloat16: half their bytes); the updates run in the state
        # dtype. cg_exact recomputes its entry residual at the state dtype
        # each smooth, so the rounding perturbs the V-cycle instead of
        # accumulating. None (or the state dtype) stores them as the state.
        self.direction_dtype = direction_dtype_of(direction_dtype, dtype)
        self._dd = None if self.direction_dtype in (None, dtype) else self.direction_dtype
        self.plan = plan
        self.dtype = dtype
        self.device = resolve_device(device)
        self.nlevels = plan.nlevels
        self.smoother = smoother
        # cycle="W": two sub-cycles below every level under the top (gamma =
        # 2), a stronger coarse correction per cycle (the reference has
        # V-cycles only, src/multigrid.jl:73-119)
        self.cycle = cycle
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

        if plan.reference.layout is None:
            raise NotImplementedError(
                "the port needs the contiguous interface layout (the flat "
                "combine is not ported)"
            )
        # combine="auto": the structured form on a lexicographic full-box
        # hypercube base, the gather form on any other (the driver's
        # reference-order prefix domains)
        det = detect_structured(plan.base) if combine != "gather" else None
        if det is None and combine == "structured":
            raise ValueError(
                "combine='structured' requires a lexicographic full-box "
                "hypercube base mesh; use combine='gather'"
            )
        self.combine_kind = "structured" if det is not None else "gather"
        self.constraint_kind = (
            "mask"
            if (constraint == "mask" or self.combine_kind != "structured")
            else "structured"
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
            structured = gather = bmask = None
            if self.combine_kind == "structured":
                sc = build_structured_combine_auto(plan, k, det=det)
                structured = flatten_structured(sc, i0, device=dev)
            else:
                gather = self._gather_tables(plan, k, dev)
            if self.constraint_kind == "mask":
                bmask = tens(self.rows_of(plan.levels[k].boundary_mask) != 0, torch.bool)
            stack = ref_ops[k].stack
            P_up = tens(prolongation_dense(plan.reference, k - 1)) if k > 0 else None
            self.levels.append(
                LevelDevice(
                    stack=tens(stack),
                    rowsum=stack_rowsum(tens(stack)),
                    table=stack_table(tens(stack)),
                    diag_ref=tens(np.diagonal(stack, axis1=1, axis2=2)),
                    first_copy_mask=tens(self.rows_of(plan.levels[k].first_copy_mask), torch.bool),
                    P_up=P_up,
                    transfer=None if P_up is None else build_transfer_tables(P_up),
                    structured=structured,
                    gather=gather,
                    boundary_mask=bmask,
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
        elements = self.rows_of(base.elements)
        self._base_idx = index_tensor(elements, dev)
        self._asm = build_segment_tables(elements, N, dev)
        im = np.zeros(N, dtype=bool)
        im[ii] = True
        self._interior_mask_N = torch.as_tensor(im, device=dev)
        pos = np.full(N, len(ii), dtype=np.int64)
        pos[ii] = np.arange(len(ii))
        self._int_idx = index_tensor(ii, dev)
        self._int_dist = index_tensor(pos[elements], dev)
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
    @property
    def n_rows(self) -> int:
        """Element rows this solver holds (all of the base's by default)."""
        E = self.plan.base.nelements
        return E if self._rows is None else len(range(E)[self._rows])

    def rows_of(self, a):
        """The rows of a global element-leading host array that this solver
        holds (all of them by default)."""
        return a if self._rows is None else a[self._rows]

    @spanned("hz.coefficients")
    def coefficients(self, sigma_el, lam: float):
        """[E, P] apply coefficients, shared by all levels."""
        c = element_coefficients(self.plan.base, sigma_el, lam, dtype=self._np_dtype)
        return torch.as_tensor(self.rows_of(c), device=self.device)

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

    @spanned("hz.coarse_setup")
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
        dinv_g = inv_positive(self._diag_global(coeff0))
        return self.mg_setup(coeff_a, inv_a, lam_max, lam_max0, dinv_g)

    def mg_setup(self, coeff, inv, lam_max, lam_max0, dinv_g) -> MGCoarseSetup:
        """The ``coarse="mg"`` payload from its parts (also the entry point
        of interop.py, which carries the JAX package's parts across)."""
        return MGCoarseSetup(
            coeff=coeff, inv=inv, lam_max=float(lam_max), lam_max0=float(lam_max0),
            dinv_g=dinv_g, dinv=dinv_g * self._interior_mask_N,
        )

    def _diag_global(self, coeff0):
        """Assembled global diagonal of the level-0 operator, [N]."""
        return self._to_global(diagonal_sum(coeff0, self.levels[0].diag_ref))

    def drop_caches(self) -> None:
        """Forget the per-coefficient device caches (inverse diagonals,
        lattice weights) and rebuild the transfer tables from the levels'
        ``P_up``: needed after the level tensors are replaced."""
        self._dinv_key = self._dinv = None
        self._lat_key = self._lat_W = None
        for L in self.levels:
            if L.P_up is not None:
                L.transfer = build_transfer_tables(L.P_up)

    # ------------------------------------------------------------------ #
    # building blocks
    # ------------------------------------------------------------------ #
    def _gather_tables(self, plan, k, device):
        """Level k's gather-combine tables (the gather-sharded subclass
        returns its shard's)."""
        return build_gather_tables(plan, k, device=device)

    def _bmask(self, k, Ls=None):
        """Level k's boundary mask of this call: the per-call ``Ls`` mask,
        else the solver's own (None: the structured constraint)."""
        return self.levels[k].boundary_mask if Ls is None else Ls[k]

    def _combine(self, x, k):
        L = self.levels[k]
        if L.structured is not None:
            return combine_structured(x, L.structured)
        return combine_gather_rows(x, L.gather)

    def _constrain(self, x, k, Ls=None):
        """Zero-Dirichlet constraint: the structured shell zeroing, or the
        multiply by the level's bool mask (the call's ``Ls`` mask first)."""
        bm = self._bmask(k, Ls)
        if bm is None:
            return constrain_structured(x, self.levels[k].structured)
        return apply_mask(x, bm)

    def _combine_constrained(self, x, k, Ls=None):
        """combine(constrain(x)) in one pass: the structured zero-Dirichlet
        fold, or the combine with the mask multiply at its store (K2 or K8),
        which is the JAX form's apply_mask(combine(x), mask)."""
        L = self.levels[k]
        bm = self._bmask(k, Ls)
        if bm is None:
            return combine_structured(x, L.structured, constrain=True)
        if L.structured is not None:
            return combine_structured(x, L.structured, mask=bm)
        return combine_gather_rows(x, L.gather, mask=bm)

    def _check_Ls(self, Ls):
        """Validate per-call level masks: one bool [E, n_k] tensor per level
        on the solver's device."""
        if Ls is None:
            return None
        Ls = list(Ls)
        if len(Ls) != self.nlevels:
            raise ValueError(f"Ls: {len(Ls)} masks, expected {self.nlevels}")
        E = self.n_rows
        for k, m in enumerate(Ls):
            shape = (E, self.plan.n_local(k))
            if (not isinstance(m, torch.Tensor) or m.dtype != torch.bool
                    or tuple(m.shape) != shape or m.device != self.device):
                raise ValueError(f"Ls[{k}] must be a bool tensor {shape} on {self.device}")
        return Ls

    def _check_interior(self, interior):
        """Validate a per-call coarse interior-node mask ([N] bool; only the
        global-space coarse solves "cg" and "mg" take one)."""
        if interior is None:
            return None
        if self.coarse_kind not in ("cg", "mg"):
            raise ValueError("interior= applies to coarse='cg'/'mg' only")
        if (not isinstance(interior, torch.Tensor) or interior.dtype != torch.bool
                or tuple(interior.shape) != (self.n_base_nodes,)
                or interior.device != self.device):
            raise ValueError(
                f"interior must be a bool tensor ({self.n_base_nodes},) on {self.device}"
            )
        return interior

    def _sum_partial(self, t):
        """The sum over the ranks of a partial computed from this solver's
        rows; on one device, the partial itself."""
        return t

    def _vdot(self, a, b, mask=None, scale=None):
        """Dot of two element-leading states over the duplicated layout,
        the mask and scale fused (kernel K5; K16 when ``a`` is a half-width
        direction)."""
        vd = dot if a.dtype == b.dtype else dot_half
        return self._sum_partial(vd(a, b, mask=mask, scale=scale))

    # num / den, but 0 when den == 0 (converged-exactly guard)
    _safe_div = staticmethod(safe_div)

    def _apply_op(self, x, coeff, k, b=None, out=None, mask=None):
        """A x (with ``b``: b - A x), times the bool ``mask`` at K1's store
        when one is given; an x narrower than coeff (a half-width
        direction) goes through K16's apply, its result in coeff's dtype."""
        L = self.levels[k]
        apply = element_apply if x.dtype == coeff.dtype else element_apply_half
        return apply(x, coeff, L.stack, b=b, out=out, rowsum=L.rowsum, mask=mask, table=L.table)

    def _apply_constrained(self, x, coeff, k, Ls=None, b=None):
        """constrain(A x), with ``b`` constrain(b - A x): the mask multiply
        at K1's store, or the structured constraint after the apply."""
        bm = self._bmask(k, Ls)
        if bm is None:
            return self._constrain(self._apply_op(x, coeff, k, b=b), k)
        return self._apply_op(x, coeff, k, b=b, mask=bm)

    def _local_residual(self, x, b, coeff, k, Ls=None):
        """r = constrain(b - A x)."""
        return self._apply_constrained(x, coeff, k, Ls, b=b)

    def diagonal(self, coeff, k, Ls=None):
        """Assembled diagonal on the duplicated layout: each copy gets the
        full assembled diagonal entry (the pieces summed by K18, then the
        combine). ``Ls`` changes no combine, so the diagonal is the same
        with or without it."""
        return self._combine(diagonal_sum(coeff, self.levels[k].diag_ref), k)

    def _dinv_all(self, coeff):
        """Inverse diagonals of every level, computed once per coefficient
        tensor (the JAX smoother recomputes them on every call)."""
        if self._dinv_key is not coeff:
            self._dinv = [inv_positive(self.diagonal(coeff, k)) for k in range(self.nlevels)]
            self._dinv_key = coeff
        return self._dinv

    def _cheb_coeffs(self, lam_max: float, steps: int | None = None, fourth: bool = False):
        """[steps, 2] device table of the Chebyshev (a, b) per step: row 0 is
        the first step (p = b z), row j-1 step j (p = a p + b z). Scalars
        follow the JAX recurrences operation for operation: the first kind
        on [lam_max/cheb_ratio, lam_max], or with ``fourth`` the fourth kind
        on [0, lam_max] (Lottes 2022: row 0 (0, (4/3)/lam_max), row j-1
        ((2j-3)/(2j+1), (8j-4)/(2j+1)/lam_max)). Cached by (lam_max, steps,
        kind): the V-cycle's smoother and the level-0 junction smoother of
        coarse="mg" (always the first kind) alternate between two keys."""
        if steps is None:
            steps = max(self.smoothing_steps, self.coarse_smoothing_steps)
        key = (float(lam_max), int(steps), bool(fourth))
        if key not in self._cheb_ab:
            lam_max = float(lam_max)
            if fourth:
                rows = [(0.0, (4.0 / 3.0) / lam_max)]
                for j in range(2, steps + 1):
                    rows.append(((2.0 * j - 3.0) / (2.0 * j + 1.0),
                                 (8.0 * j - 4.0) / (2.0 * j + 1.0) / lam_max))
            else:
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
        return self._sum_partial(copy_to_base(y, self._asm))

    def _lattice_weights(self, coeff):
        """Stencil weights of the level-0 operator (kernel K6), computed
        once per coefficient tensor (the JAX package rebuilds them in every
        coarse solve, outside its while_loop)."""
        if self._lat_key is not coeff:
            x0, planes = self._lattice_window
            self._lat_W = self._sum_partial(lattice_weights(
                coeff, self.levels[0].stack, self.lattice_stencil, x0=x0, planes=planes))
            self._lat_key = coeff
        return self._lat_W

    def _level0_ops(self, coeff, m):
        """(apply, to_global, distribute) for the global-space level-0
        solves; ``apply(u, b=None)`` is m * (A u), or b - m * (A u). On box
        bases: the lattice-stencil forms (K6) over this solver's window of
        planes, the operator application replicated; otherwise distribute +
        element apply + segment sum (K7, K1)."""
        st = self.lattice_stencil
        if st is not None:
            W = self._lattice_weights(coeff)
            x0, planes = self._lattice_window
            return (
                lambda u, b=None: lattice_apply(u, W, st, m=m, b=b),
                lambda y0: self._sum_partial(lattice_assemble(y0, st, x0=x0, planes=planes)),
                lambda u: lattice_distribute(u, st, x0=x0, planes=planes),
            )
        L0 = self.levels[0]

        def apply(u, b=None):
            yd = element_apply(distribute(u, self._base_idx), coeff, L0.stack, table=L0.table)
            y = self._to_global(yd) * m
            return y if b is None else b - y

        return apply, self._to_global, lambda u: distribute(u, self._base_idx)

    def _continue(self, rs, eps2, it, maxiter):
        """The while_loop condition of the coarse loops: one device scalar
        read by the host per iteration."""
        if it >= maxiter:
            return False
        self.host_syncs += 1
        return host_read(rs > eps2, bool)

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

    @spanned("hz.lambda_max")
    def estimate_lambda_max(self, coeff, k=None, iters: int = 30, seed: int = 0,
                            method: str = "lanczos"):
        """Estimate the largest eigenvalue of D^{-1} A on the constrained,
        interface-consistent subspace at level k (default: finest), times
        the method's safety margin (``_LAM_SAFETY``). ``method="lanczos"``
        (the default): Lanczos in the D inner product on the first-copy
        subspace, the top eigenvalue of its tridiagonal taken on the host;
        ``"power"``: the power iteration, the Rayleigh quotient of its last
        step. The start vector is ``default_rng(seed).standard_normal`` as
        in the JAX package, so both see the same numbers. The state-sized
        updates run on K18, the dots on K5; the scalars stay on the device
        until the end."""
        if method not in _LAM_SAFETY:
            raise ValueError(f"method={method!r} not in {tuple(_LAM_SAFETY)}")
        k = self.nlevels - 1 if k is None else k
        rng = np.random.default_rng(seed)
        v = torch.as_tensor(
            self.rows_of(rng.standard_normal((self.plan.base.nelements, self.plan.n_local(k)))),
            device=self.device,
        ).to(self.dtype)
        d = self.diagonal(coeff, k)
        dinv = inv_positive(d)
        w = self.levels[k].first_copy_mask
        v = self._constrain(self._combine(v, k), k)

        def matvec(u):
            return mul(dinv, self._combine(self._apply_constrained(u, coeff, k), k))

        if method == "power":
            lam = torch.zeros((), dtype=v.dtype, device=v.device)
            for _ in range(iters):
                y = matvec(v)
                # vdot(v * w, y) / vdot(v * w, v), the mask fused (K5)
                lam = self._vdot(v, y, mask=w) / self._vdot(v, v, mask=w)
                v = div_nz(y, torch.sqrt(self._vdot(y, y, mask=w)), out=y)
            return host_read(lam) * _LAM_SAFETY[method]

        def ddot(a, b_):
            # vdot(a * w, d * b) with the mask and the scale fused (K5)
            return self._vdot(a, b_, mask=w, scale=d)

        # the state-sized updates on K18, the scalars on the device; the
        # first step has no v_prev (JAX: zeros, whose term adds nothing)
        v = div_nz(v, torch.sqrt(ddot(v, v)), out=v)
        v_prev = None
        beta_prev = torch.zeros((), dtype=v.dtype, device=v.device)
        alphas, betas = [], []
        for _ in range(iters):
            u = matvec(v)
            alpha = ddot(u, v)
            u = lanczos_update(u, v, v_prev, alpha, beta_prev, out=u)
            beta = torch.sqrt(torch.clamp(ddot(u, u), min=0.0))
            v_prev, v = v, div_nz(u, beta, out=u)
            beta_prev = beta
            alphas.append(alpha)
            betas.append(beta)
        lam = self._lanczos_top(host_read(torch.stack(alphas), _numpy),
                                host_read(torch.stack(betas), _numpy))
        return lam * _LAM_SAFETY[method]

    def estimate_lambda_max_levels(self, coeff, iters: int = 30, seed: int = 0):
        """Per-level lam_max: an [nlevels] tensor of the state dtype on the
        solver's device, ``estimate_lambda_max`` at every level. Anywhere a
        scalar ``lam_max`` is taken (vcycle, fmg, pcg, solve), such a tensor
        makes each level's Chebyshev smoother target its own D^{-1}A
        spectrum instead of the finest level's."""
        return torch.tensor(
            [self.estimate_lambda_max(coeff, k, iters=iters, seed=seed)
             for k in range(self.nlevels)],
            dtype=self.dtype, device=self.device,
        )

    # ------------------------------------------------------------------ #
    # smoothers, coarse solve, cycles
    # ------------------------------------------------------------------ #
    def _smooth(self, x, b, coeff, lam_max, *, k, steps, need_r=True, x_zero=False, Ls=None):
        """The solver's smoother at level k: updates x in place and returns
        (x, r) — for "cg" the combined residual, for the others the LOCAL
        residual (None when ``need_r`` is False). ``x_zero``: x is taken as
        zero and its values are never read (the first update writes it).
        ``lam_max``: a float, or a per-level tuple (``_check_setup``) whose
        level-k entry this level's Chebyshev smoother takes."""
        if x_zero and steps < 1:
            x.zero_()
        kw = dict(k=k, steps=steps, need_r=need_r, x_zero=x_zero, Ls=Ls)
        if self.smoother == "cg":
            return self._smooth_cg(x, b, coeff, **kw)
        if self.smoother == "cg_exact":
            return self._smooth_cg_exact(x, b, coeff, **kw)
        if isinstance(lam_max, tuple):
            lam_max = lam_max[k]
        return self._smooth_chebyshev(x, b, coeff, lam_max, **kw)

    def _smooth_cg(self, x, b, coeff, *, k, steps, need_r=True, x_zero=False, Ls=None):
        """``steps`` CG iterations (reference: smoothing_steps!,
        src/multigrid.jl:46-71; JAX ``_smooth_cg``): the COMBINED residual
        and A p, and the reference's dots over the duplicated layout, which
        count shared DOFs once per copy — an approximate CG, kept for
        iteration-count parity (homogenized_coefficients.jl:136-139).
        Updates x in place and returns (x, r), r combined and constrained
        (None when ``need_r`` is False: the last step skips its r update).
        The last step's direction and dot, which no caller reads, are
        skipped. ``x_zero``: x is zero (unread: the first step writes it),
        so the entry residual is b."""
        r = self._combine_constrained(b if x_zero else self._apply_op(x, coeff, k, b=b), k, Ls)
        p = r.clone()
        rs = self._vdot(r, r)
        for i in range(steps):
            last = i + 1 == steps
            Ap = self._combine_constrained(self._apply_op(p, coeff, k), k, Ls)
            cg_step(x, None if (last and not need_r) else r, p, Ap, rs, self._vdot(p, Ap),
                    x_zero=x_zero and i == 0)
            del Ap
            if not last:
                rs_new = self._vdot(r, r)
                cg_direction(p, r, p, rs_new, rs)
                rs = rs_new
        return x, (r if need_r else None)

    def _smooth_cg_exact(self, x, b, coeff, *, k, steps, need_r=True, x_zero=False, Ls=None):
        """CG smoothing with exact dots and one combine per step (JAX
        ``_smooth_cg_exact``): the energy p'Ap of an interface-consistent p
        sums over every slot of p * (A_local p), so Ap is never combined;
        the LOCAL residual updates incrementally (r_loc -= alpha A_local p),
        one combine per step, and the final r_loc is what the V-cycle
        restricts. Dots are first-copy weighted (exact; the mask fused into
        K5). Under the structured constraint the separate constrain passes
        are skipped (see the JAX ``_combine_constrained``). Updates x in
        place; returns (x, r_loc), r_loc None when ``need_r`` is False (the
        last step then skips its r update). ``x_zero``: x is zero (unread:
        the first step writes it), so the entry residual is b. Under
        ``direction_dtype`` the direction is stored narrower (K16: p =
        store(rc + beta load(p)), x += alpha load(p), the apply and the dot
        on load(p); ``_smooth_cg_exact_half``)."""
        w = self.levels[k].first_copy_mask
        bm = self._bmask(k, Ls)
        if bm is None:
            r_loc = b.clone() if x_zero else self._apply_op(x, coeff, k, b=b)
        else:
            r_loc = apply_mask(b, bm) if x_zero else self._apply_op(x, coeff, k, b=b, mask=bm)
        if self._dd is not None:
            return self._smooth_cg_exact_half(x, r_loc, coeff, k, steps, need_r, x_zero, Ls)
        p = self._combine_constrained(r_loc, k, Ls)
        rs = self._vdot(p, p, mask=w)
        for i in range(steps):
            last = i + 1 == steps
            Ap = self._apply_op(p, coeff, k, mask=bm)
            cg_step(x, None if (last and not need_r) else r_loc, p, Ap, rs, self._vdot(p, Ap),
                    x_zero=x_zero and i == 0)
            del Ap
            if not last:
                rc = self._combine_constrained(r_loc, k, Ls)
                rs_new = self._vdot(rc, rc, mask=w)
                # p = rc + beta p, written over rc
                cg_direction(rc, rc, p, rs_new, rs)
                p, rs = rc, rs_new
                del rc
        return x, (r_loc if need_r else None)

    def _smooth_cg_exact_half(self, x, r_loc, coeff, k, steps, need_r, x_zero, Ls):
        """``_smooth_cg_exact``'s steps from its entry residual ``r_loc``
        with the direction stored in ``direction_dtype`` (the JAX
        store/load, :822-841): p = store(rc) first (K16's direction store
        without a p), then per step the apply, the dot and x += alpha p on
        load(p) (K16's apply, dot and step), and p = store(rc + beta
        load(p)) in place."""
        w = self.levels[k].first_copy_mask
        bm = self._bmask(k, Ls)
        rc = self._combine_constrained(r_loc, k, Ls)
        rs = self._vdot(rc, rc, mask=w)
        p = torch.empty(rc.shape, dtype=self._dd, device=rc.device)
        cg_direction_half(p, rc, None, rs, rs)
        del rc
        for i in range(steps):
            last = i + 1 == steps
            Ap = self._apply_op(p, coeff, k, mask=bm)
            cg_step_half(x, None if (last and not need_r) else r_loc, p, Ap, rs,
                         self._vdot(p, Ap), x_zero=x_zero and i == 0)
            del Ap
            if not last:
                rc = self._combine_constrained(r_loc, k, Ls)
                rs_new = self._vdot(rc, rc, mask=w)
                cg_direction_half(p, rc, p, rs_new, rs)
                rs = rs_new
                del rc
        return x, (r_loc if need_r else None)

    def _smooth_chebyshev(
        self, x, b, coeff, lam_max, *, k, steps, need_r=True, x_zero=False,
        Ls=None,
    ):
        """Jacobi-preconditioned Chebyshev smoother on D^{-1}A: the first kind
        over [lam_max/cheb_ratio, lam_max], or for "chebyshev4" the fourth
        kind over [0, lam_max] (the same p = a p + b z update, K3, with the
        rows of ``_cheb_coeffs``). Updates x in place; returns
        (x, r_loc) with the LOCAL residual maintained incrementally (None
        when ``need_r`` is False: the final r -= A p is skipped).
        ``x_zero``: x is zero (unread: the first update writes it), so the
        entry residual b - A x is b itself and its apply is skipped (same
        values).
        Under a mask constraint (the solver's, or the call's ``Ls``) the
        entry residual is constrained and each update subtracts the
        constrained A p, as the JAX smoother does; the structured
        constraint skips both (dead boundary rows, see the JAX
        ``_combine_constrained``).
        Under ``direction_dtype`` p is stored narrower (K16: K3 stores the
        rounded p and adds it to x, K1 applies it widened), as the JAX
        ``store``/``load``: x += load(p) adds the ROUNDED direction."""
        dinv = self._dinv_all(coeff)[k]
        ab = self._cheb_coeffs(lam_max, fourth=self.smoother == "chebyshev4")
        bm = self._bmask(k, Ls)
        # entry residual, then incremental r_loc -= A p (fused epilogue;
        # under a mask, r_loc = (r_loc - A p) * bm at K1's store, where JAX
        # computes r_loc - (A p) * bm: the same in exact arithmetic, but K1's
        # residual form is shifted by x[e, 0] (ops/apply.py), so the f32
        # rounding differs, as on the unmasked path since the shift came)
        if bm is None:
            r_loc = b.clone() if x_zero else self._apply_op(x, coeff, k, b=b)
        else:
            r_loc = apply_mask(b, bm) if x_zero else self._apply_op(x, coeff, k, b=b, mask=bm)
        if self._dd is None:
            p, update = torch.empty_like(x), chebyshev_update
        else:
            p = torch.empty(x.shape, dtype=self._dd, device=x.device)
            update = chebyshev_update_half

        def update_residual():
            self._apply_op(p, coeff, k, b=r_loc, out=r_loc, mask=bm)

        update(x, p, self._combine_constrained(r_loc, k, Ls), dinv, ab[0], first=True,
               x_zero=x_zero)
        for j in range(2, steps + 1):
            update_residual()
            update(x, p, self._combine_constrained(r_loc, k, Ls), dinv, ab[j - 1])
        if not need_r:
            return x, None
        update_residual()
        return x, r_loc

    @spanned("hz.coarse_solve")
    def _coarse_solve(self, b0, coeff, setup, interior=None):
        """Level-0 solve of the V-cycle / FMG: [E, d+1] local rhs -> [E, d+1]
        consistent solution, by the solver's ``coarse`` kind; ``interior``
        (cg, mg) replaces the solver's interior-node mask."""
        kind = self.coarse_kind
        if kind == "chol":
            return self._coarse_solve_direct(
                b0, lambda u: torch.cholesky_solve(u[:, None], setup)[:, 0]
            )
        if kind == "inv":
            return self._coarse_solve_direct(b0, lambda u: torch.mv(setup, u))
        if kind == "mg":
            return self._coarse_solve_mg(b0, coeff, setup, interior)
        return self._coarse_solve_cg(b0, coeff, interior)

    def _coarse_solve_direct(self, b0, solve):
        """Direct interior solve (reference: vcycle! k==1 branch,
        src/multigrid.jl:74-93): assemble onto base nodes (K7 segment sum),
        gather the interior (K7), solve, and gather the solution straight
        back to the duplicated layout (K7; boundary nodes read the appended
        zero)."""
        u = self._to_global(b0)
        sol = solve(gather_scale(u, self._int_idx))
        return gather_scale(torch.cat((sol, sol.new_zeros(1))), self._int_dist)

    def _coarse_solve_cg(self, b0, coeff, interior=None):
        """Matrix-free coarse solve: CG on the GLOBAL base-node vector to
        ``coarse_cg_tol`` (JAX multigrid.py:884-917), one host read of the
        stopping test per iteration."""
        m = self._interior_mask_N if interior is None else interior
        Aop, to_g, dist = self._level0_ops(coeff, m)
        b = to_g(b0) * m
        x = torch.zeros_like(b)
        r = b
        p = r
        rs = dot(r, r)
        eps2 = self._eps2(self.coarse_cg_tol, rs)
        it = 0
        while self._continue(rs, eps2, it, self.coarse_cg_maxiter):
            Ap = Aop(p)
            alpha = self._safe_div(rs, dot(p, Ap))
            x = x + alpha * p
            r = r - alpha * Ap
            rs_new = dot(r, r)
            p = r + self._safe_div(rs_new, rs) * p
            rs = rs_new
            it += 1
        self.coarse_iterations.append(it)
        return dist(x)

    def _coarse_solve_mg(self, b0, coeff, setup: MGCoarseSetup, interior=None):
        """Coarse solve via PCG on the exact level-0 operator in the GLOBAL
        base-node space (JAX multigrid.py:945-1041), preconditioned by
        Chebyshev junction smoothing on the exact operator around one aux-
        hierarchy V-cycle (the sigma-averaged operator on the coarsened box);
        stopped at ``coarse_mg_tol`` with one host read per iteration. The
        junction diagonal is masked by the call's interior, when one is
        given, not by the solver's."""
        if interior is None:
            m, dinv = self._interior_mask_N, setup.dinv
        else:
            m, dinv = interior, setup.dinv_g * interior
        Aop, to_g, dist = self._level0_ops(coeff, m)
        aux = self.aux_solver
        nu = self.coarse_prec_smooth
        ab = self._cheb_coeffs(setup.lam_max0, nu) if nu > 0 else None

        def aux_correct(r):
            # global residual -> aux finest layout in local-contribution
            # form (whole nodal value on the first aux copy) -> aux V-cycle
            b_aux = gather_scale(r, self._node_map, self._aux_first_mask)
            x_a = torch.empty_like(b_aux)  # the first cycle writes it (x_zero)
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
            chebyshev_update(x, p, r, dinv, ab[0], first=True)
            for j in range(2, nu + 1):
                chebyshev_update(x, p, Aop(x, b=b), dinv, ab[j - 1])
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
        rz = dot(r, z)
        rs = dot(r, r)
        eps2 = self._eps2(self.coarse_mg_tol, rs)
        it = 0
        while self._continue(rs, eps2, it, self.coarse_mg_maxiter):
            Ap = Aop(p)
            alpha = self._safe_div(rz, dot(p, Ap))
            x = x + alpha * p
            r = r - alpha * Ap
            z = prec(r)
            rz_new = dot(r, z)
            p = z + self._safe_div(rz_new, rz) * p
            rz = rz_new
            rs = dot(r, r)
            it += 1
        self.coarse_iterations.append(it)
        return dist(x)

    def _vcycle_impl(
        self, x_top, b_top, coeff, chol, lam_max, top=None, need_r=True,
        x_zero=False, Ls=None, interior=None,
    ):
        """One cycle (V, or W with ``cycle="W"``) from level ``top``; x_top
        is updated in place and returned: (x_top, r_finest) with r_finest
        the combined, constrained residual after the post-smooth (None when
        ``need_r`` is False). ``x_zero``: x_top is taken as zero and never
        read (the preconditioner cycles of PCG); every sub-top level's first
        pre-smooth starts from zero anyway, in a buffer its first smoothing
        update writes. ``Ls`` / ``interior``: the
        call's level masks and coarse interior mask."""
        top = self.nlevels - 1 if top is None else top
        c = _Cycle(
            xs=[None] * self.nlevels, bs=[None] * self.nlevels, coeff=coeff,
            chol=chol, lam_max=lam_max, top=top, Ls=Ls, interior=interior,
        )
        c.xs[top], c.bs[top] = x_top, b_top
        del x_top, b_top
        r_fine = self._cycle_level(c, top, need_r=need_r, x_zero=x_zero)
        return c.xs[top], r_fine

    def _cycle_level(self, c, k, need_r=False, x_zero=True):
        """Level k of the cycle ``c`` (JAX ``_vcycle_impl``'s ``descend``):
        pre-smooth, restrict, the level below (twice for a W-cycle, the
        second from the first's iterate), prolongate, post-smooth. The
        recursion runs through this bound method and keeps the levels'
        buffers in ``c`` only: a self-referencing closure would be a
        reference cycle that holds every level's buffers until Python's
        cycle collector runs (measured: the peak device memory grew by
        ~1 GB per PCG iteration at 190M DOFs). Returns the post-smooth's
        combined residual when ``need_r``, else None."""
        if k == 0:
            c.xs[0] = self._coarse_solve(c.bs[0], c.coeff, c.chol, c.interior)
            return None
        with span(f"hz.level.{k}"):
            return self._cycle_level_body(c, k, need_r, x_zero)

    def _cycle_level_body(self, c, k, need_r, x_zero):
        """Level k >= 1 of ``_cycle_level``, inside its span."""
        steps = self.smoothing_steps if k == c.top else self.coarse_smoothing_steps
        L = self.levels[k]
        kw = dict(k=k, steps=steps, Ls=c.Ls)
        if self.smoother == "cg":
            # the parity smoother's residual is combined: restriction takes
            # a fresh local residual (the reference structure,
            # src/multigrid.jl:97-105)
            x, _ = self._smooth(c.xs[k], c.bs[k], c.coeff, c.lam_max, need_r=False,
                                x_zero=x_zero, **kw)
            r_local = self._local_residual(x, c.bs[k], c.coeff, k, c.Ls)
        else:
            # cg_exact and the Chebyshev smoothers maintain the local
            # residual: restriction reads it directly
            x, r_local = self._smooth(c.xs[k], c.bs[k], c.coeff, c.lam_max,
                                      x_zero=x_zero, **kw)
        c.bs[k - 1] = restrict(r_local, L.transfer)
        del r_local
        if k - 1 > 0:
            c.xs[k - 1] = x.new_empty((x.shape[0], self.plan.n_local(k - 1)))
        self._cycle_level(c, k - 1)
        if self.cycle == "W" and k - 1 > 0:
            self._cycle_level(c, k - 1, x_zero=False)
        prolong_add(x, c.xs[k - 1], L.transfer, out=x)
        c.xs[k - 1] = c.bs[k - 1] = None
        x, r = self._smooth(x, c.bs[k], c.coeff, c.lam_max, need_r=need_r, **kw)
        if r is None or self.smoother == "cg":
            return r
        return self._combine_constrained(r, k, c.Ls)

    # ------------------------------------------------------------------ #
    # public API
    # ------------------------------------------------------------------ #
    def zero_states(self):
        """(x, b) zeros at the finest level."""
        shape = (self.n_rows, self.plan.n_local(self.nlevels - 1))
        return (torch.zeros(shape, dtype=self.dtype, device=self.device),
                torch.zeros(shape, dtype=self.dtype, device=self.device))

    def vcycle(self, x, b, coeff, chol=None, lam_max=None, Ls=None, interior=None):
        """One cycle (V or W, the solver's ``cycle``): (x, b) -> (x,
        r_finest), both [E, n_local(finest)]. ``chol`` is ``coarse_setup(
        sigma, lam)`` (None for coarse="cg"); ``lam_max`` is needed by the
        Chebyshev smoothers only. ``Ls`` / ``interior`` replace the level
        boundary masks and the coarse interior-node mask for this call (see
        the module docstring). ``x`` is not modified (the cycle runs on a
        copy)."""
        lam_max = self._check_setup(chol, lam_max)
        return self._vcycle_impl(
            x.clone(), b, coeff, chol, lam_max, Ls=self._check_Ls(Ls),
            interior=self._check_interior(interior),
        )

    def _check_setup(self, chol, lam_max):
        """Validate the coarse payload and lam_max; returns lam_max as a
        float, or as a tuple of nlevels floats for a per-level lam_max (an
        [nlevels] tensor or array, ``estimate_lambda_max_levels``; read on
        the host once); None for the CG smoothers, which do not read it."""
        if chol is None and self.coarse_kind != "cg":
            raise ValueError("pass coarse_setup(sigma, lam) as chol")
        if self.smoother not in CHEBYSHEV_SMOOTHERS:
            return None
        if lam_max is None:
            raise ValueError("pass lam_max=estimate_lambda_max(coeff)")
        a = host_read(lam_max.detach(), _numpy) if isinstance(lam_max, torch.Tensor) \
            else np.asarray(lam_max)
        if a.ndim == 0:
            return float(a)
        if a.shape != (self.nlevels,):
            raise ValueError(f"lam_max: shape {a.shape}, expected () or ({self.nlevels},)")
        return tuple(float(v) for v in a)

    def _pcg_rnorm(self, r):
        """Exact first-copy residual norm from a local-form residual."""
        top = self.nlevels - 1
        rr = self._combine(r, top)
        return torch.sqrt(self._vdot(rr, rr, mask=self.levels[top].first_copy_mask))

    def _pcg_init_impl(self, x, b, coeff, chol, lam_max, Ls=None, interior=None):
        top = self.nlevels - 1
        r = self._local_residual(x, b, coeff, top, Ls)
        z, _ = self._vcycle_impl(
            torch.empty_like(x), r, coeff, chol, lam_max, need_r=False, x_zero=True,
            Ls=Ls, interior=interior,
        )
        rz = self._vdot(z, r)
        return x, r, z, rz, self._pcg_rnorm(r)

    def _pcg_step_impl(self, x, r, p, rz, coeff, chol, lam_max, flexible=False,
                       Ls=None, interior=None):
        """One PCG iteration; x and p are updated in place, and r too unless
        ``flexible``. Exact global dots without combines: p and z are
        interface-consistent, Ap and r stay in local form (see the JAX method
        for the identity). The updates are K10's: x += alpha p with r -=
        alpha Ap (into a new buffer when ``flexible``), then p = z + beta p,
        alpha and beta read from K5's device scalars.

        ``flexible``: the Polak-Ribiere beta (rz_new - <z, r_old>) / rz that
        tolerates the mildly nonlinear preconditioner of a tolerance-stopped
        coarse solve; otherwise the classic rz_new / rz. It needs r_old after
        the V-cycle: the new residual goes to a new buffer and r_old lives
        through the V-cycle in place of Ap (freed first), which keeps the
        JAX package's arithmetic — the same peak memory as keeping Ap for
        the algebraically equal -alpha <z, Ap>, and no extra copy pass."""
        top = self.nlevels - 1
        Ap = self._apply_constrained(p, coeff, top, Ls)
        if flexible:
            r_old, r = r, torch.empty_like(r)
            cg_step(x, r_old, p, Ap, rz, self._vdot(p, Ap), r_out=r)
        else:
            cg_step(x, r, p, Ap, rz, self._vdot(p, Ap))
        del Ap
        z, _ = self._vcycle_impl(
            torch.empty_like(x), r, coeff, chol, lam_max, need_r=False, x_zero=True,
            Ls=Ls, interior=interior,
        )
        rz_new = self._vdot(z, r)
        num = rz_new - self._vdot(z, r_old) if flexible else rz_new
        if flexible:
            del r_old
        cg_direction(p, z, p, num, rz)
        return x, r, p, rz_new, self._pcg_rnorm(r)

    @spanned("hz.pcg")
    def pcg(self, b, coeff, chol=None, lam_max=None, x=None, *, iters: int = 50,
            tol: float = 0.0, Ls=None, interior=None, flexible: bool | None = None):
        """Solve A u = b by V-cycle-preconditioned CG; one V-cycle plus one
        fine-level apply per iteration. ``b`` is the local (duplicated-
        contribution) rhs. ``flexible`` (Polak-Ribiere beta) defaults to
        True for the tolerance-stopped coarse solves ("cg", "mg") and False
        for the direct ones. Returns (x, history), history = exact first-copy
        residual norms (index 0 = initial residual). ``x`` is not modified."""
        init, step = self.pcg_stepper(
            coeff, chol, lam_max, flexible=flexible, Ls=Ls, interior=interior
        )
        state = init(b, x=x)
        history = [host_read(state[4])]
        for _ in range(iters):
            state = step(state)
            history.append(host_read(state[4]))
            if tol and history[-1] <= tol * history[0]:
                break
        return state[0], history

    def pcg_stepper(self, coeff, chol=None, lam_max=None, *, flexible=None,
                    Ls=None, interior=None):
        """Stepwise PCG: returns ``(init, step)`` with ``init(b, x=None) ->
        state`` and ``step(state) -> state``, ``state = (x, r, p, rz, rn)``:
        state[0] is the iterate and state[4] the exact first-copy residual
        norm (a device scalar). The homogenization driver's ``inner="pcg"``
        evaluates its integrals on the iterate between steps. ``init``
        copies a given start ``x`` (a non-zero start is allowed); ``step``
        updates the state's tensors in place where it can, so a state must
        not be stepped twice."""
        if self.smoother not in CHEBYSHEV_SMOOTHERS:
            raise ValueError(
                "pcg needs a linear SPD preconditioner: construct the solver "
                "with smoother='chebyshev'/'chebyshev4' (the cg smoothers make "
                "the V-cycle nonlinear)"
            )
        lam_max = self._check_setup(chol, lam_max)
        if flexible is None:
            flexible = self.coarse_kind not in ("chol", "inv")
        Ls = self._check_Ls(Ls)
        interior = self._check_interior(interior)

        def init(b, x=None):
            with span("hz.pcg_iter"):
                x = self.zero_states()[0] if x is None else x.clone()
                return self._pcg_init_impl(x, b, coeff, chol, lam_max, Ls=Ls, interior=interior)

        def step(state):
            x, r, p, rz, _ = state
            with span("hz.pcg_iter"):
                return self._pcg_step_impl(
                    x, r, p, rz, coeff, chol, lam_max, flexible=flexible, Ls=Ls,
                    interior=interior,
                )

        return init, step

    def _fmg_impl(self, b_top, coeff, chol, lam_max, nu, Ls=None, interior=None):
        top = self.nlevels - 1
        bs = [None] * self.nlevels
        bs[top] = b_top
        for k in range(top, 0, -1):
            bs[k - 1] = restrict(self._constrain(bs[k], k, Ls), self.levels[k].transfer)
        x = self._coarse_solve(bs[0], coeff, chol, interior)
        r = None
        for k in range(1, top + 1):
            x = prolong_add(None, x, self.levels[k].transfer)
            for i in range(nu):
                x, r = self._vcycle_impl(
                    x, bs[k], coeff, chol, lam_max, top=k,
                    need_r=(k == top and i == nu - 1), Ls=Ls, interior=interior,
                )
        return x, r

    @spanned("hz.fmg")
    def fmg(self, b, coeff, chol=None, lam_max=None, nu: int = 1, Ls=None,
            interior=None):
        """Full-multigrid (F-cycle) initializer: restrict the rhs down the
        hierarchy, solve at the base, then ascend — prolong and run ``nu``
        V-cycles per level. Returns (x, r_finest) like ``vcycle``."""
        assert nu >= 1, "fmg needs at least one V-cycle per ascent level"
        assert self.nlevels >= 2, "fmg needs a hierarchy"
        lam_max = self._check_setup(chol, lam_max)
        return self._fmg_impl(
            b, coeff, chol, lam_max, int(nu), Ls=self._check_Ls(Ls),
            interior=self._check_interior(interior),
        )

    def solve(self, b, sigma_el, lam: float = 0.0, *, tol: float = 1e-8,
              max_cycles: int = 100, method: str = "auto", x=None,
              verbose: bool = False):
        """One-call solve of (lam - div sigma grad) u = b to a relative
        residual tolerance; returns (x, history). See ``solve_driver``."""
        return solve_driver(
            self, b, sigma_el, lam, tol=tol, max_cycles=max_cycles,
            method=method, x=x, verbose=verbose,
        )

    def initial_residual_norm(self, b, coeff, x=None, Ls=None):
        """Exact first-copy norm of the constrained combined residual
        b - A x (x=None means zero)."""
        top = self.nlevels - 1
        r = b if x is None else self._apply_op(x, coeff, top, b=b)
        return self.residual_norm(self._combine_constrained(r, top, self._check_Ls(Ls)))

    def _mixed_pcg_programs(self, inner):
        """(init, step) of ``mixed_precision_pcg`` with this solver as the
        outer one; the slab solver checks its pair first, the gather-sharded
        one raises."""
        return _mixed_pcg_impls(self, inner)

    def combine(self, x, k=None):
        """Interface combine at level k (default: finest)."""
        k = self.nlevels - 1 if k is None else k
        return self._combine(x, k)

    def residual_norm(self, r, k=None):
        """Norm with each fine DOF counted once (reference:
        zero_out_all_but_one! + norm, src/implicit_fine_grid.jl:334-386)."""
        k = self.nlevels - 1 if k is None else k
        return torch.sqrt(self._vdot(r, r, mask=self.levels[k].first_copy_mask))


def solve_driver(
    solver, b, sigma_el, lam: float = 0.0, *, tol: float = 1e-8,
    max_cycles: int = 100, method: str = "auto", x=None, verbose: bool = False,
):
    """The one-call tolerance-driven solve (same stopping logic and
    normalization as the JAX package's ``solve_driver``).

    ``method``: "vcycle", "fmg" (FMG start, then cycles), "pcg" (Chebyshev
    smoothers only), "fmg+pcg", or "auto": for the Chebyshev smoothers
    "fmg+pcg" from a zero start and "pcg" from a caller's ``x``, for the CG
    smoothers "fmg" and "vcycle". Only the Chebyshev smoothers get a
    lambda_max estimate."""
    cheb = solver.smoother in CHEBYSHEV_SMOOTHERS
    if method == "auto":
        if x is not None:
            # fmg is a from-scratch initializer: a warm start skips it
            method = "pcg" if cheb else "vcycle"
        else:
            method = "fmg+pcg" if cheb else "fmg"
    coeff = solver.coefficients(sigma_el, lam)
    setup = solver.coarse_setup(sigma_el, lam)
    lam_max = solver.estimate_lambda_max(coeff) if cheb else None
    b_norm = host_read(solver.residual_norm(b))
    if b_norm == 0.0:
        return (solver.zero_states()[0] if x is None else x), [0.0]
    if x is None and method in ("vcycle", "pcg"):
        x, _ = solver.zero_states()
    history = [host_read(solver.initial_residual_norm(b, coeff, x=x)) / b_norm]
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
        history.append(host_read(solver.residual_norm(r)) / b_norm)
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
            history.append(host_read(solver.residual_norm(r)) / b_norm)
            if verbose:
                print(f"cycle {len(history) - 1}: rel residual "
                      f"{history[-1]:.3e}", flush=True)
    return x, history


# --------------------------------------------------------------------- #
# mixed-precision PCG: a float64 Krylov loop around a float32 V-cycle
# --------------------------------------------------------------------- #
def _require(cond, msg):
    """The JAX package's asserts, kept as AssertionError with its messages
    (and not skipped under ``python -O``)."""
    if not cond:
        raise AssertionError(msg)


@dataclasses.dataclass
class MixedSetup:
    """The per-coefficient state of ``mixed_precision_pcg``
    (``mixed_precision_setup``); the level tensors are the solvers' own."""

    inv_mult: torch.Tensor  # [E, n] 1/multiplicity, in the inner dtype
    coeff_o: torch.Tensor  # outer apply coefficients
    coeff_i: torch.Tensor  # inner apply coefficients
    chol_i: object  # the inner coarse payload
    lam_max_i: float  # the inner Chebyshev bound, rounded to the inner dtype


@spanned("hz.mixed_setup")
def mixed_precision_setup(outer: MultigridSolver, inner: MultigridSolver, sigma_el,
                          lam: float = 0.0) -> MixedSetup:
    """Precompute ``mixed_precision_pcg``'s per-coefficient state (both
    solvers' coefficients, the inner coarse setup, the inner lam_max
    estimate, the combine multiplicities) once, so that repeated calls — a
    warm-up and a timed run, or several right-hand sides on one field —
    skip it. Works for a matched pair of single-device solvers or of
    slab-sharded solvers on one group (everything here goes through the
    solvers' public, sharding-aware entry points).

    The multiplicity table is stored in the INNER dtype: it scales the
    already-combined (assembled-scale) residual at the downcast, so its
    float32 rounding only perturbs the preconditioner's input (the flexible
    beta absorbs it), and a float64 table would cost another state vector
    (1.52 GB at 190M DOFs). It is 1 / combine(ones), the quotient on K18
    and the cast on K15."""
    _require(type(outer) is type(inner),
             "outer and inner must be the same solver kind (both single-device "
             "or both slab-sharded)")
    outer._mixed_pcg_programs(inner)  # the solver kind's own checks
    coeff_o = outer.coefficients(sigma_el, lam)
    coeff_i = inner.coefficients(sigma_el, lam)
    chol_i = inner.coarse_setup(sigma_el, lam)
    lam_max_i = float(torch.tensor(inner.estimate_lambda_max(coeff_i), dtype=inner.dtype))
    ones = torch.ones((outer.n_rows, outer.plan.n_local(outer.nlevels - 1)),
                      dtype=outer.dtype, device=outer.device)
    inv_mult = downcast_scale(inv_positive(outer.combine(ones)))
    return MixedSetup(inv_mult=inv_mult, coeff_o=coeff_o, coeff_i=coeff_i, chol_i=chol_i,
                      lam_max_i=lam_max_i)


def _mixed_pcg_impls(outer: MultigridSolver, inner: MultigridSolver):
    """The (init, step) bodies of ``mixed_precision_pcg``, written against
    the solvers' overridable primitives (``_combine``, ``_vdot``,
    ``_apply_op``), so the slab solver runs them unchanged: its combine is
    the halo-extended one (K11), its dots sum over the ranks. Both take
    and return the state (x, r, p, rz, rn) and a ``MixedSetup``; ``step``
    updates x and p in place."""
    top = outer.nlevels - 1

    def precond(r, su):
        # re-express at the assembled scale BEFORE the downcast: the
        # combine(r) entries are assembled-scale sums, so the cast right
        # after it is safe, and the 1/multiplicity rescale runs at inner
        # precision (K15 after whichever combine the outer solver uses)
        rs = downcast_scale(outer._combine(r, top), su.inv_mult)
        z, _ = inner._vcycle_impl(
            torch.empty_like(rs), rs, su.coeff_i, su.chol_i, su.lam_max_i,
            need_r=False, x_zero=True,
        )
        return upcast(z)

    def init(x, b, su):
        r = outer._local_residual(x, b, su.coeff_o, top)
        z = precond(r, su)
        rz = outer._vdot(z, r)
        return x, r, z, rz, outer._pcg_rnorm(r)

    def step(x, r, p, rz, su):
        # exact dots without combines: p and z consistent, Ap and r local
        # (see _pcg_step_impl for the identity); the new residual goes to a
        # new buffer (K10's r_out), the old one stays for the flexible beta
        Ap = outer._apply_constrained(p, su.coeff_o, top)
        r_new = torch.empty_like(r)
        cg_step(x, r, p, Ap, rz, outer._vdot(p, Ap), r_out=r_new)
        del Ap
        z = precond(r_new, su)
        rz_new = outer._vdot(z, r_new)
        num = rz_new - outer._vdot(z, r)  # flexible beta
        del r
        cg_direction(p, z, p, num, rz)
        return x, r_new, p, rz_new, outer._pcg_rnorm(r_new)

    return init, step


@spanned("hz.mixed_pcg")
def mixed_precision_pcg(
    outer: MultigridSolver,
    inner: MultigridSolver,
    b,
    sigma_el=None,
    lam: float = 0.0,
    *,
    x=None,
    iters: int = 200,
    tol: float = 1e-12,
    setup: MixedSetup | None = None,
    keep_best: bool = True,
    divergence_stop: int = 3,
):
    """Iterative-refinement PCG: a high-precision Krylov loop around a
    low-precision V-cycle preconditioner (JAX multigrid.py:1604-1774, the
    same semantics, guards and messages).

    ``outer`` holds the Krylov state (x, r, p) and computes the fine-level
    operator apply and every dot at its dtype (float64); ``inner`` is a
    Chebyshev-smoothed solver on the SAME plan whose V-cycle runs at its
    own dtype (float32). Each iteration combines the float64 residual,
    casts it down at the assembled scale (``combine(r) * 1/multiplicity``,
    K15: the raw local-form residual keeps entries of the size of b even at
    convergence, and casting it would floor the iteration near 1e-7), runs
    one float32 V-cycle and casts the correction up (K15). The beta is
    flexible (Polak-Ribiere): the casts and a tolerance-stopped coarse
    solve make the preconditioner slightly nonlinear.

    ``b`` is the float64 local (duplicated-contribution) rhs; ``x`` a start
    (not modified; default zero). Returns ``(x, history)``, history = exact
    first-copy residual norms, entry 0 the initial one; stops when
    ``history[-1] <= tol * history[0]``.

    Past its floor the flexible recurrence diverges rather than stagnates.
    ``keep_best`` (default on): the iterate is copied into one buffer
    allocated up front whenever it sets a new minimum (a device-to-device
    copy inside the loop, as the JAX form's ``jnp.copy``), and after
    ``divergence_stop`` non-improving iterations in a row the loop stops
    and returns that best iterate. As in the JAX form, when no iterate ever
    improved on the initial residual (no copy was taken) the LAST iterate
    is returned, not the start.

    ``setup=mixed_precision_setup(...)`` skips the per-coefficient
    precompute (``sigma_el`` is then unused). The call runs inside the span
    ``hz.mixed_pcg``, each outer step with its residual read inside
    ``hz.mixed_iter``. Slab-sharded: pass two ``SlabShardedMultigridSolver``
    on one group; the Krylov state stays sharded, the downcast runs on the
    halo-extended combine, every dot sums over the ranks."""
    _require(outer.plan is inner.plan, "solvers must share one GridPlan")
    _require(type(outer) is type(inner),
             "outer and inner must be the same solver kind (both single-device "
             "or both slab-sharded)")
    _require(getattr(outer, "group", None) is getattr(inner, "group", None),
             "slab solvers must share one SlabGroup")
    _require(inner.smoother in CHEBYSHEV_SMOOTHERS,
             "the inner V-cycle must be a linear SPD preconditioner "
             "(smoother='chebyshev'); cg smoothers are nonlinear — measured "
             "divergent under outer CG (tests/test_pcg.py)")
    _require(outer.dtype.itemsize > inner.dtype.itemsize,
             "outer must run at higher precision than inner")
    init, step = outer._mixed_pcg_programs(inner)
    if setup is None:
        _require(sigma_el is not None, "pass sigma_el or setup=")
        setup = mixed_precision_setup(outer, inner, sigma_el, lam)

    x = outer.zero_states()[0] if x is None else x.clone()
    x, r, p, rz, rn = init(x, b, setup)
    history = [host_read(rn)]
    best_rn, worse = history[0], 0
    # the snapshot buffer; None until the first improving iterate
    x_buf = torch.empty_like(x) if keep_best else None
    x_best = None
    for _ in range(iters):
        with span("hz.mixed_iter"):
            x, r, p, rz, rn = step(x, r, p, rz, setup)
            history.append(host_read(rn))
        if tol and history[-1] <= tol * history[0]:
            break
        if keep_best:
            if history[-1] < best_rn:
                best_rn, x_best, worse = history[-1], x_buf.copy_(x), 0
            else:
                worse += 1
                if worse >= divergence_stop:
                    break
    if keep_best and x_best is not None and best_rn < history[-1]:
        x = x_best
    return x, history
