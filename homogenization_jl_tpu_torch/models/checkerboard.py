"""Checkerboard homogenized-coefficient estimation (the flagship model).

Port of homogenization_jl_tpu/models/checkerboard.py (reference:
src/examples/homogenized_coefficients.jl): the recurrence v_0, v_1, ... of
"Efficient methods for the estimation of homogenized coefficients"
(arXiv:1609.06674, section 11) on a random checkerboard conductivity field,
with domain shrinking and lambda halving per outer step. It estimates a
correction sigma to E[xi . A xi] (= 5 for a in {1, 9} with equal odds):
xi . A_hom xi ~ E - sigma.

Host layer (NumPy, copied from the JAX module): the schedule, the ordered
mesh and its radius queries, the conductivity field, the initial right-hand
side, the lattice DOF norms and the consistent random start. Device layer
(PyTorch): the solver (solver/multigrid.py) and the integrals
(ops/integrals.py, kernel K9; ``next_rhs`` is kernel K1).

Both geometries of the JAX driver:
  * "ordered" (the default): the reference's inf-norm element order; a
    shrink slices a prefix of the mesh and rebuilds the plan and the solver
    (the gather combine K8 and the mask constraint on these bases);
  * "lattice": one full lexicographic box and one solver for the whole run;
    a shrink swaps the per-step Dirichlet masks (``Ls``, ``interior``).

The driver looks up ``compute_boundary_layer`` as a module global, so a
caller can patch the schedule, as the JAX package's tests do.

The driver's defaults are the JAX driver's: ``smoother="cg"`` and
``inner="vcycle"`` (the reference's plain V-cycles, with the CG smoother's
updates on kernel K10); only the Chebyshev smoothers get a lambda_max
estimate per step.

``device_mesh`` (a ``parallel.group.SlabGroup``) runs the driver SPMD on
every rank of the group, each integral summed over the ranks:
  * "lattice" on the slab-sharded solver (parallel/slab.py): the base in
    cube order, the random start and the rhs drawn on the whole base and
    cut to the rank's rows (the single-device run with
    ``lattice_order="cube"`` sees the same numbers), the per-step masks
    ``Ls`` cut too, ``interior`` replicated;
  * "ordered" on the gather-sharded solver (parallel/sharding.py), one per
    step: every element-leading array cut to the rank's block of rows; at a
    shrink the state is joined across the ranks, sliced to the new prefix,
    masked and cut to the new partition, as the JAX driver does on the host.

``solver="multishift"`` runs models/multishift.py::
homogenization_multishift (the one-Lanczos-pass estimator, fixed domain);
``return_trace`` then returns its stats dict.

``checkpoint_dir`` writes each solved outer step's state as
``step_<k>.npz`` (utils/checkpoint.py, the JAX package's format) and
``resume_from`` takes such a file: the run marks its step as solved, runs
only that step's shrink and goes on (the ordered geometry first slices its
mesh to the file's radius; the lattice geometry keeps its full box and
decides from R0, not the file, whether the coarse solve needs the masked
forms). ``save_level`` writes ``checkerboard.vtu`` (the conductivity, in
the working directory) and each step's solution at that level as
``<save_prefix>_<k>.vtu`` (utils/vtk.py). With a ``device_mesh`` the ranks'
rows are joined in rank order and rank 0 alone writes, so the files are
the ones a single-device run writes for the same element order; a resumed
rank cuts the file's state to its rows.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time

import numpy as np
import torch

from ..fem.local_operators import partial_derivative_functionals
from ..mesh.grid import Mesh, affine_maps, hypercube
from ..ops.integrals import integrals_fns
from ..ops.interfaces import apply_mask
from ..ops.plan import build_grid_plan
from ..solver.coarse import coarsening_depth
from ..solver.multigrid import CHEBYSHEV_SMOOTHERS, MultigridSolver, resolve_device
from ..utils.checkpoint import load_step, save_step
from ..utils.logging import span
from ..utils.vtk import export_conductivity, export_solution, level_columns


# ---------------------------------------------------------------------------
# schedule (homogenized_coefficients.jl:9-10)
# ---------------------------------------------------------------------------
def compute_boundary_layer(lam: float, n: int) -> int:
    return int(math.floor(4 * (n + 1) * lam**-0.5))


def compute_box_radius(k: int, n: int, eps: float = 0.0) -> int:
    return int(math.floor(2 ** (n - k * (0.5 - eps))))


# ---------------------------------------------------------------------------
# ordered mesh + radius queries (homogenized_coefficients.jl:21-48)
# ---------------------------------------------------------------------------
def ordered_hypercube(dim: int, radius: int) -> tuple[Mesh, np.ndarray, np.ndarray]:
    """[-radius, radius]^dim unit-cell mesh with nodes and elements sorted by
    distance (inf-norm) to the origin, so domain shrinking is prefix slicing.

    Returns (mesh, node_norms, element_center_norms), both norms ascending.
    """
    mesh = hypercube(dim, 2 * radius, origin=-np.full(dim, float(radius)))
    node_norm = np.abs(mesh.nodes).max(axis=1)
    I = np.argsort(node_norm, kind="stable")
    Jperm = np.empty_like(I)
    Jperm[I] = np.arange(len(I))
    nodes = mesh.nodes[I]
    elements = np.sort(Jperm[mesh.elements], axis=1)
    centers = nodes[elements].mean(axis=1)
    cnorm = np.abs(centers).max(axis=1)
    order = np.argsort(cnorm, kind="stable")
    elements = elements[order]
    return Mesh(nodes, elements), node_norm[I], cnorm[order]


def prefix_in_radius(sorted_norms: np.ndarray, radius: float, eps: float = 0.0) -> int:
    """Length of the prefix with norm <= radius (+eps). Reference:
    find_{nodes,elements}_in_radius, homogenized_coefficients.jl:34-48."""
    return int(np.searchsorted(sorted_norms, radius + eps, side="right"))


# ---------------------------------------------------------------------------
# conductivity (homogenized_coefficients.jl:476-503)
# ---------------------------------------------------------------------------
def generate_conductivity(dim: int, n_cells: int, rng) -> np.ndarray:
    """Random per-axis conductivity, value 1 or 9 with equal odds per unit
    cell: array [n_cells]^dim + [dim]."""
    shape = (n_cells,) * dim + (dim,)
    return np.where(rng.random(shape) < 0.5, 1.0, 9.0)


def conductivity_per_element(mesh: Mesh, field: np.ndarray, offset: np.ndarray) -> np.ndarray:
    """sigma_el[e] = field[floor(center_e + offset)] (per-axis), [E, dim]."""
    centers = mesh.nodes[mesh.elements].mean(axis=1)
    idx = np.floor(centers + offset).astype(np.int64)
    idx = np.clip(idx, 0, field.shape[0] - 1)
    return field[tuple(idx[:, k] for k in range(mesh.dim))]


# ---------------------------------------------------------------------------
# rhs, DOF norms, random start (homogenized_coefficients.jl:246-248, 449-474)
# ---------------------------------------------------------------------------
def initial_rhs(plan, sigma_el: np.ndarray, xi: np.ndarray, dtype=np.float64) -> np.ndarray:
    """b0[e, i] = f_i . P_e with P_e = -detJ_e J_e^{-1} (sigma_e * xi) and
    f_i = int_ref grad phi_i over the finest reference mesh.

    (Reference: rhs_axi_grad_v!, homogenized_coefficients.jl:449-474.)
    """
    fine = plan.reference.levels[plan.nlevels - 1]
    f = partial_derivative_functionals(fine, dtype)  # [n_local, d]
    _, _, detJ, Jinv = affine_maps(plan.base)
    P = -detJ[:, None] * np.einsum("ekm,em->ek", Jinv, sigma_el * xi)
    return (f @ P.T).T.astype(dtype)  # [E, n_local]


def lattice_dof_norms(plan, k: int, chunk: int = 100_000) -> np.ndarray:
    """[E, n_local(k)] inf-norm of every fine-DOF coordinate, f32 (exact for
    the dyadic lattice coordinates of hypercube plans). Chunked over elements
    — the [E, n_local, d] coordinate intermediate would be tens of GB at the
    flagship sizes."""
    J, shift, _, _ = affine_maps(plan.base)
    ref = plan.reference.levels[k].nodes  # [n_local, d]
    E = plan.base.nelements
    out = np.empty((E, ref.shape[0]), dtype=np.float32)
    for s in range(0, E, chunk):
        e = min(s + chunk, E)
        coords = np.einsum("eij,nj->eni", J[s:e], ref) + shift[s:e, None, :]
        out[s:e] = np.abs(coords).max(axis=2)
    return out


def consistent_random(plan, k: int, rng) -> np.ndarray:
    """Random [E, n_local] state, interface-consistent and zero on the
    boundary (reference: rand! + broadcast_interfaces! + apply_constraint!,
    homogenized_coefficients.jl:246-248), on the host over the gather
    (owner) tables."""
    E = plan.base.nelements
    n = plan.n_local(k)
    x = rng.random((E, n))
    gt = plan.levels[k].gather
    lay = plan.reference.layout[k]
    assert lay is not None, "consistent_random needs the contiguous layout"

    def sum_scatter(tables, offsets, width):
        # every owner copy of a shared cell receives the owners' sum;
        # single-owner (boundary) cells reproduce their own value
        if tables is None or width == 0 or len(offsets) == 0:
            return
        oe, ol, om, gmap = tables
        offs = np.asarray(offsets, dtype=np.int64)
        cols = offs[ol.astype(np.int64)][..., None] + np.arange(width)
        sums = (x[oe[..., None].astype(np.int64), cols] * om[..., None]).sum(
            axis=1
        )  # [G, width]
        for l in range(len(offsets)):
            x[:, offs[l] : offs[l] + width] = sums[gmap[:, l]]

    sum_scatter(gt.face, lay.face_offsets, lay.npf)
    sum_scatter(gt.edge, lay.edge_offsets, lay.npe)
    sum_scatter(gt.corner, lay.corner_cols, 1)
    return x * plan.levels[k].boundary_mask


# ---------------------------------------------------------------------------
# solver factory and integrals
# ---------------------------------------------------------------------------
def _make_solver(plan, dtype, device, smoothing_steps, coarse, coarse_dense_limit,
                 smoother, solver_opts=None, group=None):
    """The solver of one ordered-geometry step (JAX checkerboard.py:160-185):
    "mg" where the base coarsens, else "chol", and "cg" past the dense
    limit; with a ``group`` (SlabGroup) the gather-sharded solver."""
    kind = coarse
    if kind == "mg" and coarsening_depth(plan.base, 4000) == 0:
        # a base that is not a coarsenable box keeps the direct solve
        kind = "chol"
    if kind == "chol" and len(plan.interior_base_nodes) > coarse_dense_limit:
        kind = "cg"
    opts = dict(dtype=dtype, smoothing_steps=smoothing_steps, coarse=kind, smoother=smoother,
                **(solver_opts or {}))
    if group is None:
        return MultigridSolver(plan, device=device, **opts)
    from ..parallel.sharding import ShardedMultigridSolver

    return ShardedMultigridSolver(plan, group, **opts)


def _lambda_max(solver, coeff):
    """The step's lambda_max estimate, for the Chebyshev smoothers only (the
    JAX driver's gate; the CG smoothers read none)."""
    if solver.smoother in CHEBYSHEV_SMOOTHERS:
        return solver.estimate_lambda_max(coeff)
    return None


def _solver_integrals(solver, detJ_np, group=None):
    """K9 integrals closed over the solver's finest mass matrix (the last
    slice of the finest operator stack) and |det J| of the solver's rows on
    its device; with a slab ``group``, summed over the ranks."""
    mass = solver.levels[solver.nlevels - 1].stack[-1]
    detJ = torch.as_tensor(solver.rows_of(detJ_np), device=solver.device).to(solver.dtype)
    quirk = bool(np.allclose(detJ_np, 1.0))  # decided on the whole base
    return integrals_fns(mass, detJ, reference_quirk=quirk, group=group)


# ---------------------------------------------------------------------------
# driver (homogenized_coefficients.jl:174-343)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class HomogenizationTrace:
    """The JAX package's trace, plus host-clock seconds: ``init_seconds``
    from the call to the first outer step (plan, solver, initial state),
    ``setup_seconds`` per step before its inner loop (coefficients, coarse
    setup, the Chebyshev smoothers' lambda_max; for "ordered", the shrink's
    rebuild too), and
    ``iteration_seconds`` per step and inner iteration (each ends when the
    host reads the integral, which waits for the device)."""

    sigma: float
    sigma_steps: list
    residuals: list
    cycles_per_step: list
    init_seconds: float = 0.0
    setup_seconds: list = dataclasses.field(default_factory=list)
    iteration_seconds: list = dataclasses.field(default_factory=list)


def _inner_loop(k, step_once, integral, sigma, domain_area, tolerance, max_cycles,
                verbose, rnorm):
    """Iterate the inner solve until the sigma increment stabilizes
    (reference stopping rule, homogenized_coefficients.jl:269-290).
    Returns (d_sigma, cycles, seconds of each iteration)."""
    d_sigma = 0.0
    d_sigma_prev = 0.0
    cycles = 0
    seconds = []
    t_prev = time.perf_counter()
    for i in range(max_cycles):
        with span("hz.driver.iteration"):
            step_once()
            cycles += 1
            d_sigma = 2.0**k * float(integral()) / domain_area
        t_now = time.perf_counter()
        seconds.append(t_now - t_prev)
        if verbose:
            print(
                f"  cycle {i + 1}: |r|={float(rnorm()):.3e} "
                f"sigma+ds={sigma + d_sigma:.10f} "
                f"|ds-ds_prev|={abs(d_sigma - d_sigma_prev):.3e} "
                f"dt={t_now - t_prev:.2f}s",
                flush=True,
            )
        t_prev = t_now
        if abs(d_sigma - d_sigma_prev) < tolerance:
            break
        d_sigma_prev = d_sigma
    return d_sigma, cycles, seconds


def checkerboard_homogenization(
    n: int = 4,
    dim: int = 2,
    refinements: int = 2,
    smoothing_steps: int = 3,
    tolerance: float = 1e-4,
    xi: np.ndarray | None = None,
    cond_field: np.ndarray | None = None,
    seed: int | None = None,
    dtype=torch.float64,
    coarse: str = "chol",
    coarse_dense_limit: int = 8_000,
    max_cycles: int = 1000,
    verbose: bool = False,
    return_trace: bool = False,
    save_level: int | None = None,
    save_prefix: str = "ahom",
    checkpoint_dir: str | None = None,
    resume_from: str | None = None,
    device_mesh=None,
    smoother: str = "cg",
    shrink: bool = True,
    solver: str = "vcycle",
    lanczos_iters: int = 120,
    geometry: str = "ordered",
    lattice_order: str | None = None,
    solver_opts: dict | None = None,
    inner: str = "vcycle",
    device=None,
):
    """Estimate the correction sigma for one sampled domain: the JAX
    package's driver with its signature and defaults, plus ``device`` (the
    card unless the caller asks for the CPU; see ``resolve_device``).

    ``cond_field``: optional pinned conductivity field of shape [2R]^dim +
    [dim] with R = compute_box_radius(0, n) + compute_boundary_layer(1, n);
    if None it is sampled with ``seed``. ``smoother``: "cg" (the
    reference's), "cg_exact", "chebyshev" or "chebyshev4" (lambda_max is
    estimated per step for the last two only). ``shrink``: domain shrinking per
    outer step (reference behavior); False keeps the k=0 domain.
    ``geometry``: "ordered" (reference element order, prefix-slice shrink,
    a plan and solver per step) or "lattice" (one box, shrink by masks).
    ``inner``: "vcycle" (plain V-cycles until the sigma increment
    stabilizes) or "pcg" (V-cycle-preconditioned CG steps under the same
    stopping rule; requires a Chebyshev smoother). ``solver``: "vcycle" or
    "multishift" (one generalized-Lanczos pass of ``lanczos_iters`` steps
    serving every recurrence step, the fixed-domain variant; with
    ``return_trace`` the stats dict takes the trace's place).
    ``device_mesh``: a ``SlabGroup``: every rank calls the driver, and the
    tensors live on the group's device (the slab-sharded solver for
    "lattice", the gather-sharded one for "ordered").
    ``checkpoint_dir`` / ``resume_from``: a step file per solved outer step,
    and the step file to resume after; ``save_level`` / ``save_prefix``:
    VTK files of the conductivity and of each step's solution at that level
    (see the module docstring).
    Returns sigma, or (sigma, HomogenizationTrace) with ``return_trace``.
    """
    if device_mesh is not None:
        from ..parallel.group import SlabGroup

        if not isinstance(device_mesh, SlabGroup):
            raise TypeError(
                f"device_mesh must be a SlabGroup, got {type(device_mesh).__name__}"
            )
        if device is not None and torch.device(device) != device_mesh.device:
            raise ValueError("device= must be the device_mesh's device")
        device = device_mesh.device
    # validate before any dispatch so a bad or ignored ``inner`` never runs
    # silently (multishift has no inner solve: only the default is valid)
    if inner == "pcg":
        if solver == "multishift":
            raise ValueError(
                "inner='pcg' does not apply to solver='multishift' (no inner "
                "V-cycle there); drop one of the two"
            )
        if smoother not in CHEBYSHEV_SMOOTHERS:
            raise ValueError(
                "inner='pcg' needs a linear SPD preconditioner: pass "
                "smoother='chebyshev' or 'chebyshev4'"
            )
    elif inner != "vcycle":
        raise ValueError(f"inner={inner!r}")
    if solver == "multishift":
        if device_mesh is not None:
            raise ValueError("solver='multishift' runs on one device (no device_mesh)")
        from .multishift import homogenization_multishift

        # return_trace maps to the multishift stats dict (A / M apply
        # counts, Lanczos iterations, sigma_steps), the closest analog of
        # HomogenizationTrace for the one-pass solver
        return homogenization_multishift(
            n, dim=dim, refinements=refinements, lanczos_iters=lanczos_iters, xi=xi,
            cond_field=cond_field, seed=seed, dtype=dtype, return_stats=return_trace,
            device=device,
        )
    if solver != "vcycle":
        raise ValueError(f"solver={solver!r}")
    device = resolve_device(device)
    kw = dict(
        n=n, dim=dim, refinements=refinements, smoothing_steps=smoothing_steps,
        tolerance=tolerance, xi=xi, cond_field=cond_field, seed=seed, dtype=dtype,
        coarse=coarse, coarse_dense_limit=coarse_dense_limit, max_cycles=max_cycles,
        verbose=verbose, smoother=smoother, shrink=shrink, solver_opts=solver_opts,
        inner=inner, device=device,
        out=_StepOutput(save_level, save_prefix, checkpoint_dir, device_mesh),
        resume=_load_resume(resume_from, n, refinements),
    )
    if geometry == "lattice":
        sigma, trace = _checkerboard_lattice(lattice_order=lattice_order,
                                             device_mesh=device_mesh, **kw)
    elif geometry == "ordered":
        sigma, trace = _checkerboard_ordered(device_mesh=device_mesh, **kw)
    else:
        raise ValueError(f"geometry={geometry!r}")
    return (sigma, trace) if return_trace else sigma


def _to_device(dtype, device):
    """Host array -> tensor of the state dtype on the device, cast on the
    host (an [E, n] float64 array would otherwise take twice its size on
    the card for a moment)."""

    def to_dev(a):
        return torch.as_tensor(np.asarray(a)).to(dtype).contiguous().to(device)

    return to_dev


def _field_and_xi(dim, R0, xi, cond_field, seed, resume=None):
    """(xi, the conductivity field, the run's generator); a resumed run
    takes the field and xi of its step file (the field is drawn first all
    the same, as the JAX driver does)."""
    if xi is None:
        xi = np.ones(dim) / np.sqrt(dim)  # reference random_unit_vec (:62-65)
    xi = np.asarray(xi, dtype=np.float64)
    rng = np.random.default_rng(seed)
    if cond_field is None:
        cond_field = generate_conductivity(dim, 2 * R0, rng)
    elif cond_field.shape != (2 * R0,) * dim + (dim,):
        raise ValueError(f"cond_field shape {cond_field.shape}, expected {(2 * R0,) * dim + (dim,)}")
    if resume is not None:
        return resume["xi"], resume["cond_field"], rng
    return xi, cond_field, rng


def _load_resume(path, n, refinements):
    """The state of the step file ``path`` (None for None), which must be
    of this run's n and refinements."""
    if path is None:
        return None
    state = load_step(path)
    if (state["n"], state["refinements"]) != (n, refinements):
        raise ValueError(
            f"{path}: n={state['n']}, refinements={state['refinements']}; this run has "
            f"n={n}, refinements={refinements}"
        )
    return state


def _resume_state(resume, to_dev):
    """(x, b, v_prev, the step to resume after) of a step file, each state
    cut to the solver's rows by ``to_dev``."""
    v_prev = resume["v_prev"]
    return (to_dev(resume["x"]), to_dev(resume["b"]),
            None if v_prev is None else to_dev(v_prev), resume["k"])


@dataclasses.dataclass
class _StepOutput:
    """The driver's files: the VTK files of ``save_level`` (the
    conductivity once, then each step's solution at that level) and the
    step files of ``checkpoint_dir``. With a ``group`` the ranks' rows are
    joined in rank order (every rank takes part) and rank 0 alone writes."""

    save_level: int | None
    save_prefix: str
    checkpoint_dir: str | None
    group: object = None

    def _writes(self) -> bool:
        return self.group is None or self.group.rank == 0

    def _joined(self, t, E):
        if self.group is None or t is None:
            return t
        from ..parallel.sharding import join_rows

        return join_rows(self.group, t, E)

    def conductivity(self, base, sigma_el):
        if self.save_level is not None and self._writes():
            export_conductivity("checkerboard", base, sigma_el)

    def step(self, k, plan, x, b, v_prev, **state):
        """After the solve of step k: the level's solution and the step
        file; ``state`` holds the scalars, the field and xi."""
        E = plan.base.nelements
        if self.save_level is not None:
            # the level's columns only, taken on the device
            cols = self._joined(level_columns(plan, self.save_level, x), E)
            if self._writes():
                export_solution(f"{self.save_prefix}_{k}", plan, self.save_level, cols)
        if self.checkpoint_dir is not None:
            x, b, v_prev = (self._joined(t, E) for t in (x, b, v_prev))
            if self._writes():
                os.makedirs(self.checkpoint_dir, exist_ok=True)
                save_step(os.path.join(self.checkpoint_dir, f"step_{k}"), k=k, x=x, b=b,
                          v_prev=v_prev, **state)


def _checkerboard_ordered(
    n, dim, refinements, smoothing_steps, tolerance, xi, cond_field, seed, dtype,
    coarse, coarse_dense_limit, max_cycles, verbose, smoother, shrink, solver_opts,
    inner, device, out, resume=None, device_mesh=None,
):
    """Reference-order geometry (JAX checkerboard.py:356-573): prefix-slice
    domain shrinking with a plan and solver rebuild per outer step. With a
    ``device_mesh`` (SlabGroup) each step's solver is the gather-sharded
    one and every element-leading array is cut to the rank's rows."""
    t_start = time.perf_counter()
    with span("hz.driver.init"):
        lam = 1.0
        sigma = 0.0
        box_radius = compute_box_radius(0, n)
        boundary_layer = compute_boundary_layer(lam, n)
        total_radius = box_radius + boundary_layer
        xi, cond_field, rng = _field_and_xi(dim, total_radius, xi, cond_field, seed, resume)

        offset = np.full(dim, float(total_radius))  # field indexing uses R0
        base, node_norms, center_norms = ordered_hypercube(dim, total_radius)
        if resume is not None:
            # slice the ordered mesh down to the step file's (pre-shrink) domain
            sigma, lam = resume["sigma"], resume["lam"]
            box_radius, total_radius = resume["box_radius"], resume["total_radius"]
            n_nodes = prefix_in_radius(node_norms, total_radius, eps=1e-12)
            n_elems = prefix_in_radius(center_norms, total_radius)
            base = Mesh(base.nodes[:n_nodes], base.elements[:n_elems])
            node_norms = node_norms[:n_nodes]
            center_norms = center_norms[:n_elems]
        sigma_el = conductivity_per_element(base, cond_field, offset)
        out.conductivity(base, sigma_el)

        nlevels = refinements + 1
        plan = build_grid_plan(base, nlevels, slot_tables=False)

        group = device_mesh

        def make_solver(plan):
            sol = _make_solver(
                plan, dtype, device, smoothing_steps, coarse, coarse_dense_limit,
                smoother, solver_opts, group,
            )
            _, _, detJ_np, _ = affine_maps(plan.base)
            return sol, _solver_integrals(sol, detJ_np, group)

        to_dev_all = _to_device(dtype, device)
        sol, (area_fn, first_fn, terms_fn, next_rhs_fn) = make_solver(plan)

        def to_dev(a):  # the solver's rows of a global element-leading array
            return to_dev_all(sol.rows_of(a))

        if resume is None:
            # random consistent x with zero boundary values (:246-248)
            x = to_dev(consistent_random(plan, nlevels - 1, rng))
            b = to_dev(initial_rhs(plan, sigma_el, xi))
            v_prev, start_k = None, 0
        else:
            # the file's step is solved: its shrink runs, then the next step
            x, b, v_prev, start_k = _resume_state(resume, to_dev)
        coeff = setup = None
    trace = HomogenizationTrace(0.0, [], [], [])
    t_step = time.perf_counter()
    trace.init_seconds = t_step - t_start

    for k in range(start_k, n + 1):
        if resume is None or k != start_k:
            with span("hz.driver.step_setup"):
                if verbose:
                    print(
                        f"[step {k}] domain [-{total_radius},{total_radius}]^{dim} "
                        f"box={box_radius} layer={boundary_layer} E={base.nelements} "
                        f"unknowns<= {plan.max_unknowns}",
                        flush=True,
                    )
                coeff = sol.coefficients(sigma_el, lam)
                setup = sol.coarse_setup(sigma_el, lam)
                lam_max = _lambda_max(sol, coeff)
                n_box = prefix_in_radius(center_norms, box_radius)
                mask = to_dev((np.arange(base.nelements) < n_box).astype(np.float64))
                domain_area = float(area_fn(mask))
            trace.setup_seconds.append(time.perf_counter() - t_step)
            x, d_sigma, cycles, rn, secs = _solve_step(
                sol, k, x, b, v_prev, coeff, setup, lam_max, mask, inner, first_fn,
                terms_fn, sigma, domain_area, tolerance, max_cycles, verbose,
            )
            t_step = time.perf_counter()
            sigma += d_sigma
            trace.sigma_steps.append(sigma)
            trace.cycles_per_step.append(cycles)
            trace.residuals.append(rn)
            trace.iteration_seconds.append(secs)
            out.step(k, plan, x, b, v_prev, sigma=sigma, lam=lam, box_radius=box_radius,
                     total_radius=total_radius, cond_field=cond_field, xi=xi, n=n,
                     refinements=refinements)

        # ---- shrink the domain (:297-340) --------------------------------
        lam /= 2.0
        box_radius = compute_box_radius(k + 1, n)
        boundary_layer = compute_boundary_layer(lam, n)
        if box_radius + boundary_layer > total_radius:
            break
        if not shrink:
            # fixed-domain variant: same operators, only lambda and the
            # integration box change
            v_prev = x
            b = next_rhs_fn(x, lam)
            continue
        total_radius = box_radius + boundary_layer

        n_nodes = prefix_in_radius(node_norms, total_radius, eps=1e-12)
        n_elems = prefix_in_radius(center_norms, total_radius)
        if group is not None:
            # every rank's rows of the old partition, joined
            from ..parallel.sharding import join_rows

            x = join_rows(group, x, base.nelements)
        base = Mesh(base.nodes[:n_nodes], base.elements[:n_elems])
        node_norms = node_norms[:n_nodes]
        center_norms = center_norms[:n_elems]
        sigma_el = sigma_el[:n_elems]

        plan = build_grid_plan(base, nlevels, slot_tables=False)
        del sol, coeff, setup
        sol, (area_fn, first_fn, terms_fn, next_rhs_fn) = make_solver(plan)
        # slice state, re-apply the (new) boundary condition, cut to the
        # rank's rows of the new partition
        bmask = torch.as_tensor(sol.rows_of(plan.levels[nlevels - 1].boundary_mask), device=device)
        x = apply_mask(sol.rows_of(x[:n_elems]).contiguous(), bmask)
        v_prev = x
        b = next_rhs_fn(x, lam)

    trace.sigma = sigma
    return sigma, trace


def _solve_step(sol, k, x, b, v_prev, coeff, setup, lam_max, mask, inner, first_fn,
                terms_fn, sigma, domain_area, tolerance, max_cycles, verbose,
                Ls=None, interior=None):
    """One outer step's inner iteration; returns (x, d_sigma, cycles, the
    final residual norm, seconds per iteration). ``x`` is not modified."""
    cur = {}
    if inner == "pcg":
        init, step = sol.pcg_stepper(coeff, setup, lam_max, Ls=Ls, interior=interior)
        cur["state"] = init(b, x=x)

        def step_once():
            cur["state"] = step(cur["state"])
            cur["x"] = cur["state"][0]

        def rnorm():
            return cur["state"][4]
    else:
        cur["x"] = x

        def step_once():
            cur["x"], cur["r"] = sol.vcycle(
                cur["x"], b, coeff, setup, lam_max=lam_max, Ls=Ls, interior=interior
            )

        def rnorm():
            return sol.residual_norm(cur["r"])

    def integral():
        if k == 0:
            return first_fn(cur["x"], b, mask)
        return terms_fn(cur["x"], v_prev, mask)

    d_sigma, cycles, seconds = _inner_loop(
        k, step_once, integral, sigma, domain_area, tolerance, max_cycles, verbose, rnorm
    )
    return cur["x"], d_sigma, cycles, float(rnorm()), seconds


def _checkerboard_lattice(
    n, dim, refinements, smoothing_steps, tolerance, xi, cond_field, seed, dtype,
    coarse, coarse_dense_limit, max_cycles, verbose, smoother, shrink, solver_opts,
    inner, device, out, resume=None, lattice_order=None, device_mesh=None,
):
    """Lattice-geometry recurrence (JAX checkerboard.py:576-855): one
    full-box plan and ONE solver for the whole run; a shrink swaps the
    per-step Dirichlet masks (``Ls``), the coarse interior-node mask
    (``interior``), lambda and the integration-box mask. With a
    ``device_mesh`` (SlabGroup) the solver is the slab-sharded one and every
    element-leading array is cut to the rank's rows."""
    t_start = time.perf_counter()
    with span("hz.driver.init"):
        lam = 1.0
        sigma = 0.0
        box_radius = compute_box_radius(0, n)
        boundary_layer = compute_boundary_layer(lam, n)
        total_radius = box_radius + boundary_layer
        R0 = total_radius
        xi, cond_field, rng = _field_and_xi(dim, R0, xi, cond_field, seed, resume)

        # type-major order single-device, cube-major for the slabs;
        # lattice_order overrides (the tests pin "cube" on one device so both
        # runs see the same element order, the same random start and the same
        # sigma to 1e-9)
        order = lattice_order or ("cube" if device_mesh is not None else "type")
        base = hypercube(dim, 2 * R0, origin=-np.full(dim, float(R0)), order=order)
        offset = np.full(dim, float(R0))
        sigma_el = conductivity_per_element(base, cond_field, offset)
        out.conductivity(base, sigma_el)

        nlevels = refinements + 1
        plan = build_grid_plan(base, nlevels, slot_tables=False)
        E = base.nelements
        n_top = plan.n_local(nlevels - 1)

        # will any step actually shrink? (decides whether the coarse solve needs
        # the masked global-space forms; from R0, also on resume)
        lam_t, tot_t, shrinks = 1.0, R0, False
        for kk in range(n + 1):
            lam_t /= 2.0
            br = compute_box_radius(kk + 1, n)
            bl = compute_boundary_layer(lam_t, n)
            if br + bl > tot_t:
                break
            if shrink and br + bl < tot_t:
                shrinks = True
                tot_t = br + bl

        kind = coarse
        can_mg = coarsening_depth(base, 4000) > 0
        if kind == "mg" and not can_mg:
            kind = "cg"
        if kind in ("chol", "inv") and (
            len(plan.interior_base_nodes) > coarse_dense_limit or shrinks
        ):
            # chol/inv factor the FULL-box interior; shrunken steps solve the
            # sub-box operator, which only the global-space cg/mg forms mask
            kind = "mg" if can_mg else "cg"

        opts = dict(dtype=dtype, smoothing_steps=smoothing_steps, coarse=kind,
                    smoother=smoother, **(solver_opts or {}))
        if device_mesh is None:
            sol = MultigridSolver(plan, device=device, **opts)
        else:
            from ..parallel.slab import SlabShardedMultigridSolver

            sol = SlabShardedMultigridSolver(plan, device_mesh, **opts)
        if sol.combine_kind != "structured":
            raise AssertionError("the lattice geometry needs the structured combine")
        _, _, detJ_np, _ = affine_maps(base)
        area_fn, first_fn, terms_fn, next_rhs_fn = _solver_integrals(sol, detJ_np, device_mesh)

        to_dev_all = _to_device(dtype, device)

        def to_dev(a):  # the solver's rows of a global element-leading array
            return to_dev_all(sol.rows_of(a))

        def put_bool(a):
            return torch.as_tensor(sol.rows_of(a), device=device)

        cnorm = np.abs(base.nodes[base.elements].mean(axis=1)).max(axis=1)
        node_norm = np.abs(base.nodes).max(axis=1)
        dof_norms = [None] * nlevels

        def level_norms(k2):
            if dof_norms[k2] is None:
                dof_norms[k2] = lattice_dof_norms(plan, k2)
            return dof_norms[k2]

        def level_Ls(R):
            return [put_bool(level_norms(k2) < (R - 1e-9)) for k2 in range(nlevels)]

        if resume is None:
            # initial state: random, interface-consistent (one device combine —
            # the table-free form of rand! + broadcast_interfaces! +
            # apply_constraint!, homogenized_coefficients.jl:246-248), zero on
            # the boundary
            x = sol._constrain(sol.combine(to_dev(rng.random((E, n_top)))), nlevels - 1)
            b = to_dev(initial_rhs(plan, sigma_el, xi))
            v_prev, start_k = None, 0
        else:
            # the file's step is solved: its shrink runs, then the next step
            sigma, lam = resume["sigma"], resume["lam"]
            box_radius, total_radius = resume["box_radius"], resume["total_radius"]
            x, b, v_prev, start_k = _resume_state(resume, to_dev)
    trace = HomogenizationTrace(0.0, [], [], [])
    t_step = time.perf_counter()
    trace.init_seconds = t_step - t_start

    for k in range(start_k, n + 1):
        if resume is None or k != start_k:
            with span("hz.driver.step_setup"):
                if verbose:
                    print(
                        f"[step {k}] domain [-{total_radius},{total_radius}]^{dim} "
                        f"(masked, full box [-{R0},{R0}]) box={box_radius} "
                        f"layer={boundary_layer} E={E} unknowns<= {plan.max_unknowns}",
                        flush=True,
                    )
                shrunk = total_radius < R0
                Ls_k = level_Ls(total_radius) if shrunk else None
                int_k = (
                    torch.as_tensor(node_norm < (total_radius - 1e-9), device=device)
                    if (shrunk and kind in ("cg", "mg"))
                    else None
                )
                coeff = sol.coefficients(sigma_el, lam)
                setup = sol.coarse_setup(sigma_el, lam)
                lam_max = _lambda_max(sol, coeff)
                mask = to_dev((cnorm <= box_radius).astype(np.float64))
                domain_area = float(area_fn(mask))
            trace.setup_seconds.append(time.perf_counter() - t_step)
            x, d_sigma, cycles, rn, secs = _solve_step(
                sol, k, x, b, v_prev, coeff, setup, lam_max, mask, inner, first_fn,
                terms_fn, sigma, domain_area, tolerance, max_cycles, verbose,
                Ls=Ls_k, interior=int_k,
            )
            t_step = time.perf_counter()
            del Ls_k, int_k
            sigma += d_sigma
            trace.sigma_steps.append(sigma)
            trace.cycles_per_step.append(cycles)
            trace.residuals.append(rn)
            trace.iteration_seconds.append(secs)
            out.step(k, plan, x, b, v_prev, sigma=sigma, lam=lam, box_radius=box_radius,
                     total_radius=total_radius, cond_field=cond_field, xi=xi, n=n,
                     refinements=refinements)

        # ---- schedule tail: lambda halving + masked shrink ----------------
        lam /= 2.0
        box_radius = compute_box_radius(k + 1, n)
        boundary_layer = compute_boundary_layer(lam, n)
        if box_radius + boundary_layer > total_radius:
            break
        if shrink and box_radius + boundary_layer < total_radius:
            total_radius = box_radius + boundary_layer
            # re-apply the (new, smaller) sub-box Dirichlet condition to x
            x = apply_mask(x, put_bool(level_norms(nlevels - 1) < (total_radius - 1e-9)))
        v_prev = x
        b = next_rhs_fn(x, lam)

    trace.sigma = sigma
    return sigma, trace


def compare_refinements_on_same_material(
    n: int = 2,
    dim: int = 2,
    refinements=(1, 2, 3),
    tolerance: float = 1e-4,
    seed: int = 0,
    **kwargs,
):
    """Run the recurrence on the SAME sampled conductivity field at several
    refinement levels (reference: compare_refinements_on_same_material,
    homogenized_coefficients.jl:574-583). Returns {refinements: sigma}."""
    lam0_radius = compute_box_radius(0, n) + compute_boundary_layer(1.0, n)
    rng = np.random.default_rng(seed)
    field = generate_conductivity(dim, 2 * lam0_radius, rng)
    return {
        r: checkerboard_homogenization(
            n, dim=dim, refinements=r, tolerance=tolerance,
            cond_field=field, seed=seed, **kwargs,
        )
        for r in refinements
    }
