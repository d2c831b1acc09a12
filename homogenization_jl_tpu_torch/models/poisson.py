"""Demo solvers (port of homogenization_jl_tpu/models/poisson.py; reference:
checkerboard_hypercube_multigrid and checkerboard_hypercube_full,
src/examples/homogenized_coefficients.jl:509-572, :729-759): the
fixed-domain GMG solve of  -div(a grad u) + lam u = 1,  u = 0 on the
boundary (BASELINE.json configs 1 and 3), plus a direct explicit-assembly
solve for cross-checking.

``checkerboard_hypercube_multigrid`` runs on ``device`` (the card unless the
caller asks for the CPU): the V-cycles' kernels, K1 (apply / residual), the
combine and constraint (K2 on the hypercube bases), K4 transfers, K5 dots
and K10 CG updates, and the coarse solve (K7; K6 with coarse="mg"). Its
random start is drawn on the host exactly as the JAX function draws it, so
both packages start from the same bits. ``checkerboard_hypercube_full`` is
host code (scipy's sparse direct solve of the explicit fine mesh).
"""

from __future__ import annotations

import numpy as np
import torch

from ..fem.assembly import assemble_operator
from ..fem.local_operators import load_vector
from ..mesh.grid import affine_maps, hypercube, interior_nodes
from ..mesh.refine import refine_uniformly
from ..ops.plan import build_grid_plan
from ..solver.multigrid import MultigridSolver
from .checkerboard import conductivity_per_element, generate_conductivity


def local_unit_rhs(solver: MultigridSolver) -> torch.Tensor:
    """b[e, i] = detJ_e * int_ref phi_i — the f = 1 load in the duplicated
    layout (reference: local_rhs!, src/implicit_fine_grid.jl:391-409), the
    solver's rows on its device in its dtype."""
    plan = solver.plan
    b_ref = load_vector(plan.reference.levels[plan.nlevels - 1])
    _, _, detJ, _ = affine_maps(plan.base)
    b = solver.rows_of(detJ[:, None] * b_ref[None, :])
    return torch.as_tensor(b).to(solver.dtype).contiguous().to(solver.device)


def checkerboard_hypercube_multigrid(
    n: int,
    dim: int = 3,
    refinements: int = 2,
    max_cycles: int = 5,
    smoothing_steps: int = 3,
    lam: float = 0.0,
    seed: int = 1,
    coarse: str = "chol",
    dtype=torch.float64,
    device=None,
):
    """GMG solve of the checkerboard problem on [0, n]^dim; returns
    (residual_history, x_finest, solver). Reference:
    homogenized_coefficients.jl:509-572 (seeded RNG there too)."""
    base = hypercube(dim, n)
    rng = np.random.default_rng(seed)
    field = generate_conductivity(dim, n, rng)
    sigma_el = conductivity_per_element(base, field, np.zeros(dim))

    # no path of the port reads the flat slot tables (the flat combine is
    # not ported); skipping them halves the plan's host time
    plan = build_grid_plan(base, refinements + 1, slot_tables=False)
    solver = MultigridSolver(
        plan, dtype=dtype, device=device, smoothing_steps=smoothing_steps, coarse=coarse
    )
    coeff = solver.coefficients(sigma_el, lam)
    # the coarse payload of every kind: the JAX function passes the
    # Cholesky factor for "chol" and None otherwise, which is the same
    # payload for "chol" and "cg" and trips its vcycle's assertion for
    # "inv" and "mg"
    chol = solver.coarse_setup(sigma_el, lam)

    # random consistent start with zero b.c. (reference :546-549), drawn as
    # the JAX function draws it
    x0, _ = solver.zero_states()
    x = torch.as_tensor(rng.random(tuple(x0.shape))).to(dtype).to(solver.device)
    del x0
    x = solver.combine(x)
    x = solver._constrain(x, solver.nlevels - 1)
    b = local_unit_rhs(solver)

    history = []
    for _ in range(max_cycles):
        x, r = solver.vcycle(x, b, coeff, chol)
        history.append(float(solver.residual_norm(r)))
    return history, x, solver


def checkerboard_hypercube_full(
    n: int,
    dim: int = 3,
    refinements: int = 2,
    lam: float = 0.0,
    a_hom: float = 3.94,
    seed: int = 1,
):
    """Direct sparse solve of the fully refined mesh vs the homogenized
    operator — the "eyeball in Paraview" demo (reference :729-759).
    Returns (mesh, x, x_hom, sigma_per_element)."""
    import scipy.sparse.linalg as spl

    mesh = refine_uniformly(hypercube(dim, n), times=refinements)
    rng = np.random.default_rng(seed)
    field = generate_conductivity(dim, n, rng)
    sigma_el = conductivity_per_element(mesh, field, np.zeros(dim))

    ii = interior_nodes(mesh)
    A = assemble_operator(mesh, sigma_el, lam)
    A_hom = assemble_operator(
        mesh, np.full((mesh.nelements, dim), a_hom), lam
    )
    b = load_vector(mesh)

    x = np.zeros(mesh.nnodes)
    x_hom = np.zeros(mesh.nnodes)
    x[ii] = spl.spsolve(A[np.ix_(ii, ii)].tocsc(), b[ii])
    x_hom[ii] = spl.spsolve(A_hom[np.ix_(ii, ii)].tocsc(), b[ii])
    return mesh, x, x_hom, sigma_el
