"""Explicit global sparse assembly (host-side, SciPy).

Two uses, mirroring the reference:
  * the *coarse-grid operator* of multigrid (reference: assemble_checkerboard,
    src/examples/homogenized_coefficients.jl:358-402 + cholesky at :260);
  * the *oracle* in tests: the matrix-free implicit apply must match the
    explicitly assembled operator on the same refined geometry
    (reference: test/test_operator.jl).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..mesh.grid import Mesh, affine_maps, reference_simplex
from .local_operators import mass_matrix, stiffness_pieces


def _unit_local_matrices(dim: int, dtype=np.float64):
    """(Ahat1 [d,d,N,N], Mhat1 [N,N]) on the unit reference simplex."""
    ref = reference_simplex(dim, dtype)
    return stiffness_pieces(ref, dtype), mass_matrix(ref, dtype)


def assemble_operator(
    mesh: Mesh, sigma_el: np.ndarray, lam: float = 0.0, dtype=np.float64
) -> sp.csr_matrix:
    """Assemble B[u,v] = int lam*u*v + (sigma grad u) . grad v.

    ``sigma_el``: [Ne, d] per-element diagonal conductivity, [Ne] scalar, or
    [Ne, d, d] full symmetric tensor per element.
    """
    d = mesh.dim
    N = d + 1
    Ahat, Mhat = _unit_local_matrices(d, dtype)
    _, _, detJ, Jinv = affine_maps(mesh)
    sigma_el = np.asarray(sigma_el, dtype=dtype)
    if sigma_el.ndim == 1:
        sigma_el = np.repeat(sigma_el[:, None], d, axis=1)
    if sigma_el.ndim == 3:
        C = np.einsum("ekm,emn,eln->ekl", Jinv, sigma_el, Jinv)  # [Ne, d, d]
    else:
        C = np.einsum("ekm,em,elm->ekl", Jinv, sigma_el, Jinv)  # [Ne, d, d]
    A_loc = np.einsum("e,ekl,klij->eij", detJ, C, Ahat)
    if lam != 0.0:
        A_loc = A_loc + lam * detJ[:, None, None] * Mhat[None]
    el = mesh.elements
    rows = np.broadcast_to(el[:, :, None], (mesh.nelements, N, N)).ravel()
    cols = np.broadcast_to(el[:, None, :], (mesh.nelements, N, N)).ravel()
    A = sp.coo_matrix(
        (A_loc.ravel(), (rows, cols)), shape=(mesh.nnodes, mesh.nnodes)
    )
    return A.tocsr()


def assemble_laplace(mesh: Mesh, a: float = 1.0, dtype=np.float64) -> sp.csr_matrix:
    """Assemble the isotropic stiffness matrix a * int grad u . grad v
    (reference: assemble_matrix(mesh, dot), src/assembly.jl:4-60)."""
    sigma = np.full((mesh.nelements, mesh.dim), a, dtype=dtype)
    return assemble_operator(mesh, sigma, 0.0, dtype)


def assemble_matrix(mesh: Mesh, bf, dtype=np.float64) -> sp.csr_matrix:
    """Generic P1 bilinear-form assembly with an arbitrary integrand
    (capability parity with the reference's `assemble_matrix(mesh, bf)`,
    src/assembly.jl:4-60, whose `bf(∇u, ∇v)` closure is evaluated per
    quadrature point with physical gradients).

    ``bf(gu, gv, x)`` must be NumPy-vectorized over leading axes: ``gu``/
    ``gv`` are [..., d] physical basis gradients, ``x`` is the [..., d]
    quadrature point position; returns the [...] integrand values. For P1
    the gradients are element-constant, so x-independent forms (e.g.
    ``lambda gu, gv, x: (gu * gv).sum(-1)``) integrate exactly; an
    x-dependent coefficient is sampled at the simplex quadrature rule of
    fem/quadrature.py (degree-2 exact).
    """
    from .quadrature import basis_gradients, quad_rule

    d = mesh.dim
    N = d + 1
    pts, wq = quad_rule(d)  # [Q, d], [Q]
    J, shift, detJ, Jinv = affine_maps(mesh)
    # physical gradients J^{-T} grad_ref: [E, N, d] (element-constant for P1)
    G = np.einsum("ekd,kn->end", Jinv, basis_gradients(d)).astype(dtype)
    # physical quadrature points [E, Q, d]
    X = np.einsum("eij,qj->eqi", J, pts) + shift[:, None, :]
    E = mesh.nelements
    Q = len(wq)
    gu = np.broadcast_to(G[:, None, :, None, :], (E, Q, N, N, d))
    gv = np.broadcast_to(G[:, None, None, :, :], (E, Q, N, N, d))
    xq = np.broadcast_to(X[:, :, None, None, :], (E, Q, N, N, d))
    vals = np.asarray(bf(gu, gv, xq), dtype=dtype)  # [E, Q, N, N]
    A_loc = np.einsum("q,eqij,e->eij", wq, vals, detJ)
    el = mesh.elements
    rows = np.broadcast_to(el[:, :, None], (E, N, N)).ravel()
    cols = np.broadcast_to(el[:, None, :], (E, N, N)).ravel()
    return sp.coo_matrix(
        (A_loc.ravel(), (rows, cols)), shape=(mesh.nnodes,) * 2
    ).tocsr()
