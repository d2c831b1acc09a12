"""Dense reference-element operators (host-side, NumPy).

Rebuild of src/build_local_operators.jl and
src/examples/homogenized_coefficients.jl:407-442 in a TPU-native shape: the
reference keeps per-level *sparse CSC* matrices and applies them column-wise
per base element (src/apply_local_operators.jl:125-133); here the same
operators are *densified* so the device-side element apply is a batched
matmul on the MXU.

For a base element with affine map (J_e, b_e), conductivity sigma_e (diagonal
per-axis), and L2 coefficient lambda, the true element operator on level-l
local DOFs is

    A_e = detJ_e * ( sum_{k,l} C_e[k,l] * Ahat^{kl}  +  lambda * Mhat )
    C_e = J_e^{-1} diag(sigma_e) J_e^{-T}            (symmetric d x d)
    Ahat^{kl}[i,j] = int_ref  d_k phi_i  d_l phi_j   (assembled over the
                                                      refined reference mesh)

Since C_e is symmetric and Ahat^{lk} = (Ahat^{kl})^T, the d^2 pieces fold into
d(d+1)/2 symmetric combinations — the stacked form used on device.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..mesh.grid import Mesh, affine_maps
from ..mesh.reference import MultilevelReference
from .quadrature import basis_gradients, basis_values, quad_rule, simplex_measure


def stiffness_pieces(mesh: Mesh, dtype=np.float64) -> np.ndarray:
    """Ahat^{kl} assembled over `mesh` (in its own coordinates): [d, d, n, n].

    Reference: _build_local_diffusion_operators,
    src/build_local_operators.jl:51-105.
    """
    d = mesh.dim
    n = mesh.nnodes
    ghat = basis_gradients(d, dtype)  # [d, N]
    J, _, detJ, Jinv = affine_maps(mesh)
    # Physical gradients within the mesh coordinates: G[t] = J_t^{-T} ghat.
    G = np.einsum("tdk,km->tdm", np.swapaxes(Jinv, 1, 2), ghat)  # [Ne, d, N]
    vol = simplex_measure(d)
    # Local contribution: A_loc[t,k,l,i,j] = vol * detJ_t * G[t,k,i] G[t,l,j]
    A_loc = vol * np.einsum("t,tki,tlj->tklij", detJ, G, G)
    A = np.zeros((d, d, n, n), dtype=dtype)
    el = mesh.elements
    rows = el[:, :, None]  # i
    cols = el[:, None, :]  # j
    for k in range(d):
        for l in range(d):
            np.add.at(A[k, l], (rows, cols), A_loc[:, k, l])
    return A


def mass_matrix(mesh: Mesh, dtype=np.float64) -> np.ndarray:
    """Mhat assembled over `mesh`: [n, n] (reference: mass_matrix,
    src/build_local_operators.jl:107-141). Exact for P1."""
    d = mesh.dim
    pts, w = quad_rule(d, dtype)
    phi = basis_values(pts)  # [nq, N]
    _, _, detJ, _ = affine_maps(mesh)
    M_ref = np.einsum("q,qi,qj->ij", w, phi, phi)  # local mass, ref simplex
    M_loc = detJ[:, None, None] * M_ref[None]
    M = np.zeros((mesh.nnodes, mesh.nnodes), dtype=dtype)
    el = mesh.elements
    np.add.at(M, (el[:, :, None], el[:, None, :]), M_loc)
    return M


def load_vector(mesh: Mesh, func=None, dtype=np.float64) -> np.ndarray:
    """b[i] = int func(phi_i) over `mesh` (reference: assemble_vector,
    src/assembly.jl:121-154; func defaults to the identity, giving the unit
    load int phi_i)."""
    d = mesh.dim
    pts, w = quad_rule(d, dtype)
    phi = basis_values(pts)
    if func is not None:
        phi = func(phi)
    _, _, detJ, _ = affine_maps(mesh)
    b_loc = detJ[:, None] * (w @ phi)[None]
    b = np.zeros(mesh.nnodes, dtype=dtype)
    np.add.at(b, mesh.elements, b_loc)
    return b


# alias matching the reference's name (src/assembly.jl:121)
assemble_vector = load_vector


def partial_derivative_functionals(mesh: Mesh, dtype=np.float64) -> np.ndarray:
    """f[i, k] = int_ref d_k phi_i over `mesh`.

    Reference: partial_derivatives_functionals,
    src/examples/homogenized_coefficients.jl:407-442.
    """
    d = mesh.dim
    _, _, detJ, Jinv = affine_maps(mesh)
    ghat = basis_gradients(d, dtype)
    G = np.einsum("tdk,km->tdm", np.swapaxes(Jinv, 1, 2), ghat)  # [Ne, d, N]
    vol = simplex_measure(d)
    f_loc = vol * detJ[:, None, None] * G  # [Ne, d, N]
    f = np.zeros((mesh.nnodes, d), dtype=dtype)
    np.add.at(f, mesh.elements, np.swapaxes(f_loc, 1, 2))
    return f


# Symmetric fold: index pairs (k, l) with k <= l; off-diagonal pieces get
# Ahat^{kl} + (Ahat^{kl})^T and the coefficient C[k,l] once.
def _sym_pairs(d: int):
    return [(k, l) for k in range(d) for l in range(k, d)]


@dataclasses.dataclass(frozen=True)
class LevelOperators:
    """Densified reference operators for one refinement level.

    ``stack``: [P, n, n] with P = d(d+1)/2 + 1; the last slice is Mhat.
    Device apply: y[e] = sum_p coeff[e, p] * (stack[p] @ x[e]).
    """

    stack: np.ndarray
    dim: int

    @property
    def n_local(self) -> int:
        return self.stack.shape[1]

    @property
    def n_pieces(self) -> int:
        return self.stack.shape[0]


def build_level_operators(ref: MultilevelReference, dtype=np.float64):
    """LevelOperators for every refinement level of the reference element."""
    out = []
    d = ref.dim
    for mesh in ref.levels:
        A = stiffness_pieces(mesh, dtype)
        M = mass_matrix(mesh, dtype)
        pieces = []
        for (k, l) in _sym_pairs(d):
            pieces.append(A[k, l] if k == l else A[k, l] + A[k, l].T)
        pieces.append(M)
        out.append(LevelOperators(np.stack(pieces), d))
    return out


def element_coefficients(
    base: Mesh, sigma_el: np.ndarray, lam: float, dtype=np.float64
) -> np.ndarray:
    """Per-base-element coefficients for the stacked apply: [E, P].

    coeff[e, p<last] = detJ_e * C_e[k_p, l_p],  coeff[e, last] = lam * detJ_e
    with C_e = J_e^{-1} Sigma_e J_e^{-T}.
    (Reference computes the same quantity per element inside the hot loop,
    src/apply_local_operators.jl:98-118; here it is precomputed once.)

    ``sigma_el``: [E] isotropic scalar, [E, d] per-axis diagonal (the
    reference's SVector form), or [E, d, d] full SYMMETRIC tensor per element
    (beyond the reference — the symmetric fold of the stacked apply requires
    Sigma_e = Sigma_e^T, asserted here).
    """
    d = base.dim
    _, _, detJ, Jinv = affine_maps(base)
    sigma_el = np.asarray(sigma_el, dtype=dtype)
    if sigma_el.ndim == 1:  # isotropic scalar per element
        sigma_el = np.repeat(sigma_el[:, None], d, axis=1)
    if sigma_el.ndim == 3:  # full tensor per element
        assert sigma_el.shape[1:] == (d, d)
        assert np.allclose(sigma_el, np.swapaxes(sigma_el, 1, 2)), (
            "tensor conductivity must be symmetric (the stacked apply folds "
            "C across the diagonal)"
        )
        C = np.einsum("ekm,emn,eln->ekl", Jinv, sigma_el, Jinv)
    else:
        # C = Jinv diag(sigma) Jinv^T
        C = np.einsum("ekm,em,elm->ekl", Jinv, sigma_el, Jinv)
    cols = [detJ * C[:, k, l] for (k, l) in _sym_pairs(d)]
    cols.append(lam * detJ)
    return np.stack(cols, axis=1).astype(dtype)
