"""P1 simplex basis and quadrature rules (host-side, NumPy).

Rebuild of src/cell_values.jl:4-51. Gradients of P1 basis functions are
constant, so no autodiff is needed (the reference used ForwardDiff once at
setup); everything here is closed-form.
"""

from __future__ import annotations

import numpy as np


def quad_rule(dim: int, dtype=np.float64):
    """Default quadrature: (points [nq, dim], weights [nq]).

    2D: 3-point edge-midpoint rule, degree 2 (reference TriQuad3,
    src/cell_values.jl:23-28). 3D: 4-point degree-2 rule (TetQuad4,
    src/cell_values.jl:10-21). Both integrate P1 mass matrices exactly.
    """
    if dim == 2:
        pts = np.array([[0.0, 0.5], [0.5, 0.0], [0.5, 0.5]], dtype=dtype)
        w = np.full(3, 1.0 / 6.0, dtype=dtype)
    elif dim == 3:
        a = (5.0 + 3.0 * np.sqrt(5.0)) / 20.0
        b = (5.0 - np.sqrt(5.0)) / 20.0
        pts = np.array([[a, b, b], [b, a, b], [b, b, a], [b, b, b]], dtype=dtype)
        w = np.full(4, 1.0 / 24.0, dtype=dtype)
    else:
        raise ValueError(f"dim must be 2 or 3, got {dim}")
    return pts, w


def basis_values(points: np.ndarray) -> np.ndarray:
    """P1 basis functions evaluated at reference points: [npts, dim+1].

    phi_0 = 1 - sum(x), phi_i = x_i (reference: get_basis_funcs,
    src/cell_values.jl:40-51).
    """
    return np.concatenate(
        [1.0 - points.sum(axis=1, keepdims=True), points], axis=1
    )


def basis_gradients(dim: int, dtype=np.float64) -> np.ndarray:
    """Constant reference gradients of the P1 basis: [dim, dim+1].

    Column i is grad(phi_i): grad(phi_0) = -1, grad(phi_i) = e_i.
    """
    g = np.zeros((dim, dim + 1), dtype=dtype)
    g[:, 0] = -1.0
    g[:, 1:] = np.eye(dim, dtype=dtype)
    return g


def simplex_measure(dim: int) -> float:
    """Measure of the unit reference simplex (1/2 in 2D, 1/6 in 3D)."""
    return 1.0 / 2.0 if dim == 2 else 1.0 / 6.0
