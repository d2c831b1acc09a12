"""Random checkerboard conductivity (host, NumPy).

Host copy of ``generate_conductivity`` and ``conductivity_per_element`` from
homogenization_jl_tpu/models/checkerboard.py: the same numpy ``rng`` gives
the same field in both packages. The homogenization driver itself is not
ported yet.
"""

from __future__ import annotations

import numpy as np

from ..mesh.grid import Mesh


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
