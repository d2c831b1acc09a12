"""Base-mesh box detection (host, NumPy).

Host copy of ``detect_box`` from homogenization_jl_tpu/solver/coarse.py. The
rest of that module (the aux hierarchy behind ``coarse="mg"``) is not ported
yet; the structured combine only needs the box test.
"""

from __future__ import annotations

import numpy as np

from ..mesh.grid import Mesh


def detect_box(base: Mesh):
    """(origin, n, h) if ``base`` is the full n^d hypercube lattice mesh
    (any uniform spacing h and origin), else None."""
    d = base.dim
    lo = base.nodes.min(axis=0)
    hi = base.nodes.max(axis=0)
    ext = hi - lo
    if not np.allclose(ext, ext[0]):
        return None
    xs = np.unique(base.nodes[:, 0])
    if len(xs) < 3:
        return None
    h = float(xs[1] - xs[0])
    if h <= 0 or not np.allclose(np.diff(xs), h):
        return None
    n = ext[0] / h
    n_i = int(round(n))
    if abs(n - n_i) > 1e-9 * max(1.0, abs(n)):
        return None
    if base.nnodes != (n_i + 1) ** d:
        return None
    if base.nelements != (2 if d == 2 else 6) * n_i**d:
        return None
    return lo, n_i, h
