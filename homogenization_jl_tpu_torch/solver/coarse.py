"""Base-mesh coarsening below the implicit hierarchy (host precompute).

Host copy (NumPy only) of homogenization_jl_tpu/solver/coarse.py, with its
imports pointed at this package; tests/test_torch_coarse.py holds it equal
to the original array for array.

The reference keeps its base mesh small enough for one sparse Cholesky
(BaseLevel, src/multigrid.jl:30-41; cholesky at
src/examples/homogenized_coefficients.jl:260). At TPU scale the base mesh
itself gets large (10^5-10^6 elements at 1e9 DOFs) and the level-0 solve
dominates the V-cycle, so real multigrid levels must continue *below* the
base mesh.

TPU-native design: for a base mesh that is a full hypercube box, build an
*auxiliary implicit hierarchy* on the geometrically coarsened mesh
``hypercube(n / 2^m)`` with ``m + 1`` levels — its finest level spans exactly
the base-mesh P1 space (the Kuhn 6-tet / 2-tri split refines onto the half
grid, reference: src/tet/generate_grid.jl:32-33). The level-0 solve of the
main hierarchy then becomes a preconditioned CG on the *exact* base operator
(the existing level-0 element apply) with one auxiliary V-cycle as the
preconditioner:

  * the aux hierarchy reuses ALL the implicit-grid machinery (GridPlan,
    element apply, gather combine, dense coarse Cholesky on the now-small
    ``mesh_0``);
  * the aux operator uses cube-averaged conductivity (constant per coarse
    element) — approximate, which is why it serves as a *preconditioner*
    for CG on the exact operator rather than as a direct solve;
  * the aux smoother is Chebyshev (a fixed polynomial, hence a linear and
    symmetric preconditioner — CG-safe; the CG smoother is nonlinear);
  * state moves between the main level-0 duplicated layout and the aux
    finest-level duplicated layout through the global base-node vector with
    precomputed static gather tables (this module).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..mesh.grid import Mesh, affine_maps, hypercube
from ..ops.plan import GridPlan, build_grid_plan


@dataclasses.dataclass(frozen=True)
class CoarseGeometry:
    """Static geometry tables linking the base mesh to its aux hierarchy."""

    plan: GridPlan  # aux plan on mesh_0 = hypercube(n / 2^m), m+1 levels
    node_map: np.ndarray  # [E0, n_aux] base node id of each aux finest slot
    aux_first_flat: np.ndarray  # [N] flat aux slot holding each base node 1st
    main_first_flat: np.ndarray  # [N] flat main level-0 slot of each node 1st
    aux_first_mask: np.ndarray  # [E0, n_aux] 1.0 on first-copy slots
    cube_of_base: np.ndarray  # [E] coarse-cube id of each base element
    cube_of_aux: np.ndarray  # [E0] coarse-cube id of each aux element
    n_cubes: int
    m: int  # coarsening depth (mesh_0 spacing = 2^m * base spacing)

    def average_sigma(self, sigma_el: np.ndarray) -> np.ndarray:
        """Cube-averaged conductivity on aux elements: [E0, d] (or [E0])."""
        sigma_el = np.asarray(sigma_el, dtype=np.float64)
        if sigma_el.ndim == 1:
            sigma_el = sigma_el[:, None]
        sums = np.zeros((self.n_cubes, sigma_el.shape[1]))
        np.add.at(sums, self.cube_of_base, sigma_el)
        cnt = np.bincount(self.cube_of_base, minlength=self.n_cubes)
        avg = sums / np.maximum(cnt, 1)[:, None]
        return avg[self.cube_of_aux]


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


def coarsening_depth(base: Mesh, dense_limit: int = 4000) -> int:
    """Depth m that build_coarse_geometry would use (0 = not coarsenable)."""
    box = detect_box(base)
    if box is None:
        return 0
    _, n, _ = box
    m, nc = 0, n
    while nc % 2 == 0 and nc // 2 >= 2 and (nc - 1) ** base.dim > dense_limit:
        nc //= 2
        m += 1
    return m


def build_coarse_geometry(
    plan: GridPlan, dense_limit: int = 4000
) -> CoarseGeometry | None:
    """Build the aux hierarchy geometry, or None when the base is not a
    coarsenable box (e.g. the homogenization driver's shrunken prefix
    domains — those keep the reference-style direct coarse solve).

    ``dense_limit``: target interior-node count of mesh_0, below which a
    dense Cholesky is cheap; the coarsening depth m is the smallest that
    reaches it."""
    base = plan.base
    box = detect_box(base)
    if box is None:
        return None
    origin, n, h = box
    d = base.dim

    m = coarsening_depth(base, dense_limit)
    if m == 0:
        return None
    nc = n >> m

    s = h * 2**m
    mesh0 = hypercube(d, nc, scale=s, origin=origin)
    aux_plan = build_grid_plan(mesh0, m + 1)

    # aux finest-level slot coordinates -> base node ids (exact: both lattices
    # live on integer multiples of h from the origin)
    ref_fine = aux_plan.reference.levels[m]
    J, shift, _, _ = affine_maps(mesh0)
    coords = np.einsum("eij,nj->eni", J, ref_fine.nodes) + shift[:, None, :]

    def key(a):
        k = np.round((a - origin[None, :]) / h).astype(np.int64)
        return np.ascontiguousarray(k).view([("", np.int64)] * d).ravel()

    bk = key(base.nodes)
    order = np.argsort(bk)
    sk = bk[order]
    qk = key(coords.reshape(-1, d))
    pos = np.searchsorted(sk, qk)
    ok = (pos < len(sk)) & (sk[np.clip(pos, 0, len(sk) - 1)] == qk)
    assert ok.all(), "aux fine-grid nodes do not coincide with base nodes"
    node_map = order[pos].reshape(coords.shape[:2])

    uniq, first = np.unique(node_map.ravel(), return_index=True)
    assert len(uniq) == base.nnodes, "aux grid does not cover every base node"
    aux_first_flat = np.empty(base.nnodes, dtype=np.int64)
    aux_first_flat[uniq] = first
    aux_first_mask = np.zeros(node_map.size)
    aux_first_mask[first] = 1.0

    u2, f2 = np.unique(base.elements.ravel(), return_index=True)
    assert len(u2) == base.nnodes
    main_first_flat = np.empty(base.nnodes, dtype=np.int64)
    main_first_flat[u2] = f2

    def cube_of(mesh_):
        centers = mesh_.nodes[mesh_.elements].mean(axis=1)
        ix = np.floor((centers - origin[None, :]) / s).astype(np.int64)
        ix = np.clip(ix, 0, nc - 1)
        flat = ix[:, 0]
        for k in range(1, d):
            flat = flat * nc + ix[:, k]
        return flat

    return CoarseGeometry(
        plan=aux_plan,
        node_map=node_map.astype(np.int32)
        if node_map.size and node_map.max() < 2**31
        else node_map,
        aux_first_flat=aux_first_flat.astype(np.int64),
        main_first_flat=main_first_flat.astype(np.int64),
        aux_first_mask=aux_first_mask.reshape(node_map.shape),
        cube_of_base=cube_of(base),
        cube_of_aux=cube_of(mesh0),
        n_cubes=nc**d,
        m=m,
    )
