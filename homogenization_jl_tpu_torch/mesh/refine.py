"""Uniform red refinement of simplicial meshes (host-side, NumPy).

Rebuild of the reference refinement (src/tri/refine.jl, src/tet/refine.jl):
tri -> 4 tris, tet -> 8 tets, new nodes = edge midpoints appended *after*
the original nodes (ordering invariant used by multigrid transfer and
visualization — coarse DOFs are a prefix of fine DOFs).
"""

from __future__ import annotations

import numpy as np

from .grid import (
    Mesh,
    TET_EDGES,
    TRI_EDGES,
    find_edge_indices,
    unique_edges,
)

# Child patterns in terms of `parts` = [corners..., midpoints...] (0-based).
# Midpoint order follows the lexicographic local edge tables above.
_TRI_CHILDREN = np.array(
    [
        (0, 3, 4),  # corner 0 + midpoints m01, m02
        (1, 5, 3),  # corner 1 + m12, m01
        (2, 4, 5),  # corner 2 + m02, m12
        (3, 5, 4),  # central triangle
    ],
    dtype=np.int64,
)

# Standard Bey/Freudenthal red refinement of a tet: 4 corner children plus a
# central octahedron split into 4 tets along a fixed diagonal (same diagonal
# choice as the reference, src/tet/refine.jl:46-47, so the refined reference
# elements are geometrically identical).
# parts = [v0, v1, v2, v3, m01, m02, m03, m12, m13, m23]
_TET_CHILDREN = np.array(
    [
        (0, 4, 5, 6),
        (4, 1, 7, 8),
        (5, 7, 2, 9),
        (6, 8, 9, 3),
        (4, 5, 6, 8),
        (4, 5, 7, 8),
        (5, 6, 8, 9),
        (5, 7, 8, 9),
    ],
    dtype=np.int64,
)


def refine_uniformly(mesh: Mesh, times: int = 1, sort: bool = True):
    """Refine `times` times. Returns the refined mesh.

    Reference driver: refine_uniformly(m; times), src/grid.jl:59-64.
    """
    for _ in range(times):
        mesh, _ = refine_once(mesh, sort=sort)
    return mesh


def refine_once(mesh: Mesh, sort: bool = True):
    """One level of red refinement.

    Returns (fine_mesh, edges) where `edges` is the unique sorted edge list of
    the *coarse* mesh; fine node ``Nn + k`` is the midpoint of ``edges[k]``.
    """
    Nn = mesh.nnodes
    edges = unique_edges(mesh)
    midpoints = 0.5 * (mesh.nodes[edges[:, 0]] + mesh.nodes[edges[:, 1]])
    nodes = np.vstack([mesh.nodes, midpoints])

    npe = mesh.nodes_per_element
    local_pairs = TRI_EDGES if npe == 3 else TET_EDGES
    # Midpoint global ids per element, in local-edge order.
    elem_edges = mesh.elements[:, local_pairs].reshape(-1, 2)
    mid_ids = Nn + find_edge_indices(edges, elem_edges, Nn)
    mid_ids = mid_ids.reshape(mesh.nelements, len(local_pairs))

    parts = np.concatenate([mesh.elements, mid_ids], axis=1)  # [Ne, N + n_edges]
    children = _TRI_CHILDREN if npe == 3 else _TET_CHILDREN
    fine_elements = parts[:, children].reshape(-1, npe)
    if sort:
        fine_elements = np.sort(fine_elements, axis=1)

    return Mesh(nodes, fine_elements), edges
