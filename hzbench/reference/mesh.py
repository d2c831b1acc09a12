"""Meshes of the plain reference: a frozen copy of the host mesh code.

The discrete problem is defined by the base mesh and by how each base
tetrahedron is refined. This module rebuilds both in NumPy, for 3D only:
the box of n^3 cubes, each split into the 6 tetrahedra that share the main
diagonal, and the red (Bey) refinement of the reference tetrahedron with
the same diagonal choice for the central octahedron (Homogenization.jl:
src/tet/generate_grid.jl:22-40, src/tet/refine.jl:5-54). It imports nothing
of the program under test.
"""

from __future__ import annotations

import numpy as np

TET_EDGES = np.array([(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)], dtype=np.int64)

# parts = [v0, v1, v2, v3, m01, m02, m03, m12, m13, m23]: 4 corner children
# and the central octahedron cut along the m02-m13 diagonal
TET_CHILDREN = np.array(
    [(0, 4, 5, 6), (4, 1, 7, 8), (5, 7, 2, 9), (6, 8, 9, 3),
     (4, 5, 6, 8), (4, 5, 7, 8), (5, 6, 8, 9), (5, 7, 8, 9)],
    dtype=np.int64,
)

# the 6 tetrahedra of a cube (corner c = x + 2 y + 4 z), sharing 0-7
CUBE_TETS = [(0, 1, 2, 6), (0, 1, 4, 6), (1, 3, 2, 6), (1, 3, 6, 7), (1, 5, 4, 6), (1, 5, 6, 7)]


def box_mesh(n: int, order: str = "type"):
    """(nodes [(n+1)^3, 3] float64, elements [6 n^3, 4] int64) of the unit-
    spaced box [0, n]^3. Node id x (n+1)^2 + y (n+1) + z. Element rows are
    sorted ascending; ``order`` "cube" keeps the 6 tetrahedra of a cube
    together (e = 6 cube + t), "type" groups them by tetrahedron (e = t n^3
    + cube), cube = (x n + y) n + z."""
    ax = np.arange(n + 1, dtype=np.float64)
    gx, gy, gz = np.meshgrid(ax, ax, ax, indexing="ij")
    nodes = np.stack([gx.ravel(), gy.ravel(), gz.ravel()], axis=1)
    r = np.arange(n, dtype=np.int64)
    x, y, z = (a.ravel() for a in np.meshgrid(r, r, r, indexing="ij"))

    def nid(i, j, k):
        return (i * (n + 1) + j) * (n + 1) + k

    corners = [nid(x + (c & 1), y + ((c >> 1) & 1), z + ((c >> 2) & 1)) for c in range(8)]
    tets = np.stack([np.stack([corners[a] for a in t], axis=1) for t in CUBE_TETS], axis=1)
    elements = np.sort(tets.reshape(-1, 4), axis=1)
    if order == "type":
        elements = elements.reshape(-1, 6, 4).transpose(1, 0, 2).reshape(-1, 4)
    elif order != "cube":
        raise ValueError(f"order must be 'cube' or 'type', got {order!r}")
    return nodes, elements


def _unique_edges(elements):
    e = elements[:, TET_EDGES].reshape(-1, 2)
    return np.unique(e, axis=0)


def refine_once(nodes, elements):
    """One red refinement: midpoints of the sorted unique edges appended
    after the old nodes, 8 children per tetrahedron, rows sorted."""
    nn = len(nodes)
    edges = _unique_edges(elements)
    nodes = np.vstack([nodes, 0.5 * (nodes[edges[:, 0]] + nodes[edges[:, 1]])])
    keys = edges[:, 0] * nn + edges[:, 1]
    q = elements[:, TET_EDGES].reshape(-1, 2)
    idx = np.searchsorted(keys, q[:, 0] * nn + q[:, 1])
    if not np.array_equal(keys[idx], q[:, 0] * nn + q[:, 1]):
        raise AssertionError("refine_once: an element edge is not in the edge list")
    parts = np.concatenate([elements, nn + idx.reshape(len(elements), 6)], axis=1)
    return nodes, np.sort(parts[:, TET_CHILDREN].reshape(-1, 4), axis=1)


def refined_reference(times: int):
    """The reference tetrahedron (0, e1, e2, e3) refined ``times`` times:
    (nodes [n, 3] in reference coordinates, sub-tetrahedra [8^times, 4])."""
    nodes = np.vstack([np.zeros((1, 3)), np.eye(3)])
    elements = np.arange(4, dtype=np.int64)[None, :]
    for _ in range(times):
        nodes, elements = refine_once(nodes, elements)
    return nodes, elements


def affine(nodes, elements):
    """(v0 [E, 3], J [E, 3, 3]) of x = v0 + J xi, J's columns v_k - v_0."""
    p = nodes[elements]
    return p[:, 0, :], np.moveaxis(p[:, 1:, :] - p[:, :1, :], 1, 2)


def ordered_box(radius: int):
    """The box [-radius, radius]^3 of unit cubes with its nodes numbered by
    their distance (inf-norm) to the origin and the elements in the order
    of their centres' (Homogenization.jl homogenized_coefficients.jl:
    21-48). The numbering fixes each tetrahedron's vertex order, and with it
    which diagonal the refinement cuts."""
    nodes, elements = box_mesh(2 * radius, "cube")
    nodes = nodes - radius
    norm = np.abs(nodes).max(axis=1)
    order = np.argsort(norm, kind="stable")
    new_id = np.empty_like(order)
    new_id[order] = np.arange(len(order))
    nodes = nodes[order]
    elements = np.sort(new_id[elements], axis=1)
    cnorm = np.abs(nodes[elements].mean(axis=1)).max(axis=1)
    return nodes, elements[np.argsort(cnorm, kind="stable")]
