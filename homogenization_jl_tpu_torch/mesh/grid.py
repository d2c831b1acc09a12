"""Simplicial mesh core (host-side, NumPy).

TPU-native rebuild of the reference mesh layer (reference: src/grid.jl,
src/tri/generate_grid.jl, src/tet/generate_grid.jl, src/sparse_graph.jl).

Design notes
------------
The reference stores a mesh as ``Vector{SVector}`` nodes plus ``Vector{NTuple}``
element tuples and leans on hand-written radix sorts / set-op kernels
(src/sorting_tricks.jl) for connectivity queries.  Here everything is a dense
ndarray and connectivity is derived with vectorized lexicographic sorts
(`np.unique`) — same semantics, no scalar loops.  All of this is one-time host
precompute whose outputs become *static index tables* baked into jitted TPU
programs, so clarity and vectorization beat micro-optimization.

Invariants (load-bearing, mirrored from the reference):
  * element rows are sorted ascending (reference: sort_element_nodes!,
    src/sorting_tricks.jl:34). This makes every sub-simplex tuple taken with
    increasing local indices globally sorted, which canonicalizes face/edge
    keys *and* the orientation frame used for interface matching.
  * refinement appends edge-midpoint nodes after the original nodes
    (reference: src/tri/refine.jl:5-43, src/tet/refine.jl:5-54), so coarse
    DOFs are a prefix of fine DOFs (docs/src/index.md:310).
"""

from __future__ import annotations

import dataclasses

import numpy as np

# Local sub-simplex index tables (0-based; reference: src/grid.jl:89-91).
TET_FACES = np.array([(0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3)], dtype=np.int64)
TET_EDGES = np.array(
    [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)], dtype=np.int64
)
TRI_EDGES = np.array([(0, 1), (0, 2), (1, 2)], dtype=np.int64)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A simplicial mesh: ``nodes`` is [Nn, dim] float, ``elements`` [Ne, dim+1] int.

    dim == 2 -> triangles, dim == 3 -> tetrahedra (reference: Mesh{dim,N,Tv,Ti},
    src/grid.jl:19-22).
    """

    nodes: np.ndarray
    elements: np.ndarray

    def __post_init__(self):
        assert self.nodes.ndim == 2 and self.elements.ndim == 2
        assert self.elements.shape[1] == self.nodes.shape[1] + 1

    @property
    def dim(self) -> int:
        return self.nodes.shape[1]

    @property
    def nodes_per_element(self) -> int:
        return self.elements.shape[1]

    @property
    def nnodes(self) -> int:
        return self.nodes.shape[0]

    @property
    def nelements(self) -> int:
        return self.elements.shape[0]

    def sorted_elements(self) -> "Mesh":
        """Return a copy with each element's node tuple sorted ascending."""
        return Mesh(self.nodes, np.sort(self.elements, axis=1))


def reference_simplex(dim: int, dtype=np.float64) -> Mesh:
    """The unit reference simplex as a one-element mesh.

    Reference: reference_element, src/multilevel_reference.jl:3-13.
    """
    nodes = np.vstack([np.zeros((1, dim)), np.eye(dim)]).astype(dtype)
    elements = np.arange(dim + 1, dtype=np.int64)[None, :]
    return Mesh(nodes, elements)


def hypercube(
    dim: int, n: int, scale: float = 1.0, origin=None, dtype=np.float64,
    order: str = "cube",
) -> Mesh:
    """Uniform simplicial mesh of an n^dim hypercube.

    2D: each square -> 2 triangles (reference: src/tri/generate_grid.jl:6-35).
    3D: each cube -> 6 tetrahedra in the Kuhn-style split whose children stay
    aligned with the unit grid under uniform refinement (reference:
    src/tet/generate_grid.jl:22-40 and the comment at :32-33).

    Element rows come out sorted ascending. ``order``: "cube" interleaves the
    2/6 simplices of each cube (e = cube * ept + t); "type" groups elements
    by simplex type (e = t * n^dim + cube) — the layout the structured
    interface combine prefers (each type's rows are then contiguous, so its
    per-type lattice blocks are plain slices and the combined state
    reassembles with no interleaving stack; see ops/structured.py).
    """
    if origin is None:
        origin = np.zeros(dim)
    origin = np.asarray(origin, dtype=dtype)

    # Node grid: node id = x * (n+1)^(dim-1) + y * ... (x slowest).
    axes = [np.arange(n + 1, dtype=dtype) * scale for _ in range(dim)]
    grids = np.meshgrid(*axes, indexing="ij")
    nodes = np.stack([g.ravel() for g in grids], axis=1) + origin

    def nid(*idx):
        """Node id from integer grid coords, vectorized."""
        out = idx[0]
        for k in range(1, dim):
            out = out * (n + 1) + idx[k]
        return out

    rng = np.arange(n, dtype=np.int64)
    if dim == 2:
        x, y = np.meshgrid(rng, rng, indexing="ij")
        x, y = x.ravel(), y.ravel()
        n1 = nid(x, y)
        n2 = nid(x + 1, y)
        n3 = nid(x, y + 1)
        n4 = nid(x + 1, y + 1)
        tris = np.stack(
            [np.stack([n1, n2, n3], axis=1), np.stack([n2, n3, n4], axis=1)], axis=1
        ).reshape(-1, 3)
        elements = np.sort(tris, axis=1)
    elif dim == 3:
        x, y, z = np.meshgrid(rng, rng, rng, indexing="ij")
        x, y, z = x.ravel(), y.ravel(), z.ravel()
        c = [
            nid(x, y, z),
            nid(x + 1, y, z),
            nid(x, y + 1, z),
            nid(x + 1, y + 1, z),
            nid(x, y, z + 1),
            nid(x + 1, y, z + 1),
            nid(x, y + 1, z + 1),
            nid(x + 1, y + 1, z + 1),
        ]
        # 6-tet split sharing the main diagonal; same decomposition pattern as
        # the reference so refined tets stay grid-aligned.
        pattern = [(0, 1, 2, 6), (0, 1, 4, 6), (1, 3, 2, 6), (1, 3, 6, 7), (1, 5, 4, 6), (1, 5, 6, 7)]
        tets = np.stack(
            [np.stack([c[a], c[b], c[cc], c[d]], axis=1) for (a, b, cc, d) in pattern],
            axis=1,
        ).reshape(-1, 4)
        elements = np.sort(tets, axis=1)
    else:
        raise ValueError(f"dim must be 2 or 3, got {dim}")

    if order == "type":
        ept = 2 if dim == 2 else 6
        elements = (
            elements.reshape(-1, ept, elements.shape[1])
            .transpose(1, 0, 2)
            .reshape(-1, elements.shape[1])
        )
    elif order != "cube":
        raise ValueError(f"order must be 'cube' or 'type', got {order!r}")

    return Mesh(nodes, elements)


def element_edges(elements: np.ndarray) -> np.ndarray:
    """All (sorted) node-pair edges of every element, [Ne * n_pairs, 2].

    Rows of `elements` are sorted, so taking local index pairs in increasing
    order yields globally sorted pairs directly.
    """
    npe = elements.shape[1]
    pairs = TRI_EDGES if npe == 3 else TET_EDGES
    return elements[:, pairs].reshape(-1, 2)


def unique_edges(mesh_or_elements, nnodes: int | None = None) -> np.ndarray:
    """Deduplicated, lexicographically sorted edge list [Ne2, 2].

    Replaces the reference's count/prefix-sum/sort CSR pipeline
    (src/sparse_graph.jl:20-48): the lexicographic order of (from, to) pairs
    is exactly the reference's CSR-by-`from` order, so edge indices agree
    positionally with the reference's `edge_index` numbering.
    """
    elements = (
        mesh_or_elements.elements
        if isinstance(mesh_or_elements, Mesh)
        else mesh_or_elements
    )
    e = element_edges(elements)
    from ..native import argsort_rows

    order = argsort_rows(e)
    se = e[order]
    keep = np.ones(len(se), dtype=bool)
    if len(se) > 1:
        keep[1:] = np.any(se[1:] != se[:-1], axis=1)
    return se[keep]


def edge_lookup_key(edges: np.ndarray, nnodes: int) -> np.ndarray:
    """Encode sorted (u, v) pairs as scalar keys for O(log E) searchsorted lookup."""
    return edges[:, 0].astype(np.int64) * np.int64(nnodes) + edges[:, 1].astype(np.int64)


def find_edge_indices(edges: np.ndarray, queries: np.ndarray, nnodes: int) -> np.ndarray:
    """Index of each query edge (sorted pair) within the unique edge list."""
    keys = edge_lookup_key(edges, nnodes)
    qkeys = edge_lookup_key(queries, nnodes)
    idx = np.searchsorted(keys, qkeys)
    assert np.all(keys[idx] == qkeys), "query edge not present in edge list"
    return idx


def list_faces(mesh: Mesh) -> np.ndarray:
    """All faces (3D) or edges (2D) of all elements, one row per (element, local face).

    Rows are globally sorted tuples (element rows sorted). Reference:
    list_faces, src/grid.jl:144-174.
    """
    if mesh.dim == 3:
        return mesh.elements[:, TET_FACES].reshape(-1, 3)
    return mesh.elements[:, TRI_EDGES].reshape(-1, 2)


def _occurrence_counts(rows: np.ndarray):
    """Group identical rows: returns (order, unique_start, counts, inverse)."""
    order = np.lexsort(rows.T[::-1])
    srows = rows[order]
    new = np.ones(len(srows), dtype=bool)
    if len(srows) > 1:
        new[1:] = np.any(srows[1:] != srows[:-1], axis=1)
    group_of_sorted = np.cumsum(new) - 1
    counts = np.bincount(group_of_sorted)
    inverse = np.empty(len(rows), dtype=np.int64)
    inverse[order] = group_of_sorted
    starts = np.flatnonzero(new)
    return order, starts, counts, inverse


def boundary_faces(mesh: Mesh) -> np.ndarray:
    """Faces (3D) / edges (2D) appearing in exactly one element.

    Reference: radix_sort! + remove_repeated_pairs! (src/grid.jl:176-190,
    src/interface.jl:207-215).
    """
    faces = list_faces(mesh)
    order, starts, counts, _ = _occurrence_counts(faces)
    singleton_starts = starts[counts == 1]
    return faces[order[singleton_starts]]


def boundary_nodes(mesh: Mesh) -> np.ndarray:
    """Sorted unique node ids on the mesh boundary."""
    return np.unique(boundary_faces(mesh))


def interior_nodes(mesh: Mesh) -> np.ndarray:
    """Complement of the boundary nodes (reference: list_interior_nodes,
    src/grid.jl:176-202)."""
    mask = np.ones(mesh.nnodes, dtype=bool)
    mask[boundary_nodes(mesh)] = False
    return np.flatnonzero(mask)


def affine_maps(mesh: Mesh):
    """Per-element affine map data from the reference simplex.

    Returns (J, shift, detJ, Jinv) with shapes [Ne,d,d], [Ne,d], [Ne], [Ne,d,d];
    x_phys = J @ x_ref + shift, detJ = |det J| (reference: affine_map,
    src/grid.jl:120-139).
    """
    p = mesh.nodes[mesh.elements]  # [Ne, N, d]
    shift = p[:, 0, :]
    J = np.moveaxis(p[:, 1:, :] - p[:, :1, :], 1, 2)  # columns = p_k - p_0
    detJ = np.abs(np.linalg.det(J))
    Jinv = np.linalg.inv(J)
    return J, shift, detJ, Jinv
