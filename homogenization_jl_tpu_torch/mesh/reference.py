"""Multilevel refined reference element (host-side, NumPy).

Rebuild of MultilevelReference / ReferenceNumbering
(src/multilevel_reference.jl:19-203): the reference simplex refined L-1
times, the prolongation structure between consecutive levels, and the local
numbering of nodes on each face / edge / corner of the simplex.

Differences from the reference, by design:
  * Node-on-cell membership is decided with *exact barycentric coordinates*
    (midpoint refinement of dyadic coordinates is exact in float64), not an
    1e-7 projection tolerance (reference IsOnEdge,
    src/multilevel_reference.jl:83-101).
  * Per-cell node lists are canonically ordered by the node's (quantized,
    exact) parameters *within the cell*, measured in the frame of the cell's
    increasing local corners. Because element rows of any base mesh are sorted
    ascending, two base elements sharing a face/edge enumerate the shared fine
    DOFs in the same order — the invariant `broadcast_interfaces!` relies on
    (src/implicit_fine_grid.jl:209-328) — here it holds *by construction*
    instead of by refinement-history coincidence.
  * Prolongation is stored structurally (midpoint edge endpoints), so the
    device transfer ops are one matmul / gather rather than CSC SpMV
    (src/interpolation.jl:7-50).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .grid import Mesh, TET_EDGES, TET_FACES, TRI_EDGES, reference_simplex
from .refine import refine_once


@dataclasses.dataclass(frozen=True)
class CellNumbering:
    """Node numbering on one class of sub-simplex cells of the reference element.

    ``full[l]`` / ``interior[l]``: ref-mesh node indices on local cell ``l``
    (all / interior only), canonically ordered by in-cell parameter.
    ``params_interior[l]``: the matching quantized integer parameters
    ([k, cell_dim], in units of 1/2^level) — kept for tests/debugging.
    """

    full: list
    interior: list
    params_interior: list


@dataclasses.dataclass(frozen=True)
class ReferenceNumbering:
    faces: CellNumbering  # empty lists in 2D
    edges: CellNumbering
    corners: np.ndarray  # [N] node index of each corner (identity prefix)


@dataclasses.dataclass(frozen=True)
class MultilevelReference:
    """levels[k] = reference simplex refined k times (k = 0 .. L-1).

    ``midpoint_edges[k]``: [E_k, 2] endpoints (level-k node ids) defining the
    midpoint nodes of level k+1; level-(k+1) node ``n_k + j`` is the midpoint
    of ``midpoint_edges[k][j]``. Encodes the prolongation operator P_k.
    """

    dim: int
    levels: list
    numbering: list
    midpoint_edges: list
    # Contiguous-interface layout (optional): perms[k] maps the construction
    # numbering to the final numbering; layout[k] records the column blocks.
    perms: list | None = None
    layout: list | None = None

    @property
    def nlevels(self) -> int:
        return len(self.levels)

    def nodes_per_level(self, k: int) -> int:
        return self.levels[k].nnodes

    def level_in_finer(self, k: int) -> np.ndarray:
        """Index of each level-k node within level k+1 (identity prefix in
        construction numbering, composed with the layout permutations)."""
        nk = self.levels[k].nnodes
        if self.perms is None:
            return np.arange(nk, dtype=np.int64)
        inv_k = np.empty(nk, dtype=np.int64)
        inv_k[self.perms[k]] = np.arange(nk)
        return self.perms[k + 1][inv_k]

    def level_in_level(self, k: int, m: int) -> np.ndarray:
        """Index of each level-k node within level m >= k."""
        idx = np.arange(self.levels[k].nnodes, dtype=np.int64)
        for j in range(k, m):
            idx = self.level_in_finer(j)[idx]
        return idx


def _barycentric(nodes: np.ndarray) -> np.ndarray:
    """Exact barycentric coordinates of reference-mesh nodes, [Nn, dim+1]."""
    return np.concatenate([1.0 - nodes.sum(axis=1, keepdims=True), nodes], axis=1)


def _cell_numbering(mesh: Mesh, corners_table: np.ndarray, level: int) -> CellNumbering:
    """Numbering of nodes on each sub-cell (edge: 2 corners, face: 3 corners).

    A node lies on the cell iff its barycentric coords vanish at all
    non-cell corners (exact test). Its in-cell parameters are its barycentric
    coords at the cell's non-first corners, quantized by 2^level (exact
    dyadic -> integer).
    """
    bary = _barycentric(mesh.nodes)
    scale = float(1 << level)
    N = mesh.dim + 1

    full, interior, params_int = [], [], []
    for corners in corners_table:
        others = [c for c in range(N) if c not in corners]
        on_cell = np.all(np.abs(bary[:, others]) < 1e-12, axis=1)
        ids = np.flatnonzero(on_cell)
        # Parameters within the cell: barycentric coords at corners[1:].
        p = bary[np.ix_(ids, corners[1:])]
        q = np.round(p * scale).astype(np.int64)
        assert np.max(np.abs(q / scale - p)) < 1e-12, "non-dyadic coordinate"
        order = np.lexsort(q.T[::-1])
        ids, q = ids[order], q[order]
        # Interior: all barycentric coords strictly inside (no corner of the
        # cell reached), i.e. every param in (0, 2^level) and their sum too.
        s = q.sum(axis=1)
        inner = np.all(q > 0, axis=1) & (s < int(scale))
        full.append(ids)
        interior.append(ids[inner])
        params_int.append(q[inner])
    return CellNumbering(full, interior, params_int)


def _numbering(mesh: Mesh, level: int) -> ReferenceNumbering:
    dim = mesh.dim
    if dim == 3:
        faces = _cell_numbering(mesh, TET_FACES, level)
        edges = _cell_numbering(mesh, TET_EDGES, level)
    else:
        faces = CellNumbering([], [], [])
        edges = _cell_numbering(mesh, TRI_EDGES, level)
    corners = np.arange(dim + 1, dtype=np.int64)
    return ReferenceNumbering(faces, edges, corners)


def refined_reference(dim: int, nlevels: int, dtype=np.float64) -> MultilevelReference:
    """Build the multilevel reference element (reference: refined_element,
    src/multilevel_reference.jl:41-61)."""
    levels = [reference_simplex(dim, dtype=dtype)]
    midpoint_edges = []
    for _ in range(nlevels - 1):
        fine, edges = refine_once(levels[-1])
        midpoint_edges.append(edges)
        levels.append(fine)
    numbering = [_numbering(m, k) for k, m in enumerate(levels)]
    return MultilevelReference(dim, levels, numbering, midpoint_edges)


def prolongation_dense(ref: MultilevelReference, k: int, dtype=np.float64) -> np.ndarray:
    """Dense prolongation P_k: level-k -> level-(k+1) values, [n_{k+1}, n_k].

    Identity on existing nodes, 1/2 + 1/2 from edge endpoints on midpoints
    (reference: interpolation_operator, src/interpolation.jl:7-50). Expressed
    in the final (possibly permuted) numbering.
    """
    nc = ref.levels[k].nnodes
    nf = ref.levels[k + 1].nnodes
    edges = ref.midpoint_edges[k]  # construction numbering of level k
    P = np.zeros((nf, nc), dtype=dtype)
    P[np.arange(nc), np.arange(nc)] = 1.0
    P[np.arange(nc, nf), edges[:, 0]] = 0.5
    P[np.arange(nc, nf), edges[:, 1]] += 0.5
    if ref.perms is not None:
        inv_f = np.empty(nf, dtype=np.int64)
        inv_f[ref.perms[k + 1]] = np.arange(nf)
        inv_c = np.empty(nc, dtype=np.int64)
        inv_c[ref.perms[k]] = np.arange(nc)
        P = P[np.ix_(inv_f, inv_c)]
    return P


@dataclasses.dataclass(frozen=True)
class LevelLayout:
    """Column blocks of the contiguous-interface node numbering:
    [cell interior | face0 int | ... | edge0 int | ... | corners]."""

    face_offsets: np.ndarray  # [n_local_faces] start col of each face block
    npf: int
    edge_offsets: np.ndarray  # [n_local_edges]
    npe: int
    corner_cols: np.ndarray  # [N]


def with_contiguous_interface_layout(ref: MultilevelReference) -> MultilevelReference:
    """Renumber each level's nodes so every sub-cell's interior DOFs form a
    contiguous column block (in canonical in-cell order) and corners sit at
    fixed columns. The interface combine then gathers/scatters rectangular
    windows instead of scattered columns — the TPU-friendly layout.

    Level 0 (corners only) keeps the identity numbering, preserving the
    level-0 <-> base-node correspondence used by the coarse solve.
    """
    perms, layouts, new_levels, new_numbering = [], [], [], []
    for k, mesh in enumerate(ref.levels):
        num = ref.numbering[k]
        n = mesh.nnodes
        order = []
        in_class = np.zeros(n, dtype=bool)

        def push(ids):
            ids = np.asarray(ids, dtype=np.int64)
            assert not in_class[ids].any()
            in_class[ids] = True
            order.append(ids)

        face_off, edge_off = [], []
        # corners + boundary classes marked first; interior block leads so
        # that level-0 (corners only) stays identity-numbered... except
        # level 0 has no interior; handle by putting corners FIRST at k == 0.
        if k == 0:
            new_levels.append(mesh)
            new_numbering.append(num)
            perms.append(np.arange(n, dtype=np.int64))
            layouts.append(
                LevelLayout(
                    face_offsets=np.zeros(0, dtype=np.int64),
                    npf=0,
                    edge_offsets=np.zeros(0, dtype=np.int64),
                    npe=0,
                    corner_cols=num.corners.copy(),
                )
            )
            continue

        # interior first (bulk of the matmul work stays a prefix), then the
        # interface classes in fixed order
        marked = np.zeros(n, dtype=bool)
        for ids in num.faces.interior:
            marked[ids] = True
        for ids in num.edges.interior:
            marked[ids] = True
        marked[num.corners] = True
        push(np.flatnonzero(~marked))

        cursor = len(order[0])
        for ids in num.faces.interior:
            face_off.append(cursor)
            push(ids)
            cursor += len(ids)
        for ids in num.edges.interior:
            edge_off.append(cursor)
            push(ids)
            cursor += len(ids)
        corner_cols = np.arange(cursor, cursor + len(num.corners), dtype=np.int64)
        push(num.corners)

        old_order = np.concatenate(order)
        perm = np.empty(n, dtype=np.int64)  # old -> new
        perm[old_order] = np.arange(n)

        new_mesh = Mesh(mesh.nodes[old_order], np.sort(perm[mesh.elements], axis=1))
        npf = (
            len(num.faces.interior[0]) if len(num.faces.interior) else 0
        )
        npe = len(num.edges.interior[0]) if len(num.edges.interior) else 0

        def permute_cells(cn: CellNumbering) -> CellNumbering:
            return CellNumbering(
                [perm[ids] for ids in cn.full],
                [perm[ids] for ids in cn.interior],
                cn.params_interior,
            )

        new_numbering.append(
            ReferenceNumbering(
                permute_cells(num.faces),
                permute_cells(num.edges),
                perm[num.corners],
            )
        )
        new_levels.append(new_mesh)
        perms.append(perm)
        layouts.append(
            LevelLayout(
                face_offsets=np.asarray(face_off, dtype=np.int64),
                npf=npf,
                edge_offsets=np.asarray(edge_off, dtype=np.int64),
                npe=npe,
                corner_cols=corner_cols,
            )
        )

    return MultilevelReference(
        ref.dim, new_levels, new_numbering, ref.midpoint_edges, perms, layouts
    )
