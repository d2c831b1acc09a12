"""Static device tables for the implicit fine grid (host precompute, NumPy).

This is the TPU-native rebuild of the reference's "communication topology":
Interfaces / SparseCellToElementMap (src/interface.jl:31-117),
ZeroDirichletConstraint + apply_constraint! (src/implicit_fine_grid.jl:80-139),
broadcast_interfaces! (src/implicit_fine_grid.jl:209-328) and
zero_out_all_but_one! (:334-386).

State layout on device is ``[n_base_elements, n_local]`` (the reference uses
the transpose, src/multigrid.jl:18-25): elements lead so they can be sharded,
n_local is minor so the element apply contracts it on the MXU.

Everything dynamic in the reference becomes a *static table*:

  * broadcast_interfaces!  ->  gather slots -> segment_sum over groups ->
    scatter sums back. A "slot" is one (element, local node) copy of a shared
    fine DOF; a "group" is the physical fine DOF. Tables are exact and built
    combinatorially: both owners of a shared base face/edge enumerate its
    fine DOFs in the same canonical in-cell parameter order because element
    rows are sorted ascending (see mesh/reference.py).
  * apply_constraint!      ->  multiply by a {0,1} boundary mask.
  * zero_out_all_but_one!  ->  multiply by a first-copy mask (exact norms).
  * copy_to_base!/distribute! -> segment-sum / gather with the base element
    array itself (src/implicit_fine_grid.jl:148-202).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..mesh.grid import Mesh, TET_EDGES, TET_FACES, TRI_EDGES
from ..mesh.reference import (
    MultilevelReference,
    refined_reference,
    with_contiguous_interface_layout,
)
from ..utils.logging import spanned


@dataclasses.dataclass(frozen=True)
class CombineTable:
    """Interface gather/segment-sum/scatter table for one level."""

    slot_elem: np.ndarray  # [S] int32, base element of each slot
    slot_node: np.ndarray  # [S] int32, local (ref mesh) node of each slot
    slot_group: np.ndarray  # [S] int32, physical fine DOF id
    n_groups: int

    def flat(self, n_local: int) -> np.ndarray:
        """Flattened slot indices elem * n_local + node (int32 when they fit;
        rank-1 scatters compile far faster than two-index-vector ones)."""
        idx = self.slot_elem.astype(np.int64) * n_local + self.slot_node
        if idx.size and idx.max() < np.iinfo(np.int32).max:
            return idx.astype(np.int32)
        return idx


@dataclasses.dataclass(frozen=True)
class GatherCombineTables:
    """Fully gather-based combine tables for one level (one class each for
    faces / edges / corners; arrays empty when the class has no interior
    DOFs at this level).

    For each class over ALL its cells (shared and single-owner alike):
      owners_elem  [G, M] — owner elements, padded with 0
      owners_local [G, M] — owner's local cell id, padded with 0
      owners_mask  [G, M] — 1.0 for real owners, 0.0 padding
      gmap         [E, L] — group of element e's local cell l
    The device combine computes sums[g] = sum_j mask * value-of-owner-j via
    row gathers, then rebuilds each element's class block as sums[gmap[:, l]]
    — no scatters anywhere (TPU scatters cost ~17x more per row than
    gathers). Single-owner cells reproduce their own value, so the combine
    is a no-op on them, as required.
    """

    face: tuple | None  # (owners_elem, owners_local, owners_mask, gmap)
    edge: tuple | None
    corner: tuple | None


@dataclasses.dataclass(frozen=True)
class LevelPlan:
    combine: CombineTable
    gather: GatherCombineTables
    boundary_mask: np.ndarray  # [E, n_local] bool: True interior
    first_copy_mask: np.ndarray  # [E, n_local] bool: one copy per fine DOF


@dataclasses.dataclass(frozen=True)
class GridPlan:
    """All static tables for an implicit fine grid on `base` with `nlevels`."""

    base: Mesh
    reference: MultilevelReference
    levels: list  # [LevelPlan] * nlevels
    interior_base_nodes: np.ndarray

    @property
    def nlevels(self) -> int:
        return len(self.levels)

    def n_local(self, k: int) -> int:
        return self.reference.levels[k].nnodes

    @property
    def max_unknowns(self) -> int:
        return self.base.nelements * self.n_local(self.nlevels - 1)


def _ranges(starts: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """concatenate([arange(s, s + c) for s, c in zip(starts, counts)]) without
    the Python loop (the loop dominated plan-build time at 1e6+ elements)."""
    nz = counts > 0
    starts, counts = starts[nz], counts[nz]
    if len(starts) == 0:
        return np.empty(0, dtype=np.int64)
    total = int(counts.sum())
    step = np.ones(total, dtype=np.int64)
    step[0] = starts[0]
    idx = np.cumsum(counts)[:-1]
    step[idx] = starts[1:] - (starts[:-1] + counts[:-1] - 1)
    return np.cumsum(step)


def _pos_in_group(counts: np.ndarray) -> np.ndarray:
    """concatenate([arange(c) for c in counts]) without the Python loop."""
    return _ranges(np.zeros(len(counts), dtype=np.int64), counts)


def _occurrences(rows: np.ndarray):
    """Group identical rows. Returns (occ_order, starts, counts):
    rows[occ_order[starts[g] : starts[g] + counts[g]]] are the occurrences of
    distinct cell g (cells in lexicographic order). Uses the native radix
    argsort (native/hostops.cpp) when rows pack into 64-bit keys."""
    from ..native import argsort_rows

    order = argsort_rows(rows)
    srows = rows[order]
    new = np.ones(len(srows), dtype=bool)
    if len(srows) > 1:
        new[1:] = np.any(srows[1:] != srows[:-1], axis=1)
    starts = np.flatnonzero(new)
    counts = np.diff(np.append(starts, len(srows)))
    return order, starts, counts


def _list_cells(elements: np.ndarray, local_table: np.ndarray):
    """All (cell_nodes, element, local_id) occurrences.

    Returns (cells [Ne*L, c], elem [Ne*L], local [Ne*L]); rows of `cells` are
    globally sorted tuples because element rows are sorted.
    (Reference: list_faces/edges/nodes_with_element, src/interface.jl:124-197.)
    """
    Ne = elements.shape[0]
    L = local_table.shape[0]
    cells = elements[:, local_table].reshape(Ne * L, -1)
    elem = np.repeat(np.arange(Ne, dtype=np.int64), L)
    local = np.tile(np.arange(L, dtype=np.int64), Ne)
    return cells, elem, local


def _class_tables(elements, local_table, nodes_of_local, build_slots=True):
    """Build per-class interface slots and boundary/first-copy slot lists.

    ``nodes_of_local``: [L, m] ref-node ids on (the interior of) each local
    cell, canonically ordered (m may be 0).

    Returns dict with interface slots (elem, node, group), boundary-owner
    slots (elem, node) for cells with exactly one owner, non-first-copy slots,
    plus the occurrence bookkeeping for callers that need more (boundary
    propagation to sub-cells).
    """
    cells, elem, local = _list_cells(elements, local_table)
    order, starts, counts = _occurrences(cells)
    m = nodes_of_local.shape[1]

    def expand(occ_idx, group_rank=None):
        """Turn occurrence indices into (elem, node[, group]) slot arrays."""
        e = elem[order[occ_idx]]
        l = local[order[occ_idx]]
        slot_elem = np.repeat(e, m)
        slot_node = nodes_of_local[l].ravel()
        if group_rank is None:
            return slot_elem, slot_node
        group = (np.repeat(group_rank, m) * m + np.tile(np.arange(m), len(e))).astype(
            np.int64
        )
        return slot_elem, slot_node, group

    # Interface cells: shared by >= 2 elements. The per-DOF slot expansion
    # is S-sized (~101M entries at a 196k-tet 5-level finest) and only the
    # flat combine form and the sharded table construction consume it —
    # ``build_slots=False`` skips it (half the plan-build time, profiled).
    shared = counts >= 2
    shared_starts, shared_counts = starts[shared], counts[shared]
    n_groups = len(shared_starts) * m if m > 0 else 0
    if build_slots and m > 0:
        occ = _ranges(shared_starts, shared_counts)
        cell_rank = np.repeat(np.arange(len(shared_starts)), shared_counts)
        if len(occ):
            ie, inode, igroup = expand(occ, cell_rank)
        else:
            ie = inode = igroup = np.empty(0, dtype=np.int64)
            n_groups = 0
    else:
        ie = inode = igroup = np.empty(0, dtype=np.int64)

    # Non-first copies (for zero_out_all_but_one): every shared occurrence
    # except the first per cell — kept at CELL granularity (one (elem,
    # local) pair per occurrence); the per-DOF mask is filled by column-
    # block broadcast in build_grid_plan (the old per-DOF np.repeat
    # expansion was ~1/3 of the whole plan-build time, profiled at n=32).
    nf_occ = _ranges(shared_starts + 1, shared_counts - 1)
    if m > 0 and len(nf_occ):
        nf_e = elem[order[nf_occ]]
        nf_l = local[order[nf_occ]]
    else:
        nf_e = nf_l = np.empty(0, dtype=np.int64)

    return {
        "iface": (ie, inode, igroup, n_groups),
        "nonfirst_cells": (nf_e, nf_l),
        "cells": cells,
        "elem": elem,
        "local": local,
        "order": order,
        "starts": starts,
        "counts": counts,
    }


def _rows_in(rows: np.ndarray, table: np.ndarray) -> np.ndarray:
    """Boolean mask: which `rows` occur in (sorted-unique) `table`.

    ``table`` is small (boundary cells, O(surface)); sort ITS keys and
    binary-search the big side — np.isin would argsort the O(volume) rows
    (~13 s of the n=32 5-level plan build, profiled)."""
    if len(table) == 0 or len(rows) == 0:
        return np.zeros(len(rows), dtype=bool)

    both_max = max(int(rows.max()), int(table.max()))
    # pack each row into one int64 with a radix common to both sides
    def keyify_common(a):
        a = np.ascontiguousarray(a.astype(np.int64))
        base_v = both_max + 1
        assert base_v ** a.shape[1] < 2**63, "row keys overflow int64"
        k = a[:, 0].copy()
        for c in range(1, a.shape[1]):
            k *= base_v
            k += a[:, c]
        return k

    tk = np.sort(keyify_common(table))
    rk = keyify_common(rows)
    pos = np.searchsorted(tk, rk)
    pos_c = np.minimum(pos, len(tk) - 1)
    return tk[pos_c] == rk


@spanned("hz.plan")
def build_grid_plan(
    base: Mesh, nlevels: int, dtype=np.float64, contiguous: bool = True,
    slot_tables: bool = True,
) -> GridPlan:
    """Build all static tables (reference init path: ImplicitFineGrid ctor,
    src/implicit_fine_grid.jl:13-18 + list_boundary_nodes_edges_faces,
    src/interface.jl:207-284).

    ``contiguous``: renumber reference nodes so interface blocks are
    contiguous columns (windowed gathers/scatters in the combine).
    ``slot_tables``: build the flat per-DOF slot tables (CombineTable) —
    required only by the legacy combine="flat" form (and used as the
    counting oracle in tests); every production path — gather, structured,
    both sharded solvers — builds without them, and skipping halves
    plan-build time at large bases."""
    assert np.all(np.diff(base.elements, axis=1) > 0), "element rows must be sorted"
    dim = base.dim
    ref = refined_reference(dim, nlevels)
    if contiguous:
        ref = with_contiguous_interface_layout(ref)
    E = base.nelements

    edge_table = TRI_EDGES if dim == 2 else TET_EDGES
    face_table = TET_FACES if dim == 3 else None
    corner_table = np.arange(dim + 1, dtype=np.int64)[:, None]

    # ---- boundary cells of the base mesh (level-independent) -------------
    # 3D: boundary faces = faces with one owner; boundary edges/nodes are the
    # sub-simplices of boundary faces. 2D: boundary edges = edges with one
    # owner; boundary nodes their endpoints.
    if dim == 3:
        faces, felem, flocal = _list_cells(base.elements, face_table)
        forder, fstarts, fcounts = _occurrences(faces)
        bnd_face_occ = forder[fstarts[fcounts == 1]]
        bnd_faces = faces[bnd_face_occ]
        # edges of boundary faces: local pairs within the (sorted) face triple
        bnd_edges = np.unique(
            bnd_faces[:, [(0, 1), (0, 2), (1, 2)]].reshape(-1, 2), axis=0
        )
    else:
        edges2, eelem2, elocal2 = _list_cells(base.elements, edge_table)
        eorder2, estarts2, ecounts2 = _occurrences(edges2)
        bnd_edge_occ2 = eorder2[estarts2[ecounts2 == 1]]
        bnd_edges = np.unique(edges2[bnd_edge_occ2], axis=0)
        bnd_faces = np.empty((0, 3), dtype=np.int64)
    bnd_nodes = np.unique(bnd_edges)

    interior_base = np.setdiff1d(np.arange(base.nnodes), bnd_nodes)

    level_plans = []
    for k in range(nlevels):
        num = ref.numbering[k]
        n_local = ref.levels[k].nnodes

        classes = []
        # face class (3D only, interior nodes per face)
        if dim == 3 and len(num.faces.interior):
            npf = len(num.faces.interior[0])
            face_nodes = np.stack(num.faces.interior).astype(np.int64)
            classes.append(("face", face_table, face_nodes, npf))
        # edge class
        npe = len(num.edges.interior[0])
        edge_nodes = np.stack(num.edges.interior).astype(np.int64)
        classes.append(("edge", edge_table, edge_nodes, npe))
        # corner class
        corner_nodes = num.corners[:, None].astype(np.int64)
        classes.append(("corner", corner_table, corner_nodes, 1))

        slot_e, slot_n, slot_g = [], [], []
        nonfirst_e, nonfirst_n = [], []
        group_offset = 0
        first_mask = np.ones((E, n_local), dtype=bool)

        def contig_cols(lnodes_):
            """Per-local-cell start columns when each cell's DOF columns are
            consecutive (the contiguous-interface layout), else None."""
            if lnodes_.shape[1] == 0:
                return None
            c0s = lnodes_[:, 0]
            if np.array_equal(
                lnodes_, c0s[:, None] + np.arange(lnodes_.shape[1])
            ):
                return c0s
            return None
        # bool masks: a [196608, 969] f64 ones() alone costs ~1.5 GB of
        # allocation+fill per mask per level (profiled); consumers multiply
        # or compare, which bool serves directly
        bmask = np.ones((E, n_local), dtype=bool)

        gather_tabs = {"face": None, "edge": None, "corner": None}

        for name, ltab, lnodes, m in classes:
            tabs = _class_tables(
                base.elements, ltab, lnodes, build_slots=slot_tables
            )
            ie, inode, igroup, ng = tabs["iface"]
            if m > 0 and len(ie):
                slot_e.append(ie)
                slot_n.append(inode)
                slot_g.append(igroup + group_offset)
            group_offset += ng
            nf_e, nf_l = tabs["nonfirst_cells"]
            L_cells = ltab.shape[0]
            ccols = contig_cols(lnodes) if m > 0 else None
            if m > 0 and len(nf_e):
                if ccols is not None:
                    # cell-granular mask -> per-class column-block broadcast
                    fm_cell = np.ones((E, L_cells), dtype=bool)
                    fm_cell[nf_e, nf_l] = False
                    for l in range(L_cells):
                        first_mask[:, ccols[l] : ccols[l] + m] = fm_cell[
                            :, l : l + 1
                        ]
                else:  # non-contiguous layout: per-DOF expansion fallback
                    nonfirst_e.append(np.repeat(nf_e, m))
                    nonfirst_n.append(lnodes[nf_l].ravel())

            order, starts, counts = tabs["order"], tabs["starts"], tabs["counts"]
            elem_occ, local_occ = tabs["elem"], tabs["local"]
            if name == "face" and m > 0:
                assert counts.max(initial=0) <= 2, "face shared by > 2 elements"

            # ---- gather-based form (over ALL cells of the class) --------
            if m > 0:
                G = len(starts)
                M = int(counts.max()) if G else 1
                L = ltab.shape[0]
                o_elem = np.zeros((G, M), dtype=np.int32)
                o_local = np.zeros((G, M), dtype=np.int32)
                o_mask = np.zeros((G, M), dtype=np.float64)
                # occurrence j within its group
                pos_in_group = _pos_in_group(counts)
                grp_all = np.repeat(np.arange(G), counts)
                eo_all = elem_occ[order]
                lo_all = local_occ[order]
                o_elem[grp_all, pos_in_group] = eo_all
                o_local[grp_all, pos_in_group] = lo_all
                o_mask[grp_all, pos_in_group] = 1.0
                gmap = np.zeros((E, L), dtype=np.int32)
                gmap[eo_all, lo_all] = grp_all
                gather_tabs[name] = (o_elem, o_local, o_mask, gmap)

            # Boundary zeroing: all owners of boundary cells of this class.
            if name == "face":
                bnd_cells = bnd_faces
            elif name == "edge":
                bnd_cells = bnd_edges
            else:
                bnd_cells = bnd_nodes[:, None]
            if m > 0 and len(bnd_cells):
                is_bnd = _rows_in(tabs["cells"], bnd_cells)
                occ = np.flatnonzero(is_bnd)
                be = tabs["elem"][occ]
                bl = tabs["local"][occ]
                if ccols is not None:
                    bd_cell = np.zeros((E, L_cells), dtype=bool)
                    bd_cell[be, bl] = True
                    for l in range(L_cells):
                        bmask[:, ccols[l] : ccols[l] + m] = ~bd_cell[
                            :, l : l + 1
                        ]
                else:
                    bmask[np.repeat(be, m), lnodes[bl].ravel()] = 0.0

        if slot_e:
            combine = CombineTable(
                np.concatenate(slot_e).astype(np.int32),
                np.concatenate(slot_n).astype(np.int32),
                np.concatenate(slot_g).astype(np.int32),
                group_offset,
            )
        else:
            z = np.empty(0, dtype=np.int32)
            combine = CombineTable(z, z, z, 0)

        if nonfirst_e:  # non-contiguous-layout fallback lists
            first_mask[
                np.concatenate(nonfirst_e), np.concatenate(nonfirst_n)
            ] = 0.0

        gather = GatherCombineTables(
            face=gather_tabs["face"],
            edge=gather_tabs["edge"],
            corner=gather_tabs["corner"],
        )
        level_plans.append(LevelPlan(combine, gather, bmask, first_mask))

    return GridPlan(base, ref, level_plans, interior_base)
