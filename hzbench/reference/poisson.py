"""The plain reference of the solve cells: -div(sigma grad u) = f with
u = 0 on the boundary of the box, P1 elements on the refined base mesh.

Everything here is worked out again from the benchmark's inputs: the base
box, the number of refinements, the per-axis conductivity of every base
element and the element-local right-hand side. The fine operator is applied
sub-tetrahedron by sub-tetrahedron (4 x 4 element stiffness from the
barycentric gradients), assembled on the global lattice of fine nodes by
their integer coordinates, in float64, in blocks of base elements so that
it fits beside what the device already holds.

The one thing taken from the program is the address of its answer: which
reference coordinate each column of x [E, n] stands for (the port numbers
the refined reference element in its own interface layout). The answer is
judged against the physics at those coordinates, so a wrong address reads
as a wrong answer.
"""

from __future__ import annotations

import numpy as np
import torch

from .mesh import affine, refined_reference


class FineProblem:
    """The refined problem on a box of n^3 cubes, ``levels`` - 1 red
    refinements of each base tetrahedron.

    ``col_ref``: [n_local, 3] reference coordinates of the answer's columns
    (dyadic). ``sigma_el``: [E, 3] per-axis conductivity of the base
    elements. ``nodes``, ``elements``: the base mesh, as handed to the
    program."""

    def __init__(self, nodes, elements, levels, col_ref, sigma_el, device="cpu", block=4096):
        self.device = torch.device(device)
        self.block = block
        ref = reference_element(levels, col_ref)
        self.scale = ref["scale"]
        tv, G, vol, q_col = ref["tv"], ref["G"], ref["vol"], ref["q_col"]
        v0, J = affine(nodes, elements)
        detJ = np.abs(np.linalg.det(J))
        Jinv = np.linalg.inv(J)
        sig = np.asarray(sigma_el, dtype=np.float64)
        # metric of each element: |det J| J^-1 diag(sigma) J^-T
        K = detJ[:, None, None] * np.einsum("ekm,em,elm->ekl", Jinv, sig, Jinv)
        self.n_cells = int(round(nodes[:, 0].max() - nodes[:, 0].min()))
        lo = nodes.min(axis=0)
        dev = self.device
        t = lambda a, dt=torch.float64: torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                                                        device=dev)
        self.E = len(elements)
        self.tv = t(tv, torch.int64)
        self.G = t(G)
        self.Gv = t(G * vol[:, None, None])
        self.K = t(K)
        # integer lattice coordinates of every (element, column): 2^times
        # (v0 - lo) + J_int (2^times xi)
        self.v0q = t(np.rint((v0 - lo) * self.scale), torch.int64)
        Jq = np.rint(J)
        if np.abs(Jq - J).max() > 1e-12:
            raise ValueError("base elements are not lattice-aligned")
        self.Jq = t(Jq, torch.int64)
        self.q_col = t(q_col, torch.int64)
        self.M = self.n_cells * self.scale + 1  # fine nodes per axis
        self.n_nodes = self.M ** 3

    # -- the check ------------------------------------------------------- #
    def _keys(self, e0, e1):
        # integer arithmetic (no integer matmul on the card)
        q = self.v0q[e0:e1, None, :] + (self.Jq[e0:e1, None, :, :]
                                        * self.q_col[None, :, None, :]).sum(-1)
        M = self.M
        return (q[..., 0] * M + q[..., 1]) * M + q[..., 2], q

    def _blocks(self):
        for e0 in range(0, self.E, self.block):
            yield e0, min(self.E, e0 + self.block)

    def local_apply(self, xe, e0, e1):
        """A_e x_e for the elements [e0, e1): x [B, n] float64 -> [B, n]."""
        xt = xe[:, self.tv]  # [B, T, 4]
        g = torch.einsum("btv,tvk->btk", xt, self.G)
        w = torch.einsum("btk,bkl->btl", g, self.K[e0:e1])
        yt = torch.einsum("btl,tvl->btv", w, self.Gv)
        y = torch.zeros_like(xe)
        y.index_add_(1, self.tv.reshape(-1), yt.reshape(len(xe), -1))
        return y

    def check(self, x, b):
        """Judge an answer x [E, n] (any float dtype, any device) of the
        element-local right-hand side b [E, n]. Returns {"residual": the
        float64 relative residual ||b - A x|| / ||b|| over the interior
        fine nodes, x's copies averaged; "copy_gap": the largest distance of
        a copy from its node's mean, over max |x|}. x's boundary values
        enter A x as they are (the constraint holds them at 0)."""
        dev = self.device
        N = self.n_nodes
        xs = torch.zeros(N, dtype=torch.float64, device=dev)
        cnt = torch.zeros(N, dtype=torch.float64, device=dev)
        bs = torch.zeros(N, dtype=torch.float64, device=dev)
        for e0, e1 in self._blocks():
            k, _ = self._keys(e0, e1)
            k = k.reshape(-1)
            xs.index_add_(0, k, x[e0:e1].to(dev, torch.float64).reshape(-1))
            bs.index_add_(0, k, b[e0:e1].to(dev, torch.float64).reshape(-1))
            cnt.index_add_(0, k, torch.ones_like(k, dtype=torch.float64))
        if bool((cnt == 0).any()):
            raise AssertionError("reference: a fine node has no copy")
        xs /= cnt
        del cnt
        Ax = torch.zeros(N, dtype=torch.float64, device=dev)
        gap = torch.zeros((), dtype=torch.float64, device=dev)
        for e0, e1 in self._blocks():
            k, _ = self._keys(e0, e1)
            xe = xs[k]
            gap = torch.maximum(gap, (x[e0:e1].to(dev, torch.float64) - xe).abs().max())
            Ax.index_add_(0, k.reshape(-1), self.local_apply(xe, e0, e1).reshape(-1))
        M = self.M
        i = torch.arange(M, device=dev)
        inner = (i > 0) & (i < M - 1)
        interior = (inner[:, None, None] & inner[None, :, None] & inner[None, None, :]).reshape(-1)
        r = (bs - Ax)[interior]
        bn = torch.linalg.vector_norm(bs[interior])
        return dict(residual=float(torch.linalg.vector_norm(r) / bn),
                    copy_gap=float(gap / xs.abs().max()))


def reference_element(levels, col_ref):
    """The refined reference tetrahedron in the answer's column numbering:
    {"scale": 2^(levels - 1), "q_col": [n, 3] integer coordinates of the
    columns (units of 1 / scale), "tv": [T, 4] sub-tetrahedra as columns,
    "G": [T, 4, 3] barycentric gradients in reference coordinates, "vol":
    [T] volumes, "load": [n] the unit load of each column (each
    sub-tetrahedron gives vol / 4 to a vertex)}."""
    times = levels - 1
    scale = 1 << times
    ref_nodes, sub = refined_reference(times)
    # each column's reference node, matched by exact integer coordinates
    q_ref = np.rint(ref_nodes * scale).astype(np.int64)
    col_ref = np.asarray(col_ref, dtype=np.float64)
    q_col = np.rint(col_ref * scale).astype(np.int64)
    if np.abs(q_col / scale - col_ref).max() > 1e-12:
        raise ValueError("column coordinates are not on the refined lattice")
    m = scale + 1
    key_ref = (q_ref[:, 0] * m + q_ref[:, 1]) * m + q_ref[:, 2]
    key_col = (q_col[:, 0] * m + q_col[:, 1]) * m + q_col[:, 2]
    order = np.argsort(key_ref)
    pos = np.minimum(np.searchsorted(key_ref[order], key_col), len(key_ref) - 1)
    if len(key_col) != len(key_ref) or not np.array_equal(key_ref[order][pos], key_col) \
            or len(np.unique(key_col)) != len(key_col):
        raise ValueError("the answer's columns are not the refined element's nodes")
    ref_to_col = np.empty(len(key_ref), dtype=np.int64)
    ref_to_col[order[pos]] = np.arange(len(key_col))
    tv = ref_to_col[sub]
    p = ref_nodes[sub]  # [T, 4, 3]
    B = np.moveaxis(p[:, 1:, :] - p[:, :1, :], 1, 2)  # columns p_k - p_0
    Binv = np.linalg.inv(B)
    G = np.concatenate([-Binv.sum(axis=1, keepdims=True), Binv], axis=1)
    vol = np.abs(np.linalg.det(B)) / 6.0
    load = np.zeros(len(key_col))
    np.add.at(load, tv, np.repeat(vol[:, None] / 4.0, 4, axis=1))
    return dict(scale=scale, q_col=q_col, tv=tv, G=G, vol=vol, load=load)
