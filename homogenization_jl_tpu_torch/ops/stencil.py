"""Lattice-stencil form of the level-0 (base P1) operator on box meshes
(host tables, device ops in PyTorch + CUDA kernel K6).

Port of homogenization_jl_tpu/ops/stencil.py. On a lexicographic full-box
hypercube base the assembled base operator is a stencil on the (n+1)^d node
lattice,

    y[a] = sum_k W_k[a] * u[a + delta_k],      K <= 3^d offsets,

whose weights are linear in the per-element apply coefficients: every
(simplex type t, local i, local j) entry adds
``sum_p coeff[t, q, p] * stack0[p, i, j]`` to W_k over the cubes q, at the
lattice node q + corner[t][i]. The global-space coarse solves
(``coarse="cg"``/``"mg"``) apply the level-0 operator this way.

Host: ``LatticeStencil`` and ``build_lattice_stencil``, copied from the JAX
module. Device: four functions, each with a plain PyTorch form (the JAX
module's slice-adds, in the same order) and kernel K6
(csrc/lattice_stencil.cu) for CUDA tensors:

  * ``lattice_weights``   [E, P] coefficients -> W [K, (n+1)^d];
  * ``lattice_apply``     y = m * (A u), or b - m * (A u);
  * ``lattice_assemble``  [E, d+1] local contributions -> [(n+1)^d];
  * ``lattice_distribute`` [(n+1)^d] -> [E, d+1].

W is kept flat, [K, (n+1)^d] (the JAX form shapes it [K, n+1, ..., n+1]).

Plane window (``x0``, ``planes``; the slab form of JAX
parallel/slab.py:149-229): ``lattice_weights`` and ``lattice_assemble``
take the element rows of the planes of cubes [x0, x0 + planes) only and
return their partial over the whole lattice (zero where none of them
lands), which the ranks of a slab group sum; ``lattice_distribute`` returns
those rows. The defaults (0, n) are the whole box.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..csrc.build import LAUNCHES, launch

_DTYPES = {torch.float32: 0, torch.float64: 1}

# fixed capacities of the kernel's by-value table (csrc/lattice_stencil.cu)
_MAX_EPT, _MAX_DELTAS, _MAX_ENTRIES = 6, 27, 96


@dataclasses.dataclass(frozen=True)
class LatticeStencil:
    dim: int
    n: int  # cubes per axis; (n+1)^dim lattice nodes
    ept: int  # elements (simplices) per cube
    order: str  # "cube" (e = q*ept + t) or "type" (e = t*n^d + q)
    # corner offset alpha[t][i] in {0,1}^dim of sorted-local node i of type t
    corner: tuple  # [ept][d+1] -> dim-tuple
    # weight entries: (t, i, j, k) with k indexing deltas; delta_k = corner
    # [t][j] - corner[t][i]
    entries: tuple
    deltas: tuple  # K dim-tuples in {-1,0,1}^dim


def build_lattice_stencil(base) -> LatticeStencil | None:
    """Stencil tables for a lexicographic full-box hypercube base, else None.

    Requires (and verifies): lattice-lexicographic node numbering and the
    identical-per-cube element split (``detect_structured``)."""
    from ..solver.coarse import detect_box
    from .structured import detect_structured

    st = detect_structured(base)
    if st is None:
        return None
    n, ept, order = st
    origin, _, h = detect_box(base)
    d = base.dim

    # node id must equal the lexicographic lattice index (x slowest)
    coords = np.round((base.nodes - origin[None, :]) / h).astype(np.int64)
    ids = coords[:, 0]
    for k in range(1, d):
        ids = ids * (n + 1) + coords[:, k]
    if not np.array_equal(ids, np.arange(base.nnodes)):
        return None

    # corner offsets of each type's sorted-local nodes, from cube 0
    # (detect_structured verified every cube carries the same split)
    corner = []
    for t in range(ept):
        e0 = t * (n**d) if order == "type" else t  # type t of cube 0
        corner.append(tuple(tuple(coords[v]) for v in base.elements[e0]))

    deltas: list = []
    dindex: dict = {}
    entries = []
    for t in range(ept):
        for i in range(d + 1):
            for j in range(d + 1):
                delta = tuple(
                    corner[t][j][a] - corner[t][i][a] for a in range(d)
                )
                if delta not in dindex:
                    dindex[delta] = len(deltas)
                    deltas.append(delta)
                entries.append((t, i, j, dindex[delta]))

    return LatticeStencil(
        dim=d, n=n, ept=ept, order=order, corner=tuple(map(tuple, corner)),
        entries=tuple(entries), deltas=tuple(deltas),
    )


# --------------------------------------------------------------------- #
# plain PyTorch forms (the JAX module's slice-adds, same order)
# --------------------------------------------------------------------- #
def _window(st: LatticeStencil, planes) -> tuple:
    """Cube grid of a window: [planes] + [n]*(d-1) (planes None: n)."""
    return (st.n if planes is None else int(planes),) + (st.n,) * (st.dim - 1)


def _coeff_lattice(coeff, st: LatticeStencil, planes=None):
    """[E, P] -> [ept, cubes, P] with the cube axis in lattice-lex order."""
    P = coeff.shape[1]
    nd = int(np.prod(_window(st, planes)))
    if st.order == "type":
        return coeff.reshape(st.ept, nd, P)
    return coeff.reshape(nd, st.ept, P).transpose(0, 1)


def _box(lo, sizes, x0=0):
    """Lattice slice of the window's cubes shifted by corner ``lo``."""
    return tuple(slice(a + (x0 if ax == 0 else 0), a + (x0 if ax == 0 else 0) + m)
                 for ax, (a, m) in enumerate(zip(lo, sizes)))


def lattice_weights_plain(coeff, stack0, st: LatticeStencil, x0=0, planes=None):
    n, d = st.n, st.dim
    win = _window(st, planes)
    c3 = _coeff_lattice(coeff, st, planes).reshape((st.ept,) + win + (-1,))
    W = torch.zeros((len(st.deltas),) + (n + 1,) * d, dtype=coeff.dtype, device=coeff.device)
    for t, i, j, k in st.entries:
        s = torch.matmul(c3[t], stack0[:, i, j])  # the window's cubes
        W[(k,) + _box(st.corner[t][i], win, x0)] += s
    return W.reshape(len(st.deltas), -1)


def lattice_apply_plain(u, W, st: LatticeStencil, m=None, b=None):
    n, d = st.n, st.dim
    U = u.reshape((n + 1,) * d)
    Wg = W.reshape((len(st.deltas),) + (n + 1,) * d)
    y = torch.zeros_like(U)
    for k, delta in enumerate(st.deltas):
        dst = tuple(slice(max(-dd, 0), n + 1 + min(-dd, 0)) for dd in delta)
        src = tuple(slice(max(dd, 0), n + 1 + min(dd, 0)) for dd in delta)
        y[dst] += Wg[(k,) + dst] * U[src]
    y = y.reshape(-1)
    if m is not None:
        y = y * m
    return y if b is None else b - y


def _local_lattice(y_local, st: LatticeStencil, planes=None):
    """[E, d+1] -> [ept] + window + [d+1] with cubes in lattice-lex order."""
    d = st.dim
    win = _window(st, planes)
    if st.order == "type":
        return y_local.reshape((st.ept,) + win + (d + 1,))
    return (
        y_local.reshape(-1, st.ept, d + 1)
        .transpose(0, 1)
        .reshape((st.ept,) + win + (d + 1,))
    )


def lattice_assemble_plain(y_local, st: LatticeStencil, x0=0, planes=None):
    n, d = st.n, st.dim
    win = _window(st, planes)
    y3 = _local_lattice(y_local, st, planes)
    B = torch.zeros((n + 1,) * d, dtype=y_local.dtype, device=y_local.device)
    for t in range(st.ept):
        for i in range(d + 1):
            B[_box(st.corner[t][i], win, x0)] += y3[t][..., i]
    return B.reshape(-1)


def lattice_distribute_plain(u, st: LatticeStencil, x0=0, planes=None):
    n, d = st.n, st.dim
    win = _window(st, planes)
    U = u.reshape((n + 1,) * d)
    out = torch.stack(
        [
            torch.stack(
                [U[_box(st.corner[t][i], win, x0)].reshape(-1) for i in range(d + 1)], dim=1
            )
            for t in range(st.ept)
        ],
        dim=0,
    )  # [ept, cubes, d+1]
    if st.order == "type":
        return out.reshape(-1, d + 1)
    return out.transpose(0, 1).reshape(-1, d + 1)


# --------------------------------------------------------------------- #
# wrappers: plain form on CPU, kernel K6 on CUDA
# --------------------------------------------------------------------- #
def kernel_table(st: LatticeStencil) -> np.ndarray:
    """The stencil's int32 table in the layout of csrc/lattice_stencil.cu
    (``LatticeTab``): dim, n, ept, type_major, K, n_entries, then
    corner[6][4][3], delta[27][3], entry[96][4] (t, i, j, k) and off[27]
    (the flat lattice offset delta_k . stride of each neighbour),
    zero-padded. Packed once per stencil, on first use, and kept on it
    (read-only): every K6 call passes this array's address, and the kernels
    receive it by value, in the launch's constant parameter space. Raises
    for a stencil beyond the table's capacity."""
    tab = st.__dict__.get("_kernel_table")
    if tab is not None:
        return tab
    d = st.dim
    K = len(st.deltas)
    if st.ept > _MAX_EPT or K > _MAX_DELTAS or len(st.entries) > _MAX_ENTRIES:
        raise ValueError("lattice stencil exceeds the kernel table's capacity")
    corner = np.zeros((_MAX_EPT, 4, 3), np.int32)
    for t in range(st.ept):
        for i in range(d + 1):
            corner[t, i, :d] = st.corner[t][i]
    delta = np.zeros((_MAX_DELTAS, 3), np.int32)
    off = np.zeros(_MAX_DELTAS, np.int32)
    stride = (st.n + 1) ** np.arange(d - 1, -1, -1)
    for k, dl in enumerate(st.deltas):
        delta[k, :d] = dl
        off[k] = int(np.dot(dl, stride))
    ent = np.zeros((_MAX_ENTRIES, 4), np.int32)
    ent[: len(st.entries)] = st.entries
    head = [d, st.n, st.ept, int(st.order == "type"), K, len(st.entries)]
    tab = np.concatenate(
        [np.asarray(head, np.int32), corner.ravel(), delta.ravel(), ent.ravel(), off]
    )
    tab.flags.writeable = False
    # the frozen dataclass keeps its fields; the table rides in its __dict__
    object.__setattr__(st, "_kernel_table", tab)
    object.__setattr__(st, "_kernel_table_ptr", tab.ctypes.data)
    return tab


def _table_ptr(st: LatticeStencil) -> int:
    """Host address of ``kernel_table(st)`` (packed on first use)."""
    ptr = st.__dict__.get("_kernel_table_ptr")
    if ptr is None:
        kernel_table(st)
        ptr = st.__dict__["_kernel_table_ptr"]
    return ptr


def _nodes(st: LatticeStencil) -> int:
    return (st.n + 1) ** st.dim


def _check(name, t, dtype, device, shape):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.device != device:
        raise ValueError(f"{name}: device {t.device}, expected {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _route(name, t):
    """True for the kernel (CUDA tensor), False for the plain form (CPU)."""
    if t.dtype not in _DTYPES:
        raise TypeError(f"{name}: unsupported dtype {t.dtype}")
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    return True


def _launch(entry, st, *args):
    ptr = _table_ptr(st)
    LAUNCHES["lattice_stencil"] += 1
    launch(entry, *args, ptr)


def _check_window(st: LatticeStencil, x0, planes):
    """(plane count, element rows) of a valid window; raises otherwise."""
    win = _window(st, planes)
    p = win[0]
    if not (0 <= x0 and p >= 1 and x0 + p <= st.n):
        raise ValueError(f"lattice window: planes [{x0}, {x0 + p}) of {st.n}")
    return p, st.ept * int(np.prod(win))


def lattice_weights(coeff, stack0, st: LatticeStencil, x0: int = 0, planes=None):
    """[K, (n+1)^dim] stencil weight fields from the apply coefficients
    [E, P] and the level-0 stack [P, d+1, d+1]: exactly the assembled base
    matrix, W_k[a] = A[a, a + delta_k]. With a plane window, ``coeff``
    holds the window's rows and the result is their partial."""
    p, E = _check_window(st, x0, planes)
    d1 = st.dim + 1
    kern = _route("lattice_weights: coeff", coeff)
    if coeff.dim() != 2 or coeff.shape[0] != E:
        raise ValueError(f"lattice_weights: coeff shape {tuple(coeff.shape)}, expected ({E}, P)")
    P = coeff.shape[1]
    _check("lattice_weights: coeff", coeff, coeff.dtype, coeff.device, (E, P))
    _check("lattice_weights: stack0", stack0, coeff.dtype, coeff.device, (P, d1, d1))
    if not kern:
        return lattice_weights_plain(coeff, stack0, st, x0, p)
    W = torch.empty((len(st.deltas), _nodes(st)), dtype=coeff.dtype, device=coeff.device)
    _launch("hz_lattice_weights", st, _DTYPES[coeff.dtype], coeff.data_ptr(),
            stack0.data_ptr(), W.data_ptr(), P, int(x0), p)
    return W


def lattice_apply(u, W, st: LatticeStencil, m=None, b=None):
    """y = A u via the K shifted multiply-adds, times the node mask ``m``
    (bool [N] or None); with ``b``, returns b - y (the residual in one
    pass). u, b, y: flat [(n+1)^dim]. The entry the coarse loop calls most:
    on CUDA tensors its host part is the route, the checks, one allocation
    and one ctypes call, with the stencil's table packed once."""
    N = _nodes(st)
    K = len(st.deltas)
    kern = _route("lattice_apply: u", u)
    dt, dev = u.dtype, u.device
    try:  # the checks in one expression; on a failure, the named check below raises
        ok = (u.shape == (N,) and u.is_contiguous() and W.dtype == dt and W.device == dev
              and W.shape == (K, N) and W.is_contiguous()
              and (b is None or (b.dtype == dt and b.device == dev and b.shape == (N,)
                                 and b.is_contiguous()))
              and (m is None or (m.dtype == torch.bool and m.device == dev and m.shape == (N,)
                                 and m.is_contiguous())))
    except AttributeError:
        ok = False
    if not ok:
        _check("lattice_apply: u", u, dt, dev, (N,))
        _check("lattice_apply: W", W, dt, dev, (K, N))
        if b is not None:
            _check("lattice_apply: b", b, dt, dev, (N,))
        if m is not None:
            _check("lattice_apply: m", m, torch.bool, dev, (N,))
    if not kern:
        return lattice_apply_plain(u, W, st, m=m, b=b)
    if K * N >= 2**31:  # the kernel indexes W in 32 bits
        raise ValueError(f"lattice_apply: K * N = {K * N} does not fit 32 bits")
    out = torch.empty_like(u)
    _launch("hz_lattice_apply", st, _DTYPES[dt], u.data_ptr(), W.data_ptr(),
            None if m is None else m.data_ptr(),
            None if b is None else b.data_ptr(), out.data_ptr())
    return out


def lattice_assemble(y_local, st: LatticeStencil, x0: int = 0, planes=None):
    """Sum duplicated-layout local contributions to global nodes:
    [E, d+1] -> [N]. Equals MultigridSolver._to_global on box bases. With a
    plane window, ``y_local`` holds the window's rows and the result is
    their partial."""
    p, E = _check_window(st, x0, planes)
    kern = _route("lattice_assemble: y", y_local)
    _check("lattice_assemble: y", y_local, y_local.dtype, y_local.device, (E, st.dim + 1))
    if not kern:
        return lattice_assemble_plain(y_local, st, x0, p)
    out = torch.empty(_nodes(st), dtype=y_local.dtype, device=y_local.device)
    _launch("hz_lattice_assemble", st, _DTYPES[y_local.dtype], y_local.data_ptr(),
            out.data_ptr(), int(x0), p)
    return out


def lattice_distribute(u, st: LatticeStencil, x0: int = 0, planes=None):
    """Global node vector -> duplicated [E, d+1] layout (every copy gets
    the nodal value), for the rows of the plane window (the whole box by
    default). Equals ops.interfaces.distribute on box bases."""
    p, E = _check_window(st, x0, planes)
    kern = _route("lattice_distribute: u", u)
    _check("lattice_distribute: u", u, u.dtype, u.device, (_nodes(st),))
    if not kern:
        return lattice_distribute_plain(u, st, x0, p)
    out = torch.empty((E, st.dim + 1), dtype=u.dtype, device=u.device)
    _launch("hz_lattice_distribute", st, _DTYPES[u.dtype], u.data_ptr(), out.data_ptr(),
            int(x0), p)
    return out
