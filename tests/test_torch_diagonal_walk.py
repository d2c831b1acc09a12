"""Kernel K18's diagonal walk (csrc/elementwise.cu), emulated in NumPy in
the kernel's own order, with the constants read from the kernel's source:
the launches that its C entry plans (``diag_width``: windows of
diag_ref's columns that the shared memory holds), in each a block staging
the window, its threads cut into row groups of ``lanes`` threads
(``diag_lanes``: whole warps, or W below a warp) side by side, a block's step taking that many consecutive groups of
DIAG_ROWS rows by a grid stride, the row tail guarded, the lanes striding
the window's columns, every product and sum rounded on its own from +0;
the one-piece form writing the step's rows into a tile shifted to out's
128-byte lines and storing it in 16-byte vectors of whole lines (the
ragged ends entry by entry), or row by row for a window. In float32 and
float64 on the CPU, at small E (a row tail included) and the main path's
widths n = 4, 10, 35, 165, 969, with P = 1 and 7 pieces, for several grids
and output addresses, it writes every output entry exactly once, equals
the plain form bit for bit and, in float64, the JAX package's einsum to
1e-12 (XLA's einsum may sum the pieces in another order). A shared-memory
bound lowered to force windows gives the same bits. The wrapper hands the
C entry the whole shape in one counted launch."""

import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from homogenization_jl_tpu_torch.csrc.build import LAUNCHES
from homogenization_jl_tpu_torch.ops import elementwise as t_ew

WIDTHS = [4, 10, 35, 165, 969]
DTYPES = [np.float32, np.float64]
SOURCE = Path(t_ew.__file__).parents[1] / "csrc" / "elementwise.cu"


def _constants():
    """The kernel's DIAG_* constants, as its source states them."""
    found = re.findall(r"constexpr \w+ (DIAG_\w+) = ([0-9* ]+);", SOURCE.read_text())
    return {name: math.prod(int(f) for f in expr.split("*")) for name, expr in found}


K = _constants()
THREADS, ROWS, PIECES, LINE, SMEM = (K["DIAG_THREADS"], K["DIAG_ROWS"], K["DIAG_PIECES"],
                                     K["DIAG_LINE"], K["DIAG_SMEM_MAX"])


def lanes_of(W):
    """diag_lanes: the block's threads, whole warps (a power of two) or W."""
    if W >= THREADS:
        return THREADS
    if W < 32:
        return W
    return 32 << ((W // 32).bit_length() - 1)


def smem_of(P, W, isz):
    """diag_smem: the staged window rounded to 16 bytes, and the one-piece
    tile of the block's rows with a line to spare."""
    V = 16 // isz
    entries = -(-P * W // V) * V
    if P == 1:
        entries += ROWS * (THREADS // lanes_of(W)) * W + LINE // isz
    return entries * isz


def plan(P, n, isz, smem=SMEM):
    """hz_ew_diagonal's launches: [(m0, W, lanes)], each window as wide as
    ``smem`` bytes allow (diag_width)."""
    width = max(1, min(n, smem // (isz * (P + (ROWS if P == 1 else 0)))))
    while width > 1 and smem_of(P, width, isz) > smem:
        width -= 1
    return tuple((m0, min(width, n - m0), lanes_of(min(width, n - m0)))
                 for m0 in range(0, n, width))


def walk(c, dref, launches, grid, base=0):
    """The diagonal kernel over ``launches`` with ``grid`` blocks each, in
    NumPy, out's address ``base`` bytes past a line. Returns the output and
    how often each entry was stored."""
    E, P = c.shape
    n = dref.shape[1]
    isz = c.itemsize
    R, V, line = ROWS, 16 // isz, LINE
    out = np.full(E * n, np.nan, c.dtype)
    hits = np.zeros(E * n, np.int64)
    for m0, W, lanes in launches:
        ds = dref[:, m0:m0 + W].reshape(-1)  # the staged window [P, W]
        subs = THREADS // lanes
        groups = -(-E // R)
        tiled = P == 1
        for block in range(grid):
            for g0 in range(block * subs, groups, grid * subs):
                ob = g0 * R * n + m0  # the step's first entry
                shift = (base + ob * isz) % line // isz if tiled and W == n else 0
                tile = np.full(shift + subs * R * W, np.nan, c.dtype)
                for sub in range(subs):
                    e0 = (g0 + sub) * R
                    if e0 >= E:
                        continue
                    rows = min(R, E - e0)
                    cr = c[e0:e0 + rows]
                    for lane in range(lanes):
                        j = np.arange(lane, W, lanes)
                        idx = (e0 + np.arange(rows))[:, None] * n + m0 + j[None, :]
                        acc = np.zeros((rows, len(j)), c.dtype)
                        for p in range(P):
                            acc = acc + cr[:, p:p + 1] * ds[p * W + j][None, :]
                        if tiled:
                            t = shift + sub * R * W + np.arange(rows)[:, None] * W + j[None, :]
                            tile[t] = acc
                        else:
                            out[idx] = acc
                            hits[idx] += 1
                if not tiled:
                    continue
                total = min(subs * R, E - g0 * R) * W
                if W == n:  # 16-byte vectors of whole lines, the ends entry by entry
                    for q in range(-(-(total + shift) // V)):
                        lo = q * V - shift
                        k = np.arange(V)
                        if lo >= 0 and lo + V <= total:
                            assert (base + (ob + lo) * isz) % 16 == 0
                        ok = (lo + k >= 0) & (lo + k < total)
                        out[ob + lo + k[ok]] = tile[q * V + k[ok]]
                        hits[ob + lo + k[ok]] += 1
                    assert (base + (ob - shift) * isz) % line == 0
                else:
                    t = np.arange(total)
                    r = t // W
                    out[ob + r * n + t - r * W] = tile[t]
                    hits[ob + r * n + t - r * W] += 1
    return out.reshape(E, n), hits.reshape(E, n)


def _inputs(E, P, n, dtype, seed):
    rng = np.random.default_rng(seed)
    c = (rng.random((E, P)) + 0.5).astype(dtype)
    dref = rng.standard_normal((P, n)).astype(dtype)
    return c, dref


def _check(c, dref, launches, grid, base=0):
    out, hits = walk(c, dref, launches, grid, base)
    assert (hits == 1).all()
    plain = t_ew.diagonal_plain(torch.as_tensor(c), torch.as_tensor(dref)).numpy()
    assert np.array_equal(out.view(np.uint8), plain.view(np.uint8))
    return out


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("P", [1, 7])
@pytest.mark.parametrize("n", WIDTHS)
def test_walk_writes_each_entry_once_and_equals_plain(n, P, dtype):
    isz = np.dtype(dtype).itemsize
    E = 4 * 9 + 3  # a row tail
    c, dref = _inputs(E, P, n, dtype, seed=n + P)
    launches = plan(P, n, isz)
    assert len(launches) == 1  # one launch on every path of the port
    for grid, base in ((1, 0), (3, 0), (2, 3 * isz)):
        out = _check(c, dref, launches, grid, base)
    if dtype is np.float64:
        ref = np.asarray(jnp.einsum("ep,pn->en", jnp.asarray(c), jnp.asarray(dref)))
        assert np.abs(out - ref).max() <= 1e-12 * np.abs(ref).max()


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("P", [1, 7])
def test_windows_of_a_lowered_shared_memory_bound(dtype, P):
    E, n = 11, 969
    isz = np.dtype(dtype).itemsize
    smem = smem_of(P, 300, isz)  # 300 columns a window
    launches = plan(P, n, isz, smem)
    assert launches == ((0, 300, 256), (300, 300, 256), (600, 300, 256), (900, 69, 64))
    c, dref = _inputs(E, P, n, dtype, seed=3)
    _check(c, dref, launches, grid=2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_wrapper_hands_the_kernel_the_whole_shape(monkeypatch, dtype):
    """One counted launch with (dtype, E, P, n) and a fresh [E, n] output:
    the C entry plans the windows (CPU tensors routed to the kernel path,
    the route's checks still run)."""
    calls = []
    route = t_ew.route
    monkeypatch.setattr(t_ew, "launch", lambda name, *args: calls.append((name, args)))
    monkeypatch.setattr(t_ew, "route", lambda *a, **k: route(*a, **k) or True)
    c = torch.rand((13, 7), dtype=dtype) + 0.5
    dref = torch.randn((7, 35), dtype=dtype)
    n0 = LAUNCHES["elementwise"]
    out = t_ew.diagonal(c, dref)
    assert LAUNCHES["elementwise"] == n0 + 1
    assert out.shape == (13, 35) and out.dtype == dtype
    [(name, args)] = calls
    assert name == "hz_ew_diagonal"
    assert args == (t_ew._DTYPES[dtype], c.data_ptr(), dref.data_ptr(), out.data_ptr(), 13, 7, 35)
    with pytest.raises(ValueError, match="diag_ref"):
        t_ew.diagonal(c, dref[:, ::2])
    assert len(calls) == 1


def test_launch_plan_fits_the_kernel():
    """Every launch the C entry plans fits the kernel: a window inside the
    row that shared memory holds, lanes that divide the block's threads or
    are W below a warp; the windows cover the row once, and a row of the
    port's widths is one launch."""
    assert PIECES == 8 and THREADS % 32 == 0
    for P in range(1, PIECES + 1):
        for n in WIDTHS + [5000, 6000, 40000]:
            for isz in (4, 8):
                covered = np.zeros(n, np.int64)
                launches = plan(P, n, isz)
                for m0, W, lanes in launches:
                    assert 0 <= m0 < m0 + W <= n
                    assert smem_of(P, W, isz) <= SMEM
                    assert THREADS % lanes == 0 or lanes == W < 32
                    covered[m0:m0 + W] += 1
                assert (covered == 1).all()
                assert len(launches) == 1 or n > 969
