"""Kernel K1's pipeline (csrc/element_apply.cuh), emulated in NumPy in the
kernel's own indexing, with the constants read from its source: the step
size its launcher plans (chunk groups of 64 bytes of elements, at least
APPLY_ITEMS warp items a step, as many as ROW_SMEM holds), a persistent
grid taking steps by a grid stride, each step's x run and coefficient run
landed from their first 16-byte boundary to their last with the head and
tail read from device memory (x at any 16-byte offset), the landed rows
widened, shifted (residual form) and written transposed, the warp items of
APPLY_ROWS rows (APPLY_LANES lanes a row, each its share of a column)
walking the slot words and slot vectors of the row table, and the
epilogue. On the CPU, in float32 and
float64 and for K16's narrower x, at every main-path width n = 4, 10, 35,
165, 969, with P = 1, 4, 7 and 8 pieces, E not a multiple of the step, and
several grids: every output is written exactly once, every x value is read
once from the landed run or the edge, and the result equals the plain form
(``element_apply_plain``, float64) to 1e-12. The launcher's plan fits the
card's shared memory and makes one launch per call."""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from homogenization_jl_tpu_torch.fem.local_operators import build_level_operators
from homogenization_jl_tpu_torch.mesh.reference import refined_reference
from homogenization_jl_tpu_torch.ops import apply as t_apply

CSRC = Path(t_apply.__file__).parents[1] / "csrc"


def _constants():
    """K1's APPLY_* constants and the row kernels' ROW_*, as the sources
    state them (products and quotients of integers and earlier names)."""
    text = (CSRC / "stencil_rows.cuh").read_text() + (CSRC / "element_apply.cuh").read_text()
    found = {}
    for name, expr in re.findall(r"constexpr int ((?:APPLY|ROW)_\w+) = ([\w* /:]+);", text):
        expr = expr.replace("hz::", "")
        for k, v in found.items():
            expr = re.sub(rf"\b{k}\b", str(v), expr)
        found[name] = int(eval(expr.replace("/", "//"), {}))
    return found


K = _constants()
ROWS, LANES, COL_BYTES, ITEMS, WARPS, SMEM = (K["APPLY_ROWS"], K["APPLY_LANES"],
                                              K["APPLY_COL_BYTES"], K["APPLY_ITEMS"],
                                              K["ROW_WARPS"], K["ROW_SMEM"])


def up16(v):
    return (v + 15) // 16 * 16


def smem_of(G, n, P, PP, t, tx, R, V, table=True, land=True):
    """ApplySmem: mbarrier, the table (where ``table``: the slot words with
    their two spare rows, the slot vectors), coefficients, shifts,
    transposed rows, the landing run of x (where ``land``) and that of the
    coefficients."""
    values = 16 + (4 * (-(-n // ROWS) * (R + 1) + 2) * ROWS if table else 0)
    xt = up16(values + (V * PP * t if table else 0)) + G * PP * t + G * t
    xland = up16(xt + G * n * t)
    cland = up16(xland + G * n * tx + 16) if land else xland
    return up16(cland + G * P * t + 16)


def plan_of(E, n, P, PP, t, tx, R, V):
    """launch_pp's plan: (G, table, land), the step size in elements,
    whether the table stays in shared memory and whether x lands in bulk;
    G None where one chunk group does not fit."""
    CG = COL_BYTES // t
    table = smem_of(CG, n, P, PP, t, tx, R, V, True, False) <= SMEM
    land = smem_of(CG, n, P, PP, t, tx, R, V, table, True) <= SMEM
    groups = -(-n // ROWS)
    ng = min(-(-ITEMS // groups), -(-E // CG))
    ng = max(ng, 1)
    while ng > 1 and smem_of(ng * CG, n, P, PP, t, tx, R, V, table, land) > SMEM:
        ng -= 1
    fits = smem_of(ng * CG, n, P, PP, t, tx, R, V, table, land) <= SMEM
    return (ng * CG if fits else None), table, land


def col_elem(c, e, CG):
    """col_elem: element e of column c, its 16-byte units swapped pairwise
    where bit 1 of c is set."""
    return c * CG + (e ^ (((c >> 1) & 1) * (CG // 2)))


def run_of(offset, len_, v):
    """run_of: (lead, lo, hi) of a run of len_ values of v bytes whose
    first value lies ``offset`` bytes past a 16-byte boundary."""
    Q = 16 // v
    lead = (offset % 16) // v
    lo = min(Q - lead if lead else 0, len_)
    hi = lo + (len_ - lo) // Q * Q
    return lead, lo, hi


def emulate(x, coeff, tab, b=None, rs=None, mask=None, grid=132, x_offset=0, itemsize=None):
    """K1 on numpy inputs in float64 arithmetic, in the kernel's indexing.
    Returns (out, writes, reads): each output's value, how many times it
    was stored, and how many times each x value was read in a transposition
    (from the landed run or the edge)."""
    E, n = x.shape
    P = coeff.shape[1]
    t = itemsize or coeff.dtype.itemsize
    tx = x.dtype.itemsize
    PP = tab.vals.shape[2]
    CG = COL_BYTES // t
    GC = CG // LANES
    EU = 16 // t  # elements of a 16-byte unit
    R, V = tab.width, tab.n_values
    G, _, land = plan_of(E, n, P, PP, t, tx, R, V)
    assert G is not None
    words = tab.slot_words.numpy()[:-2].reshape(-1, R + 1, ROWS)  # [ng, R + 1, ROWS]
    # the slot vectors [V, PP] from their [PP / VW, V, VW] layout
    vecs = tab.slot_values.numpy().astype(np.float64).transpose(1, 0, 2).reshape(V, PP)
    counts = tab.counts.numpy()
    xf = x.reshape(-1).astype(np.float64)
    cf = coeff.reshape(-1).astype(np.float64)
    out = np.zeros((E, n))
    writes = np.zeros((E, n), dtype=np.int64)
    reads = np.zeros(E * n, dtype=np.int64)
    steps = -(-E // G)
    grid = min(grid, steps)
    ng = G // CG
    items = ng * -(-n // ROWS)
    for blk in range(grid):
        for s in range(blk, steps, grid):
            e0 = s * G
            Gb = min(G, E - e0)
            # the runs: the landed span and the edges cover each value once
            lead, lo, hi = run_of(x_offset + e0 * n * tx, Gb * n, tx) if land else (0, Gb * n,
                                                                                    Gb * n)
            if land:
                assert (lead + lo) * tx % 16 == 0 and (hi - lo) * tx % 16 == 0
                assert (lead + Gb * n) * tx <= G * n * tx + 16  # the landing buffer
            clead, clo, chi = run_of(e0 * P * t, Gb * P, t)
            assert (clead + Gb * P) * t <= G * P * t + 16
            Cs = np.zeros((G, PP))
            Cs[:Gb, :P] = cf[e0 * P:(e0 + Gb) * P].reshape(Gb, P)
            # transposition: element e of chunk group q, column c at
            # q * n * CG + col_elem(c, e)
            i = np.arange(G * n)
            q, c = divmod(i // CG, n)
            e = i % CG
            g = q * CG + e
            live = g < Gb
            j = g[live] * n + c[live]
            np.add.at(reads, e0 * n + j, 1)
            phys = q * n * CG + col_elem(c, e, CG)
            assert np.array_equal(np.sort(phys), i)  # a permutation of the buffer
            xt = np.zeros(G * n)
            Ss = np.zeros(G)
            if b is not None:
                Ss[:Gb] = xf[(e0 + np.arange(Gb)) * n]
            xt[phys[live]] = xf[e0 * n + j] - (Ss[g[live]] if b is not None else 0)
            # every warp item's 32 lanes at once
            W = np.repeat(np.arange(items), 32)
            lane = np.tile(np.arange(32), items)
            qq, oc = W % ng, W // ng
            r, ch = lane // LANES, lane % LANES
            m = oc * ROWS + r
            ok = m < n
            qq, oc, r, ch, m = qq[ok], oc[ok], r[ok], ch[ok], m[ok]
            cnt = words[oc, R, r]  # the group's counts after its R slots
            assert (cnt == counts[m]).all()
            acc = np.zeros((len(m), GC, PP))
            # the lane's elements: units ch and 2 + ch of its chunk group
            lane_e = EU * (2 * (np.arange(GC) // EU)[None, :] + ch[:, None]) + np.arange(GC) % EU
            for k in range(R):
                a = k < cnt
                word = words[oc[a], k, r[a]]
                col, w = word & 0xFFFF, vecs[word >> 16]
                xv = xt[(qq[a] * n * CG)[:, None] + col_elem(col[:, None], lane_e[a], CG)]
                acc[a] += xv[:, :, None] * w[:, None, :]
            for jj in range(GC):
                gg = qq * CG + lane_e[:, jj]
                st = gg < Gb
                y = (Cs[gg[st]] * acc[st, jj]).sum(axis=1)
                rows, cols_ = e0 + gg[st], m[st]
                if b is not None:
                    tsum = (Cs[gg[st]] * np.pad(rs, ((0, PP - P), (0, 0)))[:, cols_].T).sum(axis=1)
                    y = b[rows, cols_] - (y + Ss[gg[st]] * tsum)
                if mask is not None:
                    y = y * mask[rows, cols_]
                out[rows, cols_] = y
                np.add.at(writes, (rows, cols_), 1)
    return out, writes, reads


@pytest.fixture(scope="module")
def stacks():
    """The 3D reference stacks of every level (n = 4, 10, 35, 165, 969)."""
    return [op.stack for op in build_level_operators(refined_reference(3, 5))]


def _stack(stacks, k, P):
    s = stacks[k]
    return {7: s, 1: s[-1:], 4: s[:4], 8: np.concatenate([s, s[-1:]])}[P]


CASES = [(k, P, dt) for k in range(5) for P in (7, 1) for dt in ("float32", "float64")]
CASES += [(4, 4, "float32"), (4, 8, "float64"), (2, 4, "float64"), (2, 8, "float32")]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "level%d-P%d-%s" % c)
def test_walk_matches_plain(case, stacks):
    k, P, dt = case
    stack = _stack(stacks, k, P)
    n = stack.shape[1]
    rng = np.random.default_rng(10 * k + P)
    t = np.dtype(dt).itemsize
    tab = t_apply.stack_table(torch.as_tensor(stack).to(getattr(torch, dt)))
    G = plan_of(10**6, n, P, tab.vals.shape[2], t, t, tab.width, tab.n_values)[0]
    E = 2 * G + 7 if n > 100 else G + 37
    x = rng.standard_normal((E, n)).astype(dt)  # stored in the state type
    coeff = rng.uniform(0.5, 2.0, (E, P))
    b = rng.standard_normal((E, n))
    mask = rng.random((E, n)) < 0.7
    # the plain form on the stack in the table's dtype, in float64
    X, C, S = (torch.as_tensor(a.astype(np.float64)) for a in (x, coeff, stack.astype(dt)))
    rs = t_apply.stack_rowsum(S).numpy()
    for res, grid, off in ((False, 132, 0), (True, 2, t * (k % (16 // t))), (True, 1, 16 - t)):
        bb = b if res else None
        got, writes, reads = emulate(x, coeff, tab, b=bb, rs=rs, mask=mask if res else None,
                                     grid=grid, x_offset=off, itemsize=t)
        assert (writes == 1).all() and (reads == 1).all(), (res, grid, off)
        ref = t_apply.element_apply_plain(X, C, S, b=None if bb is None else torch.as_tensor(b))
        ref = ref.numpy() * (mask if res else 1)
        assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max(), (res, grid, off)


@pytest.mark.parametrize("E", [1, 131, 1000])
def test_walk_small_and_ragged(E, stacks):
    """Fewer steps than SMs, one element, a last step of a few elements."""
    stack = stacks[4]
    n = stack.shape[1]
    rng = np.random.default_rng(E)
    x = rng.standard_normal((E, n)).astype(np.float32)
    coeff = rng.uniform(0.5, 2.0, (E, 7))
    tab = t_apply.stack_table(torch.as_tensor(stack).float())
    got, writes, reads = emulate(x, coeff, tab, grid=132, x_offset=12, itemsize=4)
    assert (writes == 1).all() and (reads == 1).all()
    ref = t_apply.element_apply_plain(torch.as_tensor(x.astype(np.float64)), torch.as_tensor(coeff),
                                      torch.as_tensor(stack.astype(np.float32).astype(np.float64))).numpy()
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()


@pytest.mark.parametrize("tx", [2, 4])
def test_walk_narrow_x_landing(tx, stacks):
    """K16: x stored in 2 bytes (bfloat16, float16) under float32 or in 4
    (float32) under float64 lands in its own width, at any 2- or 4-byte
    offset, and is read once; the walk is the state type's."""
    stack = stacks[3]
    n = stack.shape[1]
    t = 8 if tx == 4 else 4
    st = np.float64 if t == 8 else np.float32
    tab = t_apply.stack_table(torch.as_tensor(stack.astype(st)))
    E = 3 * plan_of(10**6, n, 7, 8, t, tx, tab.width, tab.n_values)[0] + 5
    rng = np.random.default_rng(tx)
    x = rng.standard_normal((E, n)).astype(np.float32)  # exact in either state type
    coeff = rng.uniform(0.5, 2.0, (E, 7))
    for off in range(0, 16, tx):
        xs = x.astype(np.float16) if tx == 2 else x
        got, writes, reads = emulate(xs, coeff, tab, grid=5, x_offset=off, itemsize=t)
        assert (writes == 1).all() and (reads == 1).all(), off
        ref = t_apply.element_apply_plain(torch.as_tensor(xs.astype(np.float64)),
                                          torch.as_tensor(coeff),
                                          torch.as_tensor(stack.astype(st).astype(np.float64))).numpy()
        assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max(), off


def test_plan_fits_every_main_path_shape(stacks):
    """The step plan of every level, piece count and type fits ROW_SMEM with
    the table beside it; at n = 969 a float32 step is one chunk group of 16
    elements in 214,608 bytes, a float64 step 8 elements; narrower rows take
    at least APPLY_ITEMS warp items a step where the memory allows."""
    for k, stack in enumerate(stacks):
        n = stack.shape[1]
        for P in (1, 4, 7, 8):
            for dt, tx in ((np.float32, 4), (np.float64, 8), (np.float32, 2), (np.float64, 4),
                           (np.float64, 2)):
                tab = t_apply.stack_table(torch.as_tensor(_stack(stacks, k, P).astype(dt)))
                t, PP, R, V = np.dtype(dt).itemsize, tab.vals.shape[2], tab.width, tab.n_values
                G, table, land = plan_of(196_608, n, P, PP, t, tx, R, V)
                assert table and smem_of(G, n, P, PP, t, tx, R, V, table, land) <= SMEM
                # only float64's 853 slot vectors of 8 pieces at n = 969 leave
                # no room for the landing
                assert land or (n, t, PP) == (969, 8, 8), (n, P, dt, tx)
                CG = COL_BYTES // t
                assert G % CG == 0
                if smem_of(2 * G, n, P, PP, t, tx, R, V, table, land) <= SMEM:
                    assert (G // CG) * math.ceil(n / ROWS) >= ITEMS
    tab = t_apply.stack_table(torch.as_tensor(stacks[4].astype(np.float32)))
    assert (tab.width, tab.n_values) == (19, 353)
    assert smem_of(16, 969, 7, 8, 4, 4, 19, 353) == 214_608
    assert plan_of(196_608, 969, 7, 8, 4, 4, 19, 353) == (16, True, True)
    assert plan_of(1, 10, 7, 8, 4, 4, 8, 16) == (16, True, True)  # no wider than the elements need
    # a dense stack's table (every slot a vector of its own) stays in device memory
    assert plan_of(2000, 165, 7, 8, 4, 4, 165, 165 * 165) == (16 * 6, False, True)
    mass = t_apply.stack_table(torch.as_tensor(stacks[4][-1:]))
    assert plan_of(48_000, 969, 1, 1, 8, 8, mass.width, mass.n_values) == (8, True, True)


def test_slot_layout_lists_the_row_table():
    """slot_words / slot_values hold row m's real slots at group m //
    ITEM_ROWS, row m % ITEM_ROWS: the column and the index of the slot's
    vector, whose values are the slot's, bit for bit, and after the R slots
    the row's count; pads and rows past n are zero words; the vectors are
    distinct and fill whole 16-byte units."""
    IR = t_apply.ITEM_ROWS
    assert IR == ROWS
    for dt, P in ((torch.float32, 7), (torch.float64, 7), (torch.float32, 1), (torch.float64, 4)):
        stack = build_level_operators(refined_reference(3, 4))[3].stack
        stack = {7: stack, 1: stack[-1:], 4: stack[:4]}[P]
        tab = t_apply.stack_table(torch.as_tensor(stack).to(dt))
        n, R = tab.cols.shape
        PP = tab.vals.shape[2]
        VW, V = t_apply.slot_width(PP, tab.vals.element_size()), tab.n_values
        words, values = tab.slot_words.numpy(), tab.slot_values.numpy()
        ng = -(-n // IR)
        assert words.shape == (ng * (R + 1) + 2, IR) and values.shape == (PP // VW, V, VW)
        assert not words[-2:].any()  # the spare rows read ahead
        words = words[:-2].reshape(ng, R + 1, IR)
        assert V * PP * tab.vals.element_size() % 16 == 0
        vecs = values.transpose(1, 0, 2).reshape(V, PP)
        m = np.arange(n)
        w = words[m // IR, :, m % IR]  # [n, R + 1]
        assert (w[:, R] == tab.counts.numpy()).all()
        w = w[:, :R]
        real = np.arange(R)[None, :] < tab.counts.numpy()[:, None]
        assert (w[real] & 0xFFFF == tab.cols.numpy()[real]).all()
        got = vecs[w >> 16]  # [n, R, PP]
        assert got[real].tobytes() == tab.vals.numpy()[real].tobytes()
        assert not w[~real].any()
        assert len({v.tobytes() for v in vecs}) >= V - 1  # distinct but the zero pads
        pad = np.arange(words.shape[0] * IR) >= n
        assert not words.transpose(0, 2, 1).reshape(-1, R + 1)[pad].any()


def test_slot_layout_past_its_words():
    """A stack whose distinct slot vectors the 16-bit words cannot index (a
    dense random one) still gets its row table, which K9 walks; K1's layout
    is None and a K1 call on it raises before any launch."""
    rng = np.random.default_rng(7)
    S = torch.as_tensor(rng.standard_normal((1, 200, 200)))
    tab = t_apply.stack_table(S)
    assert tab.slot_words is None and tab.slot_values is None
    assert torch.equal(tab.cols[:, 0], torch.zeros(200, dtype=torch.int32))
    with pytest.raises(ValueError, match="16-bit"):
        tab.n_values
