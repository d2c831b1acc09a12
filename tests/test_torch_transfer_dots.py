"""The plain forms of kernels K4 (grid transfers), K5 (dots) and K10 (CG
updates) against the JAX package's expressions, in float64 on the CPU, and
NumPy emulations of the kernels' table walk and summation order (the CUDA
kernels cannot run here; tests/test_torch_kernels.py holds them against
the plain forms on a card).

  * K4: ``restrict_plain`` / ``prolong_add_plain`` against
    ``homogenization_jl_tpu.ops.transfer`` at every level of the 2D and 3D
    test configurations, to 1e-14 relative; a walk of the kernel's int32
    tables (each fine row's <= 2 entries, P^T in CSR form) against the
    dense products: prolong_add bit for bit (P's weights 1 and 1/2 make
    every product exact), restrict to 1e-14;
  * K5: ``dot_plain`` against ``jnp.vdot`` with and without the mask and
    the scale, to 1e-14 of the sum of absolute terms, and bit for bit
    against a thread-by-thread emulation of the kernels' fixed order
    (csrc/fixed_sum.cuh) in float64 and float32, at the lengths where the
    order has edges: one entry, one short of a vector, fewer entries than
    blocks, one short of and one past whole chunks;
  * K10: ``cg_step_plain`` / ``cg_direction_plain`` against the JAX update
    expressions, bit for bit, including den == 0 (the _safe_div guard);
  * the wrappers' contract: CPU tensors take the plain forms and count no
    launch; malformed inputs raise."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from homogenization_jl_tpu.mesh.reference import (
    prolongation_dense as j_prolongation_dense,
    refined_reference as j_refined_reference,
)
from homogenization_jl_tpu.ops import transfer as j_transfer
from homogenization_jl_tpu.solver.multigrid import MultigridSolver as JaxSolver
from homogenization_jl_tpu_torch.csrc.build import LAUNCHES
from homogenization_jl_tpu_torch.mesh.reference import (
    prolongation_dense as t_prolongation_dense,
    refined_reference as t_refined_reference,
)
from homogenization_jl_tpu_torch.ops import cg as t_cg
from homogenization_jl_tpu_torch.ops import dots as t_dots
from homogenization_jl_tpu_torch.ops import transfer as t_transfer

E = 37  # elements of the random test states


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-300)


def _levels(dim, nlevels):
    """(P from the JAX package, P from the port) for every level above 0."""
    rj = j_refined_reference(dim, nlevels)
    rt = t_refined_reference(dim, nlevels)
    return [(j_prolongation_dense(rj, k), t_prolongation_dense(rt, k)) for k in range(nlevels - 1)]


LEVELS = [(2, 3), (3, 3), (3, 5)]


@pytest.mark.parametrize("dim,nlevels", LEVELS, ids=["2d-L3", "3d-L3", "3d-L5"])
def test_transfer_plain_forms_match_jax(dim, nlevels):
    rng = np.random.default_rng(dim * 10 + nlevels)
    for Pj, Pt in _levels(dim, nlevels):
        assert np.array_equal(Pj, Pt)
        n_f, n_c = Pt.shape
        r = rng.standard_normal((E, n_f))
        xf = rng.standard_normal((E, n_f))
        xc = rng.standard_normal((E, n_c))
        P = torch.as_tensor(Pt)
        ref = np.asarray(j_transfer.restrict(jnp.asarray(r), jnp.asarray(Pj)))
        assert _rel(ref, t_transfer.restrict_plain(torch.as_tensor(r), P)) <= 1e-14
        ref = np.asarray(j_transfer.prolong_add(jnp.asarray(xf), jnp.asarray(xc), jnp.asarray(Pj)))
        got = t_transfer.prolong_add_plain(torch.as_tensor(xf), torch.as_tensor(xc), P)
        assert _rel(ref, got) <= 1e-14
        # the FMG's prolongation of a coarse iterate: prolong_add(zeros, x, P)
        ref = np.asarray(j_transfer.prolong_add(jnp.zeros((E, n_f)), jnp.asarray(xc), jnp.asarray(Pj)))
        assert _rel(ref, t_transfer.prolong_add_plain(None, torch.as_tensor(xc), P)) <= 1e-14


def _emulate_k4(T, x_fine, x_coarse, r):
    """NumPy walk of csrc/transfer.cu's tables: prolong_add (each fine row
    sums its <= 2 (column, weight) entries from the first) and restrict
    (each coarse column sums its CSR rows in ascending order from the
    first), as the kernel's threads do."""
    cols, wts = T.cols.numpy(), T.wts.numpy()
    colptr, rows, rwts = T.colptr.numpy(), T.rows.numpy(), T.rwts.numpy()
    n_f, n_c = T.P.shape
    y = np.zeros((x_coarse.shape[0], n_f))
    for f in range(n_f):
        s = np.zeros(x_coarse.shape[0])
        if cols[f, 0] >= 0:
            s = wts[f, 0] * x_coarse[:, cols[f, 0]]
        if cols[f, 1] >= 0:
            s = s + wts[f, 1] * x_coarse[:, cols[f, 1]]
        y[:, f] = x_fine[:, f] + s
    z = np.zeros((r.shape[0], n_c))
    for c in range(n_c):
        j0, j1 = colptr[c], colptr[c + 1]
        s = np.zeros(r.shape[0])
        if j0 < j1:
            s = rwts[j0] * r[:, rows[j0]]
        for j in range(j0 + 1, j1):
            s = s + rwts[j] * r[:, rows[j]]
        z[:, c] = s
    return y, z


@pytest.mark.parametrize("dim,nlevels", LEVELS, ids=["2d-L3", "3d-L3", "3d-L5"])
def test_k4_table_walk_matches_dense_products(dim, nlevels):
    rng = np.random.default_rng(3)
    for _, Pt in _levels(dim, nlevels):
        P = torch.as_tensor(Pt)
        T = t_transfer.build_transfer_tables(P)
        n_f, n_c = Pt.shape
        assert T.cols.dtype == T.colptr.dtype == T.rows.dtype == torch.int32
        assert T.cols.shape == (n_f, 2) and T.colptr.shape == (n_c + 1,)
        assert int(T.colptr[-1]) == int((Pt != 0).sum()) == T.rows.numel()
        xf, xc, r = (rng.standard_normal((E, m)) for m in (n_f, n_c, n_f))
        y, z = _emulate_k4(T, xf, xc, r)
        assert np.array_equal(y, xf + xc @ Pt.T)  # exact products: the same bits
        assert _rel(r @ Pt, z) <= 1e-14
        # the wrappers on CPU tensors: the plain forms, no launch counted
        before = dict(LAUNCHES)
        out = torch.as_tensor(xf.copy())
        got = t_transfer.prolong_add(out, torch.as_tensor(xc), T, out=out)
        assert got is out and np.array_equal(out.numpy(), xf + xc @ Pt.T)
        assert torch.equal(t_transfer.restrict(torch.as_tensor(r), T), t_transfer.restrict_plain(torch.as_tensor(r), P))
        assert LAUNCHES == before


def test_transfer_tables_take_at_most_two_entries_per_fine_row():
    P = torch.zeros((4, 3), dtype=torch.float64)
    P[0, 0] = P[1, 1] = P[2, 2] = 1.0
    P[3] = torch.tensor([1 / 3, 1 / 3, 1 / 3])
    with pytest.raises(ValueError, match="at most 2"):
        t_transfer.build_transfer_tables(P)
    P[3] = torch.tensor([0.5, 0.0, 0.5])
    T = t_transfer.build_transfer_tables(P)
    assert T.cols.tolist() == [[0, -1], [1, -1], [2, -1], [0, 2]]
    assert T.colptr.tolist() == [0, 2, 3, 5] and T.rows.tolist() == [0, 3, 1, 2, 3]


def test_transfer_wrappers_reject_malformed_inputs():
    Pt = _levels(2, 3)[1][1]
    T = t_transfer.build_transfer_tables(torch.as_tensor(Pt))
    n_f, n_c = Pt.shape
    r = torch.zeros((E, n_f), dtype=torch.float64)
    xc = torch.zeros((E, n_c), dtype=torch.float64)
    with pytest.raises(ValueError):
        t_transfer.restrict(r[:, :-1], T)
    with pytest.raises(TypeError):
        t_transfer.restrict(r.float(), T)
    with pytest.raises(ValueError):
        t_transfer.prolong_add(r, xc[:-1], T)
    with pytest.raises(ValueError):
        t_transfer.prolong_add(r.t().contiguous().t(), xc, T)
    with pytest.raises(ValueError):
        t_transfer.prolong_add(r, xc, T, out=xc)


# --------------------------------------------------------------------- #
# K5
# --------------------------------------------------------------------- #
def _emulate_k5(terms):
    """Thread-by-thread emulation of csrc/fixed_sum.cuh's order on the
    products (float32 or float64, summed in their own dtype): V = 16 /
    itemsize entries per vector, 256 vectors per tile; block b of
    SUM_BLOCKS takes the tiles b, b + SUM_BLOCKS, ...; its thread t adds the
    entries of vector t of each of those tiles, in index order, to a running
    sum from 0, then the block's pairwise tree; last, thread t adds the
    block sums t, t + 256, ... from 0, and the same tree."""
    nb, nt = t_dots.SUM_BLOCKS, t_dots.SUM_THREADS
    dt = terms.dtype.type
    V = 16 // terms.itemsize
    N = terms.size
    tile = nt * V

    def tree(sh):
        sh = sh.copy()
        s = nt // 2
        while s > 0:
            sh[:s] = sh[:s] + sh[s : 2 * s]
            s //= 2
        return sh[0]

    sums = np.zeros(nb, terms.dtype)
    for b in range(nb):
        if b * tile >= N:
            break  # this block and the next have no entry: their sums are 0
        sh = np.zeros(nt, terms.dtype)
        for t in range(nt):
            acc = dt(0)
            for j in range(b, -(-N // tile), nb):  # the block's tiles
                for i in range(j * tile + t * V, min(j * tile + t * V + V, N)):
                    acc = dt(acc + terms[i])
            sh[t] = acc
        sums[b] = tree(sh)
    sh = np.zeros(nt, terms.dtype)
    for t in range(nt):
        acc = dt(0)
        for j in range(t, nb, nt):
            acc = dt(acc + sums[j])
        sh[t] = acc
    return tree(sh)


@pytest.mark.parametrize("N", [1, 263, 5000, 70001])
def test_dot_plain_matches_jax_vdot(N):
    rng = np.random.default_rng(N)
    a, b = rng.standard_normal(N), rng.standard_normal(N)
    w = rng.random(N) < 0.6
    d = rng.uniform(0.5, 2.0, N)
    A, B, W, D = (torch.as_tensor(v) for v in (a, b, w, d))
    before = dict(LAUNCHES)
    for mask, scale in ((None, None), (W, None), (None, D), (W, D)):
        jw = 1.0 if mask is None else jnp.asarray(w)
        jd = 1.0 if scale is None else jnp.asarray(d)
        ref = float(jnp.vdot(jnp.asarray(a) * jw, jd * jnp.asarray(b)))
        got = t_dots.dot(A, B, mask=mask, scale=scale)
        assert got.dim() == 0 and got.dtype == torch.float64
        mag = float(np.sum(np.abs(a * b * (1.0 if mask is None else w) * (1.0 if scale is None else d))))
        assert abs(float(got) - ref) <= 1e-14 * mag
    assert LAUNCHES == before


# one short of a vector (float32), fewer entries than one tile (256
# vectors), a tile and one entry, one short of and one past a sweep of
# every block's tile (float64: 1056 * 512 entries), and past it into a
# second tile of block 0
EDGES = [3, 1000, 1025, 1056 * 512 - 1, 1056 * 512 + 1]


def _order_case(N, dtype):
    """Terms of mixed magnitude (the order is observable) and the dot's
    bits from the plain form."""
    rng = np.random.default_rng(N + 1)
    a = (rng.standard_normal(N) * 10.0 ** rng.integers(-8, 9, N)).astype(dtype)
    b = rng.standard_normal(N).astype(dtype)
    w = rng.random(N) < 0.7
    terms = (a * w) * b
    got = t_dots.dot(torch.as_tensor(a), torch.as_tensor(b), mask=torch.as_tensor(w))
    return terms, got.numpy()


@pytest.mark.parametrize("N", [1, 300, 2000, 70001] + EDGES)
def test_dot_plain_follows_the_kernel_order(N):
    """The plain form gives the bits of the kernel's order (float64), and
    another order gives others."""
    terms, got = _order_case(N, np.float64)
    assert got.tobytes() == _emulate_k5(terms).tobytes()
    if N > 1000:
        assert float(np.sum(terms[::-1])) != float(got) or float(np.cumsum(terms)[-1]) != float(got)


@pytest.mark.parametrize("N", [1, 70001] + EDGES)
def test_dot_plain_follows_the_kernel_order_float32(N):
    """The same in float32: four entries to a vector, the sums in float32."""
    terms, got = _order_case(N, np.float32)
    assert got.dtype == np.float32
    assert got.tobytes() == _emulate_k5(terms).tobytes()


def test_fixed_order_sum_covers_every_entry_once():
    """The tiles cover the N entries once, whatever N (a one-hot vector
    sums to its one entry in any order), each starting on a whole 16-byte
    vector."""
    for N in (1, 3, 5, 1023, 1025, 270_335, 270_337, 1056 * 1024 + 7):
        for dtype in (torch.float32, torch.float64):
            V = 16 // torch.empty((), dtype=dtype).element_size()
            assert (t_dots.SUM_THREADS * V * torch.empty((), dtype=dtype).element_size()) % 16 == 0
            for i in (0, N // 2, N - 1):
                v = torch.zeros(N, dtype=dtype)
                v[i] = 1.5
                assert float(t_dots.fixed_order_sum(v)) == 1.5


def test_dot_rejects_malformed_inputs():
    a = torch.zeros(10, dtype=torch.float64)
    with pytest.raises(TypeError):
        t_dots.dot(a, a.float())
    with pytest.raises(ValueError):
        t_dots.dot(a, a[:-1])
    with pytest.raises(TypeError):
        t_dots.dot(a, a, mask=torch.ones(10))  # the mask must be bool
    with pytest.raises(ValueError):
        t_dots.dot(a, a, scale=torch.zeros(20, dtype=torch.float64)[::2])
    with pytest.raises(TypeError):
        t_dots.dot(a.to(torch.int64), a.to(torch.int64))


# --------------------------------------------------------------------- #
# K10
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("den_zero", [False, True], ids=["den", "den0"])
def test_cg_updates_match_jax_expressions(den_zero):
    rng = np.random.default_rng(12)
    shape = (E, 35)
    x, r, p, Ap, rc = (rng.standard_normal(shape) for _ in range(5))
    num = rng.standard_normal()
    den = 0.0 if den_zero else rng.standard_normal()
    sd = JaxSolver._safe_div
    jnum, jden = jnp.asarray(num), jnp.asarray(den)
    alpha = sd(jnum, jden)
    x_ref = np.asarray(jnp.asarray(x) + alpha * jnp.asarray(p))
    r_ref = np.asarray(jnp.asarray(r) - alpha * jnp.asarray(Ap))
    p_ref = np.asarray(jnp.asarray(rc) + sd(jnum, jden) * jnp.asarray(p))
    X, R, Pt, APt, RC = (torch.as_tensor(v.copy()) for v in (x, r, p, Ap, rc))
    tn, td = torch.tensor(num, dtype=torch.float64), torch.tensor(den, dtype=torch.float64)
    before = dict(LAUNCHES)
    t_cg.cg_step(X, R, Pt, APt, tn, td)
    assert np.array_equal(X.numpy(), x_ref) and np.array_equal(R.numpy(), r_ref)
    if den_zero:
        assert np.array_equal(X.numpy(), x) and np.array_equal(R.numpy(), r)
    X2 = torch.as_tensor(x.copy())
    t_cg.cg_step(X2, None, Pt, None, tn, td)  # x only
    assert np.array_equal(X2.numpy(), x_ref)
    t_cg.cg_direction(RC, RC, Pt, tn, td)  # in place over rc
    assert np.array_equal(RC.numpy(), p_ref)
    P2 = torch.as_tensor(p.copy())
    t_cg.cg_direction(P2, torch.as_tensor(rc), P2, tn, td)  # in place over p
    assert np.array_equal(P2.numpy(), p_ref)
    assert LAUNCHES == before


def test_cg_wrappers_reject_malformed_inputs():
    x = torch.zeros((E, 4), dtype=torch.float64)
    s = torch.tensor(1.0, dtype=torch.float64)
    with pytest.raises(ValueError):
        t_cg.cg_step(x, x.clone(), x[:, :3].contiguous(), x.clone(), s, s)
    with pytest.raises(ValueError):
        t_cg.cg_step(x, x.clone(), x.clone(), x.clone(), s.float(), s)
    with pytest.raises(ValueError):
        t_cg.cg_step(x, x.clone(), x.clone(), x.clone(), s.reshape(1), s)
    with pytest.raises(ValueError):
        t_cg.cg_direction(x, x.t().contiguous().t(), x, s, s)
    with pytest.raises(TypeError):
        t_cg.cg_direction(x.to(torch.int64), x.to(torch.int64), x.to(torch.int64),
                          s.to(torch.int64), s.to(torch.int64))
