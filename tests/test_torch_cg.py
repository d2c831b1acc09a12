"""CG and multishift CG of the port (solver/cg.py) against the JAX
package's (homogenization_jl_tpu/solver/cg.py), in float64 on the CPU, on
the problems of tests/test_cg.py; and the plain forms of kernels K13
(ops/multishift.py) and K14a / K14c (ops/recurrence.py) against the JAX
expressions they replace.

Tolerances: the iterates to 1e-12 relative to their largest entry (the
same recurrences in the same order; only the dots' summation order
differs, K5's fixed order against XLA's); the iteration counts equal; the
plain forms to 1e-13 (one or two roundings apart at most).

The inputs come from numpy with a seed and reach both packages as numpy
arrays."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from homogenization_jl_tpu.solver import cg as j_cg
from homogenization_jl_tpu_torch.csrc.build import LAUNCHES
from homogenization_jl_tpu_torch.ops import multishift as t_ms
from homogenization_jl_tpu_torch.ops import recurrence as t_rec
from homogenization_jl_tpu_torch.solver import cg as t_cg

TOL = 1e-12


def _laplacian_1d(n):
    return 2.0 * np.eye(n) - np.eye(n, k=1) - np.eye(n, k=-1)


def _close(a, b, tol=TOL):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    scale = max(float(np.abs(b).max()), 1e-300)
    return float(np.abs(a - b).max()) / scale <= tol


def _s(value):
    return torch.tensor(value, dtype=torch.float64)


def _mv_t(A):
    At = torch.as_tensor(A)
    return lambda v: At @ v


def _mv_j(A):
    Aj = jnp.asarray(A)
    return lambda v: Aj @ v


def test_cg_plain_matches_jax():
    n = 80
    A = _laplacian_1d(n)
    rng = np.random.default_rng(0)
    b = A @ rng.standard_normal(n)
    xj, itj, rsj = j_cg.cg(_mv_j(A), jnp.asarray(b), tol=1e-12, maxiter=500)
    xt, itt, rst = t_cg.cg(_mv_t(A), torch.as_tensor(b), tol=1e-12, maxiter=500)
    assert itt == int(itj)
    assert _close(xt.numpy(), xj)
    # both stopped on the same contract: ||r||^2 <= tol^2 ||b||^2
    assert float(rst) <= 1e-24 * float(b @ b) and float(rsj) <= 1e-24 * float(b @ b)


@pytest.mark.parametrize("form", ["tensor", "callable"])
def test_jacobi_cg_matches_jax(form):
    """The ill-scaled SPD problem of test_cg.py: the port's Jacobi CG (the
    inverse diagonal as a tensor: K14a's plain form; or as a callable: the
    JAX expressions) against JAX's callable preconditioner."""
    n = 120
    rng = np.random.default_rng(5)
    L = _laplacian_1d(n) + np.eye(n)
    d = 10.0 ** rng.uniform(-3, 3, n)
    A = np.sqrt(d)[:, None] * L * np.sqrt(d)[None, :]
    b = A @ rng.standard_normal(n)
    inv = 1.0 / np.diag(A)
    inv_j = jnp.asarray(inv)
    xj, itj, _ = j_cg.cg(_mv_j(A), jnp.asarray(b), tol=1e-10, maxiter=5000,
                         precond=lambda r: inv_j * r)
    inv_t = torch.as_tensor(inv)
    pre = inv_t if form == "tensor" else (lambda r: inv_t * r)
    xt, itt, rst = t_cg.cg(_mv_t(A), torch.as_tensor(b), tol=1e-10, maxiter=5000, precond=pre)
    assert itt == int(itj)
    assert _close(xt.numpy(), xj)
    assert np.linalg.norm(A @ xt.numpy() - b) / np.linalg.norm(b) < 1e-9


def test_cg_identity_precond_matches_plain():
    n = 60
    A = _laplacian_1d(n) + np.eye(n)
    b = torch.as_tensor(np.random.default_rng(6).standard_normal(n))
    x0, it0, _ = t_cg.cg(_mv_t(A), b, tol=1e-12, maxiter=500)
    x1, it1, _ = t_cg.cg(_mv_t(A), b, tol=1e-12, maxiter=500, precond=lambda r: r)
    x2, it2, _ = t_cg.cg(_mv_t(A), b, tol=1e-12, maxiter=500, precond=torch.ones(n,
                                                                                 dtype=b.dtype))
    assert it0 == it1 == it2
    assert _close(x1.numpy(), x0.numpy()) and _close(x2.numpy(), x0.numpy())


@pytest.mark.parametrize("iters,shifts", [(60, [1.0, 0.5, 0.25]), (20, [1.0, 0.25])],
                         ids=["converged", "20-iters"])
def test_multishift_matches_jax(iters, shifts):
    n = 60 if iters == 60 else 50
    A = _laplacian_1d(n)
    b = np.random.default_rng(1 if iters == 60 else 2).standard_normal(n)
    xsj, resj = j_cg.multishift_cg(_mv_j(A), jnp.asarray(b), shifts, iters=iters)
    xst, rest = t_cg.multishift_cg(_mv_t(A), torch.as_tensor(b), shifts, iters=iters)
    for i, s in enumerate(shifts):
        assert _close(xst[i].numpy(), xsj[i]), f"shift {s}"
        direct = np.linalg.solve(A + s * np.eye(n), b)
        true_res = np.linalg.norm(b - (A + s * np.eye(n)) @ xst[i].numpy())
        assert abs(true_res - float(rest[i])) < 1e-6 * (1 + true_res)
        if iters == n:
            assert np.abs(xst[i].numpy() - direct).max() < 1e-8
    assert np.allclose(rest.numpy(), np.asarray(resj), rtol=1e-6, atol=1e-13)


def test_multishift_matrix_free_on_duplicated_layout():
    """test_cg.py:58's problem: multishift CG over the implicit-grid
    mat-vec on the duplicated [E, n] layout, both packages' solvers."""
    from homogenization_jl_tpu.mesh.grid import hypercube
    from homogenization_jl_tpu.models.checkerboard import (
        conductivity_per_element,
        generate_conductivity,
    )
    from homogenization_jl_tpu.ops.plan import build_grid_plan as j_plan
    from homogenization_jl_tpu.solver.multigrid import MultigridSolver as JSolver
    from homogenization_jl_tpu_torch.models.multishift import shifted_family_solve
    from homogenization_jl_tpu_torch.ops.plan import build_grid_plan as t_plan
    from homogenization_jl_tpu_torch.solver.multigrid import MultigridSolver as TSolver

    dim, n, levels = 2, 3, 3
    base = hypercube(dim, n)
    rng = np.random.default_rng(3)
    sigma = conductivity_per_element(base, generate_conductivity(dim, n, rng), np.zeros(dim))
    k = levels - 1
    js = JSolver(j_plan(base, levels), coarse="cg")
    ts = TSolver(t_plan(base, levels, slot_tables=False), dtype=torch.float64, device="cpu",
                 coarse="cg")
    coeff_j = js.coefficients(sigma, 0.0)
    coeff_t = ts.coefficients(sigma, 0.0)
    w = js.levels[k].first_copy_mask
    b_np = rng.standard_normal(w.shape)
    shifts = [1.0, 0.5]

    def matvec(v):
        return js._combine(js._constrain(js._apply_op(v, coeff_j, k), k), k)

    bj = js._constrain(js._combine(jnp.asarray(b_np), k), k)
    xsj, _ = j_cg.multishift_cg(matvec, bj, shifts, iters=150,
                                dot=lambda a, c: jnp.vdot(a * w, c))
    xst, rest = shifted_family_solve(ts, coeff_t, torch.as_tensor(b_np), shifts, iters=150)
    for i in range(len(shifts)):
        assert _close(xst[i].numpy(), xsj[i])
    assert (rest.numpy() < 1e-8).all()


def _scalars(rng, ns, zero_D=False):
    shifts = np.array([1.0, 0.5, 0.25][:ns])
    D_prev = rng.standard_normal(ns) + 2.0
    if zero_D:
        D_prev[1] = 0.0
    return shifts, float(rng.standard_normal()), float(rng.standard_normal()), D_prev, \
        rng.standard_normal(ns)


@pytest.mark.parametrize("case", ["first", "later", "D-zero"])
def test_multishift_step_plain_matches_jax_expressions(case):
    """K13's plain form against cg.py:127-136's expressions."""
    rng = np.random.default_rng(21)
    ns, E, nl = 3, 7, 5
    shifts, t_curr, t_prev, D_prev, y_prev = _scalars(rng, ns, zero_D=case == "D-zero")
    first = case == "first"
    v = rng.standard_normal((E, nl))
    W0 = rng.standard_normal((ns, E, nl))
    xs0 = rng.standard_normal((ns, E, nl)) if not first else np.zeros((ns, E, nl))

    # the JAX expressions
    Dsafe = jnp.where(D_prev == 0, 1, D_prev)
    sh = jnp.asarray(shifts)
    D_j = (t_curr + sh) if first else t_curr + sh - t_prev**2 / Dsafe
    y_j = jnp.asarray(y_prev) / D_j if first else jnp.asarray(y_prev) * (-t_prev / D_j)
    W_j = jnp.broadcast_to(v, W0.shape) if first else v[None] - W0 * (t_prev / Dsafe)[:, None, None]
    xs_j = xs0 + W_j * y_j[:, None, None]

    T = torch.as_tensor
    W = T(W0.copy())
    xs = torch.empty_like(W) if first else T(xs0.copy())
    n0 = sum(LAUNCHES.values())
    D_t, y_t = t_ms.multishift_step(T(v), W, xs, T(shifts), _s(t_curr), _s(t_prev), T(D_prev),
                                    T(y_prev), first)
    assert sum(LAUNCHES.values()) == n0  # the plain path counts no launch
    for a, b in ((D_t, D_j), (y_t, y_j), (W, W_j), (xs, xs_j)):
        assert _close(a.numpy(), b, 1e-13)


def test_jacobi_cg_step_plain_matches_jax_expressions():
    """K14a's plain form against cg.py:76-84 with the first-copy dot."""
    rng = np.random.default_rng(22)
    shape = (9, 6)
    x, r, p, Ap = (rng.standard_normal(shape) for _ in range(4))
    d = rng.random(shape) + 0.5
    w = rng.random(shape) < 0.7
    rz, pAp = 1.7, 0.9
    alpha = rz / pAp
    x_j, r_j = x + alpha * p, r - alpha * Ap
    z_j = d * r_j
    rz_j = float(jnp.vdot(r_j * w, z_j))
    rs_j = float(jnp.vdot(r_j * w, r_j))
    T = torch.as_tensor
    xt, rt = T(x.copy()), T(r.copy())
    z, rz_t, rs_t = t_rec.jacobi_cg_step(xt, rt, T(p), T(Ap), T(d), T(w), _s(rz), _s(pAp))
    for a, b in ((xt, x_j), (rt, r_j), (z, z_j)):
        assert _close(a.numpy(), b, 1e-13)
    assert abs(float(rz_t) - rz_j) <= 1e-13 * abs(rz_j)
    assert abs(float(rs_t) - rs_j) <= 1e-13 * abs(rs_j)
    # den == 0: the step is a no-op on x and r
    x2, r2 = T(x.copy()), T(r.copy())
    t_rec.jacobi_cg_step(x2, r2, T(p), T(Ap), T(d), None, _s(rz), _s(0.0))
    assert torch.equal(x2, T(x)) and torch.equal(r2, T(r))


def test_jacobi_cg_step_first_step_form_matches_jax_expressions():
    """K14a's first step of a solve from zero (``x_zero``, ``r_out``): x = 0
    + alpha p unread, r_out = r - alpha Ap with r kept, z and the dots on
    r_out; the same bits as the in-place form on a zero x and a copy of r."""
    rng = np.random.default_rng(24)
    shape = (9, 6)
    r, p, Ap = (rng.standard_normal(shape) for _ in range(3))
    d = rng.random(shape) + 0.5
    w = rng.random(shape) < 0.7
    rz, pAp = 1.3, 0.7
    alpha = rz / pAp
    T = torch.as_tensor
    x = torch.full(shape, np.nan, dtype=torch.float64)  # unread
    rt, r_out = T(r.copy()), torch.empty(shape, dtype=torch.float64)
    z, rz_t, rs_t = t_rec.jacobi_cg_step(x, rt, T(p), T(Ap), T(d), T(w), _s(rz), _s(pAp),
                                         r_out=r_out, x_zero=True)
    assert torch.equal(rt, T(r))
    assert _close(x.numpy(), alpha * p, 1e-13) and _close(r_out.numpy(), r - alpha * Ap, 1e-13)
    x2, r2 = torch.zeros(shape, dtype=torch.float64), T(r.copy())
    ref = t_rec.jacobi_cg_step(x2, r2, T(p), T(Ap), T(d), T(w), _s(rz), _s(pAp))
    for a, b in ((x, x2), (r_out, r2), (z, ref[0]), (rz_t, ref[1]), (rs_t, ref[2])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("form", ["plain", "tensor", "callable"])
def test_cg_from_zero_starts_without_an_apply(form):
    """From x0 = None the residual is b itself: one mat-vec per iteration
    and none of the zero iterate, b left as it was, and the iterates of an
    explicit zero x0 (one apply more) within 1e-12; b = 0 returns zeros."""
    n = 60
    rng = np.random.default_rng(6)
    A = _laplacian_1d(n) + np.diag(10.0 ** rng.uniform(-1, 1, n))
    b = torch.as_tensor(A @ rng.standard_normal(n))
    d = torch.as_tensor(1.0 / np.diag(A))
    precond = {"plain": None, "tensor": d, "callable": lambda r: d * r}[form]
    calls = []
    At = torch.as_tensor(A)

    def matvec(v):
        calls.append(1)
        return At @ v

    b0 = b.clone()
    x, it, _ = t_cg.cg(matvec, b, tol=1e-12, maxiter=500, precond=precond)
    assert len(calls) == it > 0 and torch.equal(b, b0)
    x_ref, it_ref, _ = t_cg.cg(matvec, b, x0=torch.zeros_like(b), tol=1e-12, maxiter=500,
                               precond=precond)
    assert it_ref == it and _close(x.numpy(), x_ref.numpy())
    xz, itz, rsz = t_cg.cg(matvec, torch.zeros_like(b), precond=precond)
    assert itz == 0 and float(rsz) == 0.0 and torch.equal(xz, torch.zeros_like(b))


def test_basis_forms_match_jax_einsum_and_each_other():
    """K14c's plain forms: the one-pass combination against the JAX einsum
    (multishift.py:245) and the two-pass accumulation (:257-260); the two
    port forms bitwise equal."""
    rng = np.random.default_rng(23)
    m, K, E, nl = 11, 3, 8, 6
    V = rng.standard_normal((m, E, nl))
    Y = rng.standard_normal((K, m))
    ref = [np.asarray(jnp.einsum("i,ien->en", jnp.asarray(Y[k]), jnp.asarray(V))) for k in range(K)]
    T = torch.as_tensor
    out = t_rec.basis_combine(T(V), T(Y))
    sums = torch.empty((K, E, nl), dtype=torch.float64)
    Yt = T(np.ascontiguousarray(Y.T))
    for j in range(m):
        t_rec.basis_accumulate(sums, T(V[j]), Yt[j], first=j == 0)
    for k in range(K):
        assert _close(out[k].numpy(), ref[k], 1e-13)
    assert torch.equal(out, sums)
