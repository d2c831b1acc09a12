"""The row table of a reference stack (ops/apply.py::stack_table), which
kernels K1 and K9 walk in place of the dense [P, n, n] stack.

For every level of ``refined_reference(dim, 5)``, dim 2 and 3, on the CPU:
  * scattering ``vals`` back over ``cols`` gives the dense stack bit for
    bit, for the reference stack and for the stack a ``MultigridSolver``
    level holds (the interface-layout permutation of it), and ``counts``
    marks each row's slots before its pads;
  * the widest row R and the union's nonzeros are pinned (3D: R = 4, 8, 15,
    17, 19 and 16, 60, 295, 1,773, 12,121 nonzeros; 2D: R = 3, 5, 7, 7, 7
    and 9, 24, 75, 261, 969);
  * a gather-form evaluation over the table, written here in PyTorch
    (float64), matches the JAX ``element_apply`` and the JAX mass product
    (``jnp.einsum("mn,en->em", mass, x)``) to 1e-12 relative, from the same
    numpy inputs.
On the card (the ``cuda`` marker; skipped without one), K1's and K9's
wrappers raise on a CUDA call without the table."""

import types

import numpy as np
import pytest
import torch

from homogenization_jl_tpu_torch.fem.local_operators import build_level_operators
from homogenization_jl_tpu_torch.mesh.grid import hypercube
from homogenization_jl_tpu_torch.mesh.reference import refined_reference
from homogenization_jl_tpu_torch.ops import apply as t_apply
from homogenization_jl_tpu_torch.ops import integrals as t_int
from homogenization_jl_tpu_torch.ops.plan import build_grid_plan
from homogenization_jl_tpu_torch.solver.multigrid import MultigridSolver

NLEVELS = 5
CASES = [(dim, k) for dim in (2, 3) for k in range(NLEVELS)]
# the widest row and the union's nonzeros of each level
WIDTHS = {2: (3, 5, 7, 7, 7), 3: (4, 8, 15, 17, 19)}
NONZEROS = {2: (9, 24, 75, 261, 969), 3: (16, 60, 295, 1773, 12121)}
RTOL = 1e-12


def _ids(case):
    return "%dd-level%d" % case


@pytest.fixture(scope="module")
def jx():
    """The JAX package's functions (the CPU tests only: the card's machine
    has no jax)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from homogenization_jl_tpu.fem.local_operators import build_level_operators as level_ops
    from homogenization_jl_tpu.mesh.reference import refined_reference as reference
    from homogenization_jl_tpu.ops.apply import element_apply

    return types.SimpleNamespace(jnp=jnp, level_operators=level_ops, refined_reference=reference,
                                 element_apply=element_apply)


@pytest.fixture(scope="module")
def reference_ops():
    return {dim: build_level_operators(refined_reference(dim, NLEVELS)) for dim in (2, 3)}


@pytest.fixture(scope="module")
def solver_levels():
    """The stacks (and their tables) a MultigridSolver holds, per dim."""
    out = {}
    for dim in (2, 3):
        plan = build_grid_plan(hypercube(dim, 2), NLEVELS, slot_tables=False)
        s = MultigridSolver(plan, dtype=torch.float64, device="cpu")
        out[dim] = [(L.stack, L.table) for L in s.levels]
    return out


def _scatter(tab, P, n):
    """The dense [P, n, n] stack the table lists (pad slots add zeros)."""
    R = tab.width
    rows = torch.arange(n)[:, None].expand(n, R).reshape(-1)
    cols = tab.cols.reshape(-1).long()
    dense = torch.zeros((P, n, n), dtype=tab.vals.dtype)
    for p in range(P):
        dense[p].index_put_((rows, cols), tab.vals[:, :, p].reshape(-1), accumulate=True)
    return dense


def _check_layout(tab, stack):
    P, n, _ = stack.shape
    R = tab.width
    assert tab.cols.dtype == torch.int32 and tuple(tab.cols.shape) == (n, R)
    assert tuple(tab.vals.shape) == (n, R, t_apply._padded_pieces(P))
    assert tab.pieces == P
    assert torch.equal(tab.vals[:, :, P:], torch.zeros_like(tab.vals[:, :, P:]))
    slot = torch.arange(R)[None, :]
    pad = slot >= tab.counts.long()[:, None]
    # ascending real columns, pads pointing at the row with zero values
    cols = tab.cols.long()
    assert bool((cols[:, 1:] > cols[:, :-1])[~pad[:, 1:]].all())
    assert torch.equal(cols[pad], torch.arange(n)[:, None].expand(n, R)[pad])
    assert not bool(tab.vals[pad].any())
    assert int(tab.counts.sum()) == tab.nnz
    assert tab.slice_nnz == int((stack != 0).sum())


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_table_scatters_back_to_the_stack(case, reference_ops, solver_levels):
    dim, k = case
    stack = torch.as_tensor(reference_ops[dim][k].stack)
    tab = t_apply.stack_table(stack)
    _check_layout(tab, stack)
    assert torch.equal(_scatter(tab, *stack.shape[:2]), stack)
    # the solver's level: its own (permuted) stack and the table built from it
    s_stack, s_tab = solver_levels[dim][k]
    _check_layout(s_tab, s_stack)
    assert torch.equal(_scatter(s_tab, *s_stack.shape[:2]), s_stack)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_table_width_and_nonzeros_pinned(case, reference_ops, solver_levels):
    dim, k = case
    tab = t_apply.stack_table(torch.as_tensor(reference_ops[dim][k].stack))
    assert tab.width == WIDTHS[dim][k]
    assert tab.nnz == NONZEROS[dim][k]
    # the union is exactly the mass matrix's pattern; the solver's permuted
    # stack has the same counts
    mass = torch.as_tensor(reference_ops[dim][k].stack[-1])
    assert t_apply.stack_table(mass[None]).nnz == tab.nnz
    s_tab = solver_levels[dim][k][1]
    assert (s_tab.width, s_tab.nnz) == (tab.width, tab.nnz)


def _gather_apply(x, coeff, tab):
    """y[e, m] = sum_k sum_p coeff[e, p] vals[m, k, p] x[e, cols[m, k]], the
    product over the table's slots (pads add zero)."""
    P = tab.pieces
    xg = x[:, tab.cols.long()]  # [E, n, R]
    return torch.einsum("enk,nkp,ep->en", xg, tab.vals[:, :, :P], coeff)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_gather_form_matches_jax(case, reference_ops, jx):
    dim, k = case
    jnp = jx.jnp
    j_op = jx.level_operators(jx.refined_reference(dim, NLEVELS))[k]
    op = reference_ops[dim][k]
    np.testing.assert_array_equal(np.asarray(j_op.stack), op.stack)
    rng = np.random.default_rng(100 + 10 * dim + k)
    E, P, n = 23, op.n_pieces, op.n_local
    x = rng.standard_normal((E, n))
    coeff = rng.uniform(0.5, 2.0, (E, P))
    tab = t_apply.stack_table(torch.as_tensor(op.stack))
    got = _gather_apply(torch.as_tensor(x), torch.as_tensor(coeff), tab).numpy()
    ref = np.asarray(jx.element_apply(jnp.asarray(x), jnp.asarray(coeff), jnp.asarray(j_op.stack)))
    assert np.abs(got - ref).max() <= RTOL * np.abs(ref).max()
    # the mass product over the one-piece table of the mass matrix
    mass = op.stack[-1]
    m_tab = t_apply.stack_table(torch.as_tensor(mass)[None])
    got = _gather_apply(torch.as_tensor(x), torch.ones((E, 1), dtype=torch.float64), m_tab).numpy()
    ref = np.asarray(jnp.einsum("mn,en->em", jnp.asarray(mass), jnp.asarray(x)))
    assert np.abs(got - ref).max() <= RTOL * np.abs(ref).max()


def test_table_checks_on_the_cpu(reference_ops):
    """check_table takes the stack's own table and raises on another's; the
    CPU wrappers take the plain path with or without a table."""
    stack = torch.as_tensor(reference_ops[3][2].stack)
    P, n, _ = stack.shape
    tab = t_apply.stack_table(stack)
    t_apply.check_table("t", tab, n, P, torch.float64, torch.device("cpu"))
    for args in ((n + 1, P, torch.float64), (n, P - 1, torch.float64), (n, P, torch.float32)):
        with pytest.raises((TypeError, ValueError)):
            t_apply.check_table("t", tab, *args, torch.device("cpu"))
    with pytest.raises(ValueError, match="table"):
        t_apply.check_table("t", None, n, P, torch.float64, torch.device("cpu"))
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.standard_normal((7, n)))
    c = torch.as_tensor(rng.uniform(0.5, 2.0, (7, P)))
    assert torch.equal(t_apply.element_apply(x, c, stack, table=tab),
                       t_apply.element_apply(x, c, stack))
    assert torch.allclose(_gather_apply(x, c, tab), t_apply.element_apply(x, c, stack),
                          rtol=0, atol=RTOL * float(t_apply.element_apply(x, c, stack).abs().max()))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_calls_without_the_table_raise(cuda, reference_ops):
    stack = torch.as_tensor(reference_ops[3][2].stack, device=cuda)
    P, n, _ = stack.shape
    x = torch.ones((5, n), dtype=torch.float64, device=cuda)
    c = torch.ones((5, P), dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="table"):
        t_apply.element_apply(x, c, stack)
    with pytest.raises(ValueError, match="table"):
        t_apply.element_apply_half(x.float(), c, stack, b=x.clone())
    mass = stack[-1].contiguous()
    d = torch.ones(5, dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="table"):
        t_int.sigma_integral(t_int.TERMS, x, mass, x, d, d)
    with pytest.raises(ValueError, match="table"):
        t_int.dot_M(x, x, mass, d)
    # another stack's table is refused on its shape
    other = t_apply.stack_table(torch.as_tensor(reference_ops[3][3].stack, device=cuda))
    with pytest.raises(ValueError):
        t_apply.element_apply(x, c, stack, table=other)
