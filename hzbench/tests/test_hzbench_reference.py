"""The plain reference against the port at a small size on the CPU: the
same base mesh, the same refined element, the same load, and an operator
whose residual of the port's float64 solve is the port's own."""

import numpy as np
import pytest
import torch

import homogenization_jl_tpu_torch as hz
from homogenization_jl_tpu_torch.fem.local_operators import load_vector
from homogenization_jl_tpu_torch.mesh.grid import Mesh, affine_maps
from hzbench.reference.mesh import box_mesh, refined_reference
from hzbench.reference.poisson import FineProblem, reference_element

N, L = 4, 3


@pytest.fixture(scope="module")
def problem():
    nodes, els = box_mesh(N, "type")
    plan = hz.build_grid_plan(Mesh(nodes, els), L, slot_tables=False)
    rng = np.random.default_rng(0)
    field = np.where(rng.random((N, N, N, 3)) < 0.5, 1.0, 9.0)
    cube = np.floor(nodes[els].mean(axis=1)).astype(int)
    sigma = field[cube[:, 0], cube[:, 1], cube[:, 2]]
    col = plan.reference.levels[L - 1].nodes
    return nodes, els, plan, sigma, col


@pytest.mark.parametrize("order", ["type", "cube"])
def test_box_mesh_is_the_ports(order):
    nodes, els = box_mesh(3, order)
    ref = hz.hypercube(3, 3, order=order)
    assert np.array_equal(ref.elements, els) and np.array_equal(ref.nodes, nodes)


def test_refined_element_is_the_ports(problem):
    _, _, plan, _, _ = problem
    s = 1 << (L - 1)
    port = plan.reference.levels[L - 1]
    key = lambda nodes, t: tuple(sorted(map(tuple, np.rint(nodes[t] * s).astype(int))))
    rn, rs = refined_reference(L - 1)
    assert {key(port.nodes, t) for t in port.elements} == {key(rn, t) for t in rs}


def test_load_is_the_ports(problem):
    _, _, plan, _, col = problem
    load = reference_element(L, col)["load"]
    assert np.allclose(load, load_vector(plan.reference.levels[L - 1]), rtol=1e-14, atol=0)


def test_residual_of_the_ports_solve(problem):
    nodes, els, plan, sigma, col = problem
    fp = FineProblem(nodes, els, L, col, sigma, block=37)
    s = hz.MultigridSolver(plan, dtype=torch.float64, device="cpu", smoother="chebyshev",
                           coarse="mg", coarse_mg_dense_limit=4)
    f = np.random.default_rng(1).uniform(-1, 1, len(els))
    _, _, dJ, _ = affine_maps(plan.base)
    b = torch.as_tensor((f * dJ)[:, None] * reference_element(L, col)["load"][None, :])
    x, hist = s.solve(b, sigma, 0.0, tol=1e-10)
    got = fp.check(x, b)
    # the port's own relative residual (the same norm over interior nodes)
    assert got["residual"] < 1e-9 and got["copy_gap"] < 1e-14
    # the reference sees a wrong answer: one element row moved, half the
    # rows zeroed, the answer held in bfloat16
    y = x.clone()
    y[3] += 1e-3 * x.abs().max()
    assert fp.check(y, b)["copy_gap"] > 1e-4
    y = x.clone()
    y[: len(y) // 2] = 0
    assert fp.check(y, b)["residual"] > 0.1
    assert fp.check(x.to(torch.bfloat16), b)["residual"] > 1e-3


def test_reference_imports_nothing_of_the_program():
    import ast
    import os
    import sys

    here = os.path.join(os.path.dirname(os.path.dirname(__file__)), "reference")
    for name in os.listdir(here):
        if name.endswith(".py"):
            with open(os.path.join(here, name)) as f:
                tree = ast.parse(f.read())
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    mods = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom):
                    mods = [node.module or ""] if node.level == 0 else []
                else:
                    continue
                for m in mods:
                    top = m.split(".")[0]
                    assert top in ("numpy", "torch") or top in sys.stdlib_module_names, (name, m)


def test_sigma_reference_is_the_ports():
    """The sigma reference against the port's multishift estimate on the
    CPU (n = 1, one refinement, 20 Lanczos steps, float64); the float32
    control reads far from both."""
    from homogenization_jl_tpu_torch.models.multishift import homogenization_multishift
    from hzbench.reference.lanczos import Problem, domain_radius

    R0 = domain_radius(1)
    field = np.where(np.random.default_rng(5).random((2 * R0,) * 3 + (3,)) < 0.5, 1.0, 9.0)
    xi = np.ones(3) / np.sqrt(3.0)
    s_p, st = homogenization_multishift(1, dim=3, refinements=1, lanczos_iters=20,
                                        cond_field=field, return_stats=True, device="cpu")
    s_r, steps, m, _ = Problem(1, 1, field, xi).sigma(20)
    assert m == st["lanczos_iters"] == 20
    assert abs(s_r - s_p) <= 1e-13 * abs(s_r) and len(steps) == len(st["sigma_steps"])
    s_c, *_ = Problem(1, 1, field, xi, dtype=torch.float32).sigma(20)
    assert abs(s_c - s_r) > 1e-9 * abs(s_r)
