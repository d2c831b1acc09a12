"""Host layer of the PyTorch port against the JAX package: the copied NumPy
code (mesh, reference element, level operators, grid plan, structured
orbit rules) must produce identical arrays, and the flattened K2 tables
must reproduce the structured combine (checked by a NumPy emulation of the
kernel's per-thread arithmetic, since the CUDA kernel cannot run here)."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from homogenization_jl_tpu.fem import assembly as j_asm
from homogenization_jl_tpu.fem import local_operators as j_lo
from homogenization_jl_tpu.mesh import grid as j_grid
from homogenization_jl_tpu.mesh import reference as j_ref
from homogenization_jl_tpu.models import checkerboard as j_cb
from homogenization_jl_tpu.ops import plan as j_plan
from homogenization_jl_tpu.ops import structured as j_st
from homogenization_jl_tpu_torch.fem import assembly as t_asm
from homogenization_jl_tpu_torch.fem import local_operators as t_lo
from homogenization_jl_tpu_torch.mesh import grid as t_grid
from homogenization_jl_tpu_torch.mesh import reference as t_ref
from homogenization_jl_tpu_torch.models import checkerboard as t_cb
from homogenization_jl_tpu_torch.ops import plan as t_plan
from homogenization_jl_tpu_torch.ops import structured as t_st

# (dim, n, nlevels, order); n=16 in 2D goes through the rescaled derivation
# (build_structured_combine_scaled)
CONFIGS = [
    (2, 8, 4, "cube"),
    (3, 4, 3, "type"),
    (3, 4, 3, "cube"),
    (2, 16, 3, "cube"),
]


def _plans(dim, n, nlevels, order):
    bj = j_grid.hypercube(dim, n, order=order)
    bt = t_grid.hypercube(dim, n, order=order)
    return (
        j_plan.build_grid_plan(bj, nlevels, slot_tables=True),
        t_plan.build_grid_plan(bt, nlevels, slot_tables=True),
    )


def _eq(a, b, what):
    if a is None or b is None:
        assert a is None and b is None, what
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert np.array_equal(a, b), what


def _orbit_tuple(ob):
    return (ob.pattern, ob.p_min, ob.p_max, ob.int_lo, ob.int_hi)


def _sc_tuple(sc):
    classes = {
        name: (tuple(_orbit_tuple(o) for o in orbits), rebuild, offs, w)
        for name, (orbits, rebuild, offs, w) in sc.classes.items()
    }
    return (sc.n, sc.d, sc.ept, sc.n_local, sc.order, classes, sc.pad)


@pytest.mark.parametrize("dim,n,nlevels,order", CONFIGS)
def test_host_copy_matches_jax(dim, n, nlevels, order):
    pj, pt = _plans(dim, n, nlevels, order)
    _eq(pj.base.nodes, pt.base.nodes, "base nodes")
    _eq(pj.base.elements, pt.base.elements, "base elements")
    _eq(pj.interior_base_nodes, pt.interior_base_nodes, "interior nodes")
    _eq(j_grid.interior_nodes(pj.base), t_grid.interior_nodes(pt.base), "interior_nodes()")
    for a, b in zip(j_grid.affine_maps(pj.base), t_grid.affine_maps(pt.base)):
        _eq(a, b, "affine maps")
    rj, rt = pj.reference, pt.reference
    for k in range(nlevels):
        _eq(rj.levels[k].nodes, rt.levels[k].nodes, f"ref nodes {k}")
        _eq(rj.levels[k].elements, rt.levels[k].elements, f"ref elements {k}")
        for f in dataclasses.fields(rj.layout[k]):
            _eq(getattr(rj.layout[k], f.name), getattr(rt.layout[k], f.name), f.name)
        lj, lt = pj.levels[k], pt.levels[k]
        _eq(lj.boundary_mask, lt.boundary_mask, f"boundary mask {k}")
        _eq(lj.first_copy_mask, lt.first_copy_mask, f"first-copy mask {k}")
        for name in ("face", "edge", "corner"):
            gj, gt = getattr(lj.gather, name), getattr(lt.gather, name)
            assert (gj is None) == (gt is None), name
            if gj is not None:
                for a, b in zip(gj, gt):
                    _eq(a, b, f"gather {name} {k}")
        for f in ("slot_elem", "slot_node", "slot_group"):
            _eq(getattr(lj.combine, f), getattr(lt.combine, f), f)
        assert lj.combine.n_groups == lt.combine.n_groups
        if k > 0:
            _eq(j_ref.prolongation_dense(rj, k - 1), t_ref.prolongation_dense(rt, k - 1), "P")


@pytest.mark.parametrize("dim,n,nlevels,order", CONFIGS)
def test_level_operators_and_structured_rules_match_jax(dim, n, nlevels, order):
    pj, pt = _plans(dim, n, nlevels, order)
    for a, b in zip(
        j_lo.build_level_operators(pj.reference), t_lo.build_level_operators(pt.reference)
    ):
        _eq(a.stack, b.stack, "level stack")
    rng = np.random.default_rng(3)
    sigma = j_cb.conductivity_per_element(
        pj.base, j_cb.generate_conductivity(dim, n, rng), np.zeros(dim)
    )
    sigma_t = t_cb.conductivity_per_element(
        pt.base, t_cb.generate_conductivity(dim, n, np.random.default_rng(3)), np.zeros(dim)
    )
    _eq(sigma, sigma_t, "conductivity")
    _eq(
        j_lo.element_coefficients(pj.base, sigma, 0.25),
        t_lo.element_coefficients(pt.base, sigma, 0.25),
        "coefficients",
    )
    fine = nlevels - 1
    _eq(
        j_lo.load_vector(pj.reference.levels[fine]),
        t_lo.load_vector(pt.reference.levels[fine]),
        "load vector",
    )
    Aj = j_asm.assemble_operator(pj.base, sigma, 0.25)
    At = t_asm.assemble_operator(pt.base, sigma, 0.25)
    _eq(Aj.toarray(), At.toarray(), "assembled operator")
    assert j_st.detect_structured(pj.base) == t_st.detect_structured(pt.base)
    for k in range(nlevels):
        scj = j_st.build_structured_combine_auto(pj, k)
        sct = t_st.build_structured_combine_auto(pt, k)
        assert _sc_tuple(scj) == _sc_tuple(sct), f"structured rules, level {k}"


def _emulate_k2(x, st, mode):
    """NumPy emulation of csrc/structured_combine.cu's work over the
    flattened table (its column rows and owner rows), vectorized over every
    (element, tail column): the cube's boundary bits from its coordinates,
    each owner's value at its element and column offsets unless its forbid
    bits meet the cube's, the sum in pattern order from +0, the group zeroed
    where the column's box bits meet the cube's (the fold and the
    constraint). tests/test_torch_structured_walk.py emulates the kernel's
    walk row by row, and tests/test_torch_slab_walk.py its plane window."""
    sc = st.sc
    tab = st.tab.numpy().astype(np.int64)
    n, d, ept, i0 = sc.n, sc.d, sc.ept, st.i0
    E, n_local = x.shape
    tw = n_local - i0
    cols = tab[tab[0]:tab[1]].reshape(ept, tw, 4)
    owners = tab[tab[1]:].reshape(-1, 4)
    nd = n**d
    out = x.copy()
    e = np.repeat(np.arange(E), tw)
    jj = np.tile(np.arange(tw), E)
    if sc.order == "type":
        t, cube = e // nd, e % nd
    else:
        t, cube = e % ept, e // ept
    bnd = np.full(len(e), t_st.OUTSIDE)
    for k in range(d - 1, -1, -1):
        ck = cube % n
        cube = cube // n
        bnd |= (ck == 0).astype(np.int64) << (2 * k) | (ck == n - 1).astype(np.int64) << (2 * k + 1)
    q0, q1, box, _ = cols[t, jj].T
    inside = (box & bnd) == 0
    acc = np.zeros(len(e))
    for q in range(int((q1 - q0).max())):
        has = q0 + q < q1
        forbid, rel, dcol, _ = owners[np.where(has, q0 + q, 0)].T
        ok = has & ((forbid & bnd) == 0)
        idx = np.where(ok, (e + rel) * n_local + i0 + jj + dcol, 0)
        acc = acc + np.where(ok, x.reshape(-1)[idx], 0.0)
    if mode == 0:
        val = acc
    elif mode == 1:
        val = np.where(inside, acc, 0.0)
    else:
        val = np.where(inside, x[e, i0 + jj], 0.0)
    out[e, i0 + jj] = val
    return out


@pytest.mark.parametrize("dim,n,nlevels,order", CONFIGS[:3])
def test_flattened_tables_reproduce_plain_combine(dim, n, nlevels, order):
    _, pt = _plans(dim, n, nlevels, order)
    rng = np.random.default_rng(7)
    for k in range(nlevels):
        lay = pt.reference.layout[k]
        i0 = int(min(list(lay.face_offsets) + list(lay.edge_offsets) + list(lay.corner_cols)))
        st = t_st.flatten_structured(t_st.build_structured_combine_auto(pt, k), i0)
        x = rng.standard_normal((pt.base.nelements, pt.n_local(k)))
        xt = torch.as_tensor(x)
        for mode, ref in (
            (0, t_st.combine_structured_plain(xt, st)),
            (1, t_st.combine_structured_plain(xt, st, constrain=True)),
            (2, t_st.constrain_structured_plain(xt, st)),
        ):
            got = _emulate_k2(x, st, mode)
            # same owners summed in the same order: bitwise equal
            assert np.array_equal(got, ref.numpy()), (k, mode)


def test_port_never_imports_jax():
    code = (
        "import sys\n"
        "import homogenization_jl_tpu_torch\n"
        "import homogenization_jl_tpu_torch.solver.multigrid\n"
        "import homogenization_jl_tpu_torch.interop\n"
        "import homogenization_jl_tpu_torch.ops.chebyshev\n"
        "import homogenization_jl_tpu_torch.ops.stencil\n"
        "import homogenization_jl_tpu_torch.ops.interfaces\n"
        "import homogenization_jl_tpu_torch.solver.coarse\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert 'homogenization_jl_tpu' not in sys.modules\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, cwd=root
    )
    assert res.returncode == 0, res.stderr
