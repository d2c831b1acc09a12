"""The port's slab combine and constraint (the plain forms of kernel K11)
against the JAX package's ``combine_structured_slab`` /
``constrain_structured_slab`` run in ``shard_map`` on the conftest's 8
virtual CPU devices, in float64.

On each case (2D n = 8 with S = 2, 4 and 8 slabs; 3D n = 8 with S = 4,
W = 2, and S = 8, W = 1), at every level of a 3-level cube-major plan, and
in each mode (the combine, the combine with the zero-Dirichlet fold, the
constraint, the combine times a bool mask), the port's result on every slab,
with halos cut from the full state, must be bitwise equal to the JAX
shard's rows, and equal to the rows of the port's single-device combine."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from homogenization_jl_tpu.mesh.grid import hypercube as j_hypercube
from homogenization_jl_tpu.ops.plan import build_grid_plan as j_build_grid_plan
from homogenization_jl_tpu.ops.structured import (
    combine_structured_slab as j_combine_slab,
    constrain_structured_slab as j_constrain_slab,
)
from homogenization_jl_tpu.solver.multigrid import MultigridSolver as JaxSolver
from homogenization_jl_tpu_torch.interop import join_slabs, slab_rows
from homogenization_jl_tpu_torch.mesh.grid import hypercube as t_hypercube
from homogenization_jl_tpu_torch.ops import structured as t_st
from homogenization_jl_tpu_torch.ops.plan import build_grid_plan as t_build_grid_plan

NLEVELS = 3
CASES = [(2, 8, 2), (2, 8, 4), (2, 8, 8), (3, 8, 4), (3, 8, 8)]
MODES = ["combine", "fold", "constrain", "mask"]
_PLANS: dict = {}


def _plans(dim, n):
    """The JAX solver (for its structured rules and row layouts) and the
    port's plan on hypercube(dim, n, order="cube"), built once per box."""
    if (dim, n) not in _PLANS:
        pj = j_build_grid_plan(j_hypercube(dim, n), NLEVELS, slot_tables=False)
        pt = t_build_grid_plan(t_hypercube(dim, n, order="cube"), NLEVELS, slot_tables=False)
        _PLANS[(dim, n)] = (JaxSolver(pj, combine="structured", coarse="cg"), pt)
    return _PLANS[(dim, n)]


def _tables(pt, k):
    lay = pt.reference.layout[k]
    i0 = int(min(list(lay.face_offsets) + list(lay.edge_offsets) + list(lay.corner_cols)))
    return t_st.flatten_structured(t_st.build_structured_combine_auto(pt, k), i0)


@pytest.fixture(scope="module", params=CASES, ids=[f"{d}d-n{n}-S{S}" for d, n, S in CASES])
def case(request):
    """Per level: the inputs, the JAX results of every mode (one shard_map
    program per level), and the port's slab results of every mode."""
    dim, n, S = request.param
    sj, pt = _plans(dim, n)
    mesh = Mesh(np.array(jax.devices()[:S]), ("e",))
    W = n // S
    rng = np.random.default_rng(11 + S)
    levels = []
    for k in range(NLEVELS):
        sc, lay = sj.structured[k], sj.row_layout[k]
        st = _tables(pt, k)
        assert st.sc.pad == sc.pad and st.i0 == lay["iface_start"]
        x = rng.standard_normal((pt.base.nelements, pt.n_local(k)))
        m = rng.random(x.shape) < 0.7

        def body(v, mv, sc=sc, lay=lay):
            return (
                j_combine_slab(v, sc, lay, W, S, "e"),
                j_combine_slab(v, sc, lay, W, S, "e", constrain=True),
                j_constrain_slab(v, sc, lay, W, "e"),
                j_combine_slab(v, sc, lay, W, S, "e") * mv,
            )

        spec = P("e", None)
        prog = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(spec, spec),
                                     out_specs=(spec,) * 4, check_vma=False))
        want = dict(zip(MODES, (np.asarray(a) for a in prog(jnp.asarray(x), jnp.asarray(m)))))

        h = t_st.slab_halo_rows(st.sc)
        tw = x.shape[1] - st.i0
        got = {mode: [] for mode in MODES}
        for r in range(S):
            xr = torch.as_tensor(slab_rows(x, r, S))
            lo = torch.as_tensor(slab_rows(x, r - 1, S)[-h:, st.i0:]) if r > 0 else torch.zeros(h, tw, dtype=xr.dtype)
            hi = torch.as_tensor(slab_rows(x, r + 1, S)[:h, st.i0:]) if r < S - 1 else torch.zeros(h, tw, dtype=xr.dtype)
            lo, hi = lo.contiguous(), hi.contiguous()
            mr = torch.as_tensor(slab_rows(m, r, S))
            x0 = r * W
            got["combine"].append(t_st.combine_structured_slab(xr, lo, hi, st, x0, W))
            got["fold"].append(t_st.combine_structured_slab(xr, lo, hi, st, x0, W, constrain=True))
            got["constrain"].append(t_st.constrain_structured_slab(xr, st, x0, W))
            got["mask"].append(t_st.combine_structured_slab(xr, lo, hi, st, x0, W, mask=mr))
        xt, mt = torch.as_tensor(x), torch.as_tensor(m)
        single = dict(
            combine=t_st.combine_structured(xt, st),
            fold=t_st.combine_structured(xt, st, constrain=True),
            constrain=t_st.constrain_structured(xt, st),
            mask=t_st.combine_structured(xt, st, mask=mt),
        )
        levels.append(dict(want=want, got={md: join_slabs(g) for md, g in got.items()},
                           single={md: s.numpy() for md, s in single.items()}))
    return levels


@pytest.mark.parametrize("mode", MODES)
def test_slab_form_bitwise_equals_jax(case, mode):
    for k, lv in enumerate(case):
        assert np.array_equal(lv["got"][mode], lv["want"][mode]), (
            k, np.abs(lv["got"][mode] - lv["want"][mode]).max())


@pytest.mark.parametrize("mode", MODES)
def test_slab_form_equals_single_device_rows(case, mode):
    for k, lv in enumerate(case):
        assert np.array_equal(lv["got"][mode], lv["single"][mode]), k
