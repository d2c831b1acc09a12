"""The gather-sharded combine's plain forms (kernel K12, ops/sharded.py)
against the JAX package's ``ShardedMultigridSolver._combine`` run in
``shard_map`` on the conftest's 8 virtual CPU devices, and the new plain
forms of kernels K18 (ops/elementwise.py, ``apply_mask``) and K10
(``cg_step``'s ``r_out``) against the JAX expressions they replace, in
float64.

Cases: hypercube(3, 3) (E = 162: blocks of 21 rows, the last of 15) and
the driver's ordered base ordered_hypercube(2, 4) (E = 128), 3 levels, 8
shards. At every level, with and without a bool mask, on every shard: the
port's rank result (K8's plain form on the shard's owner tables, the cross
partials added in rank order, the scatter) within 1e-13 relative of the
JAX shard's rows; the joined result within 1e-13 of the JAX single-device
gather combine, with every copy of a shared DOF bitwise equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from homogenization_jl_tpu.mesh.grid import hypercube as j_hypercube
from homogenization_jl_tpu.models.checkerboard import ordered_hypercube as j_ordered
from homogenization_jl_tpu.ops.interfaces import apply_mask as j_apply_mask
from homogenization_jl_tpu.ops.plan import build_grid_plan as j_build_grid_plan
from homogenization_jl_tpu.parallel.sharding import ShardedMultigridSolver as JaxSharded
from homogenization_jl_tpu.solver.multigrid import MultigridSolver as JaxSolver
from homogenization_jl_tpu_torch.interop import join_shards, shard_rows
from homogenization_jl_tpu_torch.mesh.grid import hypercube as t_hypercube
from homogenization_jl_tpu_torch.models.checkerboard import ordered_hypercube as t_ordered
from homogenization_jl_tpu_torch.ops import cg as t_cg
from homogenization_jl_tpu_torch.ops import elementwise as t_ew
from homogenization_jl_tpu_torch.ops import interfaces as t_if
from homogenization_jl_tpu_torch.ops import sharded as t_sh
from homogenization_jl_tpu_torch.ops.plan import build_grid_plan as t_build_grid_plan
from homogenization_jl_tpu_torch.parallel.sharding import shard_tables

S = 8
NLEVELS = 3
TOL = 1e-13
CASES = {
    "3d-E162": (lambda: j_hypercube(3, 3), lambda: t_hypercube(3, 3)),
    "2d-ordered": (lambda: j_ordered(2, 4)[0], lambda: t_ordered(2, 4)[0]),
}


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    jm, tm = CASES[request.param]
    pj = j_build_grid_plan(jm(), NLEVELS, slot_tables=False)
    pt = t_build_grid_plan(tm(), NLEVELS, slot_tables=False)
    mesh = Mesh(np.array(jax.devices()[:S]), ("e",))
    sh = JaxSharded(pj, mesh, dtype=jnp.float64, coarse="cg")
    single = JaxSolver(pj, dtype=jnp.float64, combine="gather", coarse="cg")
    return pj, pt, sh, single


def jax_sharded_combine(sh, k, x, mask):
    """JAX's sharded combine (and apply_mask of it) of the global x, as the
    [E_pad, n] padded global arrays."""
    statics = sh._level_statics(k)

    def body(v, m, valid, la):
        out = sh._combine(v, dict(**la, **statics), k, valid)
        return out, j_apply_mask(out, m)

    spec = P("e", None)
    prog = jax.jit(jax.shard_map(body, mesh=sh.mesh,
                                 in_specs=(spec, spec, P("e"), sh._level_specs(k)),
                                 out_specs=(spec, spec), check_vma=False))
    out, masked = prog(sh.put(x), sh.put(mask.astype(np.float64)), sh.valid_mask,
                       sh._level_args(k))
    return np.asarray(out), np.asarray(masked)


def port_sharded_combine(pt, k, x, mask=None):
    """The port's rank results (plain forms) of the global x cut into S
    blocks: K8 per rank, the partials added in rank order, the scatter."""
    ranks = [shard_tables(pt, k, S, r) for r in range(S)]
    xs = [torch.as_tensor(shard_rows(x, r, S)).contiguous() for r in range(S)]
    ms = [None if mask is None else torch.as_tensor(shard_rows(mask, r, S)).contiguous()
          for r in range(S)]
    local = [t_sh.sharded_combine_local(xr, gt, ct, mr) for xr, (gt, ct), mr in zip(xs, ranks, ms)]
    if local[0][1] is not None:
        total = local[0][1]
        for _, part in local[1:]:
            total = total + part
        for (out, _), (_, ct), mr in zip(local, ranks, ms):
            t_sh.cross_scatter(out, total, ct, mr)
    return [out.numpy() for out, _ in local]


def copies_equal(y, plan, k):
    lay = plan.reference.layout[k]
    lp = plan.levels[k]
    for tabs, offsets, width in ((lp.gather.face, lay.face_offsets, lay.npf),
                                 (lp.gather.edge, lay.edge_offsets, lay.npe),
                                 (lp.gather.corner, lay.corner_cols, 1)):
        if tabs is None or width == 0:
            continue
        oe, ol, om, _ = (np.asarray(a) for a in tabs)
        cols = np.asarray(offsets)[ol][..., None] + np.arange(width)
        vals = y[oe[..., None], cols]
        first = np.broadcast_to(vals[:, :1], vals.shape)
        if not np.array_equal(np.where(om[..., None] > 0, vals, first), first):
            return False
    return True


def test_sharded_combine_matches_jax_shard_map(case):
    pj, pt, sh, single = case
    rng = np.random.default_rng(21)
    E = pt.base.nelements
    B = -(-E // S)
    for k in range(NLEVELS):
        x = rng.standard_normal((E, pt.n_local(k)))
        m = rng.random(x.shape) < 0.7
        want, want_m = jax_sharded_combine(sh, k, x, m)
        got = port_sharded_combine(pt, k, x)
        got_m = port_sharded_combine(pt, k, x, m)
        for r in range(S):
            rows = slice(r * B, r * B + got[r].shape[0])
            assert _rel(got[r], want[rows]) <= TOL, (k, r)
            assert _rel(got_m[r], want_m[rows]) <= TOL, (k, r)
        joined = join_shards(got)
        ref = np.asarray(single.combine(jnp.asarray(x), k))
        assert _rel(joined, ref) <= TOL, k
        assert np.array_equal(join_shards(got_m), joined * m), k
        assert copies_equal(joined, pt, k), k


def test_one_shard_is_the_gather_combine(case):
    """With one shard there is no cross group: K12 is K8 on the plan's own
    tables, bit for bit."""
    _, pt, _, _ = case
    rng = np.random.default_rng(22)
    for k in range(NLEVELS):
        gt, ct = shard_tables(pt, k, 1, 0)
        assert ct.n_groups == 0 and ct.n_slots == 0
        x = torch.as_tensor(rng.standard_normal((pt.base.nelements, pt.n_local(k))))
        got = t_sh.sharded_combine(x, gt, ct, total_fn=None)
        assert torch.equal(got, t_if.combine_gather_rows(x, t_if.build_gather_tables(pt, k)))


def test_elementwise_plain_forms_match_jax():
    """K18's and K10's new plain forms against the JAX expressions they
    replace (solver/multigrid.py:547, :575, :580, :604-612, :1210-1211;
    ops/interfaces.py:58), bit for bit in float64 on the CPU."""
    rng = np.random.default_rng(23)
    E, n, Pp = 37, 11, 7
    u, v, w, d = (rng.standard_normal((E, n)) for _ in range(4))
    d[rng.random(d.shape) < 0.2] = 0.0
    m = rng.random((E, n)) < 0.6
    coeff = rng.uniform(0.5, 2.0, (E, Pp))
    dref = rng.standard_normal((Pp, n))
    a, b = 0.37, -1.25
    T = torch.as_tensor
    j = jnp.asarray

    def sc(v):
        return torch.tensor(v, dtype=torch.float64)

    def same(got, want):
        return np.array_equal(np.asarray(got), np.asarray(want))

    assert same(t_if.apply_mask(T(u), T(m)), j_apply_mask(j(u), j(m)))
    assert same(t_ew.mul(T(d), T(u)), j(d) * j(u))
    assert same(t_ew.lanczos_update(T(u), T(v), T(w), sc(a), sc(b)), j(u) - a * j(v) - b * j(w))
    for s in (2.5, 0.0):
        assert same(t_ew.div_nz(T(u), sc(s)), j(u) / jnp.where(s == 0, 1.0, s))
    dj = j(d)
    assert same(t_ew.inv_positive(T(d)), jnp.where(dj > 0, 1.0 / jnp.where(dj > 0, dj, 1.0), 0.0))
    # the diagonal: summed in piece order (XLA's einsum may order otherwise)
    diag = t_ew.diagonal(T(coeff), T(dref))
    assert _rel(diag, jnp.einsum("ep,pn->en", j(coeff), j(dref))) <= 1e-15
    # the first Lanczos step: no v_prev, the bits of JAX's update from zeros
    assert same(t_ew.lanczos_update(T(u), T(v), None, sc(a), sc(0.0)),
                j(u) - a * j(v) - 0.0 * jnp.zeros_like(j(w)))
    # K10's r_out form: x + alpha p and r - alpha Ap into a new buffer, r kept
    num, den = sc(0.7), sc(1.3)
    x, r, p, Ap = (T(z).clone() for z in (u, v, w, d))
    r_new = torch.empty_like(r)
    t_cg.cg_step(x, r, p, Ap, num, den, r_out=r_new)
    alpha = 0.7 / 1.3
    assert same(x, j(u) + alpha * j(w)) and same(r_new, j(v) - alpha * j(d))
    assert same(r, v)
    # x_zero: x's old values unread, x = 0 + alpha p (JAX: zeros_like(x) + alpha p)
    x = torch.full_like(p, float("nan"))
    t_cg.cg_step(x, None, p, None, num, den, x_zero=True)
    assert same(x, jnp.zeros_like(j(w)) + alpha * j(w))


def test_elementwise_wrappers_check_their_operands():
    x = torch.zeros((4, 3), dtype=torch.float64)
    with pytest.raises(ValueError):
        t_if.apply_mask(x, torch.ones((4, 3)))  # not a bool mask
    with pytest.raises(ValueError):
        t_if.apply_mask(x, torch.ones((4, 2), dtype=torch.bool))
    with pytest.raises(ValueError):
        t_ew.mul(x, torch.zeros((4, 3), dtype=torch.float32))
    with pytest.raises(ValueError):
        t_ew.div_nz(x, torch.ones(1, dtype=torch.float64))  # not 0-d
    with pytest.raises(TypeError):
        t_ew.inv_positive(x.to(torch.int32))
    with pytest.raises(ValueError):
        t_ew.diagonal(x, torch.zeros((2, 3), dtype=torch.float64))
    with pytest.raises(ValueError):
        t_cg.cg_step(x, None, x, x, torch.tensor(1.0, dtype=torch.float64),
                     torch.tensor(1.0, dtype=torch.float64), r_out=x.clone())
