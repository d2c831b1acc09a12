"""Per-call Dirichlet masks (``Ls``, ``interior``) of the port's solver
against the JAX package's, in float64 on the CPU, to 1e-10.

The lattice-geometry driver shrinks its Dirichlet box by passing per-level
boundary masks and a coarse interior-node mask to the cycles of one
full-box solver. Here both packages get the JAX state (interop) on the 2D
configuration of tests/test_torch_coarse.py, and a shrunken box: every DOF
within inf-norm distance 3 of the centre of the 8 x 8 box is interior. With
coarse="cg" and "mg" (the masked global-space coarse solves): x and r after
one V-cycle, FMG, a 5-iteration PCG history, and ``pcg_stepper`` from a
non-zero start. The structured solver with these masks takes the masked K2
fold; the masked V-cycle differs from the unmasked one."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from homogenization_jl_tpu.mesh.grid import affine_maps
from test_torch_coarse import CONFIGS, make_pair

TOL = 1e-10
CENTRE, RADIUS = 4.0, 3.0


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _shrunk_masks(plan):
    """Per-level [E, n_k] bool masks and the [N] bool base interior mask of
    the box of half-width RADIUS around CENTRE."""
    J, shift, _, _ = affine_maps(plan.base)
    masks = []
    for k in range(plan.nlevels):
        ref = plan.reference.levels[k].nodes
        coords = np.einsum("eij,nj->eni", J, ref) + shift[:, None, :]
        masks.append(np.abs(coords - CENTRE).max(axis=2) < RADIUS - 1e-9)
    interior = np.abs(plan.base.nodes - CENTRE).max(axis=1) < RADIUS - 1e-9
    return masks, interior


@pytest.fixture(scope="module", params=["cg", "mg"])
def mpair(request):
    p = make_pair(CONFIGS[1], request.param)
    masks, interior = _shrunk_masks(p["sj"].plan)
    p["Ls_j"] = tuple(L._replace(boundary_mask=jnp.asarray(m)) for L, m in zip(p["sj"].levels, masks))
    p["int_j"] = jnp.asarray(interior)
    p["Ls_t"] = [torch.as_tensor(m) for m in masks]
    p["int_t"] = torch.as_tensor(interior)
    return p


def test_masked_vcycle_matches_jax(mpair):
    sj, st, s = mpair["sj"], mpair["st"], mpair["state"]
    x0 = np.random.default_rng(6).standard_normal(mpair["b"].shape) * mpair["Ls_t"][-1].numpy()
    kw_j = dict(lam_max=mpair["lam_max"], Ls=mpair["Ls_j"], interior=mpair["int_j"])
    xj, rj = sj.vcycle(jnp.asarray(x0), jnp.asarray(mpair["b"]), mpair["coeff"], mpair["setup"], **kw_j)
    xt, rt = st.vcycle(torch.as_tensor(x0), s.b, s.coeff, s.chol, s.lam_max,
                       Ls=mpair["Ls_t"], interior=mpair["int_t"])
    assert _rel(xt, xj) <= TOL and _rel(rt, rj) <= TOL
    x_free, _ = st.vcycle(torch.as_tensor(x0), s.b, s.coeff, s.chol, s.lam_max)
    assert _rel(x_free, xt) > 1e-3
    xj, rj = sj.fmg(jnp.asarray(mpair["b"]), mpair["coeff"], mpair["setup"], **kw_j)
    xt, rt = st.fmg(s.b, s.coeff, s.chol, s.lam_max, Ls=mpair["Ls_t"], interior=mpair["int_t"])
    assert _rel(xt, xj) <= TOL and _rel(rt, rj) <= TOL
    assert float(st.initial_residual_norm(s.b, s.coeff, x=xt, Ls=mpair["Ls_t"])) > 0


def test_masked_pcg_matches_jax(mpair):
    sj, st, s = mpair["sj"], mpair["st"], mpair["state"]
    xj, hj = sj.pcg(jnp.asarray(mpair["b"]), mpair["coeff"], mpair["setup"],
                    lam_max=mpair["lam_max"], iters=5, Ls=mpair["Ls_j"], interior=mpair["int_j"])
    xt, ht = st.pcg(s.b, s.coeff, s.chol, s.lam_max, iters=5, Ls=mpair["Ls_t"],
                    interior=mpair["int_t"])
    assert len(ht) == 6
    assert _rel(xt, xj) <= TOL
    assert np.max(np.abs(np.array(hj) - np.array(ht)) / np.array(hj)) <= TOL


def test_pcg_stepper_from_nonzero_start_matches_jax(mpair):
    sj, st, s = mpair["sj"], mpair["st"], mpair["state"]
    x0 = np.random.default_rng(9).random(mpair["b"].shape) * mpair["Ls_t"][-1].numpy()
    init_j, step_j = sj.pcg_stepper(mpair["coeff"], mpair["setup"], mpair["lam_max"],
                                    Ls=mpair["Ls_j"], interior=mpair["int_j"])
    init_t, step_t = st.pcg_stepper(s.coeff, s.chol, s.lam_max, Ls=mpair["Ls_t"],
                                    interior=mpair["int_t"])
    xt0 = torch.as_tensor(x0)
    state_j = init_j(jnp.asarray(mpair["b"]), x=jnp.asarray(x0))
    state_t = init_t(s.b, x=xt0)
    assert _rel(state_t[4], state_j[4]) <= TOL
    for _ in range(3):
        state_j, state_t = step_j(state_j), step_t(state_t)
        assert _rel(state_t[0], state_j[0]) <= TOL
        assert _rel(state_t[4], state_j[4]) <= TOL
    assert np.array_equal(xt0.numpy(), x0)  # init copies the start


def test_masks_are_validated(mpair):
    st, s = mpair["st"], mpair["state"]
    with pytest.raises(ValueError):
        st.vcycle(s.b, s.b, s.coeff, s.chol, s.lam_max, Ls=mpair["Ls_t"][:-1])
    with pytest.raises(ValueError):
        st.vcycle(s.b, s.b, s.coeff, s.chol, s.lam_max, Ls=[m.double() for m in mpair["Ls_t"]])
    with pytest.raises(ValueError):
        st.vcycle(s.b, s.b, s.coeff, s.chol, s.lam_max, interior=mpair["int_t"][:-1])
