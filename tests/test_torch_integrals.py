"""The driver's sigma integrals (kernel K9's plain form, and next_rhs
through kernel K1's) against the JAX package's ``_integrals_fns``, in
float64 on the CPU, to 1e-12 relative; both ``reference_quirk`` branches:
unit cells (every detJ == 1, the quirk form) and a scaled base (detJ !=
1, the corrected form). The plain form's sum over elements follows the
kernel's fixed order, checked here against a plain sum.

The inputs come from numpy with a seed; the mass matrix is the last slice
of each package's finest operator stack, as the drivers take it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from homogenization_jl_tpu.fem.local_operators import build_level_operators as j_ops
from homogenization_jl_tpu.mesh.grid import affine_maps, hypercube
from homogenization_jl_tpu.models.checkerboard import _integrals_fns
from homogenization_jl_tpu.mesh.reference import refined_reference as j_refined_reference
from homogenization_jl_tpu_torch.csrc.build import LAUNCHES
from homogenization_jl_tpu_torch.fem.local_operators import build_level_operators as t_ops
from homogenization_jl_tpu_torch.mesh.reference import refined_reference as t_refined_reference
from homogenization_jl_tpu_torch.ops import dots as t_dots
from homogenization_jl_tpu_torch.ops import integrals as t_int

TOL = 1e-12


def _rel(a, b):
    a, b = float(a), float(b)
    return abs(a - b) / max(abs(b), 1e-300)


@pytest.fixture(scope="module", params=[(2, 6, 3, 1.0), (3, 3, 2, 1.0), (2, 5, 3, 0.5)],
                ids=["2d-unit", "3d-unit", "2d-scaled"])
def case(request):
    dim, n, levels, scale = request.param
    base = hypercube(dim, n, scale=scale)
    _, _, detJ, _ = affine_maps(base)
    mass_j = j_ops(j_refined_reference(dim, levels))[-1].stack[-1]
    mass_t = t_ops(t_refined_reference(dim, levels))[-1].stack[-1]
    assert np.array_equal(mass_j, mass_t)
    E, nl = base.nelements, mass_t.shape[0]
    rng = np.random.default_rng(11)
    x = rng.random((E, nl))
    w = rng.standard_normal((E, nl))
    mask = (rng.random(E) < 0.7).astype(np.float64)
    return dict(detJ=detJ, mass=mass_t, x=x, w=w, mask=mask, unit=scale == 1.0)


def test_integrals_match_jax(case):
    area_j, first_j, terms_j, next_j = _integrals_fns(jnp.asarray(case["mass"]), jnp.asarray(case["detJ"]))
    T = {k: torch.as_tensor(case[k]) for k in ("mass", "detJ", "x", "w", "mask")}
    before = dict(LAUNCHES)
    area_t, first_t, terms_t, next_t = t_int.integrals_fns(T["mass"], T["detJ"])
    assert _rel(area_t(T["mask"]), area_j(jnp.asarray(case["mask"]))) <= TOL
    xj, wj, mj = (jnp.asarray(case[k]) for k in ("x", "w", "mask"))
    assert _rel(first_t(T["x"], T["w"], T["mask"]), first_j(xj, wj, mj)) <= TOL
    assert _rel(terms_t(T["x"], T["w"], T["mask"]), terms_j(xj, wj, mj)) <= TOL
    nt = next_t(T["x"], 0.25).numpy()
    nj = np.asarray(next_j(xj, 0.25))
    assert np.abs(nt - nj).max() <= TOL * np.abs(nj).max()
    assert LAUNCHES == before  # CPU tensors take the plain forms


def test_reference_quirk_selection(case):
    """None picks the quirk form exactly when every detJ == 1; on a scaled
    base the two forms differ and the JAX default is the corrected one."""
    T = {k: torch.as_tensor(case[k]) for k in ("mass", "detJ", "x", "w", "mask")}
    auto = t_int.integrals_fns(T["mass"], T["detJ"])[1](T["x"], T["w"], T["mask"])
    quirk = t_int.integrals_fns(T["mass"], T["detJ"], True)[1](T["x"], T["w"], T["mask"])
    fixed = t_int.integrals_fns(T["mass"], T["detJ"], False)[1](T["x"], T["w"], T["mask"])
    if case["unit"]:
        assert float(auto) == float(quirk)
        assert _rel(quirk, fixed) <= TOL
    else:
        assert float(auto) == float(fixed)
        assert _rel(quirk, fixed) > 1e-3
        first_j = _integrals_fns(jnp.asarray(case["mass"]), jnp.asarray(case["detJ"]), True)[1]
        ref = first_j(*(jnp.asarray(case[k]) for k in ("x", "w", "mask")))
        assert _rel(quirk, ref) <= TOL


@pytest.mark.parametrize("E", [1, 255, 264, 1000, 70001])
def test_fixed_order_sum_is_a_sum(E):
    v = torch.as_tensor(np.random.default_rng(E).standard_normal(E))
    got = t_dots.fixed_order_sum(v)
    assert abs(float(got) - float(v.sum())) <= 1e-12 * float(v.abs().sum())
    assert float(t_dots.fixed_order_sum(torch.ones(E, dtype=torch.float64))) == E


def test_integral_wrapper_rejects_malformed_inputs(case):
    T = {k: torch.as_tensor(case[k]) for k in ("mass", "detJ", "x", "w", "mask")}
    with pytest.raises(ValueError):
        t_int.sigma_integral(t_int.TERMS, T["x"][:, :-1], T["mass"], T["w"], T["detJ"], T["mask"])
    with pytest.raises(TypeError):
        t_int.sigma_integral(t_int.TERMS, T["x"].float(), T["mass"], T["w"], T["detJ"], T["mask"])
    with pytest.raises(ValueError):
        t_int.sigma_integral(t_int.AREA, None, None, None, T["detJ"], T["mask"][:-1])
    with pytest.raises(ValueError):
        t_int.sigma_integral(7, T["x"], T["mass"], T["w"], T["detJ"], T["mask"])
