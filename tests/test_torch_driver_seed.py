"""The homogenization driver's random start iterate (the reference's rand!,
homogenized_coefficients.jl:246-248) is drawn from ``default_rng(seed)``.
With a seed two calls give the same sigma to the bit; with ``seed=None``
(the default, as in the JAX package) each call draws its own start, so two
calls agree only to the stopping tolerance. This is why the per-step
driver's sigma of chip_smoke.py phase 20c, called without a seed, differed
between runs; the phase now passes one. On the CPU, float64, the
per-step driver of BASELINE config 4's kind at a small size."""

import numpy as np
import pytest
import torch

from homogenization_jl_tpu_torch import checkerboard_homogenization
from homogenization_jl_tpu_torch.models.checkerboard import (
    compute_boundary_layer,
    compute_box_radius,
    generate_conductivity,
)


def _call(inner, seed):
    n, dim = 1, 2
    R0 = compute_box_radius(0, n) + compute_boundary_layer(1.0, n)
    field = generate_conductivity(dim, 2 * R0, np.random.default_rng(7))
    smoother = "chebyshev" if inner == "pcg" else "cg"
    return checkerboard_homogenization(
        n, dim=dim, refinements=2, cond_field=field, dtype=torch.float64, tolerance=1e-8,
        shrink=False, inner=inner, smoother=smoother, coarse="mg", seed=seed, device="cpu")


@pytest.mark.parametrize("inner", ["pcg", "vcycle"])
def test_driver_with_a_seed_is_bitwise_repeatable(inner):
    a, b = _call(inner, 7), _call(inner, 7)
    assert a.hex() == b.hex()


def test_driver_without_a_seed_agrees_to_the_tolerance():
    ref = _call("pcg", 7)
    for _ in range(2):
        assert abs(_call("pcg", None) - ref) <= 1e-6 * abs(ref)
