"""The cycle parity tests of tests/test_torch_smoothers.py on the 3D
configuration: hypercube(3, 4, "type") with 3 levels and coarse="chol"
(the bench's element order). Its solve(method="auto") test is in
test_torch_smoothers_3d_solve.py."""

import pytest

from test_torch_smoothers import (
    CONFIG_3D,
    SMOOTHERS,
    check_cycle,
    check_history,
    make_pair,
)


@pytest.fixture(scope="module", params=SMOOTHERS)
def pair(request):
    return make_pair(CONFIG_3D, request.param)


@pytest.fixture(scope="module", params=["cg", "cg_exact"])
def wpair(request):
    return make_pair(CONFIG_3D, request.param, cycle="W")


def test_vcycle_matches_jax_3d(pair):
    check_cycle(pair)


def test_vcycle_history_matches_jax_3d(pair):
    check_history(pair)


def test_wcycle_matches_jax_3d(wpair):
    check_cycle(wpair)
