"""``solve(method="auto", tol=1e-8)`` of tests/test_torch_smoothers.py on the
3D configuration hypercube(3, 4, "type") with 3 levels and coarse="chol":
equal iteration counts in both packages (a file of its own, so that the
test workers compile the JAX solves beside the cycle tests of
test_torch_smoothers_3d.py)."""

import pytest

from test_torch_smoothers import CONFIG_3D, SMOOTHERS, check_solve_auto, make_pair


@pytest.mark.parametrize("smoother", SMOOTHERS)
def test_solve_auto_iterations_match_jax_3d(smoother):
    check_solve_auto(make_pair(CONFIG_3D, smoother))
