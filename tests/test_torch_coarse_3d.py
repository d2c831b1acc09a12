"""The solver-parity tests of tests/test_torch_coarse.py on its 3D
configuration, hypercube(3, 4, "type") with 3 levels, for coarse="inv" and
"cg" (coarse="mg" is in test_torch_coarse_mg3d.py): separate files let the
test workers compile the JAX programs side by side."""

import pytest

from test_torch_coarse import (  # noqa: F401  (collected here with this module's pair)
    CONFIGS,
    IDS,
    make_pair,
    test_coarse_setup_matches_jax,
    test_fmg_matches_jax,
    test_pcg_history_matches_jax,
    test_solve_iterations_match_jax,
    test_vcycle_matches_jax,
)


@pytest.fixture(scope="module", params=["inv", "cg"], ids=[f"{IDS[0]}-{k}" for k in ("inv", "cg")])
def pair(request):
    return make_pair(CONFIGS[0], request.param)
