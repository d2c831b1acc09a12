"""The solver-parity tests of tests/test_torch_coarse.py on its 3D
configuration, hypercube(3, 4, "type") with 3 levels and coarsening depth
m = 1, for coarse="mg" (coarse_mg_tol=1e-12): the JAX package's V-cycle,
FMG and PCG programs with the aux-hierarchy coarse solve compile for ~100 s,
so they get a file (a test worker) of their own."""

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


@pytest.fixture(scope="module", ids=[f"{IDS[0]}-mg"], params=["mg"])
def pair(request):
    return make_pair(CONFIGS[0], request.param)
