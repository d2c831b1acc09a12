"""The port's Poisson demo (models/poisson.py) against the JAX package's in
3D, float64 on the CPU: ``checkerboard_hypercube_multigrid`` on
tests/test_multigrid.py:18's 3D case (n = 2, 3 levels, coarse "chol", 12
cycles), by tests/test_torch_poisson.py's bars. A file of its own: the JAX
compile takes most of it."""

import numpy as np

from homogenization_jl_tpu.models import poisson as jp
from homogenization_jl_tpu_torch.models import poisson as tp

TOL = 1e-10


def _close_histories(ht, hj, tol=TOL):
    ht, hj = np.asarray(ht), np.asarray(hj)
    assert ht.shape == hj.shape
    assert np.abs(ht - hj).max() <= tol * hj[0], (ht, hj)


def test_checkerboard_multigrid_3d_matches_jax():
    hj, xj, _ = jp.checkerboard_hypercube_multigrid(2, dim=3, refinements=2, max_cycles=12)
    ht, xt, _ = tp.checkerboard_hypercube_multigrid(2, dim=3, refinements=2, max_cycles=12,
                                                    device="cpu")
    _close_histories(ht, hj)
    xj = np.asarray(xj)
    assert np.abs(xt.numpy() - xj).max() <= TOL * np.abs(xj).max()
    assert ht[-1] < 1e-4 * ht[0]
