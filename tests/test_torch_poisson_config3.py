"""BASELINE config 3 (BASELINE.json configs[2]: 3D Poisson, the Tet64 base,
3 refinements) through the port's Poisson demo against the JAX package's,
float64 on the CPU: ``checkerboard_hypercube_multigrid(2, dim=3,
refinements=3, max_cycles=12)``, the history within 1e-10 x the first of
JAX's (tests/test_torch_poisson.py's bar), the JAX test's contraction bar.
A file of its own: the JAX compile at 3 refinements takes most of it."""

import numpy as np
import torch

from homogenization_jl_tpu.models import poisson as jp
from homogenization_jl_tpu_torch.models import poisson as tp

TOL = 1e-10


def _close_histories(ht, hj, tol=TOL):
    ht, hj = np.asarray(ht), np.asarray(hj)
    assert ht.shape == hj.shape
    assert np.abs(ht - hj).max() <= tol * hj[0], (ht, hj)


def test_baseline_config3_matches_jax():
    hj, _, _ = jp.checkerboard_hypercube_multigrid(2, dim=3, refinements=3, max_cycles=12)
    ht, xt, s = tp.checkerboard_hypercube_multigrid(2, dim=3, refinements=3, max_cycles=12,
                                                    device="cpu")
    assert tuple(xt.shape) == (48, 165) and bool(torch.isfinite(xt).all())
    _close_histories(ht, hj)
    assert ht[-1] < 1e-4 * ht[0]
