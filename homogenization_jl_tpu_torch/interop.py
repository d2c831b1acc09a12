"""Carry solver state across from the JAX package as numpy arrays.

The parity tests feed both packages identical state: the JAX solver's
coefficients, coarse factor, lambda_max estimate, per-level operator stacks,
prolongations and right-hand side, exported with ``np.asarray``, are loaded
into the port's solver here. This module imports no JAX.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class SolverState(NamedTuple):
    coeff: torch.Tensor  # [E, P]
    chol: torch.Tensor  # coarse Cholesky factor (lower)
    lam_max: float
    b: torch.Tensor | None  # [E, n_local(finest)] local rhs


def solver_state_from_numpy(
    solver, *, coeff, chol, lam_max, stacks=None, P_up=None, b=None
) -> SolverState:
    """Load numpy state into ``solver`` (a torch MultigridSolver).

    ``stacks`` ([nlevels] of [P, n, n]) and ``P_up`` ([nlevels] of
    [n_k, n_{k-1}], None at level 0) overwrite the solver's level tensors
    in place of its own setup; ``coeff``, ``chol``, ``lam_max`` and ``b``
    come back as a SolverState on the solver's device and dtype."""
    dev, dt = solver.device, solver.dtype

    def tens(a):
        return torch.tensor(np.asarray(a), dtype=dt, device=dev)

    def same_shape(name, new, old):
        if new.shape != old.shape:
            raise ValueError(f"{name}: shape {tuple(new.shape)}, expected {tuple(old.shape)}")
        return new

    if stacks is not None:
        if len(stacks) != solver.nlevels:
            raise ValueError(f"stacks: {len(stacks)} levels, expected {solver.nlevels}")
        for k, (L, s) in enumerate(zip(solver.levels, stacks)):
            L.stack = same_shape(f"stacks[{k}]", tens(s), L.stack)
            L.diag_ref = torch.diagonal(L.stack, dim1=1, dim2=2).contiguous()
    if P_up is not None:
        if len(P_up) != solver.nlevels or P_up[0] is not None:
            raise ValueError("P_up: one entry per level, None at level 0")
        for k in range(1, solver.nlevels):
            L = solver.levels[k]
            L.P_up = same_shape(f"P_up[{k}]", tens(P_up[k]), L.P_up)
    # level tensors changed: drop the cached inverse diagonals
    solver._dinv_key = solver._dinv = None
    return SolverState(
        coeff=tens(coeff),
        chol=tens(chol),
        lam_max=float(np.asarray(lam_max)),
        b=None if b is None else tens(b),
    )
