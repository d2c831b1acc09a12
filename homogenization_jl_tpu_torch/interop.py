"""Carry solver state across from the JAX package as numpy arrays.

The parity tests feed both packages identical state: the JAX solver's
coefficients, coarse payload, lambda_max estimate, per-level operator
stacks, prolongations and right-hand side, exported with ``np.asarray``,
are loaded into the port's solver here. The coarse payload follows the JAX
``coarse_setup``: the Cholesky factor ("chol"), the interior inverse
("inv"), nothing ("cg"), or for "mg" a mapping with the JAX dict's ``coeff``,
``chol`` (the aux inverse), ``lam_max``, ``lam_max0`` and ``dinv_g`` plus the
aux solver's ``stacks`` and ``P_up``. This module imports no JAX.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class SolverState(NamedTuple):
    coeff: torch.Tensor  # [E, P]
    chol: object  # coarse payload: tensor, None ("cg") or MGCoarseSetup
    lam_max: float
    b: torch.Tensor | None  # [E, n_local(finest)] local rhs


def _loader(solver):
    dev, dt = solver.device, solver.dtype

    def tens(a):
        return torch.tensor(np.asarray(a), dtype=dt, device=dev)

    return tens


def _same_shape(name, new, old):
    if new.shape != old.shape:
        raise ValueError(f"{name}: shape {tuple(new.shape)}, expected {tuple(old.shape)}")
    return new


def load_levels(solver, stacks=None, P_up=None) -> None:
    """Overwrite the solver's per-level stacks ([nlevels] of [P, n, n]) and
    prolongations ([nlevels] of [n_k, n_{k-1}], None at level 0)."""
    tens = _loader(solver)
    if stacks is not None:
        if len(stacks) != solver.nlevels:
            raise ValueError(f"stacks: {len(stacks)} levels, expected {solver.nlevels}")
        for k, (L, s) in enumerate(zip(solver.levels, stacks)):
            L.stack = _same_shape(f"stacks[{k}]", tens(s), L.stack)
            L.diag_ref = torch.diagonal(L.stack, dim1=1, dim2=2).contiguous()
    if P_up is not None:
        if len(P_up) != solver.nlevels or P_up[0] is not None:
            raise ValueError("P_up: one entry per level, None at level 0")
        for k in range(1, solver.nlevels):
            L = solver.levels[k]
            L.P_up = _same_shape(f"P_up[{k}]", tens(P_up[k]), L.P_up)
    # level tensors changed: drop the caches built from them
    solver.drop_caches()


def coarse_setup_from_numpy(solver, chol):
    """The port's coarse payload from the JAX package's, as numpy."""
    tens = _loader(solver)
    if solver.coarse_kind in ("chol", "inv"):
        return tens(chol)
    if solver.coarse_kind == "cg":
        return None
    aux = solver.aux_solver
    load_levels(aux, chol["stacks"], chol["P_up"])
    return solver.mg_setup(
        coeff=tens(chol["coeff"]),
        inv=tens(chol["chol"]),
        lam_max=float(np.asarray(chol["lam_max"])),
        lam_max0=float(np.asarray(chol["lam_max0"])),
        dinv_g=tens(chol["dinv_g"]),
    )


def solver_state_from_numpy(
    solver, *, coeff, chol, lam_max, stacks=None, P_up=None, b=None
) -> SolverState:
    """Load numpy state into ``solver`` (a torch MultigridSolver).

    ``stacks`` and ``P_up`` overwrite the solver's level tensors in place of
    its own setup (``load_levels``); ``coeff``, the coarse payload ``chol``
    (``coarse_setup_from_numpy``), ``lam_max`` and ``b`` come back as a
    SolverState on the solver's device and dtype."""
    tens = _loader(solver)
    load_levels(solver, stacks, P_up)
    return SolverState(
        coeff=tens(coeff),
        chol=coarse_setup_from_numpy(solver, chol),
        lam_max=float(np.asarray(lam_max)),
        b=None if b is None else tens(b),
    )
