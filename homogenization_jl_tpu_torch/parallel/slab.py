"""Slab-sharded multigrid on structured boxes (the 1e9-DOF design).

Port of homogenization_jl_tpu/parallel/slab.py. ``SlabShardedMultigridSolver``
splits the element axis of a cube-major full-box hypercube plan into
contiguous x-plane slabs, one per rank of a ``SlabGroup`` (parallel/
group.py: one process per device, SPMD over torch.distributed, as JAX's
``shard_map`` over a 1D mesh), and inherits the whole single-device solver
(every smoother and coarse solve, V/W-cycles, FMG, PCG, ``pcg_stepper``,
``solve``) by overriding the same primitives as the JAX class:

  * ``_combine`` / ``_constrain`` / ``_combine_constrained``: one exchange
    of the ``pad`` edge planes of tail columns with each neighbour, then
    kernel K11 (ops/structured.py::combine_structured_slab) on the
    halo-extended slab; the constraint needs no halo;
  * ``_sum_partial``: ``SlabGroup.sum``, which the base class applies to
    the rank's partials: the K5 dots of ``_vdot``, the K7 segment sum of
    ``_to_global``, and the level-0 lattice weights and assembly (K6 over
    the rank's ``_lattice_window`` of planes); the coarse solves then run
    replicated.

Each rank's element-leading tensors (coefficients, first-copy and boundary
masks, base element rows, states) hold only its E/S rows, cut on the host
before they reach the device (``rows_of``). ``put``, ``zero_states``,
``coefficients``, ``combine`` and ``constrain`` take or return the rank's
rows; ``interop.slab_rows`` / ``join_slabs`` cut and join global arrays.

Mixed-precision PCG (solver/multigrid.py::mixed_precision_pcg) takes two
slab solvers on one group, as the JAX class's ``_mixed_pcg_programs``
(JAX parallel/slab.py:343-383): the same init and step run through this
class's primitives, so the float64 Krylov state stays sharded, the
multiplicity-rescaled downcast (K15) follows the halo-extended combine
(K11), and every dot sums over the ranks.

Requirements (asserted as in JAX): a ``hypercube(order="cube")`` base, a
slab count dividing the cube count n, W = n / S planes per slab at least
the orbit radius ``pad``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.interfaces import apply_mask
from ..ops.plan import GridPlan
from ..ops.structured import (
    combine_structured_slab,
    constrain_structured_slab,
    detect_structured,
    slab_halo_rows,
)
from ..solver.multigrid import MultigridSolver, _mixed_pcg_impls, _require
from .group import SlabGroup


class SlabShardedMultigridSolver(MultigridSolver):
    """MultigridSolver over a ``SlabGroup``; rank r holds the element rows
    of x-planes [r W, (r + 1) W). Every rank calls the same methods in the
    same order (SPMD); replicated results are bitwise equal on every rank.
    The solver's device is the group's."""

    def __init__(self, plan: GridPlan, group: SlabGroup, dtype=torch.float32, **kwargs):
        if not isinstance(group, SlabGroup):
            raise TypeError(f"group must be a SlabGroup, got {type(group).__name__}")
        if torch.device(kwargs.pop("device", group.device)) != group.device:
            raise ValueError("the slab solver runs on its group's device")
        kwargs.setdefault("combine", "structured")
        if kwargs["combine"] != "structured":
            raise ValueError("slab sharding requires the structured combine")
        det = detect_structured(plan.base)
        if det is None:
            raise ValueError(
                "slab sharding requires a structured (full-box hypercube) base; "
                "any other base takes the gather-sharded solver "
                "(parallel/sharding.py::ShardedMultigridSolver)"
            )
        n, ept, order = det
        if order != "cube":
            raise ValueError(
                "slab sharding requires hypercube(order='cube'): contiguous "
                "x-plane slabs; order='type' interleaves planes across types"
            )
        S = group.size
        if n % S:
            raise ValueError(f"slab count {S} must divide the cube count {n}")
        self.group = group
        self.n_shards = S
        self.W = n // S
        self.x0 = group.rank * self.W
        rows = self.W * n ** (plan.base.dim - 1) * ept
        self._rows = slice(group.rank * rows, (group.rank + 1) * rows)
        self._lattice_window = (self.x0, self.W)
        super().__init__(plan, dtype=dtype, device=group.device, **kwargs)
        pad = max(L.structured.sc.pad for L in self.levels)
        if self.W < pad:
            raise ValueError(f"slab width {self.W} must cover the orbit radius {pad}")

    # -- overridden primitives ---------------------------------------------- #
    def _sum_partial(self, t):
        return self.group.sum(t)

    def _slab_combine(self, x, k, constrain=False, mask=None):
        """Exchange the edge planes' tail columns with the neighbours (none
        at the domain ends), then K11 on the halo-extended slab."""
        st = self.levels[k].structured
        h = slab_halo_rows(st.sc)
        g = self.group
        halo_lo, halo_hi = g.exchange(
            x[:h, st.i0:].contiguous() if g.has_lo else None,
            x[-h:, st.i0:].contiguous() if g.has_hi else None,
        )
        return combine_structured_slab(
            x, halo_lo, halo_hi, st, self.x0, self.W, constrain=constrain, mask=mask
        )

    def _combine(self, x, k):
        return self._slab_combine(x, k)

    def _constrain(self, x, k, Ls=None):
        bm = self._bmask(k, Ls)
        if bm is None:
            return constrain_structured_slab(x, self.levels[k].structured, self.x0, self.W)
        return apply_mask(x, bm)

    def _combine_constrained(self, x, k, Ls=None):
        bm = self._bmask(k, Ls)
        if bm is None:
            return self._slab_combine(x, k, constrain=True)
        return self._slab_combine(x, k, mask=bm)

    def _mixed_pcg_programs(self, inner):
        """The mixed-precision PCG's init and step on slabs (the
        single-device impls through this class's primitives), after the
        JAX class's checks of the pair."""
        _require(isinstance(inner, SlabShardedMultigridSolver),
                 "the slab outer needs a slab inner (same plan, same mesh)")
        _require(inner.group is self.group, "solvers must share one device mesh")
        return _mixed_pcg_impls(self, inner)

    # -- public state helpers ----------------------------------------------- #
    def put(self, a):
        """This rank's rows of a global element-leading host array, on the
        solver's device in its dtype."""
        rows = np.ascontiguousarray(self.rows_of(np.asarray(a)), dtype=self._np_dtype)
        return torch.as_tensor(rows, device=self.device)

    def constrain(self, x, k=None):
        """Zero-Dirichlet constraint of the rank's rows at level k."""
        k = self.nlevels - 1 if k is None else k
        return self._constrain(x, k)
