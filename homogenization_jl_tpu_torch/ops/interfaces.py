"""Constraint and base-grid transfer ops (device, PyTorch).

Port of the parts of homogenization_jl_tpu/ops/interfaces.py that the
structured solver path uses: apply_mask, copy_to_base and distribute. The
general-mesh gather combine (combine_gather_rows) is not ported yet.
"""

from __future__ import annotations

import torch


def apply_mask(x, mask):
    """Zero Dirichlet constraint / first-copy selection as a mask multiply.

    Reference: apply_constraint! (src/implicit_fine_grid.jl:94-139),
    zero_out_all_but_one! (:334-386).
    """
    return x * mask


def copy_to_base(b, base_elements, n_base_nodes: int):
    """Accumulate the duplicated-layout rhs onto global base-mesh nodes.

    Equivalent to broadcast_interfaces! followed by taking the first copy
    (reference: vcycle! coarsest branch, src/multigrid.jl:75-81): summing all
    copies directly gives the same vector by linearity.
    b: [E, N] -> [n_base_nodes].
    """
    u = torch.zeros(n_base_nodes, dtype=b.dtype, device=b.device)
    return u.index_add_(0, base_elements.reshape(-1), b.reshape(-1))


def distribute(u, base_elements):
    """Scatter a global base-node vector to the duplicated layout
    (reference: distribute!, src/implicit_fine_grid.jl:178-202)."""
    return u[base_elements]
