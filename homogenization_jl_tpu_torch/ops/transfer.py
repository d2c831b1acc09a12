"""Grid transfer: prolongation / restriction (device, PyTorch).

Port of homogenization_jl_tpu/ops/transfer.py. The per-level prolongation
P_k is [n_{k+1}, n_k] (identity prefix + half/half midpoint rows, see
mesh/reference.py); batched over base elements both transfers are single
dense matmuls, left to ``torch.matmul`` as the JAX package leaves its
einsums to XLA. A hand gather kernel (at most 2 nonzeros per fine row) is
later work.

Float32 matmuls on CUDA must not round through TF32 (about three decimal
digits): the flag below is PyTorch's default, set here explicitly because
the solver's restriction residuals depend on it.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False


def prolong_add(x_fine, x_coarse, P):
    """x_fine + x_coarse @ P^T  (reference: xk += P x_{k-1})."""
    return x_fine + torch.matmul(x_coarse, P.T)


def restrict(r_fine, P):
    """P^T r, batched: [E, n_f] @ [n_f, n_c] (reference: b_{k-1} = P' r_k)."""
    return torch.matmul(r_fine, P)
