"""The solver's state-sized elementwise passes (device, PyTorch + CUDA
kernel K18).

Replaces the elementwise expressions of homogenization_jl_tpu/solver/
multigrid.py that XLA fuses into passes on the TPU (the mask multiply
itself is ``ops/interfaces.py::apply_mask``, on the same kernel):

  * ``mul(a, b)``: a * b, the Lanczos matvec's ``dinv * y`` (:580);
  * ``lanczos_update(u, v, w, alpha, beta)``: u - alpha v - beta w, the
    three-term update (:610), alpha and beta 0-d device tensors; w=None
    for the first step, u - alpha v: the bits of the JAX form's update
    from a zero v_prev, with no zero buffer;
  * ``div_nz(v, s)``: v / (s == 0 ? 1 : s), the normalizations (:604,
    :612), s a 0-d device tensor;
  * ``inv_positive(d)``: 1 / d where d > 0, else 0, the Jacobi inverse
    diagonal (:575, :690);
  * ``diagonal(coeff, diag_ref)``: d[e, m] = sum_p coeff[e, p]
    diag_ref[p, m], the assembled diagonal before its combine (the einsum
    of :547), summed in piece order from +0.

Kernel K18 (csrc/elementwise.cu) runs for CUDA tensors, one entry per
pass, each product, sum and quotient rounded on its own: it gives the bits
of the plain form (the JAX expression in PyTorch), which runs for CPU
tensors. The scalars never reach the host. The diagonal's kernel stages a
window of diag_ref's columns in shared memory and walks groups of rows
(its one-piece form stores through a tile); its C entry plans the launches
(one on every path of the port: a window that shared memory holds) and
refuses more than 8 pieces.
"""

from __future__ import annotations

import torch

from ..csrc.build import LAUNCHES, launch

_DTYPES = {torch.float32: 0, torch.float64: 1}


def mul_plain(a, b):
    return a * b


def lanczos_update_plain(u, v, w, alpha, beta):
    y = u - alpha * v
    return y if w is None else y - beta * w


def div_nz_plain(v, s):
    return v / torch.where(s == 0, torch.ones_like(s), s)


def inv_positive_plain(d):
    pos = d > 0
    return torch.where(pos, 1.0 / torch.where(pos, d, torch.ones_like(d)), torch.zeros_like(d))


def diagonal_plain(coeff, diag_ref):
    acc = torch.zeros((coeff.shape[0], diag_ref.shape[1]), dtype=coeff.dtype, device=coeff.device)
    for p in range(coeff.shape[1]):
        acc = acc + coeff[:, p : p + 1] * diag_ref[p]
    return acc


def route(fn, ref, tensors=(), scalars=()):
    """Check the operands of ``fn`` against ``ref`` (dtype, shape, device,
    contiguity; ``scalars`` 0-d of ref's dtype and device) and return True
    for the kernel (CUDA tensors) or False for the plain form (CPU)."""
    if not isinstance(ref, torch.Tensor) or ref.dtype not in _DTYPES:
        raise TypeError(f"{fn}: unsupported operand {getattr(ref, 'dtype', type(ref))}")
    for name, t in tensors:
        if t.dtype != ref.dtype or t.shape != ref.shape or t.device != ref.device:
            raise ValueError(f"{fn}: {name} does not match the first operand")
    for name, t in (("first operand", ref),) + tuple(tensors):
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
    for name, t in scalars:
        if t.dtype != ref.dtype or t.dim() != 0 or t.device != ref.device:
            raise ValueError(f"{fn}: {name} must be a 0-d tensor like the first operand")
    if ref.device.type == "cpu":
        return False
    if ref.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {ref.device}")
    return True


def run(entry, dtype, *args):
    """Launch one K18 entry on the current stream, counted."""
    LAUNCHES["elementwise"] += 1
    launch(entry, _DTYPES[dtype], *args)


def mul(a, b):
    """a * b (one shape). K18 for CUDA tensors, the plain form for CPU."""
    if not route("mul", a, [("b", b)]):
        return mul_plain(a, b)
    out = torch.empty_like(a)
    run("hz_ew_mul", a.dtype, a.data_ptr(), b.data_ptr(), out.data_ptr(), a.numel())
    return out


def lanczos_update(u, v, w, alpha, beta, out=None):
    """u - alpha * v - beta * w (u - alpha * v when w is None), each product
    and difference rounded on its own; ``out`` may be ``u``."""
    tensors = [(name, t) for name, t in (("v", v), ("w", w), ("out", out)) if t is not None]
    if not route("lanczos_update", u, tensors, [("alpha", alpha), ("beta", beta)]):
        y = lanczos_update_plain(u, v, w, alpha, beta)
        return y if out is None else out.copy_(y)
    out = torch.empty_like(u) if out is None else out
    run("hz_ew_lanczos", u.dtype, u.data_ptr(), v.data_ptr(),
        None if w is None else w.data_ptr(), alpha.data_ptr(),
        beta.data_ptr(), out.data_ptr(), u.numel())
    return out


def div_nz(v, s, out=None):
    """v / s, or v where s == 0; ``out`` may be ``v``."""
    tensors = [("out", out)] if out is not None else []
    if not route("div_nz", v, tensors, [("s", s)]):
        y = div_nz_plain(v, s)
        return y if out is None else out.copy_(y)
    out = torch.empty_like(v) if out is None else out
    run("hz_ew_div_nz", v.dtype, v.data_ptr(), s.data_ptr(), out.data_ptr(), v.numel())
    return out


def inv_positive(d):
    """1 / d where d > 0, else 0 (the Jacobi inverse diagonal)."""
    if not route("inv_positive", d):
        return inv_positive_plain(d)
    out = torch.empty_like(d)
    run("hz_ew_inv_positive", d.dtype, d.data_ptr(), out.data_ptr(), d.numel())
    return out


def diagonal(coeff, diag_ref):
    """[E, n] = sum_p coeff[:, p, None] * diag_ref[p] for coeff [E, P] and
    diag_ref [P, n], in piece order from +0."""
    kern = route("diagonal", coeff)
    if coeff.dim() != 2 or diag_ref.dim() != 2 or diag_ref.shape[0] != coeff.shape[1]:
        raise ValueError(f"diagonal: coeff {tuple(coeff.shape)}, diag_ref {tuple(diag_ref.shape)}")
    if diag_ref.dtype != coeff.dtype or diag_ref.device != coeff.device or not diag_ref.is_contiguous():
        raise ValueError("diagonal: diag_ref must be a contiguous tensor like coeff")
    if not kern:
        return diagonal_plain(coeff, diag_ref)
    E, P = coeff.shape
    n = diag_ref.shape[1]
    out = torch.empty((E, n), dtype=coeff.dtype, device=coeff.device)
    if out.numel() == 0:
        return out
    run("hz_ew_diagonal", coeff.dtype, coeff.data_ptr(), diag_ref.data_ptr(), out.data_ptr(),
        E, P, n)
    return out
