"""Kernels K13 (multishift CG's per-shift update), K14 (the multishift
recurrence's Jacobi CG step, M-inner product and basis passes) and K17
(the st1 field's spectral filter and exp(alpha |f|)) against their plain
PyTorch forms.

On the card (the ``cuda`` marker; skipped without one; run there with
``python -m pytest tests/test_torch_multishift_kernels.py -q --noconftest``),
float32 and float64:
  * K13 bitwise equal to its plain form at k == 0 and k > 0, a D == 0
    guard included;
  * K14a bitwise equal to its plain form (x, r, z and both dots; the dots
    also bitwise equal to K5's), two launches equal;
  * K14b (K9's DOT_M mode) within 1e-12 (float64) / 1e-5 (float32)
    relative of its plain form (the row sums round in another order);
  * K14c's combination and accumulation bitwise equal to their plain
    forms and to each other, with more rows than one launch takes, on a
    ragged N, a misaligned view and m = 1;
  * K17a within 1e-6 and K17b within 4e-6 relative of their plain forms
    (libdevice's pow and exp against PyTorch's);
  * multishift CG and the multishift recurrence on the card launch K13 and
    K14 and give the CPU's results within 1e-10.
On the CPU: the wrappers take the plain path and count no launch."""

import numpy as np
import pytest
import torch

from homogenization_jl_tpu_torch.csrc.build import LAUNCHES
from homogenization_jl_tpu_torch.ops import apply as t_apply
from homogenization_jl_tpu_torch.ops import integrals as t_int
from homogenization_jl_tpu_torch.ops import multishift as t_ms
from homogenization_jl_tpu_torch.ops import recurrence as t_rec
from homogenization_jl_tpu_torch.utils import fft_field as t_ff

DTYPES = [torch.float32, torch.float64]
KERNELS = ("multishift_update", "jacobi_cg", "mass_dot", "basis_combine", "spectral_filter",
           "exp_abs")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA and Triton kernels)")
    return torch.device("cuda")


def _bits(t):
    return t.contiguous().view(torch.int32 if t.element_size() == 4 else torch.int64)


def _inputs(dev, dtype, shape=(37, 45), seed=0):
    g = np.random.default_rng(seed)
    return lambda *s: torch.as_tensor(g.standard_normal(s or shape)).to(dtype).to(dev)


def _step_inputs(dev, dtype, zero_D):
    r = _inputs(dev, dtype)
    ns = 3
    shifts = torch.tensor([1.0, 0.5, 0.25], dtype=dtype, device=dev)
    D_prev = r(ns) + 2
    if zero_D:
        D_prev[1] = 0
    return (r(), r(ns, 37, 45), r(ns, 37, 45), shifts, r(1)[0].clone(), r(1)[0].clone(), D_prev,
            r(ns))


def test_wrappers_take_plain_path_without_counting():
    before = {k: LAUNCHES[k] for k in KERNELS}
    v, W, xs, shifts, tc, tp, D, y = _step_inputs("cpu", torch.float64, False)
    t_ms.multishift_step(v, W, xs, shifts, tc, tp, D, y, False)
    r = _inputs("cpu", torch.float64)
    w = torch.rand(37, 45) < 0.7
    t_rec.jacobi_cg_step(r(), r(), r(), r(), r().abs(), w, tc, tp)
    t_rec.basis_combine(r(5, 37, 45), r(3, 5))
    t_rec.basis_accumulate(r(3, 37, 45), r(), r(3), first=False)
    t_int.dot_M(r(), r(), r(45, 45), r(37))
    F = torch.fft.rfftn(torch.randn(8, 8))
    t_ff.exp_abs(torch.fft.irfftn(t_ff.spectral_filter(F, (8, 8)), s=(8, 8)), 3.0)
    assert {k: LAUNCHES[k] for k in KERNELS} == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ["first", "later", "D-zero"])
def test_multishift_step_kernel_equals_plain(cuda, dtype, case):
    v, W, xs, shifts, tc, tp, D, y = _step_inputs(cuda, dtype, case == "D-zero")
    first = case == "first"
    Wp, xsp = W.clone(), xs.clone()
    Dp, yp = t_ms.multishift_step_plain(v, Wp, xsp, shifts, tc, tp, D, y, first)
    n0 = LAUNCHES["multishift_update"]
    Dk, yk = t_ms.multishift_step(v, W, xs, shifts, tc, tp, D, y, first)
    torch.cuda.synchronize()
    assert LAUNCHES["multishift_update"] == n0 + 1
    for a, b in ((Dk, Dp), (yk, yp), (W, Wp), (xs, xsp)):
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_jacobi_cg_step_kernel_equals_plain(cuda, dtype):
    from homogenization_jl_tpu_torch.ops.dots import dot

    r = _inputs(cuda, dtype, shape=(311, 97))
    x, res, p, Ap = r(), r(), r(), r()
    d = r().abs() + 0.5
    w = torch.as_tensor(np.random.default_rng(1).random((311, 97)) < 0.7, device=cuda)
    num, den = r(1)[0].clone(), r(1)[0].clone()
    outs = []
    for _ in range(2):
        xk, rk = x.clone(), res.clone()
        z, rz, rs = t_rec.jacobi_cg_step(xk, rk, p, Ap, d, w, num, den)
        outs.append((xk, rk, z, rz, rs))
    xp, rp = x.clone(), res.clone()
    zp, rzp, rsp = t_rec.jacobi_cg_step_plain(xp, rp, p, Ap, d, w, num, den)
    torch.cuda.synchronize()
    for a, b in zip(outs[0], (xp, rp, zp, rzp, rsp)):
        assert torch.equal(_bits(a), _bits(b))
    for a, b in zip(outs[0], outs[1]):
        assert torch.equal(_bits(a), _bits(b))
    assert torch.equal(_bits(outs[0][3]), _bits(dot(outs[0][1], outs[0][2], mask=w)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_jacobi_cg_first_step_kernel_equals_plain(cuda, dtype):
    """K14a's first step from zero: x unread (x_zero), r kept, r_out
    written; bitwise equal to its plain form."""
    r = _inputs(cuda, dtype, shape=(311, 97), seed=2)
    res, p, Ap = r(), r(), r()
    d = r().abs() + 0.5
    w = torch.as_tensor(np.random.default_rng(3).random((311, 97)) < 0.7, device=cuda)
    num, den = r(1)[0].clone(), r(1)[0].clone()
    xk = torch.full_like(res, float("nan"))
    rk, rok = res.clone(), torch.empty_like(res)
    outs = (xk, rok) + t_rec.jacobi_cg_step(xk, rk, p, Ap, d, w, num, den, rok, True)
    xp, rop = torch.empty_like(res), torch.empty_like(res)
    ref = (xp, rop) + t_rec.jacobi_cg_step_plain(xp, res.clone(), p, Ap, d, w, num, den, rop, True)
    torch.cuda.synchronize()
    assert torch.equal(_bits(rk), _bits(res))
    for a, b in zip(outs, ref):
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_dot_M_kernel_close_to_plain(cuda, dtype):
    r = _inputs(cuda, dtype, shape=(500, 35))
    M = r(35, 35)
    M = (M + M.T).contiguous()
    u, v, detJ = r(), r(), r(500).abs()
    k = t_int.dot_M(u, v, M, detJ, table=t_apply.stack_table(M[None]))
    p = t_int.sigma_integral_plain(t_int.DOT_M, v, M, u, detJ, None)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    scale = float((detJ[:, None] * (u * (v @ M.T)).abs()).sum())
    assert abs(float(k) - float(p)) <= tol * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_basis_kernels_equal_plain(cuda, dtype):
    r = _inputs(cuda, dtype, shape=(53, 35))
    m, K = 13, 11  # K > MAXK: two launches
    V, Y = r(m, 53, 35), r(K, m)
    out = t_rec.basis_combine(V, Y)
    ref = t_rec.basis_combine_plain(V, Y)
    sums = torch.empty_like(out)
    Yt = Y.T.contiguous()
    for j in range(m):
        t_rec.basis_accumulate(sums, V[j], Yt[j], first=j == 0)
    torch.cuda.synchronize()
    assert torch.equal(_bits(out), _bits(ref))
    assert torch.equal(_bits(sums), _bits(ref))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m, K, N, offset", [
    (13, 3, 999, 0),   # N not a multiple of the 16-byte vector: entry by entry
    (9, 2, 4096, 1),   # a view one entry off a 16-byte boundary
    (13, 11, 1000, 0),  # K > MAXK: two launches
    (1, 3, 1024, 0),   # one basis vector
    (20, 3, 4096, 0),  # the vector path, a remainder after the unrolled rows
], ids=["ragged", "misaligned", "K>MAXK", "m=1", "vector"])
def test_basis_kernels_edge_shapes(cuda, dtype, m, K, N, offset):
    """K14c's combination and accumulation bitwise equal to their plain
    forms, and the accumulation over j equal to the combination, on the
    shapes that leave the 16-byte path or split the launch."""
    g = np.random.default_rng(m * 1000 + N)
    flat = torch.as_tensor(g.standard_normal(m * N + offset)).to(dtype).to(cuda)
    V = flat[offset:].view(m, N)
    Y = torch.as_tensor(g.standard_normal((K, m))).to(dtype).to(cuda)
    out = t_rec.basis_combine(V, Y)
    ref = t_rec.basis_combine_plain(V, Y)
    sums = torch.empty_like(out)
    Yt = Y.T.contiguous()
    for j in range(m):
        t_rec.basis_accumulate(sums, V[j], Yt[j], first=j == 0)
    torch.cuda.synchronize()
    assert torch.equal(_bits(out), _bits(ref))
    assert torch.equal(_bits(sums), _bits(out))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 16), (8, 8, 8), (32, 32, 32)])
def test_field_kernels_close_to_plain(cuda, shape):
    noise = torch.randn(shape, generator=torch.Generator().manual_seed(0)).to(cuda)
    F = torch.fft.rfftn(noise).contiguous()
    fk = t_ff.spectral_filter(F, shape, 1.5)
    fp = t_ff.spectral_filter_plain(F, shape, 1.5)
    assert float((fk - fp).abs().max()) <= 1e-6 * float(fp.abs().max())
    f = torch.fft.irfftn(fp, s=shape).contiguous()
    ek = t_ff.exp_abs(f, 100.0)
    ep = t_ff.exp_abs_plain(f, 100.0)
    assert float((ek / ep - 1).abs().max()) <= 4e-6


@pytest.mark.cuda
def test_multishift_paths_on_the_card_match_the_cpu(cuda):
    from homogenization_jl_tpu_torch.models.multishift import (
        homogenization_multishift,
        multishift_demo,
    )

    kw = dict(dim=2, refinements=1, lanczos_iters=30, seed=3, return_stats=True)
    s_cpu, st_cpu = homogenization_multishift(1, device="cpu", **kw)
    for two_pass in (False, True):
        before = {k: LAUNCHES[k] for k in KERNELS}
        s, st = homogenization_multishift(1, device=cuda, two_pass=two_pass, **kw)
        for k in ("jacobi_cg", "mass_dot", "basis_combine"):
            assert LAUNCHES[k] > before[k], k
        assert abs(s - s_cpu) <= 1e-10 * abs(s_cpu)
        assert st["lanczos_iters"] == st_cpu["lanczos_iters"]
    n0 = LAUNCHES["multishift_update"]
    worst, res = multishift_demo(dim=2, n=3, levels=2, n_shifts=3, iters=120, device=cuda)
    assert LAUNCHES["multishift_update"] == n0 + 120
    assert worst < 1e-6 and (res < 1e-6).all()
