#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (homogenization_jl_tpu_torch).

Runs the port's main path on one NVIDIA card and checks every hand kernel
on it. Phases (each prints one line; any failure raises, and the script
then exits non-zero without the final line):

  1. require a CUDA card; print its name and power limit (nvidia-smi);
  2. build K1/K2 with nvcc from csrc/ into build/kernels/, warm up K3;
  3. every kernel against its plain PyTorch version on the card, at the
     main path's shapes (every level n = 4..969, E = 196,608), float32 and
     float64; the kernel and plain times at the finest float32 shape;
  4. a small float64 solve through the kernels against scipy's sparse
     direct solve of the explicitly refined operator;
  5. the main path at full size: the 3D checkerboard on
     hypercube(3, 32, order="type"), 5 levels (190,513,152 DOFs), float32,
     MultigridSolver(smoother="chebyshev", coarse="chol"),
     solve(method="auto", tol=1e-4) = FMG start + V-cycle-preconditioned CG,
     with every kernel's launch count over that solve;
then one JSON line with the kernels, and last the device JSON line.

Usage: python3 chip_smoke.py            (one card, full size)
       python3 chip_smoke.py --n 16     (a smaller base, for rehearsals)
       python3 chip_smoke.py --profile DIR
                                        (also trace one PCG iteration with
                                         torch.profiler; the kernel table
                                         goes to DIR/profile_pcg_iter.txt)
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

KERNELS = {
    "element_apply": dict(
        route="cuda",
        source="homogenization_jl_tpu_torch/csrc/element_apply.cu",
        replaces="homogenization_jl_tpu/ops/apply.py:28",
    ),
    "structured_combine": dict(
        route="cuda",
        source="homogenization_jl_tpu_torch/csrc/structured_combine.cu",
        replaces="homogenization_jl_tpu/ops/structured.py:622",
    ),
    "chebyshev_update": dict(
        route="triton",
        source="homogenization_jl_tpu_torch/ops/chebyshev.py",
        replaces="homogenization_jl_tpu/solver/multigrid.py:727",
    ),
}


def check(cond, msg):
    """Fail the phase (a check that survives python -O, unlike assert)."""
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def say(phase, **kw):
    print(f"phase {phase}: " + json.dumps(kw, default=float), flush=True)


def cuda_ms(fn, reps, warmup=1):
    """Mean device milliseconds of fn() over ``reps`` runs (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def problem(hz, n, nlevels, seed=0):
    """The bench problem: base mesh, checkerboard sigma, local unit rhs."""
    from homogenization_jl_tpu_torch.fem.local_operators import load_vector
    from homogenization_jl_tpu_torch.mesh.grid import affine_maps
    from homogenization_jl_tpu_torch.models.checkerboard import (
        conductivity_per_element,
        generate_conductivity,
    )

    base = hz.hypercube(3, n, order="type")
    rng = np.random.default_rng(seed)
    sigma = conductivity_per_element(base, generate_conductivity(3, n, rng), np.zeros(3))
    plan = hz.build_grid_plan(base, nlevels, slot_tables=False)
    b_ref = load_vector(plan.reference.levels[nlevels - 1])
    _, _, detJ, _ = affine_maps(base)
    return base, sigma, plan, detJ[:, None] * b_ref[None, :]


# --------------------------------------------------------------------- #
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------- #
def _bits(t):
    import torch

    return t.contiguous().view(torch.int32 if t.element_size() == 4 else torch.int64)


def copies_bitwise_equal(y, plan, k):
    """True when every copy of every shared DOF of y (combined, [E, n]) has
    the same bits, checked on the plan's owner tables."""
    import torch

    lay = plan.reference.layout[k]
    lp = plan.levels[k]
    for tabs, offsets, width in (
        (lp.gather.face, lay.face_offsets, lay.npf),
        (lp.gather.edge, lay.edge_offsets, lay.npe),
        (lp.gather.corner, lay.corner_cols, 1),
    ):
        if tabs is None or width == 0:
            continue
        oe, ol, om, _ = (torch.as_tensor(np.asarray(a), device=y.device) for a in tabs)
        cols = torch.as_tensor(np.asarray(offsets), device=y.device)[ol.long()]
        cols = cols[..., None] + torch.arange(width, device=y.device)
        vals = y[oe.long()[..., None], cols]  # [G, M, width]
        first = vals[:, :1].expand_as(vals)
        vals = torch.where(om[..., None] > 0, vals, first)
        if not torch.equal(_bits(vals), _bits(first)):
            return False
    return True


def check_kernels(solver, plan, coeff64, dev):
    """Phase 3. Returns {kernel: (max_abs_err, ms, plain_ms)} at the finest
    float32 shape and a per-level report."""
    import torch

    from homogenization_jl_tpu_torch.ops import apply as k_apply
    from homogenization_jl_tpu_torch.ops import chebyshev as k_cheb
    from homogenization_jl_tpu_torch.ops import structured as k_st

    g = torch.Generator(device=dev).manual_seed(1234)
    top = solver.nlevels - 1
    E = plan.base.nelements
    report = {"element_apply": [], "structured_combine": [], "chebyshev_update": []}
    timing = {}
    for dtype in (torch.float32, torch.float64):
        f32 = dtype == torch.float32
        coeff = coeff64.to(dtype)
        for k in range(solver.nlevels):
            n = plan.n_local(k)
            L = solver.levels[k]
            stack = L.stack.to(dtype)
            x = torch.randn((E, n), generator=g, device=dev, dtype=dtype)
            b = torch.randn((E, n), generator=g, device=dev, dtype=dtype)

            # K1: relative norm error (a 7n-term sum in another order)
            ref = k_apply.element_apply_plain(x, coeff, stack, b=b)
            got = k_apply.element_apply(x, coeff, stack, b=b)
            rel = float(torch.linalg.norm(got - ref) / torch.linalg.norm(ref))
            tol = 1e-5 if f32 else 1e-12
            check(rel <= tol, f"K1 level {k} {dtype}: rel err {rel} > {tol}")
            report["element_apply"].append((str(dtype)[6:], n, rel))
            if f32 and k == top:
                timing["element_apply"] = (
                    float((got - ref).abs().max()),
                    cuda_ms(lambda: k_apply.element_apply(x, coeff, stack, b=b), 3),
                    cuda_ms(lambda: k_apply.element_apply_plain(x, coeff, stack, b=b), 3),
                )
            del ref, got

            # K2: all three modes, <= 1e-6 vs plain, copies bitwise equal
            st = L.structured
            worst = 0.0
            for mode in ("combine", "fold", "constrain"):
                if mode == "constrain":
                    ref = k_st.constrain_structured_plain(x, st)
                    got = k_st.constrain_structured(x, st)
                else:
                    c = mode == "fold"
                    ref = k_st.combine_structured_plain(x, st, constrain=c)
                    got = k_st.combine_structured(x, st, constrain=c)
                err = float((got - ref).abs().max() / ref.abs().max())
                check(err <= 1e-6, f"K2 {mode} level {k} {dtype}: rel err {err}")
                if mode == "combine":
                    check(copies_bitwise_equal(got, plan, k), f"K2 copies differ, level {k}")
                worst = max(worst, err)
                del ref, got
            report["structured_combine"].append((str(dtype)[6:], n, worst))
            if f32 and k == top:
                ref = k_st.combine_structured_plain(x, st, constrain=True)
                got = k_st.combine_structured(x, st, constrain=True)
                timing["structured_combine"] = (
                    float((got - ref).abs().max()),
                    cuda_ms(lambda: k_st.combine_structured(x, st, constrain=True), 10),
                    cuda_ms(lambda: k_st.combine_structured_plain(x, st, constrain=True), 3),
                )
                del ref, got

            # K3: fused update against the plain one on the same inputs
            dinv = torch.rand((E, n), generator=g, device=dev, dtype=dtype)
            ab = torch.tensor([0.37, 1.9], dtype=dtype, device=dev)
            worst = 0.0
            rc = x.neg()
            for first in (True, False):
                xr, pr = x.clone(), b.clone()
                xk, pk = x.clone(), b.clone()
                k_cheb.chebyshev_update_plain(xr, pr, rc, dinv, ab, first)
                k_cheb.chebyshev_update(xk, pk, rc, dinv, ab, first=first)
                for a, r in ((xk, xr), (pk, pr)):
                    err = float((a - r).abs().max() / r.abs().max())
                    check(err <= 1e-6, f"K3 level {k} {dtype} first={first}: {err}")
                    worst = max(worst, err)
            report["chebyshev_update"].append((str(dtype)[6:], n, worst))
            if f32 and k == top:
                timing["chebyshev_update"] = (
                    float((xk - xr).abs().max()),
                    cuda_ms(lambda: k_cheb.chebyshev_update(xk, pk, rc, dinv, ab), 10),
                    cuda_ms(lambda: k_cheb.chebyshev_update_plain(xr, pr, rc, dinv, ab, False), 10),
                )
            del x, b, dinv, xr, pr, xk, pk, rc
            torch.cuda.empty_cache()
    return timing, report


# --------------------------------------------------------------------- #
# phase 4: small float64 solve against a sparse direct solve
# --------------------------------------------------------------------- #
def small_solve_error(hz, dev):
    import scipy.sparse.linalg as spl
    import torch

    from homogenization_jl_tpu_torch.fem.assembly import assemble_operator
    from homogenization_jl_tpu_torch.fem.local_operators import load_vector
    from homogenization_jl_tpu_torch.mesh.grid import affine_maps, interior_nodes
    from homogenization_jl_tpu_torch.models.checkerboard import (
        conductivity_per_element,
        generate_conductivity,
    )

    n, nlevels = 4, 3
    base, sigma, plan, b = problem(hz, n, nlevels, seed=1)
    solver = hz.MultigridSolver(plan, dtype=torch.float64, device=dev,
                                smoother="chebyshev", coarse="chol")
    x, hist = solver.solve(torch.as_tensor(b, device=dev), sigma, 0.0, tol=1e-10)
    check(hist[-1] <= 1e-10, hist)

    fine = hz.refine_uniformly(base, times=nlevels - 1)
    field = generate_conductivity(3, n, np.random.default_rng(1))
    sigma_f = conductivity_per_element(fine, field, np.zeros(3))
    A = assemble_operator(fine, sigma_f, 0.0)
    bf = load_vector(fine)
    ii = interior_nodes(fine)
    u = np.zeros(fine.nnodes)
    u[ii] = spl.spsolve(A[np.ix_(ii, ii)].tocsc(), bf[ii])

    # map the duplicated solution onto fine nodes by exact coordinates
    J, shift, _, _ = affine_maps(base)
    refn = plan.reference.levels[nlevels - 1].nodes
    allx = (np.einsum("eij,nj->eni", J, refn) + shift[:, None, :]).reshape(-1, 3)

    def key(a):
        return (
            np.ascontiguousarray(np.round(a * 2**20).astype(np.int64))
            .view([("", np.int64)] * 3)
            .ravel()
        )

    fk = key(fine.nodes)
    order = np.argsort(fk)
    mapping = order[np.searchsorted(fk[order], key(allx))]
    xs = x.cpu().numpy().reshape(-1)
    return float(np.abs(u[mapping] - xs).max() / np.abs(u).max()), len(hist) - 2


def profile_pcg_iteration(step, out):
    """Trace one PCG iteration: device time by kernel and the device busy
    share of the iteration's wall time. The full table goes to
    out/profile_pcg_iter.txt."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for ev in prof.key_averages():
        # device-side events only (kernels, copies): the CPU-side ops that
        # launched them carry the same device time again
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dt = ev.self_device_time_total
        if dt > 0:
            rows.append((ev.key[:80], dt / 1e3, ev.count))
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "profile_pcg_iter.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=40))
    say("profile", wall_ms=wall * 1e3, device_busy_ms=busy,
        idle_share=1.0 - busy / (wall * 1e3), top=rows[:12])


# --------------------------------------------------------------------- #
def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=32, help="cubes per axis of the base")
    ap.add_argument("--profile", metavar="DIR",
                    help="trace one PCG iteration with torch.profiler; "
                    "write the kernel table into DIR")
    args = ap.parse_args(argv)

    # ---- phase 1: the card -------------------------------------------
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only on the card")
    sys.path.insert(0, ROOT)
    import homogenization_jl_tpu_torch as hz
    from homogenization_jl_tpu_torch.csrc import build as kbuild
    from homogenization_jl_tpu_torch.ops.chebyshev import chebyshev_update

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(1, device=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
        nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)

    # ---- phase 2: build ------------------------------------------------
    t0 = time.perf_counter()
    kbuild.kernels_lib()
    t_nvcc = time.perf_counter() - t0
    xw = torch.zeros(4096, device=dev)
    chebyshev_update(xw, xw.clone(), xw.clone(), xw.clone(),
                     torch.ones(2, device=dev), first=True)
    torch.cuda.synchronize()
    ptxas = [ln.strip() for ln in kbuild.BUILD_LOG.splitlines()
             if "registers" in ln or "spill" in ln]
    say(2, nvcc_s=t_nvcc, triton_warmup_s=time.perf_counter() - t0 - t_nvcc,
        ptxas=ptxas)

    # ---- host setup of the main path (used by phases 3 and 5) ----------
    t0 = time.perf_counter()
    base, sigma, plan, b_np = problem(hz, args.n, 5, seed=0)
    t_plan = time.perf_counter() - t0
    solver = hz.MultigridSolver(plan, dtype=torch.float32, device=dev,
                                smoother="chebyshev", coarse="chol")
    t_setup = time.perf_counter() - t0
    dofs = plan.base.nelements * plan.n_local(4)

    # ---- phase 3: kernels vs plain ----------------------------------
    from homogenization_jl_tpu_torch.fem.local_operators import element_coefficients

    coeff64 = torch.as_tensor(element_coefficients(base, sigma, 0.0), device=dev)
    timing, report = check_kernels(solver, plan, coeff64, dev)
    del coeff64
    kbuild.reset_launches()  # comparison launches do not count
    say(3, ok=True, per_level=report,
        finest_f32={k: dict(max_abs_err=v[0], ms=v[1], plain_ms=v[2])
                    for k, v in timing.items()})

    # ---- phase 4: small float64 solve vs scipy --------------------------
    err, its = small_solve_error(hz, dev)
    check(err <= 1e-7, f"small f64 solve: rel err {err} vs spsolve")
    kbuild.reset_launches()
    say(4, ok=True, rel_err_vs_spsolve=err, pcg_iters=its)

    # ---- phase 5: the main path -----------------------------------------
    b = torch.as_tensor(b_np, device=dev, dtype=torch.float32)
    del b_np
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kbuild.reset_launches()
    t0 = time.perf_counter()
    x, hist = solver.solve(b, sigma, 0.0, tol=1e-4, method="auto", max_cycles=30)
    torch.cuda.synchronize()
    t_solve = time.perf_counter() - t0
    launches = dict(kbuild.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    check(all(v > 0 for v in launches.values()), f"a kernel never ran: {launches}")
    check(x.shape == b.shape and bool(torch.isfinite(x).all()), "non-finite solution")
    check(hist[-1] < 1e-4, f"relative residual {hist[-1]} >= 1e-4")
    pcg_iters = len(hist) - 2
    check(pcg_iters <= 20, f"{pcg_iters} PCG iterations > 20")

    def iters_to(tol):
        return next((i - 1 for i in range(1, len(hist)) if hist[i] < tol), None)

    # timing of the cycle and of one PCG iteration (after the solve)
    coeff = solver.coefficients(sigma, 0.0)
    chol = solver.coarse_setup(sigma, 0.0)
    lam_max = solver.estimate_lambda_max(coeff)
    xv = torch.zeros_like(b)
    sec_vcycle = cuda_ms(
        lambda: solver._vcycle_impl(xv, b, coeff, chol, lam_max), 5) / 1e3
    state = list(solver._pcg_init_impl(torch.zeros_like(b), b, coeff, chol, lam_max))

    def pcg_step():
        state[:] = solver._pcg_step_impl(*state[:4], coeff, chol, lam_max)

    sec_iter = cuda_ms(pcg_step, 5) / 1e3
    if args.profile:
        profile_pcg_iteration(pcg_step, args.profile)
    say(5, ok=True, dofs=dofs, history=hist, iters_to_1e3=iters_to(1e-3),
        iters_to_1e4=iters_to(1e-4), solve_wall_s=t_solve,
        sec_per_vcycle=sec_vcycle, sec_per_pcg_iter=sec_iter,
        vcycle_dof_per_s=dofs / sec_vcycle, pcg_dof_per_s=dofs / sec_iter,
        max_memory_allocated=peak, host_plan_s=t_plan,
        host_setup_s=t_setup, launches=launches, card=smi)

    kernels = [
        dict(name=name, **meta, launches=launches[name],
             max_abs_err=timing[name][0], ms=timing[name][1],
             plain_ms=timing[name][2])
        for name, meta in KERNELS.items()
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
