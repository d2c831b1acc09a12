#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (homogenization_jl_tpu_torch).

Runs the port's main paths on one NVIDIA card and checks every hand kernel
on it. Phases (each prints one line; any failure raises, and the script
then exits non-zero without the final line):

  1. require a CUDA card; print its name and power limit (nvidia-smi);
  2. build the CUDA kernels (every one but the Triton ones: K3 and K16's
     Chebyshev update; one nvcc per source, started together) from csrc/ into
     build/kernels/, warm up K3 (Triton); the wrappers' raw stream is
     PyTorch's current stream;
  3. every kernel against its plain PyTorch version on the card, at the
     main path's shapes, float32 and float64: K1-K5 and K10 at every level
     (K1 over each level's row table of nonzeros, ops/apply.py)
     (n = 4..969, E = 196,608; K4 prolong_add bitwise equal to the dense
     product, K5 bitwise equal on two launches and to its plain form, on a
     misaligned view as on its aligned copy, K10 bitwise equal to its
     plain form, den == 0 included); K6 on the 33^3 lattice of the
     type-major base (apply bitwise equal to its plain form in every mask /
     b form); K7 on the base's 786,432 -> 35,937
     segment sum, the aux hierarchy's cube-major 98,304 -> 4,913 one, and
     the aux transfers ([24576, 10]); the kernel, plain and library times
     at the float32 shapes (K5's plain dot, K6's apply and K7's segment sum
     per call, medians of 5 rounds in turns with torch.dot, CSR mv and
     index_add_; K5's mask, scale and float64 forms beside them); the
     segment sum bitwise equal on two launches; K2's fold, combine and
     constraint at the finest float32 shape in turns with a copy of the
     same bytes; (3c) the device times of
     K6's apply and K7's segment sum beside CSR mv's (the sum of cuSPARSE's
     kernels) and index_add_'s, and of K17a and K17b at 32^3 beside an
     empty kernel launched through the same ctypes launcher (the launch
     floor, csrc/launch_floor.cu), from one torch.profiler session in a child
     process (its first session: later sessions of a process lost kernel
     records, and one before phase 15b's costs that one its coverage):
     medians of 5 rounds, each timing them in turns; before that session,
     K17's and the floor's ms per call in that fresh process (phase 19
     times them again late in this one, after its profiler sessions);
     at the finest shape (E = 196,608, n = 969), float32 and float64, every
     entry of K18 (the mask, the Lanczos scale, three-term update, first
     step and normalization, the Jacobi inverse, the diagonal), K10's r_out
     and x_zero forms, K3's x_zero form and K1's mask store (apply and
     residual forms) bitwise equal to their plain forms, with times and
     bounds (K1's and K9's operations: their nonzero work); K1's library
     time (one einsum of the same function); K18's diagonal in float32 and
     float64 at every level, and its one-piece form at config 4's [48000,
     969] float64 (the mass solves' Jacobi diagonal), bitwise equal to its
     plain form at each of these shapes (the coarse levels of _dinv_all
     and lam_max too: the narrow-row walk) and timed in turns
     with torch.matmul of the same function (medians, quartiles) beside
     its bound;
 3b. the driver's kernels against their plain versions, float32 and
     float64: K9 (sigma integrals, all forms, both reference_quirk
     branches) at E = 196,608, n = 969, bitwise equal on two launches, the
     area form (no row partials: the sum in K5's order alone) bitwise equal
     to its plain form; K8
     (gather combine, with and without its mask) at the finest level of
     the ordered 3D base ordered_hypercube(3, 16) (196,608 tets, n = 969),
     at every level of the 2D base of phase 8 and at config 4's finest
     level ([48000, 969], float64), bitwise equal to the plain form with
     every copy of a shared DOF bitwise equal; K8 with the boundary mask
     timed in turns with a copy of the same state (medians and quartiles)
     at the 3D shape in float32 and float64 and at config 4's, each with
     its bound, and the design kept; the masked K2 fold at n = 969,
     bitwise equal to the plain combine times the mask;
  4. small float64 solves through the kernels against scipy's sparse
     direct solve of the explicitly refined operator, 3 levels each:
     Chebyshev with coarse="chol" on hypercube(3, 4) and coarse="mg" on
     hypercube(3, 8); smoother="cg", "cg_exact" and a W-cycle ("cg_exact")
     with coarse="chol" on hypercube(3, 4);
  5. the main path at full size: the 3D checkerboard on
     hypercube(3, 32, order="type"), 5 levels (190,513,152 DOFs), float32,
     MultigridSolver(smoother="chebyshev", coarse="mg",
     coarse_mg_tol=5e-2), solve(method="auto", tol=1e-4) = FMG start +
     V-cycle-preconditioned CG, as the JAX package's bench.py runs it: every
     kernel's launch count over that solve, the coarse-PCG iterations per
     coarse solve, the host syncs of a solve, and a second solve whose
     history and solution must be bitwise equal to the first;
  6. the same problem at n = 16 (23,814,144 DOFs) with coarse="chol" (the
     dense Cholesky coarse solve);
  7. the flagship driver at full size, as scripts/run_flagship.py calls it,
     through the port's entry point (run_flagship.flagship; its JSON line
     is printed): checkerboard_homogenization(2, dim=3, refinements=4, geometry=
     "lattice", float32, tolerance=1e-4, seed=7, coarse="mg", smoother=
     "chebyshev", inner="pcg", coarse_mg_tol=5e-2): 190,513,152 DOFs, one
     outer step; sigma within 1e-3 of the TPU record 1.2947696447 (7 PCG
     iterations; ACCURACY.md) in at most 14 PCG iterations; the launches of
     K18's diagonal (setup only) beside the kernels' counts;
  8. the 2D recurrence with a shrink, checkerboard_homogenization(5, dim=2,
     refinements=4, float64, tolerance=1e-8, chebyshev, pcg, coarse="mg",
     seed=3), with geometry="ordered" (the gather combine K8, the mask
     constraint, a plan and solver per step) and "lattice" (the masked K2
     fold, the masked coarse solve): two steps each (radius 56, then 55),
     the two sigmas within 50 x tolerance; then the same call with the
     driver's defaults (ordered, smoother="cg", inner="vcycle",
     coarse="chol"), its sigma within 50 x tolerance of the ordered
     Chebyshev one;
  9. the JAX bench's vcycle mode (bench.py, BENCH_SOLVE_MODE=vcycle) at
     full size: phase 5's problem with MultigridSolver(float32,
     smoother="cg_exact", coarse="mg", coarse_mg_tol=5e-2,
     smooth_precision="high"), solve(method="vcycle", tol=1e-3,
     max_cycles=30), twice (bitwise equal), then the same in float64:
     1e-2 within 13 cycles and below 1e-3 within 30 in both, float32
     within 5% of float64 while float64 is above 2e-2; seconds per
     V-cycle, peak memory; and, as a control, the float32 solve with K1's
     residual form unshifted (b - A x summed as is), which stalls above
     1e-3, and the error of both forms' fresh residual against float64;
 10. the flagship driver with FLAGSHIP_INNER=vcycle, as
     scripts/run_flagship.py calls it (run_flagship.flagship, its line
     printed): phase 7's call with
     smoother="cg_exact", inner="vcycle"; sigma within 1e-3 of the TPU
     record 1.2947099209 (12 cycles; ACCURACY.md) in at most 24 cycles;
 11. K11, the slab combine, at full size: the main-path problem in cube
     order (hypercube(3, 32, order="cube"), 5 levels, 190,513,152 DOFs)
     cut into S = 1, 4 and 8 slabs (W = 32, 8 and 4 planes; S = 1 is the
     shape phases 12 and 13 launch); on every slab, at every level in
     float32 and at the finest in float64, K11 with halos cut from the full
     state equals K2 on the full state's rows bit for bit in every mode
     (combine, Dirichlet fold, constraint, mask store); at the finest level
     K11 on the S = 1 slab and on the timed S = 8 shard equals its plain
     form in every mode (max abs error 0); the finest K11 timed at the
     S = 8 shard shape against its plain form, and at S = 1 (phase 13's
     shape) in turns with K2's fold on the same rows (medians, quartiles);
 12. parallel/run_slab.py through an NCCL group of one rank (a FileStore in
     a temporary directory), at scripts/run_slab_big.py's configuration on
     the cube-order base at n = 16: float32, Chebyshev, coarse="chol", 3
     V-cycles and
     the integral, and the single-device leg on the same plan: with one
     rank both legs do the same arithmetic, so the residual histories and
     the integral must be equal (with more ranks: integral within 5e-4 and
     each cycle's contraction rate within 2%); the residual histories'
     largest relative difference and both legs' peak memory;
 13. the flagship through the slab: phase 7's call with device_mesh= the
     group of phase 12 (cube order); sigma within 1e-3 of 1.2947696447 in
     at most 14 PCG iterations, its seconds per iteration beside phase
     7's and their ratio;
 14. K12, the gather-sharded combine, at full size: the ordered 3D base
     ordered_hypercube(3, 16) (196,608 tets, 5 levels, 190,513,152 DOFs)
     cut into S = 1, 4 and 8 blocks of rows in one process: on every rank
     K8 on the rank's owner tables, then the cross partials, added in rank
     order as SlabGroup.sum adds them, then the scatter; at every level in
     float32 and at the finest in float64, with and without the boundary
     mask, the joined result bitwise equal to K12's plain forms, every copy
     of a shared DOF bitwise equal, and within 1e-6 (float32) / 1e-13
     (float64) relative of K8 on the full state (the sums' order differs
     across shards); the cross slots per level; K12 timed at an S = 8
     shard (the K8 part, and the fix-up in turns with its plain form and
     pass by pass in device time from CUDA-graph replays) against its
     plain forms, its bound counting every table it reads, beside the
     first design's formula; the comparisons' launches, which are not the
     path's (15d has those);
 15. the gather-sharded solver through the group of phase 12: (a) 3 PCG
     iterations of ShardedMultigridSolver and of MultigridSolver on the
     ordered 3D base one level below the flagship (4 levels, 32,440,320
     DOFs) from the same rhs (float32, Chebyshev, the coarse
     kind the ordered driver picks), the residual histories equal; (b) the
     flagship call of phase 7 with geometry="ordered" and device_mesh= the
     group (190,513,152 DOFs, one outer step; coarse_mg_tol=5e-2): sigma
     within 5e-3 (50 x tolerance, the JAX suite's bar between geometries)
     of 1.2947696447 in at most 14 PCG iterations, its seconds per
     iteration beside phase 7's; (c) torch.profiler's kernel table of one
     PCG iteration of phase 5 (taken after the group is destroyed: a
     profiler session after the first one, with an NCCL group alive, lost
     a prefix of its step) and of the PCG step of one driver iteration
     of (b), top 15 by device time, each read only when its kernels, with
     the device's waits on the host (the idle a faster step shows), cover
     0.9 of the CUDA-event time of the same call (each profiles up to 4
     iterations, (b) from its second, until one is covered), with no
     PyTorch elementwise kernel above 20 us per launch on
     average, the device's waits on the host, and one K5 kernel per K5
     call (18 and 20e report and hold the same); (d) the ordered driver through
     the gather-sharded solver on 2 spawned ranks that share the card
     through a gloo group (NCCL refuses two ranks on one card), two
     levels below the flagship (refinements=2, 6,881,280 DOFs) in float64,
     tolerance 1e-6: the ranks' sigma bitwise equal, within 1e-8 relative
     of the single-device driver's, and every kernel of the ordered path
     launched on every rank, K12's cross-shard kernels included;
 16. K15 and K16 at the finest main-path shape (E = 196,608, n = 969):
     K15's downcast (with and without the scale) and upcast, and every K16
     variant (K1's apply, residual and masked forms; K3's first, x_zero
     and later steps; K5 with and without the mask and the scale; K10's
     step forms and its direction store) for bfloat16 and float16
     directions under float32 and float64 states and float32 under
     float64, each bitwise equal to its plain form; K15's three forms
     bitwise equal to .to() (and the product) at an odd N and on views one
     entry in; their times (float32 state, bfloat16 direction), and K1 and
     K2 in float64; K15's downcast and upcast in turns with the one .to()
     call each computes (no call casts and scales; its scaled downcast
     with quartiles);
 17. (a) ``python -m homogenization_jl_tpu_torch.bench`` in a subprocess at
     its defaults (190,513,152 DOFs): its last line parses with the
     metric and every detail key, 6 / 8 PCG iterations to 1e-3 / 1e-4
     within 1 (BENCH_r05.json); (b) phase 5's solve with
     direction_dtype="bfloat16": 7 / 9 within 1 (the JAX record,
     PERFORMANCE.md:803-806), seconds per PCG iteration beside phase 5's,
     then three cg_exact V-cycles with bfloat16 directions (K16's dot and
     CG forms on their path);
 18. mixed-precision PCG at 190,513,152 DOFs: run_mixed_pcg's pair (outer
     float64, inner float32 Chebyshev, coarse="mg", coarse_mg_tol=5e-2)
     on phase 5's plan, tol 1e-10, keep_best: the history, 1e-6 within 14
     iterations (the CPU record crossed at 13, ACCURACY.md), seconds per
     iteration between CUDA events after two warm-up iterations, setup
     seconds, peak memory, the returned x's float64 residual recomputed
     from scratch at most 1e-6, and one step under torch.profiler by phase
     15c's rules; (18b) the same solve on slabs (run_slab's "mixed" job)
     through an NCCL group of one rank at n = 8 (2,976,768 DOFs), its
     history and x equal to the single-device leg's;
 19. K13, K14 and K17 against their plain forms, float32 and float64 (K17
     float32), at the shapes of phases 20 and 21: K13 on [3, 48000, 969]
     at k == 0 and k > 0 with a D == 0 guard, bitwise; K14a (the Jacobi CG
     step of the mass solves) on [48000, 969], bitwise, two launches equal;
     K14b (K9's DOT_M mode, on config 4's finest mass matrix) within phase
     3b's K9 bars, repeatable; K14c's
     one-pass combination (m = 120 basis vectors, K + 1 = 3 rows) and
     two-pass accumulation, bitwise, the combination timed in turns with
     torch.matmul of the same function and the accumulation beside its
     bound, in float64 and float32, with a copy of eight basis vectors (the
     card's stream rate); K17a / K17b (CUDA, csrc/fft_field.cu) on the
     32^3 field of phase 21 within 1e-6 / 4e-6 relative, their times per
     call in turns with the launch floor's (CUDA events over 20 calls:
     the host's launch cost included); the kernel, plain and library
     times (float64; K17 float32) and bounds; and K1's mass apply (the
     one-piece stack [M], coefficient detJ, masked) at [48000, 969]
     float64 against its plain form, timed beside cuBLAS's dense GEMM and
     cuSPARSE's CSR product of the same M;
 20. BASELINE config 4: checkerboard_homogenization(1, dim=3,
     refinements=4) on ordered_hypercube(3, 10) (48,000 tets, 46,512,000
     DOFs), float64, the field generate_conductivity(3, 20,
     default_rng(7)): (a) solver="multishift" with 120 Lanczos vectors
     (sigma, apply counts, setup and Lanczos seconds, peak memory); (b)
     homogenization_multishift(two_pass=True), sigma within 1e-10 of (a);
     (c) the per-step driver (shrink=False, inner="pcg", chebyshev,
     tolerance 1e-8, its random start iterate from seed 7), twice, the
     second run's sigma and residuals bitwise equal to the first's (without
     a seed the driver draws a new start each call, so sigma moves within
     the tolerance): (a) within 1e-2 of it, or else (a) again with 188
     vectors (as many as the card holds with 10e9 bytes to spare) within
     1e-2; (d) shifted_family_solve (shifts 1, 1/2, 1/4, 150 iterations,
     K13) one level down (7,920,000 DOFs) within 1e-8 of per-shift CG (tol
     1e-12); (e) one Lanczos step of (a) under torch.profiler by phase
     15c's rules (coverage, no PyTorch elementwise kernel above 20 us per
     launch): the kernels' shares, the idle share and the host reads;
 21. the st1 contrast rescue (ACCURACY.md:153-159): st1_multigrid(32,
     dim=3, refinements=4, alpha=100, seed=3, max_cycles=40, coarse="mg",
     float32, method="pcg", chebyshev, coarse_mg_tol=5e-2) on the JAX draw
     of seed 3 (190,513,152 DOFs): contrast within 0.1% of 60,794, the
     residual 1.1e-3 within 12 PCG iterations and 3.4e-5 within 16; the
     history, seconds per PCG iteration (CUDA events), setup times, peak;
 22. the Poisson demos (models/poisson.py), float64: (a) BASELINE config 1
     as tests/test_multigrid.py:71-96 runs it (hypercube(2, 8, scale=1/8),
     3 levels, Cholesky, f = 1, V-cycles from zero): |r| <= 1e-8 within 30
     cycles; (b) BASELINE config 3, checkerboard_hypercube_multigrid(2,
     dim=3, refinements=3, max_cycles=12): |r| below 1e-4 of the first
     (the JAX test's bar); each history against the JAX package's CPU
     record (constants below) entry by entry, |h_i - j_i| <= max(1e-9 j_i,
     1e-12 j_0); (c) checkerboard_hypercube_multigrid(32, dim=3,
     refinements=4, coarse="mg", max_cycles=5) (190,513,152 DOFs) twice:
     the histories and x bitwise equal, cycle i's contraction at most 1.1 x
     cycle i's of the JAX record at n = 4 (coarse "chol"), K1, K2, K4, K5,
     K10, K6 and K7 launched; seconds per V-cycle (CUDA events), setup
     seconds, peak memory, launches;
 23. phase 8's recurrence (3.84M DOFs, float64, two outer steps) in both
     geometries with checkpoint_dir= a temporary directory and
     save_level=2, then resumed from step_0.npz: the resumed sigma and last
     residual bitwise equal to the uninterrupted run's; every .vtu re-parsed:
     E x n_local(2) points, the values the step file's x at those DOFs
     bitwise; checkerboard.vtu's cells and values; st1_multigrid(8, dim=3,
     refinements=2, float32, method="pcg", save=): its file parses with E x
     n_local(2) points and the solution's values bitwise;
 24. the entry points in child processes started together (at most 300
     s): python -m homogenization_jl_tpu_torch.run_flagship 2 1 1e-3 (its
     last line has every key of the JAX script's line); python -m
     torch.distributed.run --standalone --nproc-per-node=1 -m
     homogenization_jl_tpu_torch.parallel.run_slab --kind sharded (--cubes
     8 --levels 3 --compare) and --kind ordered_driver --coarse mg (--cubes
     1 --levels 2 --smoother chebyshev --compare): rank 0's line parses, the
     world of one equal to the single device (residual norms and x; sigma)
     and the gather-sharded path's kernels launched; profile_trace around
     one PCG iteration in a child process (``--profile-trace``): one trace
     file, naming K1's kernel;
then one JSON line with the kernels (each kernel's launches on its path:
K4, K5 and K10 on phase 10, K8 on phase 8's ordered run, K11 on phase 13,
K12's cross-shard kernels on phase 15d, summed over its ranks, K16's apply
and Chebyshev update on 17b's solve, its dot and CG forms on 17b's
cg_exact cycles, K15 on phase 18, K13 on 20d, K14 on 20a, K17 on 21, the
others on phase 7), and last the device JSON line.

Usage: python3 chip_smoke.py            (one card, full size)
       python3 chip_smoke.py --device-times
                                        (phase 3c alone: one JSON line)
       python3 chip_smoke.py --n 16     (a smaller base, for rehearsals)
       python3 chip_smoke.py --profile DIR
                                        (also write phase 5's full
                                         torch.profiler table to
                                         DIR/profile_pcg_iter.txt)
       python3 chip_smoke.py --config4-repeat
                                        (phase 20c's call twice with its
                                         seed, twice without, a digest of
                                         its library calls: one JSON line)
       python3 chip_smoke.py --profile-trace DIR
                                        (phase 24's child: one PCG
                                         iteration inside profile_trace(DIR),
                                         the trace's kernels as one JSON
                                         line)
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time
import warnings

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
    "lattice_stencil": dict(
        route="cuda",
        source="homogenization_jl_tpu_torch/csrc/lattice_stencil.cu",
        replaces="homogenization_jl_tpu/ops/stencil.py:148",
    ),
    "coarse_gather": dict(
        route="cuda",
        source="homogenization_jl_tpu_torch/csrc/coarse_gather.cu",
        replaces="homogenization_jl_tpu/solver/multigrid.py:861",
    ),
    "gather_combine": dict(
        route="cuda",
        source="homogenization_jl_tpu_torch/csrc/gather_combine.cu",
        replaces="homogenization_jl_tpu/ops/interfaces.py:85",
    ),
    "integrals": dict(
        route="cuda",
        source="homogenization_jl_tpu_torch/csrc/integrals.cu",
        replaces="homogenization_jl_tpu/models/checkerboard.py:188",
    ),
    "transfer": dict(
        route="cuda",
        source="homogenization_jl_tpu_torch/csrc/transfer.cu",
        replaces="homogenization_jl_tpu/ops/transfer.py:18",
    ),
    "masked_dot": dict(
        route="cuda",
        source="homogenization_jl_tpu_torch/csrc/dots.cu",
        replaces="homogenization_jl_tpu/solver/multigrid.py:510",
    ),
    "cg_update": dict(
        route="cuda",
        source="homogenization_jl_tpu_torch/csrc/cg_smoother.cu",
        replaces="homogenization_jl_tpu/solver/multigrid.py:765",
    ),
    "slab_combine": dict(
        route="cuda",
        source="homogenization_jl_tpu_torch/csrc/structured_combine.cu",
        replaces="homogenization_jl_tpu/ops/structured.py:902",
    ),
    "sharded_combine": dict(
        route="cuda",
        source="homogenization_jl_tpu_torch/csrc/sharded_combine.cu",
        replaces="homogenization_jl_tpu/parallel/sharding.py:376",
    ),
    "elementwise": dict(
        route="cuda",
        source="homogenization_jl_tpu_torch/csrc/elementwise.cu",
        replaces="homogenization_jl_tpu/ops/interfaces.py:58",
    ),
    # K16: the half-width direction forms of K1, K3, K5 and K10
    "direction_apply": dict(
        route="cuda",
        source="homogenization_jl_tpu_torch/csrc/element_apply_half.cu",
        replaces="homogenization_jl_tpu/solver/multigrid.py:733",
    ),
    "direction_chebyshev": dict(
        route="triton",
        source="homogenization_jl_tpu_torch/ops/chebyshev.py",
        replaces="homogenization_jl_tpu/solver/multigrid.py:743",
    ),
    "direction_dot": dict(
        route="cuda",
        source="homogenization_jl_tpu_torch/csrc/dots.cu",
        replaces="homogenization_jl_tpu/solver/multigrid.py:833",
    ),
    "direction_cg": dict(
        route="cuda",
        source="homogenization_jl_tpu_torch/csrc/cg_smoother.cu",
        replaces="homogenization_jl_tpu/solver/multigrid.py:839",
    ),
    # K15: the mixed-precision boundary
    "mixed_boundary": dict(
        route="cuda",
        source="homogenization_jl_tpu_torch/csrc/mixed_boundary.cu",
        replaces="homogenization_jl_tpu/solver/multigrid.py:1618",
    ),
    # K13: multishift CG's per-shift update
    "multishift_update": dict(
        route="cuda",
        source="homogenization_jl_tpu_torch/csrc/multishift.cu",
        replaces="homogenization_jl_tpu/solver/cg.py:90",
    ),
    # K14: the multishift recurrence's Jacobi CG step (a), M-inner product
    # (b, a mode of K9) and basis passes (c)
    "jacobi_cg": dict(
        route="cuda",
        source="homogenization_jl_tpu_torch/csrc/recurrence.cu",
        replaces="homogenization_jl_tpu/models/multishift.py:174",
    ),
    "mass_dot": dict(
        route="cuda",
        source="homogenization_jl_tpu_torch/csrc/integrals.cu",
        replaces="homogenization_jl_tpu/models/multishift.py:152",
    ),
    "basis_combine": dict(
        route="cuda",
        source="homogenization_jl_tpu_torch/csrc/recurrence.cu",
        replaces="homogenization_jl_tpu/models/multishift.py:245",
    ),
    # K17: the st1 field's spectral filter and exp(alpha |f|)
    "spectral_filter": dict(
        route="cuda",
        source="homogenization_jl_tpu_torch/csrc/fft_field.cu",
        replaces="homogenization_jl_tpu/utils/fft_field.py:44",
    ),
    "exp_abs": dict(
        route="cuda",
        source="homogenization_jl_tpu_torch/csrc/fft_field.cu",
        replaces="homogenization_jl_tpu/utils/fft_field.py:46",
    ),
}
# NVIDIA's data sheet for the H100 SXM:
# float32 outside the tensor cores, and HBM bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
# the JAX driver's flagship result on the TPU (ACCURACY.md, "Flagship
# driver"): a check on the answer, not a yardstick of speed
FLAGSHIP_SIGMA = 1.2947696447
# the same with FLAGSHIP_INNER=vcycle (the cg_exact smoother; phase 10)
FLAGSHIP_VCYCLE_SIGMA = 1.2947099209
# phase 9's bars: the bench's vcycle mode takes 11 cycles to 1e-2 in
# float32 and float64, and reaches 1e-3 within BENCH_MAX_CYCLES = 30 (the
# TPU took 19, PERFORMANCE.md; float32 needs K1's shifted residual form,
# ops/apply.py)
VCYCLE_TO_1E2 = 13
VCYCLE_MAX = 30
# scripts/run_flagship.py's call (phase 7) and phase 8's 2D recurrence
FLAGSHIP = dict(n=2, dim=3, refinements=4)
RECURRENCE_2D = dict(n=5, dim=2, refinements=4)
# K8's 3D check: the ordered base with the flagship's element count
ORDERED_3D_RADIUS = 16
# phase 11's slab counts (W = 32, 8 and 4 planes of the n = 32 box: S = 1
# is the shape phases 12 and 13 launch, and 8 slabs of 190M DOFs each make
# BASELINE config 5) and the shard it times
SLAB_COUNTS = (1, 4, 8)
SLAB_TIMED = (8, 3)
# phase 12's gates against the single-device leg (ROADMAP.md queue 1 item
# 10: measured-plus-margin, not run_slab_big.py's 1e-3 / 5%)
SLAB_INTEGRAL_TOL = 5e-4
SLAB_RATE_TOL = 0.02
# phase 14's block counts of the ordered 3D state (S = 1 is the shape phase
# 15 launches) and the shard it times
SHARD_COUNTS = (1, 4, 8)
SHARD_TIMED = (8, 3)
# K8's design (csrc/gather_combine.cu), stated in phase 3b's report
K8_DESIGN = ("group-major: a thread per (group, column of the cell), each owner read once and "
             "the sum stored to every copy; the row-major design was not built")
# phase 15b's bar between geometries: 50 x the tolerance 1e-4
# (tests/test_homogenization.py:411)
ORDERED_SIGMA_TOL = 5e-3
# phase 15c: PyTorch's own elementwise kernels may run only on small
# vectors (the global-space coarse loops' take 2-5 us); a state-sized pass
# at the finest two levels takes 80-450 us
LIBRARY_ELEMENTWISE_MAX_US = 20.0
# a profile is read only when its kernels, with the device's waits on the
# host, cover this share of the CUDA-event time of the same call
# (torch.profiler has missed half of a step's kernels on the H100;
# profile_table); phases 5 and 15b profile up to PROFILE_ATTEMPTS iterations
# for one
PROFILE_MIN_COVERAGE = 0.9
PROFILE_ATTEMPTS = 4
PROFILE_MARGIN_S = 1.0
# idle trace before the step: in profiler sessions after the process's
# first, a profile lost a prefix of its step's kernels, as if their device
# times fell before the trace's window (with 1 s of lead, prefixes of
# 0.36-0.52 s of the step went missing); attempt i waits
# PROFILE_LEAD_S * 2**i
PROFILE_LEAD_S = 2.0
# phase 17's bars: bench.py's 6 / 8 PCG iterations to 1e-3 / 1e-4
# (BENCH_r05.json), and the JAX record with bfloat16 directions, 7 / 9
# (PERFORMANCE.md:803-806), each within 1
BENCH_ITERS = (6, 8)
BENCH_BF16_ITERS = (7, 9)
BENCH_TIMEOUT_S = 420
# bench.py's detail keys (BENCH_r05.json) and the port's additions
BENCH_DETAIL_KEYS = (
    "dofs", "sec_per_vcycle", "base_elements", "n_local", "levels", "coarse", "smoother",
    "dtype", "apply_precision", "smooth_precision", "device", "residual_norm", "degraded",
    "solve_mode", "iters_to_1e3", "sec_to_1e3", "iters_to_1e4", "sec_to_1e4", "sec_per_iter",
    "dof_per_s_solve", "fmg_start_rel_residual", "power_limit", "precision_run",
    "sec_per_vcycle_repeats", "sec_per_vcycle_spread", "sec_per_iter_repeats",
    "sec_per_iter_spread")
# phase 18: run_mixed_pcg's solve at n = 32, 5 levels, tol 1e-10, keep_best;
# the CPU record crossed 1e-6 relative at iteration 13 (ACCURACY.md), the
# bar is 14; the returned x's recomputed float64 residual at most 1e-6
MIXED_ITERS = 30
MIXED_TOL = 1e-10
MIXED_1E6_WITHIN = 14
MIXED_RECOMPUTED_MAX = 1e-6
# depths cut to keep the script near 1,000 s with phases 19-21 (PERF.md
# section 4): phase 6's chol solve, phase 12's run_slab legs and phase 18b's
# slab of one at n = 16 / 16 / 8 (23,814,144 / 23,814,144 / 2,976,768
# DOFs); phase 15d one level down (SHARED_CARD_CALL)
CHOL_N = 16
SLAB_RUN_N = 16
MIXED_SLAB_N = 8
# and phase 15a one level below the flagship (4 levels, 32,440,320 DOFs)
SHARDED_PCG_LEVELS = 4
# phases 19-20: BASELINE config 4 (BASELINE.json configs[3]): the 3D
# checkerboard at n = 1 (R0 = 10: ordered_hypercube(3, 10), 48,000 tets),
# refinements = 4 (n_local 969, 46,512,000 DOFs), float64, the multishift
# recurrence with 120 Lanczos vectors (44.6 GB of basis), the field of
# scripts/run_multishift_compare.py (default_rng(7))
CONFIG4 = dict(n=1, dim=3, refinements=4)
CONFIG4_STATE = (48_000, 969)
CONFIG4_SEED = 7
CONFIG4_LANCZOS = 120
# (a) against the per-step driver (c): at most 1e-2 relative; past it, (a)
# again with as many vectors as the card holds with CONFIG4_MARGIN bytes to
# spare, held to the same bar: a vector is 0.372e9 bytes and the rest of
# (a)'s peak 4.74e9, so 188 vectors peak at 74.7e9 of the card's 85.0e9
# bytes (PERF.md: 120 vectors 6.4e-2, 160 2.1e-2, 200 2.6e-3 at a peak of
# 79.2e9); the run fails with the numbers when less than its peak is free
CONFIG4_GAP = 1e-2
CONFIG4_LANCZOS_MORE = 188
CONFIG4_MARGIN = 10e9
# (e) one Lanczos step of (a) under torch.profiler by phase 15c's rules: a
# run of CONFIG4_PROFILE_VECTORS vectors (every step does the same work),
# the window from one Lanczos update to the next
CONFIG4_PROFILE_VECTORS = 6
# (b) two-pass against one-pass
CONFIG4_TWO_PASS_TOL = 1e-10
# (d) K13 on its path: shifted_family_solve one level down (refinements =
# 3, 7,920,000 DOFs) against per-shift CG (tol 1e-12), ACCURACY.md:19's bar
SHIFTED = dict(refinements=3, shifts=(1.0, 0.5, 0.25), iters=150)
SHIFTED_TOL = 1e-8
# phase 21: the st1 contrast rescue (ACCURACY.md:153-159), scripts/
# run_st1.py's call with ST1_METHOD=pcg, 32 4 100.0 40, on the JAX draw
# of seed 3: contrast 60,794 within 0.1%, the residual 1.1e-3 within 12
# PCG iterations and 3.4e-5 within 16 (the TPU: 10 and 14 with bf16x3
# smoothing; every knob of the port runs full float32)
ST1 = dict(n=32, dim=3, refinements=4, alpha=100.0, seed=3, max_cycles=40, coarse="mg")
ST1_CONTRAST = 60_794.0
ST1_MARKS = ((1.1e-3, 12), (3.4e-5, 16))
# phase 22: the Poisson demos (models/poisson.py). The JAX package's
# histories on the CPU (float64): (a) BASELINE config 1 as
# tests/test_multigrid.py:71-96 runs it (hypercube(2, 8, scale=1/8), 3
# levels, Cholesky, f = 1, V-cycles from zero until |r| <= 1e-8); (b)
# BASELINE config 3, checkerboard_hypercube_multigrid(2, dim=3,
# refinements=3, max_cycles=12); (c)'s yardstick, the same function at
# n = 4 with refinements = 4 and max_cycles = 8 (coarse="chol": at n = 4
# the function refuses "mg", whose default dense limit does not coarsen a
# 4^3 base)
CONFIG1_JAX_HISTORY = (0.010612690556119783, 0.00023839619886641011, 1.2243331975884738e-05,
                       8.379701812230068e-07, 5.4248634679862254e-08, 3.384884626327244e-09)
CONFIG3_JAX_HISTORY = (6.021048120468745, 1.3960548217202546, 0.4164353183743639,
                       0.13615655869677326, 0.04811273375912405, 0.01682261481762168,
                       0.005364848298852324, 0.0018635672950247223, 0.0006873773397280004,
                       0.0002499024697484937, 8.242861906171413e-05, 1.9031995471951718e-05)
POISSON_N4_JAX_HISTORY = (27.654347323122725, 7.860388556810069, 3.3635396050443407,
                          1.6467368136421217, 0.8493051516739729, 0.4460817030317405,
                          0.2344763408463265, 0.12210985283463476)
# a card history entry h_i against JAX's j_i: |h_i - j_i| <= max(1e-9 j_i,
# 1e-12 j_0). Rounding differences scale with the first residual, not with
# the entry: on the CPU the port's config 1 history differs from JAX's by
# 3.5e-9 relative at its last entry (3.2e-7 of the first), 1.1e-15 of the
# first (tests/test_torch_poisson.py)
POISSON_HISTORY_REL = 1e-9
POISSON_HISTORY_FLOOR = 1e-12
# (c): hypercube(3, 32), refinements = 4 (190,513,152 DOFs), coarse="mg",
# float64, 5 cycles, run twice; cycle i's contraction at most 1.1 x that
# of the n = 4 history (the port on the CPU: n = 8 within 1% of n = 4 at
# every cycle)
POISSON_FULL = dict(n=32, dim=3, refinements=4, coarse="mg", max_cycles=5)
POISSON_RATE_MARGIN = 1.1
# K1, K2 (combine and constraint), K4, K5 and K10 on every cycle; the
# coarse solve: K7 (chol, beside the library Cholesky) or K6 and K7 (mg)
POISSON_CHOL_PATH = ("element_apply", "structured_combine", "transfer", "masked_dot",
                     "cg_update", "coarse_gather")
POISSON_MG_PATH = POISSON_CHOL_PATH + ("lattice_stencil",)
# phase 23: phase 8's recurrence with step files and VTK files of level 2,
# then resumed from step_0.npz: sigma and the last residual bitwise equal
SAVE_LEVEL = 2
# and st1_multigrid(save=) on phase 21's solve cut to an 8^3 base and 2
# refinements (its finest level is level 2: a 15 MB file; at phase 21's
# n = 32 level 2 alone is 0.95 GB of base64), its own noise draw, alpha 3
ST1_SAVE = dict(n=8, dim=3, refinements=2, seed=3, max_cycles=10, coarse="chol")
# phase 24: the entry points in child processes, started together
# (scripts/run_flagship.py's line; run_slab's sharded kinds under torchrun
# in a world of one; profile_trace in a fresh process)
ENTRY_TIMEOUT_S = 300
FLAGSHIP_LINE_KEYS = ("sigma", "sigma_steps", "cycles_per_step", "residuals", "wall_s", "n",
                      "refinements", "tolerance")
SHARDED_CLI_PATH = ("element_apply", "gather_combine", "transfer", "masked_dot", "cg_update",
                    "coarse_gather")


def bound(nbytes, flops):
    """The least time the card could take: the larger of the bytes a
    function must move over the HBM rate and its operations over the FP32
    rate (67 TFLOP/s, also the card's float64 peak, with the tensor
    cores)."""
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def entry(max_abs_err, ms, plain_ms, nbytes, flops, library_ms=None):
    """One kernel's measured numbers and its bound."""
    return dict(max_abs_err=float(max_abs_err), ms=ms, plain_ms=plain_ms,
                **bound(nbytes, flops), library_ms=library_ms)


def table_bytes(tab):
    """Bytes of a stack's row table (ops/apply.py::StackTable), which K1
    and K9 read in place of the dense stack."""
    return sum(t.numel() * t.element_size() for t in (tab.cols, tab.vals, tab.counts))


def apply_flops(E, tab):
    """K1's nonzero work: a multiply-add per element for every nonzero of
    every slice (a sparse product's bound counts the work its data needs;
    the dense [P, n, n] product is 77 times as much at n = 969)."""
    return 2 * E * tab.slice_nnz


def csr_mm_ms(mass, u, reps):
    """cuSPARSE's time for the one-piece product M u_e of every element, one
    torch.sparse.mm of the CSR mass matrix with u^T (the sparse yardstick
    of K1's mass apply and K9's mass product)."""
    import torch

    csr = mass.to_sparse_csr()
    ut = u.t().contiguous()
    return cuda_ms(lambda: torch.sparse.mm(csr, ut), reps)


def gather_table_bytes(gt):
    """Bytes of K8's owner tables (ops/interfaces.py::GatherTables), which
    it reads beside the state."""
    return sum(c.own.numel() * c.own.element_size() for c in gt.classes)


def combine_adds(plan, k, E, rows=slice(None)):
    """Owner values a combine adds at level k (on the element ``rows``):
    each output entry of a class adds its group's valid owners."""
    lay = plan.reference.layout[k]
    lp = plan.levels[k]
    total = 0
    for tabs, width in ((lp.gather.face, lay.npf), (lp.gather.edge, lay.npe),
                        (lp.gather.corner, 1)):
        if tabs is None or width == 0:
            continue
        _, _, om, gmap = (np.asarray(a) for a in tabs)
        total += int((om != 0).sum(axis=1)[gmap[rows]].sum()) * width
    return total


# the kernels each driven path must launch (K10 updates PCG too, and K18
# carries the Lanczos estimate, the Jacobi diagonal and the mask)
MAIN_PATH = ("element_apply", "structured_combine", "chebyshev_update", "lattice_stencil",
             "coarse_gather", "transfer", "masked_dot", "cg_update", "elementwise")
FLAGSHIP_PATH = MAIN_PATH + ("integrals",)
ORDERED_2D_PATH = ("element_apply", "structured_combine", "chebyshev_update", "coarse_gather",
                   "gather_combine", "integrals", "transfer", "masked_dot", "cg_update",
                   "elementwise")
LATTICE_2D_PATH = FLAGSHIP_PATH
# the CG smoothers' paths (K3 runs there as the level-0 junction smoother
# of coarse="mg")
VCYCLE_PATH = MAIN_PATH
FLAGSHIP_VCYCLE_PATH = FLAGSHIP_PATH
DEFAULTS_2D_PATH = ("element_apply", "coarse_gather", "gather_combine", "integrals",
                    "transfer", "masked_dot", "cg_update", "elementwise")
# the slab paths: run_slab (Chebyshev, coarse="chol", V-cycles) and the
# flagship through the slab (its aux hierarchy of coarse="mg" runs K2)
SLAB_RUN_PATH = ("element_apply", "slab_combine", "chebyshev_update", "coarse_gather",
                 "transfer", "masked_dot", "integrals", "elementwise")
FLAGSHIP_SLAB_PATH = FLAGSHIP_PATH + ("slab_combine",)
# the ordered flagship through the gather-sharded solver (one rank: K12 is
# K8 there, no cross groups; the ordered base is no lattice box, so no K6)
FLAGSHIP_ORDERED_PATH = ("element_apply", "chebyshev_update", "coarse_gather", "gather_combine",
                         "integrals", "transfer", "masked_dot", "cg_update", "elementwise")
# phase 17: bfloat16 directions on phase 5's path (Chebyshev: K16's apply
# and update) and on the vcycle mode's (cg_exact: K16's dot and CG forms)
BF16_CHEB_PATH = MAIN_PATH + ("direction_apply", "direction_chebyshev")
BF16_CG_PATH = ("element_apply", "structured_combine", "chebyshev_update", "lattice_stencil",
                "coarse_gather", "transfer", "masked_dot", "direction_apply", "direction_dot",
                "direction_cg")
# phase 18: mixed-precision PCG (float64 outer step, float32 V-cycle, K15
# between them); 18b: the same on slabs (K11)
MIXED_PATH = ("element_apply", "structured_combine", "chebyshev_update", "lattice_stencil",
              "coarse_gather", "transfer", "masked_dot", "cg_update", "mixed_boundary")
MIXED_SLAB_PATH = ("element_apply", "slab_combine", "chebyshev_update", "coarse_gather",
                   "transfer", "masked_dot", "cg_update", "mixed_boundary")
# phase 20: the multishift recurrence on the ordered base (the gather
# combine K8; the mass solves' K1, K5, K14a, K10; K14b, K14c; K9 for
# sigma), and (d) multishift CG (K13) with its per-shift CG references
CONFIG4_PATH = ("element_apply", "gather_combine", "masked_dot", "cg_update", "elementwise",
                "integrals", "jacobi_cg", "mass_dot", "basis_combine")
SHIFTED_PATH = ("element_apply", "gather_combine", "masked_dot", "elementwise",
                "multishift_update")
# phase 21: st1 (phase 5's solver kinds on the cube-order base, K17 for the
# field)
ST1_PATH = MAIN_PATH + ("spectral_filter", "exp_abs")


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


def graph_ms(fn, reps, calls=10):
    """Device milliseconds per call of fn(): ``calls`` calls captured in a
    CUDA graph, replayed ``reps`` times between CUDA events, so the host's
    launch cost (which exceeds a small kernel's time) is left out."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode="thread_local"):
        for _ in range(calls):
            fn()
    return cuda_ms(g.replay, reps) / calls


# repeats of a timing taken in turns (phase 3's K5, K6 and K7 against their
# library calls, phase 3c's device times): median of at least 5
TIMING_ROUNDS = 5


def turns_ms(fns, reps, rounds=TIMING_ROUNDS):
    """Median ms per call of each of ``fns`` ({label: callable}) by
    ``cuda_ms`` over ``reps`` back-to-back calls, taken in turns (a, b, b,
    a, ...) ``rounds`` times. Returns ({label: median}, {label: samples})."""
    samples = {k: [] for k in fns}
    order = list(fns)
    for _ in range(rounds):
        for k in order + order[::-1]:
            samples[k].append(cuda_ms(fns[k], reps))
    return {k: float(np.median(v)) for k, v in samples.items()}, samples


def quartiles(samples):
    """{label: [first, third quartile]} of ``turns_ms``'s samples: the
    spread a difference of medians is held against."""
    return {k: np.percentile(v, [25, 75]).tolist() for k, v in samples.items()}


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

    return t.contiguous().view({1: torch.int8, 2: torch.int16, 4: torch.int32,
                                8: torch.int64}[t.element_size()])


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
            tab = L.table if f32 else k_apply.stack_table(stack)
            x = torch.randn((E, n), generator=g, device=dev, dtype=dtype)
            b = torch.randn((E, n), generator=g, device=dev, dtype=dtype)

            # K1: relative norm error (a sum over the row's nonzeros in
            # another order)
            ref = k_apply.element_apply_plain(x, coeff, stack, b=b)
            got = k_apply.element_apply(x, coeff, stack, b=b, table=tab)
            rel = float(torch.linalg.norm(got - ref) / torch.linalg.norm(ref))
            tol = 1e-5 if f32 else 1e-12
            check(rel <= tol, f"K1 level {k} {dtype}: rel err {rel} > {tol}")
            report["element_apply"].append((str(dtype)[6:], n, rel))
            if f32 and k == top:
                P = stack.shape[0]
                timing["element_apply"] = entry(
                    (got - ref).abs().max(),
                    cuda_ms(lambda: k_apply.element_apply(x, coeff, stack, b=b, table=tab), 5),
                    cuda_ms(lambda: k_apply.element_apply_plain(x, coeff, stack, b=b), 3),
                    nbytes=4 * (3 * E * n + E * P) + table_bytes(tab), flops=apply_flops(E, tab),
                )
                # the plain apply A x (the smoothers' direction applies), and
                # how sparse the stack is: nonzero columns per row of the
                # union of its P slices, the widest row, each slice's own
                report["element_apply_f32_ms"] = dict(
                    residual=timing["element_apply"]["ms"],
                    apply=cuda_ms(lambda: k_apply.element_apply(x, coeff, stack, table=tab), 5),
                    stack_nonzeros_per_row=tab.nnz / n, widest_row=tab.width,
                    union_nnz=tab.nnz, slice_nnz=tab.slice_nnz, n=n)
            del ref, got, tab

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
                timing["structured_combine"] = entry(
                    (got - ref).abs().max(),
                    cuda_ms(lambda: k_st.combine_structured(x, st, constrain=True), 10),
                    cuda_ms(lambda: k_st.combine_structured_plain(x, st, constrain=True), 3),
                    nbytes=4 * 2 * E * n, flops=combine_adds(plan, k, E),
                )
                # what bounds it: each mode in turns with a copy of the same
                # bytes (the constraint reads and writes them without the
                # sums)
                t, samples = turns_ms(dict(
                    fold=lambda: k_st.combine_structured(x, st, constrain=True),
                    combine=lambda: k_st.combine_structured(x, st),
                    constrain=lambda: k_st.constrain_structured(x, st),
                    copy=lambda: x.clone()), 10)
                report["K2_modes_f32_ms"] = dict(t, quartiles=quartiles(samples))
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
                # reads x, p, rc, dinv; writes x, p; 5 operations per entry
                timing["chebyshev_update"] = entry(
                    (xk - xr).abs().max(),
                    cuda_ms(lambda: k_cheb.chebyshev_update(xk, pk, rc, dinv, ab), 10),
                    cuda_ms(lambda: k_cheb.chebyshev_update_plain(xr, pr, rc, dinv, ab, False), 10),
                    nbytes=4 * 6 * E * n, flops=5 * E * n,
                )
            del x, b, dinv, xr, pr, xk, pk, rc
            torch.cuda.empty_cache()
    return timing, report


def check_coarse_kernels(solver, coeff64, dev):
    """Phase 3, K6 and K7 at the main path's shapes (``solver`` is the
    coarse="mg" main-path solver): K6 apply bitwise equal to its plain form
    in every mask / b form. Returns {kernel: (max_abs_err, ms, plain_ms)} of
    the float32 entry the coarse loop calls most (K6 apply, K7 segment sum;
    ms and library_ms per call: medians of TIMING_ROUNDS rounds taken in
    turns with the library call) and a report of every entry."""
    import torch

    from homogenization_jl_tpu_torch.ops import interfaces as k_if
    from homogenization_jl_tpu_torch.ops import stencil as k_st

    g = torch.Generator(device=dev).manual_seed(4321)
    st = solver.lattice_stencil
    check(st is not None, "the main-path base has no lattice stencil")
    N = solver.n_base_nodes
    E = coeff64.shape[0]
    aux = solver.aux_solver
    m = solver._interior_mask_N
    report, timing, turns = [], {}, {}

    def rel(got, ref, scale=None):
        scale = ref.abs().max() if scale is None else scale
        return float((got - ref).abs().max() / scale)

    for dtype in (torch.float32, torch.float64):
        f32 = dtype == torch.float32
        tol = 2e-6 if f32 else 1e-13
        name = str(dtype)[6:]
        coeff = coeff64.to(dtype)
        stack0 = solver.levels[0].stack.to(dtype)
        u = torch.randn(N, generator=g, device=dev, dtype=dtype)
        b = torch.randn(N, generator=g, device=dev, dtype=dtype)
        y = torch.randn((E, 4), generator=g, device=dev, dtype=dtype)

        # K6, all four entries
        W_ref = k_st.lattice_weights_plain(coeff, stack0, st)
        W = k_st.lattice_weights(coeff, stack0, st)
        e_w = rel(W, W_ref)
        check(e_w <= tol, f"K6 weights {name}: rel err {e_w}")
        # apply: the plain form's products and adds in its order, every
        # mask / b form bit for bit
        for mm, bb in ((None, None), (m, None), (None, b), (m, b)):
            ref = k_st.lattice_apply_plain(u, W_ref, st, m=mm, b=bb)
            got = k_st.lattice_apply(u, W_ref, st, m=mm, b=bb)
            check(torch.equal(_bits(got), _bits(ref)),
                  f"K6 apply {name} m={mm is not None} b={bb is not None}: differs from plain")
        if f32:
            K = W_ref.shape[0]
            A_csr = stencil_csr(W_ref, st)
            # per call, in turns with the library call (K6, CSR, CSR, K6)
            med, samples = turns_ms({
                "k6": lambda: k_st.lattice_apply(u, W_ref, st, m=m, b=b),
                "csr_mv": lambda: torch.mv(A_csr, u)}, 50)
            timing["lattice_stencil"] = entry(
                (got - ref).abs().max(), med["k6"],
                cuda_ms(lambda: k_st.lattice_apply_plain(u, W_ref, st, m=m, b=b), 20),
                nbytes=4 * (K * N + 3 * N) + N, flops=2 * K * N + 2 * N,
                library_ms=med["csr_mv"],
            )
            turns["lattice_apply_vs_csr_mv"] = dict(median_ms=med, samples_ms=samples)
            del A_csr
            t_w = (cuda_ms(lambda: k_st.lattice_weights(coeff, stack0, st), 20),
                   cuda_ms(lambda: k_st.lattice_weights_plain(coeff, stack0, st), 5))
        ref = k_st.lattice_assemble_plain(y, st)
        got = k_st.lattice_assemble(y, st)
        e_s = rel(got, ref)
        check(e_s <= tol, f"K6 assemble {name}: rel err {e_s}")
        asm_bitwise = torch.equal(got, ref)
        dist_ok = torch.equal(k_st.lattice_distribute(u, st), k_st.lattice_distribute_plain(u, st))
        check(dist_ok, f"K6 distribute {name} differs from the plain form")
        if f32:
            t_s = (cuda_ms(lambda: k_st.lattice_assemble(y, st), 50),
                   cuda_ms(lambda: k_st.lattice_assemble_plain(y, st), 20))
            t_d = (cuda_ms(lambda: k_st.lattice_distribute(u, st), 50),
                   cuda_ms(lambda: k_st.lattice_distribute_plain(u, st), 20))

        # K7: both segment sums (two launches bitwise equal), the gathers
        seg = {}
        for label, tab, vals in (
            ("base", solver._asm, y),
            ("aux", aux._asm, torch.randn(aux._asm.perm.numel(), generator=g,
                                          device=dev, dtype=dtype)),
        ):
            ref = k_if.segment_sum_plain(vals, tab)
            got = k_if.segment_sum(vals, tab)
            again = k_if.segment_sum(vals, tab)
            check(torch.equal(_bits(got), _bits(again)),
                  f"K7 segment sum {label} {name}: two launches differ")
            e = rel(got, ref)
            check(e <= tol, f"K7 segment sum {label} {name}: rel err {e}")
            seg[label] = dict(rel_err=e, bitwise_vs_plain=torch.equal(_bits(got), _bits(ref)))
            if f32 and label == "base":
                S = vals.numel()
                keys = torch.as_tensor(solver.plan.base.elements.reshape(-1), device=dev)
                med, samples = turns_ms({
                    "k7": lambda: k_if.segment_sum(vals, tab),
                    "index_add": lambda: torch.zeros(tab.n_seg, dtype=dtype, device=dev).index_add_(
                        0, keys, vals.reshape(-1))}, 50)
                timing["coarse_gather"] = entry(
                    (got - ref).abs().max(), med["k7"],
                    cuda_ms(lambda: k_if.segment_sum_plain(vals, tab), 20),
                    nbytes=4 * (2 * S + 2 * tab.n_seg + 1), flops=S,
                    library_ms=med["index_add"],
                )
                turns["segment_sum_vs_index_add"] = dict(median_ms=med, samples_ms=samples)
        r_aux = torch.randn(aux.levels[-1].stack.shape[1] * aux.plan.base.nelements,
                            generator=g, device=dev, dtype=dtype)
        for label, src, idx, mask in (
            ("node_map", u, solver._node_map, solver._aux_first_mask),
            ("aux_first", r_aux, solver._aux_first_flat, m),
            ("distribute", u, solver._base_idx, None),
        ):
            ok = torch.equal(k_if.gather_scale(src, idx, mask),
                             k_if.gather_scale_plain(src, idx, mask))
            check(ok, f"K7 gather {label} {name} differs from the plain form")
        if f32:
            t_g = (cuda_ms(lambda: k_if.gather_scale(u, solver._node_map,
                                                     solver._aux_first_mask), 50),
                   cuda_ms(lambda: k_if.gather_scale_plain(u, solver._node_map,
                                                           solver._aux_first_mask), 20))
        report.append(dict(
            dtype=name, weights_rel=e_w, apply_bitwise=True, assemble_rel=e_s,
            assemble_bitwise=asm_bitwise, segment_sum=seg,
        ))
        del W, W_ref, u, b, y, ref, got
    report.append(dict(f32_ms={
        "lattice_weights": t_w, "lattice_apply": timing["lattice_stencil"]["ms"],
        "lattice_assemble": t_s, "lattice_distribute": t_d,
        "segment_sum_base": timing["coarse_gather"]["ms"], "gather_node_map": t_g,
    }, per_call_in_turns=turns,
        shapes=dict(lattice_nodes=N, elements=E, aux_node_map=list(solver._node_map.shape),
                    aux_segments=aux._asm.n_seg, aux_values=aux._asm.perm.numel())))
    return timing, report


def stencil_csr(W, st):
    """The lattice stencil W [K, (n+1)^d] as a sparse CSR matrix on W's
    device: row a, column a + delta_k, value W[k, a] (in-range neighbours),
    the library yardstick of the K6 apply."""
    import torch

    n1 = st.n + 1
    d = st.dim
    idx = np.indices((n1,) * d).reshape(d, -1)
    rows, cols, vals = [], [], []
    Wn = W.cpu().numpy()
    for k, delta in enumerate(st.deltas):
        nb = idx + np.asarray(delta)[:, None]
        ok = ((nb >= 0) & (nb < n1)).all(axis=0)
        a = np.flatnonzero(ok)
        col = np.ravel_multi_index(tuple(nb[:, ok]), (n1,) * d)
        rows.append(a)
        cols.append(col)
        vals.append(Wn[k, a])
    import scipy.sparse as sp

    A = sp.csr_matrix((np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
                      shape=(n1**d, n1**d))
    return torch.sparse_csr_tensor(
        torch.as_tensor(A.indptr, dtype=torch.int64), torch.as_tensor(A.indices, dtype=torch.int64),
        torch.as_tensor(A.data, dtype=W.dtype), size=A.shape,
    ).to(W.device)


# --------------------------------------------------------------------- #
# phase 3b: the driver's kernels (K9, K8, the masked K2 fold)
# --------------------------------------------------------------------- #
def check_driver_kernels(hz, solver, plan, dev):
    """K9 at the flagship's finest shape, K8 on the ordered 3D base's finest
    level and on every level of phase 8's 2D base, and the masked K2 fold
    at n = 969. Returns ({kernel: entry}, report)."""
    import torch

    from homogenization_jl_tpu_torch.models.checkerboard import (
        compute_boundary_layer,
        compute_box_radius,
        ordered_hypercube,
    )
    from homogenization_jl_tpu_torch.ops import apply as k_apply
    from homogenization_jl_tpu_torch.ops import integrals as k_int
    from homogenization_jl_tpu_torch.ops import interfaces as k_if
    from homogenization_jl_tpu_torch.ops import structured as k_st

    rng = np.random.default_rng(77)
    top = solver.nlevels - 1
    E, n = plan.base.nelements, plan.n_local(top)
    timing, report = {}, {}

    # K9: every form, both quirk branches (modes FIRST_QUIRK and FIRST)
    modes = {"terms": k_int.TERMS, "first_quirk": k_int.FIRST_QUIRK,
             "first": k_int.FIRST, "area": k_int.AREA}
    x_np = rng.random((E, n))
    w_np = rng.standard_normal((E, n))
    detJ_np = rng.uniform(0.5, 2.0, E)
    mask_np = (rng.random(E) < 0.6).astype(np.float64)
    for dtype in (torch.float32, torch.float64):
        f32 = dtype == torch.float32
        tol = 1e-5 if f32 else 1e-12

        def t(a):
            return torch.as_tensor(a).to(dtype).to(dev)

        x, w, detJ, mask = t(x_np), t(w_np), t(detJ_np), t(mask_np)
        mass = solver.levels[top].stack[-1].to(dtype).contiguous()
        tab = k_apply.stack_table(mass[None])
        errs, times = {}, {}
        for label, mode in modes.items():
            args = (None, None, None) if mode == k_int.AREA else (x, mass, w)
            got = k_int.sigma_integral(mode, *args, detJ, mask, table=tab)
            again = k_int.sigma_integral(mode, *args, detJ, mask, table=tab)
            ref = k_int.sigma_integral_plain(mode, *args, detJ, mask)
            absargs = (None, None, None) if mode == k_int.AREA else (x.abs(), mass.abs(), w.abs())
            scale = float(k_int.sigma_integral_plain(mode, *absargs, detJ, mask))
            check(torch.equal(_bits(got), _bits(again)), f"K9 {label} {dtype}: two launches differ")
            err = abs(float(got) - float(ref)) / scale
            check(err <= tol, f"K9 {label} {dtype}: rel err {err} > {tol}")
            if mode == k_int.AREA:
                # no row partials: the sum alone, K5's order on the plain
                # form's terms, bit for bit
                check(torch.equal(_bits(got), _bits(ref)), f"K9 area {dtype}: differs from plain")
            errs[label] = err
            times[label] = cuda_ms(lambda: k_int.sigma_integral(mode, *args, detJ, mask, table=tab),
                                   10)
            if f32 and label == "terms":
                u = x + w
                dm = detJ * mask
                timing["integrals"] = entry(
                    abs(float(got) - float(ref)),
                    cuda_ms(lambda: k_int.sigma_integral(mode, x, mass, w, detJ, mask, table=tab),
                            10),
                    cuda_ms(lambda: k_int.sigma_integral_plain(mode, x, mass, w, detJ, mask), 3),
                    nbytes=4 * (2 * E * n + 2 * E) + table_bytes(tab),
                    flops=apply_flops(E, tab) + 4 * E * n,
                    library_ms=cuda_ms(lambda: torch.einsum("e,em,mn,en->", dm, u, mass, x), 3),
                )
                timing["integrals"]["csr_mm_ms"] = csr_mm_ms(mass, x, 3)
                del u, dm
        report[f"K9_{str(dtype)[6:]}"] = errs
        report[f"K9_{str(dtype)[6:]}_ms"] = times
        del x, w, detJ, mask, ref, got, again, tab
    torch.cuda.empty_cache()

    # masked K2 fold at the finest main-path level
    st = solver.levels[top].structured
    for dtype in (torch.float32, torch.float64):
        x = torch.as_tensor(rng.standard_normal((E, n))).to(dtype).to(dev)
        m = torch.as_tensor(rng.random((E, n)) < 0.8, device=dev)
        got = k_st.combine_structured(x, st, mask=m)
        ref = k_st.combine_structured_plain(x, st) * m
        check(torch.equal(_bits(got), _bits(ref)), f"masked K2 {dtype}: differs from plain * mask")
        if dtype == torch.float32:
            report["K2_masked_f32_ms"] = dict(
                ms=cuda_ms(lambda: k_st.combine_structured(x, st, mask=m), 10),
                plain_ms=cuda_ms(lambda: k_st.combine_structured_plain(x, st) * m, 3))
        del x, m, got, ref
    torch.cuda.empty_cache()

    # K8: the ordered 3D base's finest level, then every level of phase 8's
    # 2D base, then config 4's finest level
    t0 = time.perf_counter()
    mesh3, _, _ = ordered_hypercube(3, ORDERED_3D_RADIUS)
    plan3 = hz.build_grid_plan(mesh3, FLAGSHIP["refinements"] + 1, slot_tables=False)
    report["K8_ordered3d_plan_s"] = time.perf_counter() - t0
    r = RECURRENCE_2D
    mesh2, _, _ = ordered_hypercube(2, compute_box_radius(0, r["n"]) + compute_boundary_layer(1.0, r["n"]))
    plan2 = hz.build_grid_plan(mesh2, r["refinements"] + 1, slot_tables=False)
    mesh4, _, _ = ordered_hypercube(3, config4_field()[0])
    plan4 = hz.build_grid_plan(mesh4, CONFIG4["refinements"] + 1, slot_tables=False)
    check((plan4.base.nelements, plan4.n_local(plan4.nlevels - 1)) == CONFIG4_STATE,
          "K8: config 4's finest state is not CONFIG4_STATE")
    cases = ([("3d", plan3, plan3.nlevels - 1)] + [("2d", plan2, k) for k in range(plan2.nlevels)]
             + [("config4", plan4, plan4.nlevels - 1)])
    report["K8_design"] = K8_DESIGN
    for label, pl, k in cases:
        gt = k_if.build_gather_tables(pl, k, dev)
        Ek, nk = pl.base.nelements, pl.n_local(k)
        bm = torch.as_tensor(pl.levels[k].boundary_mask != 0, device=dev)
        dtypes = (torch.float64,) if label == "config4" else (torch.float32, torch.float64)
        for dtype in dtypes:
            x = torch.as_tensor(rng.standard_normal((Ek, nk))).to(dtype).to(dev)
            for mk in (None, bm):
                got = k_if.combine_gather_rows(x, gt, mask=mk)
                ref = k_if.combine_gather_rows_plain(x, gt, mask=mk)
                check(torch.equal(_bits(got), _bits(ref)),
                      f"K8 {label} level {k} {dtype} mask={mk is not None}: differs from plain")
                if mk is None:
                    check(copies_bitwise_equal(got, pl, k), f"K8 {label} level {k}: copies differ")
            if label != "2d":
                # in turns with a copy of the state (the bytes of x read and
                # written once), with the boundary mask as the path runs it
                isz = x.element_size()
                t, samples = turns_ms(dict(kernel=lambda: k_if.combine_gather_rows(x, gt, mask=bm),
                                           copy=lambda: x.clone()), 10)
                e = entry((got - ref).abs().max(), t["kernel"],
                          cuda_ms(lambda: k_if.combine_gather_rows_plain(x, gt, mask=bm), 3),
                          nbytes=isz * 2 * Ek * nk + Ek * nk + gather_table_bytes(gt),
                          flops=combine_adds(pl, k, Ek))
                e.update(copy_ms=t["copy"], quartiles=quartiles(samples))
                if label == "3d" and dtype == torch.float32:
                    timing["gather_combine"] = e
                else:
                    report[f"K8_{label}_{str(dtype)[6:]}"] = e
            del x, got, ref
        report[f"K8_{label}_level{k}"] = dict(E=Ek, n=nk, classes=len(gt.classes))
        del gt, bm
    del plan3, plan2, plan4, mesh3, mesh2, mesh4
    torch.cuda.empty_cache()
    return timing, report


def check_cg_kernels(solver, plan, dev):
    """Phase 3, the kernels of the CG smoothers' path at every level of the
    main path (E = 196,608, n = 4..969), float32 and float64: K4
    (prolong_add bitwise equal to the dense product, restrict within 1e-6 /
    1e-14 of it), K5 (every mask/scale form bitwise equal on two launches
    and equal to its plain form, which sums in the kernel's order, on a
    misaligned view as on an aligned copy; at the finest shape, float32 and
    float64, every form timed and the plain dot in turns with torch.dot)
    and K10 (bitwise equal to its plain form). Returns ({kernel: entry} at
    the finest float32 shape, a per-level report)."""
    import torch

    from homogenization_jl_tpu_torch.ops import cg as k_cg
    from homogenization_jl_tpu_torch.ops import dots as k_dots
    from homogenization_jl_tpu_torch.ops import transfer as k_tr

    g = torch.Generator(device=dev).manual_seed(2468)
    top = solver.nlevels - 1
    E = plan.base.nelements
    report = {"transfer": [], "masked_dot": [], "cg_update": []}
    timing, extra = {}, {}
    for dtype in (torch.float32, torch.float64):
        f32 = dtype == torch.float32
        name = str(dtype)[6:]
        isz = 4 if f32 else 8
        for k in range(solver.nlevels):
            n = plan.n_local(k)
            fin = f32 and k == top
            # K4: the transfer between level k and k - 1
            if k > 0:
                T = k_tr.build_transfer_tables(solver.levels[k].P_up.to(dtype))
                P = T.P
                n_c = P.shape[1]
                nnz = int(T.rows.numel())
                xf = torch.randn((E, n), generator=g, device=dev, dtype=dtype)
                xc = torch.randn((E, n_c), generator=g, device=dev, dtype=dtype)
                got = k_tr.prolong_add(xf, xc, T)
                check(torch.equal(got, k_tr.prolong_add_plain(xf, xc, P)),
                      f"K4 prolong_add level {k} {name}: differs from the dense product")
                check(torch.equal(k_tr.prolong_add(None, xc, T), k_tr.prolong_add_plain(None, xc, P)),
                      f"K4 prolongation level {k} {name}: differs from the dense product")
                r = k_tr.restrict(xf, T)
                ref = k_tr.restrict_plain(xf, P)
                err = float((r - ref).abs().max() / ref.abs().max())
                check(err <= (1e-6 if f32 else 1e-14), f"K4 restrict level {k} {name}: rel err {err}")
                report["transfer"].append((name, n, n_c, err))
                if fin:
                    timing["transfer"] = entry(
                        (got - k_tr.prolong_add_plain(xf, xc, P)).abs().max(),
                        cuda_ms(lambda: k_tr.prolong_add(xf, xc, T), 10),
                        cuda_ms(lambda: k_tr.prolong_add_plain(xf, xc, P), 10),
                        nbytes=isz * (2 * E * n + E * n_c), flops=2 * E * nnz,
                        library_ms=cuda_ms(lambda: torch.addmm(xf, xc, P.T), 10),
                    )
                    extra["restrict"] = entry(
                        err, cuda_ms(lambda: k_tr.restrict(xf, T), 10),
                        cuda_ms(lambda: k_tr.restrict_plain(xf, P), 10),
                        nbytes=isz * (E * n + E * n_c), flops=2 * E * nnz - E * n_c,
                        library_ms=cuda_ms(lambda: torch.matmul(xf, P), 10),
                    )
                del xf, xc, got, r, ref, T, P
            # K5: every form, two launches and the plain form
            a = torch.randn((E, n), generator=g, device=dev, dtype=dtype)
            bb = torch.randn((E, n), generator=g, device=dev, dtype=dtype)
            w = solver.levels[k].first_copy_mask
            d = torch.rand((E, n), generator=g, device=dev, dtype=dtype) + 0.5
            worst = 0.0
            for mask, scale in ((None, None), (w, None), (w, d)):
                got = k_dots.dot(a, bb, mask=mask, scale=scale)
                again = k_dots.dot(a, bb, mask=mask, scale=scale)
                ref = k_dots.dot_plain(a, bb, mask=mask, scale=scale)
                check(torch.equal(_bits(got.view(1)), _bits(again.view(1))),
                      f"K5 level {k} {name}: two launches differ")
                check(float(got) == float(ref), f"K5 level {k} {name}: {float(got)} vs plain {float(ref)}")
                ref64 = float(torch.dot((a * (1 if mask is None else mask)).reshape(-1).double(),
                                        ((1 if scale is None else scale) * bb).reshape(-1).double()))
                mag = float(torch.dot(a.abs().reshape(-1).double(), bb.abs().reshape(-1).double()))
                worst = max(worst, abs(float(got) - ref64) / mag)
            report["masked_dot"].append((name, n, worst))
            # a view that starts one entry past a 16-byte vector (a row-block
            # view): the kernel's entry-by-entry loads, the aligned bits
            av = a.view(-1)[1:]
            check(av.data_ptr() % 16 != 0, "K5: the view is aligned")
            wv = w.view(-1)[1:]
            got = k_dots.dot(av, bb.view(-1)[1:], mask=wv)
            check(torch.equal(_bits(got.view(1)),
                              _bits(k_dots.dot(av.clone(), bb.view(-1)[1:].clone(),
                                               mask=wv.clone()).view(1))),
                  f"K5 level {k} {name}: a misaligned view differs from its aligned copy")
            check(float(got) == float(k_dots.dot_plain(av, bb.view(-1)[1:], mask=wv)),
                  f"K5 level {k} {name}: the misaligned view differs from the plain form")
            del av, wv
            if k == top:
                # every form at the finest shape, the plain dot in turns with
                # torch.dot (K5, dot, dot, K5); the bytes each form must move
                med, samples = turns_ms({
                    "k5": lambda: k_dots.dot(a, bb),
                    "torch_dot": lambda: torch.dot(a.view(-1), bb.view(-1))}, 20)
                forms = {
                    "mask": (lambda: k_dots.dot(a, bb, mask=w), isz * 2 * E * n + E * n),
                    "scale": (lambda: k_dots.dot(a, bb, scale=d), isz * 3 * E * n),
                    "mask_scale": (lambda: k_dots.dot(a, bb, mask=w, scale=d),
                                   isz * 3 * E * n + E * n),
                    "one_operand_masked": (lambda: k_dots.dot(a, a, mask=w), isz * E * n + E * n),
                }
                k5 = entry(0.0, med["k5"], cuda_ms(lambda: k_dots.dot_plain(a, bb), 2),
                           nbytes=isz * 2 * E * n, flops=2 * E * n, library_ms=med["torch_dot"])
                k5.update(turns_samples_ms=samples, bytes_bound_share=k5["bound_ms"] / k5["ms"],
                          not_above_torch_dot=med["k5"] <= med["torch_dot"])
                for label, (fn, nbytes) in forms.items():
                    ms = float(np.median([cuda_ms(fn, 20) for _ in range(TIMING_ROUNDS)]))
                    extra[f"masked_dot_{label}_{name}"] = dict(
                        ms=ms, **bound(nbytes, 2 * E * n),
                        bytes_bound_share=bound(nbytes, 0)["bound_ms"] / ms)
                if fin:
                    timing["masked_dot"] = {kk: v for kk, v in k5.items()
                                            if kk not in ("turns_samples_ms",
                                                          "bytes_bound_share",
                                                          "not_above_torch_dot")}
                extra[f"masked_dot_{name}"] = k5
            del got, again, ref, d
            # K10: both updates, den != 0 and den == 0
            num = torch.tensor(0.7, dtype=dtype, device=dev)
            for den_v in (1.3, 0.0):
                den = torch.tensor(den_v, dtype=dtype, device=dev)
                p = torch.randn((E, n), generator=g, device=dev, dtype=dtype)
                xr, rr, pr = a.clone(), bb.clone(), a.clone()
                k_cg.cg_step_plain(xr, rr, p, bb, num, den)
                k_cg.cg_direction_plain(pr, a, p, num, den)
                xk, rk, pk = a.clone(), bb.clone(), a.clone()
                k_cg.cg_step(xk, rk, p, bb, num, den)
                k_cg.cg_direction(pk, pk, p, num, den)
                for got, ref, what in ((xk, xr, "x"), (rk, rr, "r"), (pk, pr, "p")):
                    check(torch.equal(got, ref), f"K10 {what} level {k} {name} den={den_v}: differs from plain")
                if fin and den_v != 0:
                    timing["cg_update"] = entry(
                        0.0, cuda_ms(lambda: k_cg.cg_step(xk, rk, p, bb, num, den), 10),
                        cuda_ms(lambda: k_cg.cg_step_plain(xr, rr, p, bb, num, den), 10),
                        nbytes=isz * 6 * E * n, flops=4 * E * n,
                    )
                    extra["cg_direction"] = entry(
                        0.0, cuda_ms(lambda: k_cg.cg_direction(pk, pk, p, num, den), 10),
                        cuda_ms(lambda: k_cg.cg_direction_plain(pr, a, p, num, den), 10),
                        nbytes=isz * 3 * E * n, flops=2 * E * n,
                    )
                del p, xr, rr, pr, xk, rk, pk
            report["cg_update"].append((name, n, "bitwise"))
            del a, bb
            torch.cuda.empty_cache()
    return timing, dict(per_level=report, f32_other_forms=extra)


def check_new_forms(solver, plan, coeff64, dev):
    """Phase 3, at the finest main-path shape (E = 196,608, n = 969),
    float32 and float64: every entry of K18 (the first Lanczos step too),
    K10's r_out and x_zero forms, K3's x_zero form and K1's mask store (the
    apply and the residual form, in place too) bitwise equal to their plain
    forms; den == 0 and s == 0 included; K18's diagonal also at every
    coarser level's width and at config 4's one-piece shape. Returns ({name: entry} at the float32 shape: K18's
    entries, "cg_step_r_out", "element_apply_masked"; the diagonal's in
    turns with torch.matmul: "diagonal" (float32), "diagonal_float64",
    "diagonal_config4", and {n_local: entry} of the coarser levels,
    "diagonal_levels" and "diagonal_levels_float64"), and K1's library
    time: one einsum of the same function, sum_p c[e, p] S_p x[e]."""
    import torch

    from homogenization_jl_tpu_torch.ops import apply as k_apply
    from homogenization_jl_tpu_torch.ops import cg as k_cg
    from homogenization_jl_tpu_torch.ops import chebyshev as k_cheb
    from homogenization_jl_tpu_torch.ops import elementwise as k_ew
    from homogenization_jl_tpu_torch.ops import interfaces as k_if

    g = torch.Generator(device=dev).manual_seed(9753)
    top = solver.nlevels - 1
    E, n = plan.base.nelements, plan.n_local(top)
    N = E * n
    L = solver.levels[top]
    P = L.stack.shape[0]
    timing = {}
    for dtype in (torch.float32, torch.float64):
        f32 = dtype == torch.float32
        isz = 4 if f32 else 8
        name = str(dtype)[6:]

        def rnd():
            return torch.randn((E, n), generator=g, device=dev, dtype=dtype)

        u, v, w, d = rnd(), rnd(), rnd(), rnd()
        d[torch.rand((E, n), generator=g, device=dev) < 0.2] = 0.0
        m = torch.rand((E, n), generator=g, device=dev) < 0.7
        a = torch.tensor(0.37, dtype=dtype, device=dev)
        zero = torch.zeros((), dtype=dtype, device=dev)
        c = coeff64.to(dtype)
        dref = L.diag_ref.to(dtype)
        # name: (kernel, plain form, bytes moved, operations, library call)
        forms = {
            "mask": (lambda: k_if.apply_mask(u, m), lambda: u * m, isz * 2 * N + N, N,
                     lambda: torch.mul(u, m)),
            "mul": (lambda: k_ew.mul(d, u), lambda: k_ew.mul_plain(d, u), isz * 3 * N, N,
                    lambda: torch.mul(d, u)),
            "lanczos_update": (lambda: k_ew.lanczos_update(u, v, w, a, a),
                               lambda: k_ew.lanczos_update_plain(u, v, w, a, a),
                               isz * 4 * N, 4 * N, None),
            "div_nz": (lambda: k_ew.div_nz(u, a), lambda: k_ew.div_nz_plain(u, a),
                       isz * 2 * N, N, lambda: torch.div(u, a)),
            "div_nz_zero": (lambda: k_ew.div_nz(u, zero), lambda: k_ew.div_nz_plain(u, zero),
                            isz * 2 * N, N, None),
            "inv_positive": (lambda: k_ew.inv_positive(d), lambda: k_ew.inv_positive_plain(d),
                             isz * 2 * N, N, None),
            "diagonal": (lambda: k_ew.diagonal(c, dref), lambda: k_ew.diagonal_plain(c, dref),
                         isz * (E * P + P * n + N), 2 * P * N, lambda: torch.matmul(c, dref)),
            "lanczos_first": (lambda: k_ew.lanczos_update(u, v, None, a, a),
                              lambda: k_ew.lanczos_update_plain(u, v, None, a, a),
                              isz * 3 * N, 2 * N, None),
        }
        for label, (kern, plain, nbytes, flops, lib) in forms.items():
            got, want = kern(), plain()
            check(torch.equal(_bits(got), _bits(want)), f"K18 {label} {name}: differs from plain")
            del got, want
            if f32 and label not in ("div_nz_zero", "lanczos_first", "diagonal"):
                timing[label] = entry(0.0, cuda_ms(kern, 10), cuda_ms(plain, 10), nbytes, flops,
                                      library_ms=None if lib is None else cuda_ms(lib, 10))
        y = u.clone()
        k_if.apply_mask(y, m, out=y)
        check(torch.equal(_bits(y), _bits(u * m)), f"K18 mask in place {name}: differs")
        del y
        timing["diagonal" if f32 else "diagonal_float64"] = diagonal_turns(
            k_ew, c, dref, nbytes=isz * (E * P + P * n + N), flops=2 * P * N,
            label=f"n={n} {name}")
        # the coarser levels' shapes (the same solver's diagonals, _dinv_all)
        levels = {}
        for k in range(top):
            nk = plan.n_local(k)
            levels[nk] = diagonal_turns(k_ew, c, solver.levels[k].diag_ref.to(dtype),
                                        nbytes=isz * (E * P + P * nk + E * nk),
                                        flops=2 * P * E * nk, label=f"n={nk} {name}")
        timing["diagonal_levels" if f32 else "diagonal_levels_float64"] = levels
        if not f32:
            # the mass solves' Jacobi diagonal of config 4 (models/multishift.py):
            # one piece, detJ per element times the mass matrix's diagonal
            E4, n4 = CONFIG4_STATE
            c4 = torch.rand((E4, 1), generator=g, device=dev, dtype=dtype) + 0.5
            d4 = torch.rand((1, n4), generator=g, device=dev, dtype=dtype)
            timing["diagonal_config4"] = diagonal_turns(
                k_ew, c4, d4, nbytes=isz * (E4 + n4 + E4 * n4), flops=2 * E4 * n4,
                label="config 4")
            del c4, d4

        # K10's r_out form: x += alpha p, r_out = r - alpha Ap, r kept
        for den_v in (1.3, 0.0):
            den = torch.tensor(den_v, dtype=dtype, device=dev)
            xk, xp, r0 = u.clone(), u.clone(), v.clone()
            rk, rp = torch.empty_like(v), torch.empty_like(v)
            k_cg.cg_step(xk, v, w, d, a, den, r_out=rk)
            k_cg.cg_step_plain(xp, v, w, d, a, den, r_out=rp)
            check(torch.equal(xk, xp) and torch.equal(rk, rp) and torch.equal(v, r0),
                  f"K10 r_out {name} den={den_v}: differs from plain")
            if f32 and den_v != 0:
                timing["cg_step_r_out"] = entry(
                    0.0, cuda_ms(lambda: k_cg.cg_step(xk, v, w, d, a, den, r_out=rk), 10),
                    cuda_ms(lambda: k_cg.cg_step_plain(xp, v, w, d, a, den, r_out=rp), 10),
                    nbytes=isz * 6 * N, flops=4 * N)
            del xk, xp, r0, rk, rp
        # the x_zero forms of K10 and K3: x unread (NaN here), x = 0 + update
        xk, xp = torch.full_like(u, float("nan")), torch.empty_like(u)
        den = torch.tensor(1.3, dtype=dtype, device=dev)
        k_cg.cg_step(xk, None, w, None, a, den, x_zero=True)
        k_cg.cg_step_plain(xp, None, w, None, a, den, x_zero=True)
        check(torch.equal(_bits(xk), _bits(xp)), f"K10 x_zero {name}: differs from plain")
        ab = torch.tensor([0.4, 0.9], dtype=dtype, device=dev)
        pk, pp = torch.empty_like(u), torch.empty_like(u)
        xk.fill_(float("nan"))
        k_cheb.chebyshev_update(xk, pk, v, u, ab, first=True, x_zero=True)
        k_cheb.chebyshev_update_plain(xp, pp, v, u, ab, True, x_zero=True)
        check(torch.equal(pk, pp) and torch.equal(xk, xp), f"K3 x_zero {name}: differs from plain")
        del xk, xp, pk, pp
        del v, w, d

        # K1's mask store: the unmasked output times the mask, bit for bit
        stack, rowsum = L.stack.to(dtype), L.rowsum.to(dtype)
        tab = L.table if f32 else k_apply.stack_table(stack)
        b = rnd()
        for label, kw in (("apply", {}), ("residual", dict(b=b))):
            want = k_apply.element_apply(u, c, stack, rowsum=rowsum, table=tab, **kw) * m
            got = k_apply.element_apply(u, c, stack, rowsum=rowsum, mask=m, table=tab, **kw)
            check(torch.equal(_bits(got), _bits(want)), f"K1 mask store {label} {name}: differs")
            del got, want
        r = b.clone()
        k_apply.element_apply(u, c, stack, b=r, out=r, rowsum=rowsum, mask=m, table=tab)
        want = k_apply.element_apply(u, c, stack, b=b, rowsum=rowsum, table=tab) * m
        check(torch.equal(_bits(r), _bits(want)), f"K1 mask store in place {name}: differs")
        del r, want
        if f32:
            timing["element_apply_masked"] = entry(
                0.0, cuda_ms(lambda: k_apply.element_apply(u, c, stack, b=b, rowsum=rowsum, mask=m,
                                                           table=tab), 5),
                cuda_ms(lambda: k_apply.element_apply_plain(u, c, stack, b=b, rowsum=rowsum) * m, 3),
                nbytes=4 * (3 * N + E * P) + N + table_bytes(tab), flops=apply_flops(E, tab))
            # K1's library yardstick: one einsum of sum_p c[e, p] S_p x[e],
            # operands in the order that contracts x with the stack first (a
            # batched GEMM into [E, P, n], then the sum over the pieces):
            # without opt_einsum, torch contracts left to right, and c with
            # the stack first would be an [E, P, n, n] intermediate
            timing["element_apply_library_ms"] = cuda_ms(
                lambda: torch.einsum("en,pmn,ep->em", u, stack, c), 3)
        del u, b, m, c, stack, rowsum, tab
        torch.cuda.empty_cache()
    return timing


def diagonal_turns(k_ew, c, dref, nbytes, flops, label):
    """K18's diagonal at one main-path shape: first held bit for bit against
    its plain form (so every coarse level of _dinv_all and lam_max, in both
    dtypes, is checked at its own shape, not only the finest), then timed in
    turns with torch.matmul of the same function (medians and quartiles of
    ``turns_ms``), with its plain form's time and its bound: coeff and
    diag_ref read once, the output written once."""
    import torch

    check(torch.equal(_bits(k_ew.diagonal(c, dref)), _bits(k_ew.diagonal_plain(c, dref))),
          f"K18 diagonal {label}: differs from plain")
    med, samples = turns_ms({"kernel": lambda: k_ew.diagonal(c, dref),
                             "matmul": lambda: torch.matmul(c, dref)}, 10)
    return dict(entry(0.0, med["kernel"], cuda_ms(lambda: k_ew.diagonal_plain(c, dref), 3),
                      nbytes, flops, library_ms=med["matmul"]),
                quartiles=quartiles(samples))


# --------------------------------------------------------------------- #
# phase 4: small float64 solve against a sparse direct solve
# --------------------------------------------------------------------- #
def small_solve_error(hz, dev, n, **kw):
    """Relative max error of a float64 solve(tol=1e-10) (``kw``: the
    solver's options; the Chebyshev smoother unless named) against scipy's
    sparse direct solve, and the solve's iterations."""
    import scipy.sparse.linalg as spl
    import torch

    from homogenization_jl_tpu_torch.fem.assembly import assemble_operator
    from homogenization_jl_tpu_torch.fem.local_operators import load_vector
    from homogenization_jl_tpu_torch.mesh.grid import affine_maps, interior_nodes
    from homogenization_jl_tpu_torch.models.checkerboard import (
        conductivity_per_element,
        generate_conductivity,
    )

    nlevels = 3
    base, sigma, plan, b = problem(hz, n, nlevels, seed=1)
    solver = hz.MultigridSolver(plan, dtype=torch.float64, device=dev,
                                **dict(dict(smoother="chebyshev"), **kw))
    x, hist = solver.solve(torch.as_tensor(b, device=dev), sigma, 0.0, tol=1e-10)
    check(hist[-1] <= 1e-10, hist)

    fine = hz.refine_uniformly(base, times=nlevels - 1)
    field = generate_conductivity(3, n, np.random.default_rng(1))
    sigma_f = conductivity_per_element(fine, field, np.zeros(3))
    A = assemble_operator(fine, sigma_f, 0.0)
    bf = load_vector(fine)
    ii = interior_nodes(fine)
    u = np.zeros(fine.nnodes)
    A_int = A.tocsr()[ii][:, ii].tocsc()
    A_int.eliminate_zeros()  # explicit zeros of the assembly slow the factorization ~100x
    u[ii] = spl.splu(A_int, permc_spec="MMD_AT_PLUS_A").solve(bf[ii])

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


# --------------------------------------------------------------------- #
# phases 7 and 8: the homogenization driver
# --------------------------------------------------------------------- #
def flagship_driver(hz, kbuild, dev, timing, smi):
    """Phase 7: scripts/run_flagship.py's call at full size on the card,
    through the entry point's function (run_flagship.flagship), whose line
    it prints. Returns the launches of the run and its mean seconds per
    iteration."""
    import torch

    from homogenization_jl_tpu_torch import run_flagship
    from homogenization_jl_tpu_torch.solver import multigrid as k_mg

    # K18's diagonal shares the "elementwise" count: its own launches (one
    # per call of the solver's diagonal_sum) are counted around the run
    diagonal_sum, diagonal_calls = k_mg.diagonal_sum, [0]

    def counted_diagonal(*args, **kwargs):
        diagonal_calls[0] += 1
        return diagonal_sum(*args, **kwargs)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kbuild.reset_launches()
    t0 = time.perf_counter()
    k_mg.diagonal_sum = counted_diagonal
    try:
        record, trace = run_flagship.flagship(FLAGSHIP["refinements"], FLAGSHIP["n"], 1e-4,
                                              inner="pcg", device=dev, verbose=False)
    finally:
        k_mg.diagonal_sum = diagonal_sum
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(json.dumps(record), flush=True)  # the entry point's line
    sigma = record["sigma"]
    launches = dict(kbuild.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    check(all(launches[k] > 0 for k in FLAGSHIP_PATH), f"flagship: a kernel never ran: {launches}")
    check(math.isfinite(sigma), f"flagship: sigma {sigma}")
    check(abs(sigma - FLAGSHIP_SIGMA) < 1e-3, f"flagship: sigma {sigma} vs {FLAGSHIP_SIGMA}")
    its = sum(trace.cycles_per_step)
    check(its <= 14, f"flagship: {its} PCG iterations > 14")
    iters = [t for step in trace.iteration_seconds for t in step]
    say(7, ok=True, sigma=sigma, sigma_steps=trace.sigma_steps,
        cycles_per_step=trace.cycles_per_step, residuals=trace.residuals, wall_s=wall,
        host_init_s=trace.init_seconds, step_setup_s=trace.setup_seconds,
        sec_per_iteration=iters, sec_per_iteration_mean=sum(iters) / len(iters),
        k9_ms_per_launch=timing["integrals"]["ms"], max_memory_allocated=peak,
        sigma_minus_tpu_record=sigma - FLAGSHIP_SIGMA, launches=launches,
        k18_diagonal_launches=diagonal_calls[0], card=smi)
    torch.cuda.empty_cache()
    return launches, sum(iters) / len(iters)


def recurrence_2d(kbuild, dev):
    """Phase 8: the 2D recurrence with a shrink in both geometries. Returns
    {geometry: launches}."""
    import torch

    from homogenization_jl_tpu_torch.models.checkerboard import checkerboard_homogenization

    out, sig, rep = {}, {}, {}
    tol = 1e-8
    for geometry, path in (("ordered", ORDERED_2D_PATH), ("lattice", LATTICE_2D_PATH)):
        kbuild.reset_launches()
        t0 = time.perf_counter()
        sigma, trace = checkerboard_homogenization(
            **RECURRENCE_2D, dtype=torch.float64, tolerance=tol,
            smoother="chebyshev", inner="pcg", coarse="mg", seed=3, geometry=geometry,
            return_trace=True, device=dev,
        )
        torch.cuda.synchronize()
        out[geometry] = dict(kbuild.LAUNCHES)
        check(all(out[geometry][k] > 0 for k in path),
              f"2D {geometry}: a kernel never ran: {out[geometry]}")
        check(len(trace.sigma_steps) == 2, f"2D {geometry}: {len(trace.sigma_steps)} steps, expected 2")
        check(math.isfinite(sigma), f"2D {geometry}: sigma {sigma}")
        sig[geometry] = sigma
        rep[geometry] = dict(sigma=sigma, sigma_steps=trace.sigma_steps,
                             cycles_per_step=trace.cycles_per_step, residuals=trace.residuals,
                             wall_s=time.perf_counter() - t0, launches=out[geometry])
    diff = abs(sig["ordered"] - sig["lattice"])
    check(diff < 50 * tol, f"2D: ordered {sig['ordered']} vs lattice {sig['lattice']}")

    # the driver's defaults: ordered, smoother="cg", inner="vcycle",
    # coarse="chol"
    kbuild.reset_launches()
    t0 = time.perf_counter()
    sigma, trace = checkerboard_homogenization(
        **RECURRENCE_2D, dtype=torch.float64, tolerance=tol, seed=3, return_trace=True,
        device=dev,
    )
    torch.cuda.synchronize()
    out["defaults"] = dict(kbuild.LAUNCHES)
    check(all(out["defaults"][k] > 0 for k in DEFAULTS_2D_PATH),
          f"2D defaults: a kernel never ran: {out['defaults']}")
    check(math.isfinite(sigma), f"2D defaults: sigma {sigma}")
    d_def = abs(sigma - sig["ordered"])
    check(d_def < 50 * tol, f"2D defaults: sigma {sigma} vs chebyshev {sig['ordered']}")
    rep["defaults"] = dict(sigma=sigma, sigma_steps=trace.sigma_steps,
                           cycles_per_step=trace.cycles_per_step, residuals=trace.residuals,
                           setup_s=trace.setup_seconds, wall_s=time.perf_counter() - t0,
                           launches=out["defaults"], sigma_minus_chebyshev=sigma - sig["ordered"])
    say(8, ok=True, sigma_diff=diff, **rep)
    return out


# --------------------------------------------------------------------- #
# phases 9 and 10: the CG smoothers' paths at full size
# --------------------------------------------------------------------- #
def residual_shift_control(solver, x, b, sigma):
    """What K1's shifted residual form buys in float32: the error of the
    fresh residual b - A x on the float32 iterate x, by K1's residual form
    and by b - (A x) summed unshifted (K1's plain apply), against the same
    product in float64 arithmetic, relative to |b|; and the solve's history
    with every residual unshifted."""
    import torch

    from homogenization_jl_tpu_torch.ops import apply as k_apply

    top = solver.nlevels - 1
    coeff = solver.coefficients(sigma, 0.0)
    stack, tab = solver.levels[top].stack, solver.levels[top].table
    w = solver.levels[top].first_copy_mask
    ref = solver._combine_constrained(k_apply.element_apply_plain(
        x.double(), coeff.double(), stack.double(), b=b.double()).float(), top)
    b_norm = float(solver.residual_norm(b))

    def err(r):
        d = (solver._combine_constrained(r, top).double() - ref.double()) * w
        return float(torch.linalg.vector_norm(d)) / b_norm

    shifted = k_apply.element_apply(x, coeff, stack, b=b, table=tab)
    unshifted = b - k_apply.element_apply(x, coeff, stack, table=tab)
    out = dict(fresh_residual_err_shifted=err(shifted), fresh_residual_err_unshifted=err(unshifted))
    del shifted, unshifted
    del ref

    def unshifted_op(x_, coeff_, k, b=None, out=None, mask=None):
        L = solver.levels[k]
        if b is None:
            return k_apply.element_apply(x_, coeff_, L.stack, out=out, mask=mask, table=L.table)
        y = b - k_apply.element_apply(x_, coeff_, L.stack, table=L.table)
        if mask is not None:
            y = y * mask
        return y if out is None else out.copy_(y)

    solver._apply_op = unshifted_op
    try:
        _, hist = solver.solve(b, sigma, 0.0, tol=1e-3, method="vcycle", max_cycles=VCYCLE_MAX)
    finally:
        del solver._apply_op
    out["unshifted_history"] = hist
    return out


def bench_vcycle(hz, kbuild, plan, sigma, b_np, dev, smi, dense):
    """Phase 9: the JAX bench's vcycle mode (cg_exact, coarse="mg") at full
    size: in float32 as the bench runs it, solved twice, and once in
    float64; then the float32 control without K1's residual shift. Returns
    the launches of the first solve."""
    import torch

    out, hists = {}, {}
    for dtype in (torch.float32, torch.float64):
        name = str(dtype)[6:]
        solver = hz.MultigridSolver(plan, dtype=dtype, device=dev, smoother="cg_exact",
                                    coarse="mg", coarse_mg_tol=5e-2, smooth_precision="high",
                                    **dense)
        b = torch.as_tensor(b_np, device=dev, dtype=dtype)

        def solve():
            return solver.solve(b, sigma, 0.0, tol=1e-3, method="vcycle",
                                max_cycles=VCYCLE_MAX)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        solver.coarse_iterations.clear()
        kbuild.reset_launches()
        t0 = time.perf_counter()
        x, hist = solve()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kbuild.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        cits = list(solver.coarse_iterations)
        cycles = len(hist) - 1
        check(all(launches[k] > 0 for k in VCYCLE_PATH),
              f"vcycle {name}: a kernel never ran: {launches}")
        check(x.shape == b.shape and bool(torch.isfinite(x).all()),
              f"vcycle {name}: non-finite solution")
        to_1e2 = next((i for i in range(1, len(hist)) if hist[i] < 1e-2), None)
        check(to_1e2 is not None and to_1e2 <= VCYCLE_TO_1E2,
              f"vcycle {name}: {to_1e2} cycles to 1e-2 > {VCYCLE_TO_1E2}: {hist}")
        check(hist[-1] < 1e-3, f"vcycle {name}: relative residual {hist[-1]} >= 1e-3 after "
              f"{cycles} cycles: {hist}")
        rep = dict(history=hist, cycles=cycles, cycles_to_1e2=to_1e2, solve_wall_s=wall,
                   max_memory_allocated=peak, coarse_solves=len(cits),
                   coarse_pcg_iters=dict(min=min(cits), max=max(cits),
                                         mean=sum(cits) / len(cits)),
                   launches=launches)
        if dtype == torch.float32:
            first = launches
            x2, hist2 = solve()
            check(hist2 == hist, f"vcycle: second solve's history differs: {hist2} vs {hist}")
            check(torch.equal(_bits(x2), _bits(x)), "vcycle: second solve's solution differs")
            del x2
            rep["second_solve_bitwise_equal"] = True
            rep.update(residual_shift_control(solver, x, b, sigma))
        # one V-cycle from the solution, CUDA events over 5 cycles
        coeff = solver.coefficients(sigma, 0.0)
        setup = solver.coarse_setup(sigma, 0.0)
        sec = cuda_ms(lambda: solver._vcycle_impl(x, b, coeff, setup, None), 5) / 1e3
        rep.update(sec_per_vcycle=sec, vcycle_dof_per_s=x.numel() / sec,
                   wall_s_per_cycle=wall / cycles)
        out[name], hists[name] = rep, hist
        del solver, x, b, coeff, setup
        torch.cuda.empty_cache()
    # float32 follows float64 until its rounding floor
    h32, h64 = hists["float32"], hists["float64"]
    above = [i for i in range(min(len(h32), len(h64))) if h64[i] > 2e-2]
    dev32 = max(abs(h32[i] / h64[i] - 1) for i in above)
    check(dev32 < 0.05, f"vcycle: float32 leaves float64 above 2e-2 by {dev32}")
    say(9, ok=True, smoother="cg_exact", coarse="mg", dofs=int(np.prod(b_np.shape)),
        f32_vs_f64_above_2e2=dev32, card=smi, **out)
    return first


def flagship_vcycle(kbuild, dev, smi):
    """Phase 10: scripts/run_flagship.py with FLAGSHIP_INNER=vcycle at full
    size, through run_flagship.flagship, whose line it prints. Returns the
    launches of the run."""
    import torch

    from homogenization_jl_tpu_torch import run_flagship

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kbuild.reset_launches()
    t0 = time.perf_counter()
    record, trace = run_flagship.flagship(FLAGSHIP["refinements"], FLAGSHIP["n"], 1e-4,
                                          inner="vcycle", device=dev, verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(json.dumps(record), flush=True)  # the entry point's line
    sigma = record["sigma"]
    launches = dict(kbuild.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    check(all(launches[k] > 0 for k in FLAGSHIP_VCYCLE_PATH),
          f"flagship vcycle: a kernel never ran: {launches}")
    check(math.isfinite(sigma), f"flagship vcycle: sigma {sigma}")
    check(abs(sigma - FLAGSHIP_VCYCLE_SIGMA) < 1e-3,
          f"flagship vcycle: sigma {sigma} vs {FLAGSHIP_VCYCLE_SIGMA}")
    cycles = sum(trace.cycles_per_step)
    check(cycles <= 24, f"flagship vcycle: {cycles} cycles > 24")
    iters = [t for step in trace.iteration_seconds for t in step]
    say(10, ok=True, sigma=sigma, sigma_steps=trace.sigma_steps,
        cycles_per_step=trace.cycles_per_step, residuals=trace.residuals, wall_s=wall,
        host_init_s=trace.init_seconds, step_setup_s=trace.setup_seconds,
        sec_per_cycle=iters, sec_per_cycle_mean=sum(iters) / len(iters),
        max_memory_allocated=peak, sigma_minus_tpu_record=sigma - FLAGSHIP_VCYCLE_SIGMA,
        launches=launches, card=smi)
    torch.cuda.empty_cache()
    return launches


# --------------------------------------------------------------------- #
# phases 11-13: the slab-sharded path
# --------------------------------------------------------------------- #
def slab_cuts(x, st, S):
    """(r, rows, x0, W, slab, halo_lo, halo_hi) of every slab of the
    cube-major state x cut into S slabs; the halos are the neighbours' edge
    planes' tail columns, None beyond the domain ends (as the exchange
    delivers them)."""
    from homogenization_jl_tpu_torch.ops.structured import slab_halo_rows

    h = slab_halo_rows(st.sc)
    W = st.sc.n // S
    B = x.shape[0] // S
    for r in range(S):
        lo = x[r * B - h : r * B, st.i0:].contiguous() if r > 0 else None
        hi = x[(r + 1) * B : (r + 1) * B + h, st.i0:].contiguous() if r < S - 1 else None
        yield r, slice(r * B, (r + 1) * B), r * W, W, x[r * B : (r + 1) * B], lo, hi


def check_slab_kernel(plan, dev, smi, t_plan):
    """Phase 11: K11 on every slab of S = 1, 4 and 8 equals K2 on the full
    state's rows bit for bit, every level (float32) and the finest
    (float64), every mode; at the finest level K11 on the S = 1 slab and
    the timed S = 8 shard equals its plain form in every mode (max abs
    error 0); the finest float32 K11 timed at the S = 8 shard shape, and at
    S = 1 (phase 13's shape) in turns with K2's fold on the same rows.
    Returns K11's kernel entry (the S = 8 shard's time)."""
    import torch

    from homogenization_jl_tpu_torch.ops import structured as k_st

    g = torch.Generator(device=dev).manual_seed(1111)
    top = plan.nlevels - 1
    E = plan.base.nelements
    det = k_st.detect_structured(plan.base)
    checked, timing, plain_err = [], None, {}
    for k in range(plan.nlevels):
        lay = plan.reference.layout[k]
        i0 = int(min(list(lay.face_offsets) + list(lay.edge_offsets) + list(lay.corner_cols)))
        st = k_st.flatten_structured(k_st.build_structured_combine_auto(plan, k, det=det), i0,
                                     device=dev)
        n = plan.n_local(k)
        for dtype in (torch.float32, torch.float64) if k == top else (torch.float32,):
            x = torch.randn((E, n), generator=g, device=dev, dtype=dtype)
            m = torch.rand((E, n), generator=g, device=dev) < 0.8
            refs = dict(combine=k_st.combine_structured(x, st),
                        fold=k_st.combine_structured(x, st, constrain=True),
                        mask=k_st.combine_structured(x, st, mask=m),
                        constrain=k_st.constrain_structured(x, st))
            slabs = 0
            for S in SLAB_COUNTS:
                for r, rows, x0, W, xr, lo, hi in slab_cuts(x, st, S):
                    got = dict(
                        combine=k_st.combine_structured_slab(xr, lo, hi, st, x0, W),
                        fold=k_st.combine_structured_slab(xr, lo, hi, st, x0, W, constrain=True),
                        mask=k_st.combine_structured_slab(xr, lo, hi, st, x0, W,
                                                          mask=m[rows]),
                        constrain=k_st.constrain_structured_slab(xr, st, x0, W))
                    for mode, ref in refs.items():
                        check(torch.equal(_bits(got[mode]), _bits(ref[rows])),
                              f"K11 {mode} level {k} {dtype} S={S} slab {r}: differs from K2")
                    slabs += 1
                    if k == top and (S == 1 or (S, r) == SLAB_TIMED):
                        plain = dict(
                            combine=k_st.combine_structured_slab_plain(xr, lo, hi, st, x0, W),
                            fold=k_st.combine_structured_slab_plain(xr, lo, hi, st, x0, W, True),
                            constrain=k_st.constrain_structured_slab_plain(xr, st, x0, W))
                        plain["mask"] = plain["combine"] * m[rows]
                        for mode, ref in plain.items():
                            err = float((got[mode] - ref).abs().max())
                            check(err == 0, f"K11 {mode} {dtype} S={S} slab {r}: max abs err "
                                            f"{err} against its plain form")
                            plain_err[f"{str(dtype)[6:]} S={S} slab {r} {mode}"] = err
                        del plain
                    if (S, r) == SLAB_TIMED and k == top and dtype == torch.float32:
                        plain = k_st.combine_structured_slab_plain(xr, lo, hi, st, x0, W, True)
                        tw = n - i0
                        timing = entry(
                            (got["fold"] - plain).abs().max(),
                            cuda_ms(lambda: k_st.combine_structured_slab(
                                xr, lo, hi, st, x0, W, constrain=True), 20),
                            cuda_ms(lambda: k_st.combine_structured_slab_plain(
                                xr, lo, hi, st, x0, W, True), 3),
                            nbytes=4 * (2 * xr.numel() + lo.numel() + hi.numel()),
                            flops=combine_adds(plan, k, E, rows),
                        )
                        shard = dict(rows=xr.shape[0], n=n, halo_rows=lo.shape[0], tail=tw)
                        del plain
                    if S == 1 and k == top and dtype == torch.float32:
                        # phase 13's shape: K11 on the whole state against
                        # K2's fold on the same rows and bytes, in turns
                        med, samples = turns_ms(dict(
                            k11=lambda: k_st.combine_structured_slab(
                                xr, lo, hi, st, x0, W, constrain=True),
                            k2=lambda: k_st.combine_structured(x, st, constrain=True)), 20)
                        s1 = dict(rows=xr.shape[0], n=n, k11_ms=med["k11"], k2_fold_ms=med["k2"],
                                  ratio=med["k11"] / med["k2"], quartiles=quartiles(samples),
                                  **bound(4 * 2 * xr.numel(), combine_adds(plan, k, E)))
                    del got
            checked.append((str(dtype)[6:], k, n, slabs))
            del x, m, refs
            torch.cuda.empty_cache()
    check(timing is not None, "K11 was not timed")
    say(11, ok=True, bitwise_vs_k2=checked, max_abs_err_vs_plain=plain_err,
        host_plan_cube_s=t_plan, timed_shard=shard, f32=timing, s1_in_turns_with_k2=s1, card=smi)
    return timing


def slab_run(run_slab, group, prob, n, smi):
    """Phase 12: run_slab.run through the NCCL group of one rank, with the
    single-device leg."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run_slab.run(group, n, 5, 3, smoother="chebyshev", coarse="chol",
                       dtype=torch.float32, compare=True, prob=prob)
    wall = time.perf_counter() - t0
    check(all(out["launches"][k] > 0 for k in SLAB_RUN_PATH),
          f"slab run: a kernel never ran: {out['launches']}")
    check(all(math.isfinite(v) for v in out["residuals"] + [out["integral"]]),
          f"slab run: non-finite results {out['residuals']} {out['integral']}")
    if group.size == 1:
        # one rank does the single-device leg's arithmetic: equal bits
        check(out["residuals"] == out["residuals_single"]
              and out["integral"] == out["integral_single"],
              f"slab run of one rank differs from the single-device leg: "
              f"{out['residuals']} {out['integral']} vs {out['residuals_single']} "
              f"{out['integral_single']}")
    check(out["integral_rel_err"] <= SLAB_INTEGRAL_TOL,
          f"slab run: integral rel err {out['integral_rel_err']} > {SLAB_INTEGRAL_TOL}")
    check(max(out["rate_rel_err"]) <= SLAB_RATE_TOL,
          f"slab run: contraction rates differ by {out['rate_rel_err']}")
    out["residual_rel_err_max"] = max(out["residual_rel_err"])
    say(12, ok=True, wall_s=wall, card=smi, **out)


def flagship_slab(kbuild, group, smi, sec_iter_phase7):
    """Phase 13: phase 7's flagship call through the slab solver
    (device_mesh= the group of one rank). Returns its launches."""
    import torch

    from homogenization_jl_tpu_torch.models.checkerboard import checkerboard_homogenization

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kbuild.reset_launches()
    t0 = time.perf_counter()
    sigma, trace = checkerboard_homogenization(
        **FLAGSHIP, geometry="lattice", dtype=torch.float32, tolerance=1e-4,
        seed=7, coarse="mg", smoother="chebyshev", inner="pcg",
        solver_opts=dict(smooth_precision="high", coarse_mg_tol=5e-2),
        return_trace=True, device_mesh=group,
    )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kbuild.LAUNCHES)
    check(all(launches[k] > 0 for k in FLAGSHIP_SLAB_PATH),
          f"flagship slab: a kernel never ran: {launches}")
    check(math.isfinite(sigma), f"flagship slab: sigma {sigma}")
    check(abs(sigma - FLAGSHIP_SIGMA) < 1e-3, f"flagship slab: sigma {sigma} vs {FLAGSHIP_SIGMA}")
    its = sum(trace.cycles_per_step)
    check(its <= 14, f"flagship slab: {its} PCG iterations > 14")
    iters = [t for step in trace.iteration_seconds for t in step]
    say(13, ok=True, sigma=sigma, sigma_steps=trace.sigma_steps,
        cycles_per_step=trace.cycles_per_step, residuals=trace.residuals, wall_s=wall,
        host_init_s=trace.init_seconds, step_setup_s=trace.setup_seconds,
        sec_per_iteration=iters, sec_per_iteration_mean=sum(iters) / len(iters),
        phase7_sec_per_iteration_mean=sec_iter_phase7,
        ratio_to_phase7=sum(iters) / len(iters) / sec_iter_phase7,
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        sigma_minus_tpu_record=sigma - FLAGSHIP_SIGMA, launches=launches, card=smi)
    torch.cuda.empty_cache()
    return launches


# --------------------------------------------------------------------- #
# phases 14-15: the gather-sharded path
# --------------------------------------------------------------------- #
def ordered_flagship_problem(hz):
    """The ordered flagship's plan (ordered_hypercube(3, 16), 5 levels) and
    conductivity (seed 7), as the ordered driver builds them."""
    from homogenization_jl_tpu_torch.models.checkerboard import (
        compute_boundary_layer,
        compute_box_radius,
        conductivity_per_element,
        generate_conductivity,
        ordered_hypercube,
    )

    R = compute_box_radius(0, FLAGSHIP["n"]) + compute_boundary_layer(1.0, FLAGSHIP["n"])
    check(R == ORDERED_3D_RADIUS, f"ordered flagship radius {R}")
    mesh, _, _ = ordered_hypercube(3, R)
    plan = hz.build_grid_plan(mesh, FLAGSHIP["refinements"] + 1, slot_tables=False)
    field = generate_conductivity(3, 2 * R, np.random.default_rng(7))
    sigma = conductivity_per_element(mesh, field, np.full(3, float(R)))
    return plan, sigma


def shard_cut(x, S):
    """The rows of each of S blocks of x (B = ceil(E / S) rows each, the
    last shorter), as contiguous views."""
    E = x.shape[0]
    B = -(-E // S)
    return [x[r * B : min((r + 1) * B, E)] for r in range(S)]


def k12_ranks(x, tabs, mask, plain=False):
    """K12 on every rank of x's blocks in one process: K8 on the rank's
    owner tables, the cross partials, added in rank order as SlabGroup.sum
    adds them, then the scatter; or (``plain``) the same with the plain
    forms. Returns the joined result."""
    import torch

    from homogenization_jl_tpu_torch.ops import interfaces as k_if
    from homogenization_jl_tpu_torch.ops import sharded as k_sh

    S = len(tabs)
    xs = shard_cut(x, S)
    ms = [None] * S if mask is None else shard_cut(mask, S)
    if plain:
        local = [(k_if.combine_gather_rows_plain(xr, gt, mr),
                  k_sh.cross_partial_plain(xr, ct) if ct.n_groups else None)
                 for xr, (gt, ct), mr in zip(xs, tabs, ms)]
    else:
        local = [k_sh.sharded_combine_local(xr, gt, ct, mr) for xr, (gt, ct), mr in zip(xs, tabs, ms)]
    if local[0][1] is not None:
        total = local[0][1]
        for _, part in local[1:]:
            total = total + part
        for (out, _), (_, ct), mr in zip(local, tabs, ms):
            (k_sh.cross_scatter_plain if plain else k_sh.cross_scatter)(out, total, ct, mr)
    return torch.cat([out for out, _ in local])


def check_sharded_kernel(hz, kbuild, plan, dev, smi, t_plan):
    """Phase 14: K12 on every rank of S = 1, 4 and 8 blocks of the ordered
    3D state, against its plain forms (bitwise), K8 on the full state
    (1e-6 / 1e-13 relative) and itself (every copy of a shared DOF); at
    every level in float32 and at the finest in float64, with and without
    the boundary mask; the cross slots per level; K12 timed at an S = 8
    shard (its fix-up in turns with the plain form, and pass by pass), its
    bound beside the first design's formula. Returns K12's kernel entry.
    Its launches here are comparisons (reported, the timing loops' left
    out); the path's are phase 15d's."""
    import torch

    from homogenization_jl_tpu_torch.ops import interfaces as k_if
    from homogenization_jl_tpu_torch.ops import sharded as k_sh
    from homogenization_jl_tpu_torch.parallel.sharding import shard_tables_all

    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(1414)
    top = plan.nlevels - 1
    E = plan.base.nelements
    kbuild.reset_launches()
    checked, cross_slots, worst, timing, timed_launches = [], {}, {}, None, 0
    t_tables = 0.0
    for k in range(plan.nlevels):
        n = plan.n_local(k)
        full = k_if.build_gather_tables(plan, k, dev)
        bm = torch.as_tensor(plan.levels[k].boundary_mask, device=dev)
        t1 = time.perf_counter()
        tabs = {S: shard_tables_all(plan, k, S, dev) for S in SHARD_COUNTS}
        t_tables += time.perf_counter() - t1
        cross_slots[k] = {S: sum(ct.n_slots for _, ct in tabs[S]) for S in SHARD_COUNTS}
        check(cross_slots[k][1] == 0 and all(cross_slots[k][S] > 0 for S in SHARD_COUNTS[1:]),
              f"K12 level {k}: cross slots {cross_slots[k]}")
        for dtype in (torch.float32, torch.float64) if k == top else (torch.float32,):
            name = str(dtype)[6:]
            tol = 1e-6 if dtype == torch.float32 else 1e-13
            x = torch.randn((E, n), generator=g, device=dev, dtype=dtype)
            for mask in (None, bm):
                label = f"level {k} {name} mask={mask is not None}"
                ref = k_if.combine_gather_rows(x, full, mask=mask)
                scale = float(ref.abs().max())
                for S in SHARD_COUNTS:
                    got = k12_ranks(x, tabs[S], mask)
                    plain = k12_ranks(x, tabs[S], mask, plain=True)
                    check(torch.equal(_bits(got), _bits(plain)),
                          f"K12 {label} S={S}: differs from its plain forms")
                    del plain
                    if mask is None:
                        check(copies_bitwise_equal(got, plan, k), f"K12 {label} S={S}: copies differ")
                    err = float((got - ref).abs().max()) / scale
                    check(err <= tol, f"K12 {label} S={S}: rel err {err} > {tol} against K8")
                    if S == 1:
                        check(torch.equal(_bits(got), _bits(ref)), f"K12 {label} S=1: not K8's bits")
                    key = f"{name} S={S}"
                    worst[key] = max(worst.get(key, 0.0), err)
                    del got
                del ref
            checked.append((name, k, n))
            if k == top and dtype == torch.float32:
                S, r = SHARD_TIMED
                gt, ct = tabs[S][r]
                xr = shard_cut(x, S)[r]
                mr = shard_cut(bm, S)[r]
                out, part = k_sh.sharded_combine_local(xr, gt, ct, mr)
                out_p = out.clone()
                n0 = kbuild.LAUNCHES["sharded_combine"]
                ms_k8 = cuda_ms(lambda: k_if.combine_gather_rows(xr, gt, mask=mr), 10)
                fix, fix_samples = turns_ms(dict(
                    kernel=lambda: k_sh.cross_scatter(out, k_sh.cross_partial(xr, ct), ct, mr),
                    plain=lambda: k_sh.cross_scatter_plain(
                        out_p, k_sh.cross_partial_plain(xr, ct), ct, mr)), 5)
                check(torch.equal(_bits(out), _bits(out_p)), "K12's fix-up differs from its plain form")
                # the fix-up's passes in device time: the [G] vector zeroed
                # (tables without a slot), zeroed and summed, the scatter
                none = dataclasses.replace(ct, perm=ct.perm[:0], start=ct.start[:1],
                                           gid=ct.gid[:0], idx=ct.idx[:0], grp=ct.grp[:0])
                total = k_sh.cross_partial(xr, ct)
                passes = dict(
                    zero=graph_ms(lambda: k_sh.cross_partial(xr, none), 20),
                    zero_and_sums=graph_ms(lambda: k_sh.cross_partial(xr, ct), 20),
                    scatter=graph_ms(lambda: k_sh.cross_scatter(out, total, ct, mr), 20))
                ms_plain = cuda_ms(lambda: k_sh.cross_scatter_plain(
                    k_if.combine_gather_rows_plain(xr, gt, mr), k_sh.cross_partial_plain(xr, ct),
                    ct, mr), 3)
                timed_launches += kbuild.LAUNCHES["sharded_combine"] - n0
                C, G, Gl = ct.n_slots, ct.n_groups, ct.n_local_groups
                tab_bytes = gather_table_bytes(gt)
                # the fix-up: x's cross slots read, the [G] partial written,
                # the shard's groups' totals read, the slots written, the mask
                # at the slots, and its int32 tables (perm, idx, grp: a word a
                # slot; gid and start: a word a group of the shard)
                fix_bytes = 4 * C + 4 * G + 4 * Gl + 4 * C + C + 4 * 3 * C + 4 * (2 * Gl + 1)
                # the shard's rows read and written, the mask, K8's owner table
                k8_bytes = 4 * 2 * xr.numel() + mr.numel() + tab_bytes
                flops = combine_adds(plan, k, E, slice(r * xr.shape[0], (r + 1) * xr.shape[0])) + C
                timing = entry(0.0, ms_k8 + fix["kernel"], ms_plain, nbytes=k8_bytes + fix_bytes,
                               flops=flops)
                shard = dict(S=S, rank=r, rows=xr.shape[0], n=n, cross_slots=C, cross_groups=G,
                             shard_groups=Gl, k8_ms=ms_k8, fixup_ms=fix["kernel"],
                             fixup_plain_ms=fix["plain"], fixup_quartiles=quartiles(fix_samples),
                             fixup_passes_device_ms=passes,
                             fixup_bound_ms=bound(fix_bytes, C)["bound_ms"],
                             # the first design's formula: no start array, the
                             # level's totals read, three int64 slot tables
                             bound_ms_old_formula=bound(
                                 k8_bytes + 4 * (2 * C + 2 * G) + 8 * 3 * C, flops)["bound_ms"])
                del out, out_p, part, total
            del x
            torch.cuda.empty_cache()
        del full, bm, tabs
    torch.cuda.synchronize()
    compared = kbuild.LAUNCHES["sharded_combine"] - timed_launches
    check(compared > 0, "K12's cross-shard kernels never launched")
    kbuild.reset_launches()
    say(14, ok=True, checked=checked, rel_err_vs_k8=worst,
        cross_slots_per_level={k: v for k, v in cross_slots.items()},
        host_plan_s=t_plan, host_tables_s=t_tables, timed_shard=shard, f32=timing,
        comparison_launches=compared, wall_s=time.perf_counter() - t0, card=smi)
    return timing


def profile_step(step, lead_s=PROFILE_LEAD_S):
    """torch.profiler over one call of ``step``, ``lead_s`` of idle trace
    before it and PROFILE_MARGIN_S after. Returns (``profile_table``'s
    dict, the profile)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # idle margins inside the trace around the step (PROFILE_LEAD_S)
        torch.ones(1).to("cuda")
        torch.cuda.synchronize()
        time.sleep(lead_s)
        calls = k5_calls()
        t0 = time.perf_counter()
        start.record()
        step()
        end.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        calls = k5_calls() - calls
        time.sleep(PROFILE_MARGIN_S)
    return profile_table(prof, wall, start, end, calls), prof


def k5_calls():
    """K5's wrapper calls so far (its launch counts: the dots and K16's)."""
    from homogenization_jl_tpu_torch.csrc.build import LAUNCHES

    return LAUNCHES["masked_dot"] + LAUNCHES["direction_dot"]


def device_timeline(prof):
    """The step's device time from the profile's trace: {"busy_ms": the
    union of its kernels and copies, "host_wait_ms": the device's idle gaps
    that end with a kernel or copy whose launch call had not returned when
    the device went idle (the device waiting on the host), "lost_launches":
    the step's launch calls (kernels, copies) whose device record the trace
    lacks}. The step is what follows the lead (the trace's longest gap)."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    launches = {}
    device = []
    for e in events:
        if e.get("ph") != "X":
            continue
        corr = e.get("args", {}).get("correlation")
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and corr is not None:
            if any(k in e["name"] for k in ("LaunchKernel", "Memcpy", "Memset")):
                launches[corr] = (e["ts"], e["ts"] + e["dur"])
        elif e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            device.append((e["ts"], e["ts"] + e["dur"], corr))
    device.sort()
    after = float("-inf")
    if len(device) > 1:
        lead = max(range(1, len(device)), key=lambda i: device[i][0] - device[i - 1][1])
        after = max(t1 for _, t1, _ in device[:lead])
        device = device[lead:]
    recorded = {corr for _, _, corr in device}
    lost = sum(1 for corr, (t0, _) in launches.items() if t0 > after and corr not in recorded)
    busy = wait = 0.0
    reach = device[0][0] if device else 0.0
    for t0, t1, corr in device:
        if t0 > reach and launches.get(corr, (0.0, -1.0))[1] >= reach:
            wait += t0 - reach
        busy += max(0.0, t1 - max(t0, reach))
        reach = max(reach, t1)
    return dict(busy_ms=busy / 1e3, host_wait_ms=wait / 1e3, lost_launches=lost)


def profile_table(prof, wall_s, start, end, k5_wrapper_calls):
    """The table of a finished profile: {"rows": [(kernel, device ms,
    launches)] by device time, "wall_ms", "event_ms" (between the CUDA
    events ``start`` and ``end``), "busy_ms", "host_wait_ms" and
    "lost_launches" (``device_timeline``), "coverage": busy_ms, with
    host_wait_ms when no launch lost its record, over event_ms,
    "host_reads": the device scalars read on the host, and "k5": K5's
    kernels in the trace per wrapper call in the window
    (``k5_wrapper_calls``; one launch per call)}. The coverage falls
    short of 1 by the gaps between back-to-back kernels; far below it, the
    profile lost kernels (a prefix of the step, PERF.md), and its table
    proves nothing about them. The device's waits on the host count as
    covered: they are idle time, not lost kernels (``host_wait_ms`` says how
    much)."""
    import torch

    rows, reads = [], 0
    for ev in prof.key_averages():
        if ev.key == "aten::_local_scalar_dense":
            reads += ev.count
        # device-side events only (kernels, copies): the CPU-side ops that
        # launched them carry the same device time again
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if ev.self_device_time_total > 0:
            rows.append((ev.key, ev.self_device_time_total / 1e3, ev.count))
    rows.sort(key=lambda r: -r[1])
    event_ms = start.elapsed_time(end)
    line = device_timeline(prof)
    # waits on the host count only in a trace that lost no launch's record
    covered = line["busy_ms"] + (line["host_wait_ms"] if line["lost_launches"] == 0 else 0.0)
    k5_kernels = sum(cnt for name, _, cnt in rows if "masked_dot_kernel" in name)
    return dict(rows=rows, wall_ms=wall_s * 1e3, event_ms=event_ms, **line,
                coverage=covered / event_ms, host_reads=reads,
                k5=dict(kernels=k5_kernels, calls=k5_wrapper_calls,
                        kernels_per_call=k5_kernels / max(k5_wrapper_calls, 1)))


def check_k5_per_call(p, label):
    """A covered profile with no lost launch holds one K5 kernel per call."""
    if p["lost_launches"] == 0:
        check(p["k5"]["kernels"] == p["k5"]["calls"],
              f"{label}: {p['k5']['kernels']} K5 kernels for {p['k5']['calls']} calls")


def covered_profile(step, label):
    """The first of up to PROFILE_ATTEMPTS profiles of ``step`` (one call
    each) that covers PROFILE_MIN_COVERAGE of its CUDA-event time, with the
    coverage of every attempt (attempt i with PROFILE_LEAD_S * 2**i of idle
    trace before the step); fails when none does."""
    tried = []
    for i in range(PROFILE_ATTEMPTS):
        p, prof = profile_step(step, PROFILE_LEAD_S * 2 ** i)
        tried.append(p["coverage"])
        if p["coverage"] >= PROFILE_MIN_COVERAGE:
            return dict(p, attempts=tried), prof
        del prof
    raise RuntimeError(f"chip_smoke: {label}: no profile covers {PROFILE_MIN_COVERAGE} "
                       f"of the step: coverages {tried}")


def library_elementwise(rows):
    """PyTorch's elementwise kernels of a profile: [(name, mean us per
    launch, launches)]."""
    return [(name[:90], ms * 1e3 / count, count) for name, ms, count in rows
            if "elementwise_kernel" in name]


def sharded_pcg_compare(hz, kbuild, group, plan_full, sigma, dev, smi):
    """Phase 15a: 3 PCG iterations from zero of the gather-sharded solver
    (a world of one) and of MultigridSolver on the ordered 3D base one
    level below the flagship (SHARDED_PCG_LEVELS), the solver the ordered
    driver builds for its first step (float32, Chebyshev, the coarse kind
    it picks, coarse_mg_tol=5e-2): equal lambda_max and residual
    histories."""
    import torch

    from homogenization_jl_tpu_torch.models.checkerboard import _make_solver, initial_rhs

    t0 = time.perf_counter()
    plan = hz.build_grid_plan(plan_full.base, SHARDED_PCG_LEVELS, slot_tables=False)
    b_np = initial_rhs(plan, sigma, np.ones(3) / np.sqrt(3), dtype=np.float32)
    out = {}
    for label, grp in (("single", None), ("sharded", group)):
        sol = _make_solver(plan, torch.float32, dev, 3, "mg", 8_000, "chebyshev",
                           dict(coarse_mg_tol=5e-2), grp)
        coeff = sol.coefficients(sigma, 1.0)
        setup = sol.coarse_setup(sigma, 1.0)
        lam_max = sol.estimate_lambda_max(coeff)
        b = torch.as_tensor(np.ascontiguousarray(sol.rows_of(b_np)), device=dev)
        kbuild.reset_launches()
        _, hist = sol.pcg(b, coeff, setup, lam_max=lam_max, iters=3)
        out[label] = dict(kind=sol.coarse_kind, lam_max=lam_max, history=hist,
                          launches=dict(kbuild.LAUNCHES))
        del sol, coeff, setup, b
        torch.cuda.empty_cache()
    s, m = out["sharded"], out["single"]
    check(s["kind"] == m["kind"], f"15a: coarse kinds {s['kind']} vs {m['kind']}")
    check(s["lam_max"] == m["lam_max"] and s["history"] == m["history"],
          f"15a: sharded {s['lam_max']} {s['history']} vs single {m['lam_max']} {m['history']}")
    check(all(math.isfinite(h) for h in s["history"]) and s["history"][-1] < s["history"][0],
          f"15a: history {s['history']}")
    say("15a", ok=True, dofs=int(b_np.size), coarse=s["kind"], lam_max=s["lam_max"],
        history=s["history"],
        single_history=m["history"], launches=s["launches"], wall_s=time.perf_counter() - t0,
        card=smi)


# phase 15b profiles the PCG steps of its driver iterations from this one
# on, until one covers PROFILE_MIN_COVERAGE of its step
PROFILE_FIRST_ITERATION = 2


def flagship_ordered_sharded(kbuild, group, smi, sec_iter_phase7):
    """Phase 15b: the flagship call with geometry="ordered" and
    device_mesh= the group (the gather-sharded solver, a world of one);
    the PCG steps of up to PROFILE_ATTEMPTS driver iterations from
    PROFILE_FIRST_ITERATION on are profiled until one is covered. Returns
    ({iteration: covered profile}, {iteration: coverage} of every
    profiled iteration)."""
    import torch

    from homogenization_jl_tpu_torch.models.checkerboard import checkerboard_homogenization
    from homogenization_jl_tpu_torch.parallel.sharding import ShardedMultigridSolver

    profiled, attempts = {}, {}
    stepper = ShardedMultigridSolver.pcg_stepper

    def traced_stepper(self, *args, **kwargs):
        init, step = stepper(self, *args, **kwargs)

        def step_traced(state):
            calls = profiled["calls"] = profiled.get("calls", 0) + 1
            done = any(p["coverage"] >= PROFILE_MIN_COVERAGE for p in attempts.values())
            if calls < PROFILE_FIRST_ITERATION or done or len(attempts) == PROFILE_ATTEMPTS:
                return step(state)
            box = {}
            attempts[calls], _ = profile_step(lambda: box.setdefault("state", step(state)),
                                              PROFILE_LEAD_S * 2 ** len(attempts))
            return box["state"]

        return init, step_traced

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kbuild.reset_launches()
    ShardedMultigridSolver.pcg_stepper = traced_stepper
    t0 = time.perf_counter()
    try:
        sigma, trace = checkerboard_homogenization(
            **FLAGSHIP, geometry="ordered", dtype=torch.float32, tolerance=1e-4, seed=7,
            coarse="mg", smoother="chebyshev", inner="pcg",
            solver_opts=dict(coarse_mg_tol=5e-2), return_trace=True, device_mesh=group,
        )
        torch.cuda.synchronize()
    finally:
        ShardedMultigridSolver.pcg_stepper = stepper
    wall = time.perf_counter() - t0
    launches = dict(kbuild.LAUNCHES)
    check(all(launches[k] > 0 for k in FLAGSHIP_ORDERED_PATH),
          f"flagship ordered: a kernel never ran: {launches}")
    check(math.isfinite(sigma), f"flagship ordered: sigma {sigma}")
    check(abs(sigma - FLAGSHIP_SIGMA) < ORDERED_SIGMA_TOL,
          f"flagship ordered: sigma {sigma} vs {FLAGSHIP_SIGMA}")
    its = sum(trace.cycles_per_step)
    check(its <= 14, f"flagship ordered: {its} PCG iterations > 14")
    covered = {i: p for i, p in attempts.items() if p["coverage"] >= PROFILE_MIN_COVERAGE}
    check(covered, f"flagship ordered: no profile covers {PROFILE_MIN_COVERAGE} of its step: "
          f"{ {i: p['coverage'] for i, p in attempts.items()} }")
    iters = [t for step in trace.iteration_seconds for t in step]
    # the profiled iterations carry the profiler's cost: left out of the mean
    plain = [t for i, t in enumerate(iters, 1) if i not in attempts]
    say("15b", ok=True, sigma=sigma, sigma_steps=trace.sigma_steps,
        cycles_per_step=trace.cycles_per_step, residuals=trace.residuals, wall_s=wall,
        host_init_s=trace.init_seconds, step_setup_s=trace.setup_seconds,
        sec_per_iteration=iters,
        profile_coverage={i: p["coverage"] for i, p in attempts.items()},
        sec_per_iteration_mean_unprofiled=sum(plain) / len(plain) if plain else None,
        phase7_sec_per_iteration_mean=sec_iter_phase7,
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        sigma_minus_tpu_record=sigma - FLAGSHIP_SIGMA, launches=launches, card=smi)
    torch.cuda.empty_cache()
    return covered, {i: p["coverage"] for i, p in attempts.items()}


def profiles_report(pcg_profile, driver_profiles, driver_coverage, smi):
    """Phase 15c: the kernel tables, top 15 by device time, and no PyTorch
    elementwise kernel above LIBRARY_ELEMENTWISE_MAX_US per launch on
    average. The gate reads only tables that cover PROFILE_MIN_COVERAGE of
    their call's CUDA-event time (``profile_table``: kernels and the
    device's waits on the host; far below 1, the profile missed kernels);
    ``driver_coverage``: every 15b attempt's."""
    out = {}
    tables = [("phase5_pcg_iteration", pcg_profile)] + [
        (f"phase15b_driver_iteration{i}_pcg_step", p) for i, p in driver_profiles.items()]
    check(len(tables) >= 2, "15c: no covered profile of a driver iteration")
    for label, p in tables:
        rows = p["rows"]
        check(p["coverage"] >= PROFILE_MIN_COVERAGE,
              f"15c {label}: the profile covers {p['coverage']} of the step")
        busy = sum(r[1] for r in rows)
        lib = library_elementwise(rows)
        worst = max((us for _, us, _ in lib), default=0.0)
        check(worst <= LIBRARY_ELEMENTWISE_MAX_US,
              f"15c {label}: a PyTorch elementwise kernel takes {worst} us per launch: {lib}")
        check_k5_per_call(p, f"15c {label}")
        out[label] = dict(wall_ms=p["wall_ms"], event_ms=p["event_ms"], device_busy_ms=busy,
                          coverage=p["coverage"], idle_share=1.0 - busy / p["wall_ms"],
                          host_wait_share=p["host_wait_ms"] / p["event_ms"], k5=p["k5"],
                          lost_launches=p["lost_launches"],
                          top15=[(name[:90], ms, count) for name, ms, count in rows[:15]],
                          library_elementwise=lib)
    say("15c", ok=True, max_library_elementwise_us=LIBRARY_ELEMENTWISE_MAX_US,
        min_coverage=PROFILE_MIN_COVERAGE, phase5_attempts=pcg_profile["attempts"],
        phase15b_attempts=driver_coverage, card=smi, **out)


# phase 15d: the ordered driver through the gather-sharded solver on ranks
# that share the card through a gloo group (NCCL refuses two ranks on one
# card), one level below the flagship (32.4M DOFs) in float64, against the
# single-device driver: the run in which K12's cross-shard kernels serve
# the path (a world of one has no cross groups)
SHARED_CARD_RANKS = 2
SHARED_CARD_CALL = dict(n=2, dim=3, refinements=2, tolerance=1e-6, seed=7, coarse="mg",
                        smoother="chebyshev", inner="pcg", solver_opts=dict(coarse_mg_tol=5e-2))
SHARED_CARD_SIGMA_TOL = 1e-8


def sharded_shared_card(dev, smi):
    """Phase 15d: SHARED_CARD_CALL (geometry="ordered", float64) on
    SHARED_CARD_RANKS spawned ranks on the card, each counting its hand
    kernels' launches from zero over its driver call, and in this process
    on the single device: every rank's sigma bitwise equal, within
    SHARED_CARD_SIGMA_TOL relative of the single device's, and every kernel
    of the ordered path, K12's cross-shard kernels included, launched on
    every rank. Returns the launches summed over the ranks."""
    import torch

    from homogenization_jl_tpu_torch.models.checkerboard import checkerboard_homogenization
    from homogenization_jl_tpu_torch.parallel import run_slab

    t0 = time.perf_counter()
    kw = dict(SHARED_CARD_CALL, dtype=torch.float64)
    outs = run_slab.spawn_ranks(
        SHARED_CARD_RANKS, dict(kind="ordered_driver", kwargs=kw, device="cuda"), timeout=600)
    t_ranks = time.perf_counter() - t0
    t1 = time.perf_counter()
    sigma, trace = checkerboard_homogenization(**kw, geometry="ordered", return_trace=True,
                                               device=dev)
    t_single = time.perf_counter() - t1
    got = outs[0]["sigma"]
    check(all(o["sigma"] == got for o in outs), f"15d: ranks disagree: {[o['sigma'] for o in outs]}")
    rel = abs(got - sigma) / abs(sigma)
    check(rel <= SHARED_CARD_SIGMA_TOL, f"15d: sigma {got} vs single device {sigma} (rel {rel})")
    path = FLAGSHIP_ORDERED_PATH + ("sharded_combine",)
    for o in outs:
        check(all(o["job_launches"][k] > 0 for k in path),
              f"15d: a kernel never ran on a rank: {o['job_launches']}")
    launches = {k: sum(o["job_launches"][k] for o in outs) for k in outs[0]["job_launches"]}
    say("15d", ok=True, ranks=SHARED_CARD_RANKS, call=dict(SHARED_CARD_CALL, dtype="float64"),
        sigma=got, sigma_single=sigma, sigma_rel_diff=rel, cycles_per_step=outs[0]["cycles_per_step"],
        cycles_per_step_single=trace.cycles_per_step, ranks_wall_s=t_ranks, single_wall_s=t_single,
        launches_per_rank=[o["job_launches"] for o in outs], card=smi)
    torch.cuda.empty_cache()
    return launches


# --------------------------------------------------------------------- #
# --------------------------------------------------------------------- #
# phases 16-18b: the precision surface (K15, K16, the bench entry point,
# mixed-precision PCG)
# --------------------------------------------------------------------- #
K16_PAIRS = (("float32", "bfloat16"), ("float32", "float16"), ("float64", "float32"),
             ("float64", "bfloat16"), ("float64", "float16"))


def check_precision_kernels(outer, inner, plan, coeff64, dev):
    """Phase 16, at the finest main-path shape (E = 196,608, n = 969): K15's
    two entries (float64 -> float32 with and without the scale, float32 ->
    float64) and every K16 variant (K1's apply, residual and masked forms,
    in place too; K3's first, x_zero and later steps; K5 with and without
    the mask and the scale; K10's step (in place, r_out, x only, x_zero),
    its direction store from p in place and from rc alone) for bfloat16 and
    float16 directions under float32 and float64 states and float32 under
    float64, each bitwise equal to its plain form (K1 and K5: the
    state-type kernel on the widened operand). Times (float32 state,
    bfloat16 direction: the path's forms), K15's, and K1 and K2 in float64
    (the mixed solve's outer apply and combine). Returns ({kernel: entry},
    report)."""
    import torch

    from homogenization_jl_tpu_torch.ops import apply as k_apply
    from homogenization_jl_tpu_torch.ops import cg as k_cg
    from homogenization_jl_tpu_torch.ops import chebyshev as k_cheb
    from homogenization_jl_tpu_torch.ops import dots as k_dots
    from homogenization_jl_tpu_torch.ops import mixed as k_mixed
    from homogenization_jl_tpu_torch.ops import structured as k_st

    g = torch.Generator(device=dev).manual_seed(1616)
    top = plan.nlevels - 1
    E, n = plan.base.nelements, plan.n_local(top)
    N = E * n
    timing, report = {}, {}

    def same(a, b_):
        return torch.equal(_bits(a), _bits(b_))

    # K15: the downcast at the assembled scale and the upcast
    c = torch.randn((E, n), generator=g, device=dev, dtype=torch.float64) * 1e3
    s = torch.rand((E, n), generator=g, device=dev, dtype=torch.float32)
    z = torch.randn((E, n), generator=g, device=dev, dtype=torch.float32)
    check(same(k_mixed.downcast_scale(c, s), k_mixed.downcast_scale_plain(c, s)),
          "K15 downcast_scale differs from plain")
    check(same(k_mixed.downcast_scale(c), k_mixed.downcast_scale_plain(c)),
          "K15 downcast differs from plain")
    check(same(k_mixed.upcast(z), k_mixed.upcast_plain(z)), "K15 upcast differs from plain")
    # an odd N (the scalar tail of the vector path) and views one entry in
    # (not 16-byte aligned: the scalar path), against .to() itself
    for off, NN in ((0, N - 3), (1, N - 1)):
        cv, sv, zv = (t.view(-1)[off : off + NN] for t in (c, s, z))
        check(same(k_mixed.downcast_scale(cv, sv), cv.to(torch.float32) * sv)
              and same(k_mixed.downcast_scale(cv), cv.to(torch.float32))
              and same(k_mixed.upcast(zv), zv.to(torch.float64)),
              f"K15 at N = {NN}, offset {off}: differs from .to()")
    # no single PyTorch call casts and scales; the two forms that .to()
    # computes are timed in turns with it (12 bytes per entry each)
    t, samples = turns_ms(dict(kernel=lambda: k_mixed.downcast_scale(c, s)), 10)
    timing["mixed_boundary"] = entry(
        0.0, t["kernel"], cuda_ms(lambda: k_mixed.downcast_scale_plain(c, s), 10),
        nbytes=16 * N, flops=N)
    report["downcast_scale_quartiles"] = quartiles(samples)["kernel"]
    for name, kern, plain, lib in (
            ("downcast", lambda: k_mixed.downcast_scale(c), lambda: k_mixed.downcast_scale_plain(c),
             lambda: c.to(torch.float32)),
            ("upcast", lambda: k_mixed.upcast(z), lambda: k_mixed.upcast_plain(z),
             lambda: z.to(torch.float64))):
        t, samples = turns_ms(dict(kernel=kern, library=lib), 10)
        report[name] = entry(0.0, t["kernel"], cuda_ms(plain, 10), nbytes=12 * N, flops=0,
                             library_ms=t["library"])
        report[name]["quartiles"] = quartiles(samples)
    del c, s, z
    torch.cuda.empty_cache()

    dtypes = dict(float32=torch.float32, float64=torch.float64, bfloat16=torch.bfloat16,
                  float16=torch.float16)
    checked = []
    for sname, dname in K16_PAIRS:
        sdt, ddt = dtypes[sname], dtypes[dname]
        isz, dsz = torch.finfo(sdt).bits // 8, torch.finfo(ddt).bits // 8
        L = (inner if sdt == torch.float32 else outer).levels[top]
        stack, rowsum, tab, coeff = L.stack, L.rowsum, L.table, coeff64.to(sdt)
        P = stack.shape[0]

        def rnd():
            return torch.randn((E, n), generator=g, device=dev, dtype=sdt)

        p, x, rc, dinv, b = rnd().to(ddt), rnd(), rnd(), rnd().abs(), rnd()
        m = torch.rand((E, n), generator=g, device=dev) < 0.7
        pw = p.to(sdt)
        for label, kw in (("apply", {}), ("residual", dict(b=b)), ("masked", dict(mask=m)),
                          ("masked_residual", dict(b=b, mask=m))):
            got = k_apply.element_apply_half(p, coeff, stack, rowsum=rowsum, table=tab, **kw)
            want = k_apply.element_apply(pw, coeff, stack, rowsum=rowsum, table=tab, **kw)
            check(same(got, want),
                  f"K16 apply {label} {sname}/{dname}: differs from K1 on the widened x")
            del got, want
        r = b.clone()
        k_apply.element_apply_half(p, coeff, stack, b=r, out=r, rowsum=rowsum, table=tab)
        check(same(r, k_apply.element_apply(pw, coeff, stack, b=b, rowsum=rowsum, table=tab)),
              f"K16 apply in place {sname}/{dname}: differs")
        del r
        ab = torch.tensor([0.37, 1.9], dtype=sdt, device=dev)
        for first, x_zero in ((True, True), (True, False), (False, False)):
            xk, pk, xp, pp = x.clone(), p.clone(), x.clone(), p.clone()
            if x_zero:
                xk.fill_(float("nan"))
            k_cheb.chebyshev_update_half(xk, pk, rc, dinv, ab, first=first, x_zero=x_zero)
            k_cheb.chebyshev_update_half_plain(xp, pp, rc, dinv, ab, first, x_zero)
            check(same(pk, pp) and same(xk, xp),
                  f"K16 chebyshev first={first} x_zero={x_zero} {sname}/{dname}: differs")
            del xk, pk, xp, pp
        for kw in ({}, dict(mask=m), dict(scale=dinv), dict(mask=m, scale=dinv)):
            got = k_dots.dot_half(p, rc, **kw)
            check(same(got, k_dots.dot(pw, rc, **kw)) and same(got, k_dots.dot_plain(pw, rc, **kw)),
                  f"K16 dot {sorted(kw)} {sname}/{dname}: differs")
        num = torch.tensor(0.8, dtype=sdt, device=dev)
        for den_v in (1.3, 0.0):
            den = torch.tensor(den_v, dtype=sdt, device=dev)
            for r_out, with_r, x_zero in ((False, True, False), (True, True, False),
                                          (False, False, True)):
                xk, xp = x.clone(), x.clone()
                rk, rp = (rc.clone(), rc.clone()) if with_r else (None, None)
                ok, op = (torch.empty_like(rc), torch.empty_like(rc)) if r_out else (None, None)
                k_cg.cg_step_half(xk, rk, p, b if with_r else None, num, den, r_out=ok,
                                  x_zero=x_zero)
                k_cg.cg_step_half_plain(xp, rp, p, b if with_r else None, num, den, r_out=op,
                                        x_zero=x_zero)
                check(same(xk, xp) and all(a is None or same(a, c_) for a, c_ in
                                           ((rk, rp), (ok, op))),
                      f"K16 cg_step r_out={r_out} x_zero={x_zero} den={den_v} "
                      f"{sname}/{dname}: differs")
                del xk, xp, rk, rp, ok, op
            for from_p in (True, False):
                pk, pp = p.clone(), p.clone()
                k_cg.cg_direction_half(pk, rc, pk if from_p else None, num, den)
                k_cg.cg_direction_half_plain(pp, rc, pp if from_p else None, num, den)
                check(same(pk, pp), f"K16 cg_direction from_p={from_p} {sname}/{dname}: differs")
                del pk, pp
        checked.append(f"{sname}/{dname}")
        den = torch.tensor(1.3, dtype=sdt, device=dev)
        if (sname, dname) == ("float32", "bfloat16"):
            # the path's forms: the residual update r -= A load(p) in place,
            # a later Chebyshev step, vdot(load(p), A p), x += alpha load(p)
            r = b.clone()
            timing["direction_apply"] = entry(
                0.0, cuda_ms(lambda: k_apply.element_apply_half(p, coeff, stack, b=r, out=r,
                                                                rowsum=rowsum, table=tab), 5),
                cuda_ms(lambda: k_apply.element_apply_plain(p.to(sdt), coeff, stack, b=b,
                                                            rowsum=rowsum), 3),
                nbytes=dsz * N + isz * (2 * N + E * P) + table_bytes(tab),
                flops=apply_flops(E, tab))
            xk, pk = x.clone(), p.clone()
            timing["direction_chebyshev"] = entry(
                0.0, cuda_ms(lambda: k_cheb.chebyshev_update_half(xk, pk, rc, dinv, ab), 10),
                cuda_ms(lambda: k_cheb.chebyshev_update_half_plain(xk, pk, rc, dinv, ab, False),
                        10),
                nbytes=(4 * isz + 2 * dsz) * N, flops=5 * N)
            timing["direction_dot"] = entry(
                0.0, cuda_ms(lambda: k_dots.dot_half(p, rc), 10),
                cuda_ms(lambda: k_dots.dot_plain(p.to(sdt), rc), 3),
                nbytes=(isz + dsz) * N, flops=2 * N)
            rk = rc.clone()
            timing["direction_cg"] = entry(
                0.0, cuda_ms(lambda: k_cg.cg_step_half(xk, rk, p, b, num, den), 10),
                cuda_ms(lambda: k_cg.cg_step_half_plain(xk, rk, p, b, num, den), 10),
                nbytes=(5 * isz + dsz) * N, flops=4 * N)
            report["direction_cg_direction_ms"] = cuda_ms(
                lambda: k_cg.cg_direction_half(pk, rc, pk, num, den), 10)
            del r, xk, pk, rk
        if (sname, dname) == ("float64", "bfloat16"):
            # K1 and K2 in float64 (the mixed solve's outer apply and
            # combine); K1's bound by its bytes (its nonzero work over the
            # FP64 peak, 67 TFLOP/s, is less)
            xw = rnd()
            k1 = entry(0.0, cuda_ms(lambda: k_apply.element_apply(xw, coeff, stack, b=b,
                                                                   rowsum=rowsum, table=tab), 5),
                       None, nbytes=8 * (3 * N + E * P) + table_bytes(tab),
                       flops=apply_flops(E, tab),
                       library_ms=cuda_ms(lambda: torch.einsum("en,pmn,ep->em", xw, stack,
                                                                coeff), 2))
            k1.update(apply_ms=cuda_ms(lambda: k_apply.element_apply(xw, coeff, stack, table=tab),
                                       5))
            report["element_apply_f64"] = k1
            st = outer.levels[top].structured
            report["structured_combine_f64"] = entry(
                0.0, cuda_ms(lambda: k_st.combine_structured(xw, st, constrain=True), 10),
                cuda_ms(lambda: k_st.combine_structured_plain(xw, st, constrain=True), 3),
                nbytes=8 * 2 * N, flops=combine_adds(plan, top, E))
            del xw
        del p, pw, x, rc, dinv, b, m, coeff
        torch.cuda.empty_cache()
    report["bitwise_pairs"] = checked
    return timing, report


def bench_entry(smi, n):
    """Phase 17a: ``python -m homogenization_jl_tpu_torch.bench`` in a
    subprocess at its defaults (the BENCH_* knobs cleared; n = 32 unless a
    rehearsal size is given): the partial and the final line parse, the
    metric and every detail key are there, the device is this card, and at
    n = 32 the solve takes BENCH_ITERS within 1. Returns the final line."""
    import torch

    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    if n != 32:
        env["BENCH_N"] = str(n)
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "homogenization_jl_tpu_torch.bench"], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=BENCH_TIMEOUT_S)
    wall = time.perf_counter() - t0
    check(res.returncode == 0, f"17: the bench exited {res.returncode}: {res.stderr[-3000:]}")
    lines = [json.loads(ln) for ln in res.stdout.splitlines() if ln.startswith("{")]
    check(len(lines) == 2 and lines[0]["detail"].get("partial") is True,
          f"17: expected a partial and a final line: {res.stdout[-2000:]}")
    out = lines[-1]
    d = out["detail"]
    check(out["metric"] == "gmg_vcycle_dof_per_s_per_chip_3d_checkerboard"
          and out["unit"] == "DOF/s" and out["value"] > 0, f"17: the line: {out}")
    missing = [k for k in BENCH_DETAIL_KEYS if k not in d]
    check(not missing, f"17: detail lacks {missing}")
    check(d["device"] == torch.cuda.get_device_name(0), f"17: device {d['device']}")
    if n == 32:
        check(d["dofs"] == 190_513_152, f"17: {d['dofs']} DOFs")
        for got, want, tol in ((d["iters_to_1e3"], BENCH_ITERS[0], "1e-3"),
                               (d["iters_to_1e4"], BENCH_ITERS[1], "1e-4")):
            check(got is not None and abs(got - want) <= 1,
                  f"17: {got} PCG iterations to {tol}, expected {want} +- 1")
    return dict(out, wall_s=wall)


def bf16_directions(hz, kbuild, plan, sigma, b_np, dev, dense, sec_iter_phase5):
    """Phase 17b: phase 5's solve with direction_dtype="bfloat16" (K16's
    apply and Chebyshev update on its path): BENCH_BF16_ITERS within 1 at
    n = 32, seconds per PCG iteration beside phase 5's; then three V-cycles
    of the bench's vcycle mode (cg_exact, smooth_precision="high") with
    bfloat16 directions (K16's dot and CG forms), the residual falling.
    Returns (report, launches of the Chebyshev solve, launches of the
    cycles)."""
    import torch

    b = torch.as_tensor(b_np, device=dev, dtype=torch.float32)
    s = hz.MultigridSolver(plan, dtype=torch.float32, device=dev, smoother="chebyshev",
                           coarse="mg", coarse_mg_tol=5e-2, direction_dtype="bfloat16", **dense)
    kbuild.reset_launches()
    t0 = time.perf_counter()
    x, hist = s.solve(b, sigma, 0.0, tol=1e-4, method="auto", max_cycles=30)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kbuild.LAUNCHES)
    check(all(launches[k] > 0 for k in BF16_CHEB_PATH), f"17b: a kernel never ran: {launches}")
    check(bool(torch.isfinite(x).all()) and hist[-1] < 1e-4, f"17b: history {hist}")

    def iters_to(tol):
        return next((i - 1 for i in range(1, len(hist)) if hist[i] < tol), None)

    it3, it4 = iters_to(1e-3), iters_to(1e-4)
    if plan.base.nelements == 196_608:
        for got, want, tol in ((it3, BENCH_BF16_ITERS[0], "1e-3"),
                               (it4, BENCH_BF16_ITERS[1], "1e-4")):
            check(got is not None and abs(got - want) <= 1,
                  f"17b: {got} PCG iterations to {tol} with bfloat16 directions, "
                  f"expected {want} +- 1")
    coeff = s.coefficients(sigma, 0.0)
    setup = s.coarse_setup(sigma, 0.0)
    lam_max = s.estimate_lambda_max(coeff)
    state = list(s._pcg_init_impl(torch.zeros_like(b), b, coeff, setup, lam_max))

    def pcg_step():
        state[:] = s._pcg_step_impl(*state[:4], coeff, setup, lam_max, flexible=True)

    sec_iter = cuda_ms(pcg_step, 5) / 1e3
    del state, x, s, coeff, setup
    torch.cuda.empty_cache()

    s2 = hz.MultigridSolver(plan, dtype=torch.float32, device=dev, smoother="cg_exact",
                            coarse="mg", coarse_mg_tol=5e-2, smooth_precision="high",
                            direction_dtype="bfloat16", **dense)
    coeff = s2.coefficients(sigma, 0.0)
    setup = s2.coarse_setup(sigma, 0.0)
    b_norm = float(s2.residual_norm(b))
    kbuild.reset_launches()
    x, _ = s2.zero_states()
    norms = []
    for _ in range(3):
        x, r = s2.vcycle(x, b, coeff, setup)
        norms.append(float(s2.residual_norm(r)) / b_norm)
    torch.cuda.synchronize()
    launches_cg = dict(kbuild.LAUNCHES)
    check(all(launches_cg[k] > 0 for k in BF16_CG_PATH), f"17b: a kernel never ran: {launches_cg}")
    check(all(math.isfinite(v) for v in norms) and norms[2] < norms[1] < norms[0],
          f"17b: cg_exact cycles with bfloat16 directions: {norms}")
    del x, r, s2, coeff, setup, b
    torch.cuda.empty_cache()
    report = dict(history=hist, iters_to_1e3=it3, iters_to_1e4=it4, solve_wall_s=wall,
                  sec_per_pcg_iter=sec_iter, sec_per_pcg_iter_phase5=sec_iter_phase5,
                  cg_exact_cycles_rel=norms, launches=launches, launches_cg_exact=launches_cg)
    return report, launches, launches_cg


def mixed_solve(kbuild, outer, inner, sigma, b_np, dev, smi):
    """Phase 18: run_mixed_pcg's solve (outer float64 / inner float32
    Chebyshev, coarse="mg", coarse_mg_tol=5e-2 inside) at the main-path
    size: the setup's seconds, two warm-up iterations, then the solve to
    MIXED_TOL with keep_best between CUDA events (seconds per iteration);
    its history and crossings, 1e-6 within MIXED_1E6_WITHIN iterations;
    peak memory; the float64 residual of the returned x recomputed from
    scratch; the kernels of the solve; one step under torch.profiler
    (phase 15c's rules). Returns the solve's launches."""
    import torch

    from homogenization_jl_tpu_torch.solver.multigrid import (
        mixed_precision_pcg,
        mixed_precision_setup,
    )

    b = torch.as_tensor(b_np, device=dev, dtype=torch.float64)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    setup = mixed_precision_setup(outer, inner, sigma)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    x, h2 = mixed_precision_pcg(outer, inner, b, setup=setup, iters=2, tol=0.0)
    del x
    kbuild.reset_launches()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    x, hist = mixed_precision_pcg(outer, inner, b, setup=setup, iters=MIXED_ITERS, tol=MIXED_TOL,
                                  keep_best=True)
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kbuild.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    iters = len(hist) - 1
    sec_iter = start.elapsed_time(end) / 1e3 / iters
    rel = [h / hist[0] for h in hist]
    cross = {f"{t:g}": next((i for i, v in enumerate(rel) if v < t), None)
             for t in (1e-3, 1e-4, 1e-6, 1e-9)}
    check(all(launches[k] > 0 for k in MIXED_PATH), f"18: a kernel never ran: {launches}")
    check(bool(torch.isfinite(x).all()), "18: non-finite x")
    check(cross["1e-06"] is not None and cross["1e-06"] <= MIXED_1E6_WITHIN,
          f"18: 1e-6 crossed at {cross['1e-06']} > {MIXED_1E6_WITHIN}: {rel}")
    top = outer.nlevels - 1
    r = outer._local_residual(x, b, setup.coeff_o, top)
    recomputed = float(outer.residual_norm(outer.combine(r))) / hist[0]
    del r
    check(recomputed <= MIXED_RECOMPUTED_MAX,
          f"18: the returned x's recomputed residual {recomputed} > {MIXED_RECOMPUTED_MAX}")
    del x
    torch.cuda.empty_cache()
    # one step under torch.profiler
    init, step = outer._mixed_pcg_programs(inner)
    state = list(init(outer.zero_states()[0], b, setup))

    def mixed_step():
        state[:] = step(*state[:4], setup)

    mixed_step()
    prof_d, prof = covered_profile(mixed_step, "phase 18")
    del prof, state
    rows = prof_d["rows"]
    lib = library_elementwise(rows)
    worst = max((us for _, us, _ in lib), default=0.0)
    check(worst <= LIBRARY_ELEMENTWISE_MAX_US,
          f"18: a PyTorch elementwise kernel takes {worst} us per launch: {lib}")
    busy = sum(rw[1] for rw in rows)
    check_k5_per_call(prof_d, "18")
    say(18, ok=True, dofs=int(np.prod(b_np.shape)), history=hist, rel_history=rel,
        iterations=iters, crossings=cross, sec_per_iter=sec_iter, solve_wall_s=wall,
        setup_s=t_setup, warmup_history=h2, max_memory_allocated=peak,
        recomputed_rel_residual=recomputed, launches=launches,
        profile=dict(wall_ms=prof_d["wall_ms"], event_ms=prof_d["event_ms"],
                     coverage=prof_d["coverage"], attempts=prof_d["attempts"],
                     device_busy_ms=busy, idle_share=1.0 - busy / prof_d["wall_ms"],
                     host_wait_share=prof_d["host_wait_ms"] / prof_d["event_ms"],
                     lost_launches=prof_d["lost_launches"], k5=prof_d["k5"],
                     top15=[(name[:90], ms, cnt) for name, ms, cnt in rows[:15]],
                     library_elementwise=lib, max_library_elementwise_us=worst),
        card=smi)
    del b, setup
    torch.cuda.empty_cache()
    return launches


def mixed_slab(dev, smi, n):
    """Phase 18b: run_slab's "mixed" job (mixed-precision PCG on slabs, K11
    the combine) through an NCCL group of one rank, with the single-device
    leg on the same cube-order plan (``compare``): one rank does the
    single device's arithmetic, so the histories and x must be equal."""
    import torch

    from homogenization_jl_tpu_torch.parallel import run_slab
    from homogenization_jl_tpu_torch.parallel.group import SlabGroup

    store = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    group = SlabGroup.from_file(os.path.join(store, "store"), 0, 1, device=dev)
    try:
        t0 = time.perf_counter()
        out = run_slab.run_mixed(group, 3, n, 5, iters=MIXED_ITERS, tol=MIXED_TOL, compare=True)
        wall = time.perf_counter() - t0
    finally:
        SlabGroup.destroy()
        shutil.rmtree(store, ignore_errors=True)
    check(all(out["launches"][k] > 0 for k in MIXED_SLAB_PATH),
          f"18b: a kernel never ran: {out['launches']}")
    check(out["history"] == out["history_single"] and out["x_rel_diff"] == 0.0,
          f"18b: the slab of one differs from the single device: {out['history']} vs "
          f"{out['history_single']}, x {out['x_rel_diff']}")
    h = out["history"]
    check(h[-1] <= 1e-6 * h[0], f"18b: history {h}")
    say("18b", ok=True, n=n, wall_s=wall, card=smi, **out)
    torch.cuda.empty_cache()


# --------------------------------------------------------------------- #
# phases 19-21: the multishift recurrence and st1 (K13, K14, K17)
# --------------------------------------------------------------------- #
def check_multishift_kernels(dev):
    """Phase 19: K13, K14a/b/c and K17 against their plain forms at the
    shapes of phases 20 and 21, float32 and float64 (K17: float32). Returns
    ({kernel: entry} at float64 (K17 float32), report)."""
    import torch

    from homogenization_jl_tpu_torch.fem.local_operators import build_level_operators
    from homogenization_jl_tpu_torch.mesh.reference import refined_reference
    from homogenization_jl_tpu_torch.ops import dots as k_dots
    from homogenization_jl_tpu_torch.ops import integrals as k_int
    from homogenization_jl_tpu_torch.ops import multishift as k_ms
    from homogenization_jl_tpu_torch.ops import recurrence as k_rec
    from homogenization_jl_tpu_torch.ops.apply import (
        element_apply,
        element_apply_plain,
        stack_table,
    )
    from homogenization_jl_tpu_torch.csrc import build as kbuild
    from homogenization_jl_tpu_torch.utils import fft_field as k_ff

    g = torch.Generator(device=dev).manual_seed(19)
    E, n = CONFIG4_STATE
    # config 4's finest mass matrix (refinements = 4, n_local 969): the
    # kernels' work follows its nonzeros
    mass64 = build_level_operators(refined_reference(3, CONFIG4["refinements"] + 1))[-1].stack[-1]
    check(mass64.shape == (n, n), f"phase 19: mass matrix {mass64.shape}, expected {(n, n)}")
    N = E * n
    ns, m, K = 3, CONFIG4_LANCZOS, 3
    timing, report = {}, {}
    for dtype in (torch.float32, torch.float64):
        f64 = dtype == torch.float64
        es = 8 if f64 else 4
        tag = str(dtype)[6:]

        def rand(*shape):
            return torch.randn(shape, generator=g, dtype=dtype, device=dev)

        # K13: k == 0, k > 0 and a D == 0 guard, bitwise
        shifts = torch.tensor([1.0, 0.5, 0.25], dtype=dtype, device=dev)
        v, W, xs = rand(E, n), rand(ns, E, n), rand(ns, E, n)
        tc, tp = rand(), rand()
        for case in ("first", "later", "D-zero"):
            D = rand(ns) + 2
            if case == "D-zero":
                D[1] = 0
            y = rand(ns)
            Wk, xk, Wp, xp = W.clone(), xs.clone(), W.clone(), xs.clone()
            got = k_ms.multishift_step(v, Wk, xk, shifts, tc, tp, D, y, case == "first")
            ref = k_ms.multishift_step_plain(v, Wp, xp, shifts, tc, tp, D, y, case == "first")
            for a, b in zip(got + (Wk, xk), ref + (Wp, xp)):
                check(torch.equal(_bits(a), _bits(b)), f"K13 {case} {dtype}: differs from plain")
            del Wp, xp
        if f64:
            timing["multishift_update"] = entry(
                0.0, cuda_ms(lambda: k_ms.multishift_step(v, Wk, xk, shifts, tc, tp, D, y, False), 5),
                cuda_ms(lambda: k_ms.multishift_step_plain(v, Wk, xk, shifts, tc, tp, D, y, False), 3),
                nbytes=(1 + 4 * ns) * N * es, flops=4 * ns * N)
        del v, W, xs, Wk, xk
        torch.cuda.empty_cache()

        # K14a: bitwise, two launches equal, the dots K5's
        x, r, p, Ap = rand(E, n), rand(E, n), rand(E, n), rand(E, n)
        d = rand(E, n).abs() + 0.5
        w = torch.rand((E, n), generator=g, device=dev) < 0.7
        num, den = rand(), rand()
        outs = []
        for _ in range(2):
            xk, rk = x.clone(), r.clone()
            outs.append((xk, rk) + k_rec.jacobi_cg_step(xk, rk, p, Ap, d, w, num, den))
        xp, rp = x.clone(), r.clone()
        ref = (xp, rp) + k_rec.jacobi_cg_step_plain(xp, rp, p, Ap, d, w, num, den)
        for a, b, c in zip(outs[0], outs[1], ref):
            check(torch.equal(_bits(a), _bits(b)), f"K14a {dtype}: two launches differ")
            check(torch.equal(_bits(a), _bits(c)), f"K14a {dtype}: differs from plain")
        # its two dots are K5's on the updated r and z, bit for bit
        _, r1, z1, rz1, rs1 = outs[0]
        check(torch.equal(_bits(rz1), _bits(k_dots.dot(r1, z1, mask=w)))
              and torch.equal(_bits(rs1), _bits(k_dots.dot(r1, r1, mask=w))),
              f"K14a {dtype}: its dots differ from K5's")
        if f64:
            xk, rk = outs[0][0], outs[0][1]
            timing["jacobi_cg"] = entry(
                0.0, cuda_ms(lambda: k_rec.jacobi_cg_step(xk, rk, p, Ap, d, w, num, den), 5),
                cuda_ms(lambda: k_rec.jacobi_cg_step_plain(xp, rp, p, Ap, d, w, num, den), 3),
                nbytes=(8 * es + 1) * N, flops=9 * N)
        del x, r, p, Ap, d, w, outs, ref, xp, rp, xk, rk
        torch.cuda.empty_cache()

        # K14b: K9's DOT_M mode within phase 3b's K9 bars, repeatable
        mass = torch.as_tensor(mass64, device=dev).to(dtype).contiguous()
        tab = stack_table(mass[None])
        u, vv, detJ = rand(E, n), rand(E, n), rand(E).abs() + 0.5
        got = k_int.dot_M(u, vv, mass, detJ, table=tab)
        again = k_int.dot_M(u, vv, mass, detJ, table=tab)
        ref = k_int.sigma_integral_plain(k_int.DOT_M, vv, mass, u, detJ, None)
        scale = float(k_int.sigma_integral_plain(k_int.DOT_M, vv.abs(), mass.abs(), u.abs(), detJ,
                                                 None))
        err = abs(float(got) - float(ref)) / scale
        check(torch.equal(_bits(got), _bits(again)), f"K14b {dtype}: two launches differ")
        check(err <= (1e-12 if f64 else 1e-5), f"K14b {dtype}: rel err {err}")
        report[f"K14b_{tag}_rel_err"] = err
        report[f"K14b_{tag}_ms"] = cuda_ms(lambda: k_int.dot_M(u, vv, mass, detJ, table=tab), 10)
        if f64:
            timing["mass_dot"] = entry(
                abs(float(got) - float(ref)),
                cuda_ms(lambda: k_int.dot_M(u, vv, mass, detJ, table=tab), 10),
                cuda_ms(lambda: k_int.sigma_integral_plain(k_int.DOT_M, vv, mass, u, detJ, None), 3),
                nbytes=es * (2 * N + E) + table_bytes(tab), flops=apply_flops(E, tab) + 3 * N,
                library_ms=cuda_ms(lambda: torch.einsum("e,em,mn,en->", detJ, u, mass, vv), 3))
            timing["mass_dot"]["csr_mm_ms"] = csr_mm_ms(mass, vv, 3)
        del u, vv, detJ
        torch.cuda.empty_cache()

        if f64:
            # K1's mass apply of the mass solves: the one-piece stack [M],
            # coefficient detJ, the boundary mask at the store
            u, detJ = rand(E, n), rand(E, 1).abs() + 0.5
            bm = torch.rand((E, n), generator=g, device=dev) < 0.9
            got = element_apply(u, detJ, mass[None], mask=bm, table=tab)
            ref = element_apply_plain(u, detJ, mass[None]) * bm
            err = float((got - ref).abs().max())
            check(err <= 1e-12 * float(ref.abs().max()), f"K1 mass apply: abs err {err}")
            report["K1_mass_apply_float64"] = entry(
                err, cuda_ms(lambda: element_apply(u, detJ, mass[None], mask=bm, table=tab), 10),
                cuda_ms(lambda: element_apply_plain(u, detJ, mass[None]) * bm, 3),
                nbytes=es * (2 * N + E) + N + table_bytes(tab), flops=apply_flops(E, tab) + 2 * N)
            # the same product alone (no detJ, no mask): cuBLAS's dense GEMM
            # and cuSPARSE's CSR product
            report["K1_mass_apply_float64"]["gemm_ms"] = cuda_ms(lambda: torch.mm(u, mass), 3)
            report["K1_mass_apply_float64"]["csr_mm_ms"] = csr_mm_ms(mass, u, 3)
            del u, detJ, bm, got, ref
            torch.cuda.empty_cache()
        del mass, tab

        # K14c: one-pass with m = 120, K + 1 = 3; the two-pass accumulation
        V, Y = rand(m, E, n), rand(K, m)
        out = k_rec.basis_combine(V, Y)
        ref = k_rec.basis_combine_plain(V, Y)
        check(torch.equal(_bits(out), _bits(ref)), f"K14c combine {dtype}: differs from plain")
        del ref
        sums = torch.empty_like(out)
        Yt = Y.T.contiguous()
        for j in range(m):
            k_rec.basis_accumulate(sums, V[j], Yt[j], first=j == 0)
        check(torch.equal(_bits(sums), _bits(out)), f"K14c accumulate {dtype}: differs from combine")
        acc = k_rec.basis_accumulate_plain
        sums_p = sums.clone()
        k_rec.basis_accumulate(sums, V[1], Yt[1])
        acc(sums_p, V[1], Yt[1], False)
        check(torch.equal(_bits(sums), _bits(sums_p)), f"K14c accumulate {dtype}: differs from plain")
        # the combination in turns with cuBLAS's product of the same
        # function; the accumulation (no single call: it updates K sums in
        # place); a copy of eight basis vectors, the card's stream rate
        t, samples = turns_ms(dict(kernel=lambda: k_rec.basis_combine(V, Y),
                                   matmul=lambda: torch.matmul(Y, V.view(m, -1))), 3)
        combine = entry(0.0, t["kernel"],
                        cuda_ms(lambda: k_rec.basis_combine_plain(V, Y), 1) if f64 else None,
                        nbytes=(m + K) * N * es, flops=2 * m * K * N, library_ms=t["matmul"])
        report[f"K14c_combine_{tag}_quartiles"] = quartiles(samples)
        report[f"K14c_accumulate_{tag}"] = entry(
            0.0, cuda_ms(lambda: k_rec.basis_accumulate(sums, V[1], Yt[1]), 10),
            cuda_ms(lambda: acc(sums_p, V[1], Yt[1], False), 3), nbytes=(2 * K + 1) * N * es,
            flops=2 * K * N)
        copy_ms = cuda_ms(lambda: V[:8].clone(), 3)
        report[f"K14c_copy_{tag}"] = dict(ms=copy_ms, TBps=2 * 8 * N * es / copy_ms / 1e9)
        if f64:
            timing["basis_combine"] = combine
        else:
            report["K14c_combine_float32"] = combine
        del V, Y, out, sums, sums_p, Yt
        torch.cuda.empty_cache()

    # K17 at 32^3 on the JAX draw of phase 21
    shape = (32, 32, 32)
    noise = torch.as_tensor(k_ff.pinned_noise(3, shape), device=dev)
    F = torch.fft.rfftn(noise).contiguous()
    fk = k_ff.spectral_filter(F, shape, 1.5)
    fp = k_ff.spectral_filter_plain(F, shape, 1.5)
    err_a = float((fk - fp).abs().max()) / float(fp.abs().max())
    check(err_a <= 1e-6, f"K17a: rel err {err_a}")
    f = torch.fft.irfftn(fp, s=shape).contiguous()
    ek, ep = k_ff.exp_abs(f, ST1["alpha"]), k_ff.exp_abs_plain(f, ST1["alpha"])
    err_b = float((ek / ep - 1).abs().max())
    check(err_b <= 4e-6, f"K17b: rel err {err_b}")
    # per call in turns with the launch floor (an empty kernel through the
    # same launcher): CUDA events over 20 calls, the host's cost included
    med, samples = turns_ms({"k17a": lambda: k_ff.spectral_filter(F, shape, 1.5),
                             "k17b": lambda: k_ff.exp_abs(f, ST1["alpha"]),
                             "floor": lambda: kbuild.launch("hz_launch_floor")}, 20)
    report.update(K17a_rel_err=err_a, K17b_rel_err=err_b, K17_per_call_ms=med,
                  K17_per_call_quartiles=quartiles(samples))
    timing["spectral_filter"] = entry(
        float((fk - fp).abs().max()), med["k17a"],
        cuda_ms(lambda: k_ff.spectral_filter_plain(F, shape, 1.5), 20),
        nbytes=2 * 8 * F.numel(), flops=12 * F.numel())
    timing["exp_abs"] = entry(
        float((ek - ep).abs().max()), med["k17b"],
        cuda_ms(lambda: k_ff.exp_abs_plain(f, ST1["alpha"]), 20),
        nbytes=2 * 4 * f.numel(), flops=3 * f.numel())
    for name in ("spectral_filter", "exp_abs"):
        timing[name]["launch_floor_ms"] = med["floor"]
    return timing, report


def config4_field():
    from homogenization_jl_tpu_torch.models.checkerboard import (
        compute_boundary_layer,
        compute_box_radius,
        generate_conductivity,
    )

    n, dim = CONFIG4["n"], CONFIG4["dim"]
    R0 = compute_box_radius(0, n) + compute_boundary_layer(1.0, n)
    return R0, generate_conductivity(dim, 2 * R0, np.random.default_rng(CONFIG4_SEED))


def config4_per_step(field, dev, seed=CONFIG4_SEED):
    """Phase 20c's call: the per-step driver on config 4, its random start
    iterate drawn from ``seed`` (None: a fresh draw, the driver's default)."""
    import torch

    from homogenization_jl_tpu_torch.models.checkerboard import checkerboard_homogenization

    return checkerboard_homogenization(
        **CONFIG4, cond_field=field, dtype=torch.float64, tolerance=1e-8, shrink=False,
        inner="pcg", smoother="chebyshev", coarse="mg", seed=seed, return_trace=True,
        device=dev)


def config4_repeat(dev, smi):
    """--config4-repeat: phase 20c's call twice with its seed and twice
    without one (the driver's default), in this process, with a digest of
    every library call on its path (the aux hierarchy's torch.linalg.inv
    and torch.mv, the host's eigvalsh): one JSON line. Run it in two
    processes to compare across them."""
    import hashlib

    import torch

    def digest(a):
        if isinstance(a, torch.Tensor):  # an integer sum of the bits, on the card
            v = _bits(a.detach()).reshape(-1).to(torch.int64)
            w = torch.arange(1, v.numel() + 1, device=v.device, dtype=torch.int64)
            return f"{int((v * w).sum()) & (2**64 - 1):016x}"
        return hashlib.sha1(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]

    calls = []
    patched = [(torch.linalg, "inv"), (torch, "mv"), (np.linalg, "eigvalsh")]
    originals = [getattr(mod, name) for mod, name in patched]

    def logged(name, f):
        def g(*args, **kw):
            out = f(*args, **kw)
            calls.append((name, tuple(digest(a) for a in args), digest(out)))
            return out
        return g

    for (mod, name), f in zip(patched, originals):
        setattr(mod, name, logged(name, f))
    try:
        _, field = config4_field()
        runs = []
        for seed in (CONFIG4_SEED, CONFIG4_SEED, None, None):
            calls.clear()
            sig, tr = config4_per_step(field, dev, seed)
            runs.append(dict(seed=seed, sigma=float(sig).hex(), cycles=tr.cycles_per_step,
                             calls=list(calls)))
    finally:
        for (mod, name), f in zip(patched, originals):
            setattr(mod, name, f)

    def first_difference(a, b):
        for i, (x, y) in enumerate(zip(a, b)):
            if x != y:
                what = "output" if x[:2] == y[:2] else "input"
                return dict(call=i, name=x[0], differs_in=what)
        return None

    ref = runs[0]["calls"]
    report = [dict(seed=r["seed"], sigma=r["sigma"], cycles=r["cycles"], calls=len(r["calls"]),
                   inv=[c[2] for c in r["calls"] if c[0] == "inv"],
                   first_difference_from_run_0=first_difference(ref, r["calls"]))
              for r in runs]
    print(json.dumps(dict(config4_repeat=report, card=smi)), flush=True)


def config4(kbuild, dev, smi):
    """Phase 20: BASELINE config 4 on the card. Returns (launches of (a),
    launches of (d))."""
    import torch

    from homogenization_jl_tpu_torch.models.checkerboard import checkerboard_homogenization
    from homogenization_jl_tpu_torch.models.multishift import homogenization_multishift

    R0, field = config4_field()
    f64 = torch.float64
    out = {}

    def run(fn):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kbuild.reset_launches()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        rec = dict(wall_s=time.perf_counter() - t0, max_memory_allocated=torch.cuda.max_memory_allocated())
        return res, rec, dict(kbuild.LAUNCHES)

    def multishift(m, two_pass=False):
        if two_pass:
            return homogenization_multishift(
                **CONFIG4, lanczos_iters=m, cond_field=field, dtype=f64, two_pass=True,
                return_stats=True, device=dev)
        return checkerboard_homogenization(
            **CONFIG4, solver="multishift", lanczos_iters=m, dtype=f64, cond_field=field,
            return_trace=True, device=dev)

    def stats_rec(sigma, st, rec):
        return dict(sigma=sigma, sigma_steps=st["sigma_steps"], lanczos_iters=st["lanczos_iters"],
                    A_applies=st["A_applies"], M_applies=st["M_applies"],
                    setup_s=st["setup_seconds"], lanczos_s=st["lanczos_seconds"], **rec)

    (sig_a, st_a), rec, launches_a = run(lambda: multishift(CONFIG4_LANCZOS))
    check(all(launches_a[k] > 0 for k in CONFIG4_PATH), f"config 4 (a): a kernel never ran: {launches_a}")
    check(math.isfinite(sig_a), f"config 4 (a): sigma {sig_a}")
    out["a"] = stats_rec(sig_a, st_a, rec)
    out["a"]["launches"] = launches_a
    say("20a", ok=True, **out["a"], card=smi)

    (sig_b, st_b), rec, _ = run(lambda: multishift(CONFIG4_LANCZOS, two_pass=True))
    rel_b = abs(sig_b - sig_a) / abs(sig_a)
    check(rel_b <= CONFIG4_TWO_PASS_TOL, f"config 4 (b): two-pass sigma {sig_b} vs {sig_a}")
    check(st_b["lanczos_iters"] == st_a["lanczos_iters"], "config 4 (b): Lanczos counts differ")
    out["b"] = dict(stats_rec(sig_b, st_b, rec), rel_diff_vs_one_pass=rel_b)
    say("20b", ok=True, **out["b"], card=smi)

    (sig_c, tr_c), rec, _ = run(lambda: config4_per_step(field, dev))
    # the driver's random start iterate is drawn from the seed: the same
    # call again gives the same bits
    sig_c2, tr_c2 = config4_per_step(field, dev)
    check(float(sig_c2).hex() == float(sig_c).hex() and tr_c2.residuals == tr_c.residuals,
          f"config 4 (c): a second run gave sigma {sig_c2!r}, the first {sig_c!r}")
    gap = abs(sig_a - sig_c) / abs(sig_c)
    iters = [t for step in tr_c.iteration_seconds for t in step]
    out["c"] = dict(sigma=sig_c, sigma_hex=float(sig_c).hex(), second_run_bitwise_equal=True,
                    sigma_steps=tr_c.sigma_steps, cycles_per_step=tr_c.cycles_per_step,
                    residuals=tr_c.residuals, host_init_s=tr_c.init_seconds,
                    step_setup_s=tr_c.setup_seconds, sec_per_iteration_mean=sum(iters) / len(iters),
                    gap_a_vs_c=gap, **rec)
    say("20c", ok=True, **out["c"], card=smi)
    if gap > CONFIG4_GAP:
        # the estimator's own limit at this size: more vectors, the same bar
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info(dev)
        vec = CONFIG4_STATE[0] * CONFIG4_STATE[1] * 8
        need = out["a"]["max_memory_allocated"] + (CONFIG4_LANCZOS_MORE - CONFIG4_LANCZOS) * vec
        check(need + CONFIG4_MARGIN <= total and need <= free,
              f"config 4 (c+): {CONFIG4_LANCZOS_MORE} vectors need {need} bytes: "
              f"{free} free of {total}, margin {CONFIG4_MARGIN}")
        (sig_a2, st_a2), rec, _ = run(lambda: multishift(CONFIG4_LANCZOS_MORE))
        gap2 = abs(sig_a2 - sig_c) / abs(sig_c)
        out["a_more"] = dict(stats_rec(sig_a2, st_a2, rec), gap_vs_c=gap2, free_before=free,
                             need=need)
        say("20c+", gap_first=gap, **out["a_more"], card=smi)
        check(gap2 <= CONFIG4_GAP,
              f"config 4: {CONFIG4_LANCZOS} vectors gap {gap}, {CONFIG4_LANCZOS_MORE} gap {gap2}")

    # (d) K13 on its path, one level down
    from homogenization_jl_tpu_torch.models.checkerboard import (
        conductivity_per_element,
        ordered_hypercube,
    )
    from homogenization_jl_tpu_torch.models.multishift import (
        shift_solutions_gap,
        shifted_family_solve,
    )
    from homogenization_jl_tpu_torch.ops.plan import build_grid_plan
    from homogenization_jl_tpu_torch.solver.multigrid import MultigridSolver

    dim = CONFIG4["dim"]
    base = ordered_hypercube(dim, R0)[0]
    sigma_el = conductivity_per_element(base, field, np.full(dim, float(R0)))
    levels = SHIFTED["refinements"] + 1
    plan = build_grid_plan(base, levels, slot_tables=False)
    solver = MultigridSolver(plan, dtype=f64, device=dev, coarse="cg")
    coeff = solver.coefficients(sigma_el, 0.0)
    k = levels - 1
    b = torch.as_tensor(np.random.default_rng(CONFIG4_SEED).standard_normal(
        (base.nelements, plan.n_local(k)))).to(dev)
    (xs, res), rec, launches_d = run(lambda: shifted_family_solve(
        solver, coeff, b, SHIFTED["shifts"], iters=SHIFTED["iters"]))
    check(all(launches_d[kk] > 0 for kk in SHIFTED_PATH), f"config 4 (d): a kernel never ran: {launches_d}")
    check(launches_d["multishift_update"] in (0, SHIFTED["iters"]) if dev.type == "cpu" else
          launches_d["multishift_update"] == SHIFTED["iters"], "config 4 (d): K13 launches")
    t0 = time.perf_counter()
    worst = shift_solutions_gap(solver, coeff, b, SHIFTED["shifts"], xs, k,
                                maxiter=2 * SHIFTED["iters"])
    check(worst <= SHIFTED_TOL, f"config 4 (d): multishift vs per-shift CG {worst}")
    out["d"] = dict(dofs=int(b.numel()), worst_rel_diff=worst, resnorms=res.tolist(),
                    reference_cg_s=time.perf_counter() - t0, **rec, launches=launches_d)
    say("20d", ok=True, **out["d"], card=smi)
    del xs, res, b, coeff, solver, plan
    torch.cuda.empty_cache()
    lanczos_step_profile(dev, field, out["a"], smi)
    return launches_a, launches_d


def kernel_function(name):
    """A profile row's kernel function without its return type, namespace
    and template arguments (element_apply_kernel, vectorized_elementwise_
    kernel, ...; a copy's kind: DtoH, HtoD)."""
    m = re.search(r"(\w+)\s*[<(]", name.replace("(anonymous namespace)::", ""))
    return m.group(1) if m else name


def lanczos_step_profile(dev, field, rec_a, smi):
    """Phase 20e: one Lanczos step of (a) under torch.profiler, by phase
    15c's rules: the first window (of up to PROFILE_ATTEMPTS, from one
    Lanczos update to the next in a run of CONFIG4_PROFILE_VECTORS vectors,
    attempt i after PROFILE_LEAD_S * 2**i of idle trace) that covers
    PROFILE_MIN_COVERAGE of its CUDA-event time, and no PyTorch elementwise
    kernel above LIBRARY_ELEMENTWISE_MAX_US per launch. Reports each kernel
    function's share of the step's device time, the idle share and the
    host reads."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from homogenization_jl_tpu_torch.models import multishift as ms_model
    from homogenization_jl_tpu_torch.models.multishift import homogenization_multishift

    update = ms_model.lanczos_update
    attempts, win = [], {}

    def traced_update(*args, **kwargs):
        out = update(*args, **kwargs)
        if "prof" in win:  # close the window: one Lanczos step
            win["end"].record()
            torch.cuda.synchronize()
            wall = time.perf_counter() - win["t0"]
            time.sleep(PROFILE_MARGIN_S)
            prof = win.pop("prof")
            prof.stop()
            attempts.append(profile_table(prof, wall, win["start"], win["end"],
                                          k5_calls() - win["k5_calls"]))
            del prof
        covered = any(a["coverage"] >= PROFILE_MIN_COVERAGE for a in attempts)
        if win.get("updates", 0) >= 1 and not covered and len(attempts) < PROFILE_ATTEMPTS:
            torch.cuda.synchronize()
            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            prof.start()
            torch.ones(1).to("cuda")
            torch.cuda.synchronize()
            time.sleep(PROFILE_LEAD_S * 2 ** len(attempts))
            win.update(prof=prof, start=torch.cuda.Event(enable_timing=True),
                       end=torch.cuda.Event(enable_timing=True), t0=time.perf_counter(),
                       k5_calls=k5_calls())
            win["start"].record()
        win["updates"] = win.get("updates", 0) + 1
        return out

    ms_model.lanczos_update = traced_update
    try:
        _, st = homogenization_multishift(
            **CONFIG4, lanczos_iters=CONFIG4_PROFILE_VECTORS, cond_field=field,
            dtype=torch.float64, return_stats=True, device=dev)
    finally:
        ms_model.lanczos_update = update
        if "prof" in win:
            win.pop("prof").stop()
    covered = [a for a in attempts if a["coverage"] >= PROFILE_MIN_COVERAGE]
    check(covered, f"20e: no profile covers {PROFILE_MIN_COVERAGE} of the Lanczos step: "
          f"{[a['coverage'] for a in attempts]}")
    p = covered[0]
    lib = library_elementwise(p["rows"])
    worst = max((us for _, us, _ in lib), default=0.0)
    check(worst <= LIBRARY_ELEMENTWISE_MAX_US,
          f"20e: a PyTorch elementwise kernel takes {worst} us per launch: {lib}")
    busy = sum(r[1] for r in p["rows"])
    check_k5_per_call(p, "20e")
    funcs = {}
    for name, ms, count in p["rows"]:
        f = funcs.setdefault(kernel_function(name), [0.0, 0])
        f[0] += ms
        f[1] += count
    shares = sorted(((k, ms, cnt, ms / p["event_ms"]) for k, (ms, cnt) in funcs.items()),
                    key=lambda r: -r[1])
    steps = st["lanczos_iters"]
    say("20e", ok=True, vectors=CONFIG4_PROFILE_VECTORS, step_wall_ms=p["wall_ms"],
        step_event_ms=p["event_ms"], device_busy_ms=busy, coverage=p["coverage"],
        idle_share=1.0 - busy / p["wall_ms"], host_wait_share=p["host_wait_ms"] / p["event_ms"],
        lost_launches=p["lost_launches"], host_reads=p["host_reads"], k5=p["k5"],
        attempts=[a["coverage"] for a in attempts],
        mass_cg_iterations_per_step=(st["M_applies"] - steps - 1) / (steps + 1),
        a_lanczos_ms_per_step=rec_a["lanczos_s"] * 1e3 / rec_a["lanczos_iters"],
        kernels=shares, top15=[(name[:90], ms, cnt) for name, ms, cnt in p["rows"][:15]],
        library_elementwise=lib, max_library_elementwise_us=worst, card=smi)


def st1_rescue(kbuild, dev, smi):
    """Phase 21: the st1 contrast rescue at 190,513,152 DOFs on the TPU
    record's field. Returns the launches of the run."""
    import torch

    from homogenization_jl_tpu_torch.models.st1 import st1_multigrid
    from homogenization_jl_tpu_torch.utils.fft_field import pinned_noise

    noise = pinned_noise(ST1["seed"], (ST1["n"],) * ST1["dim"])
    check(noise is not None, "st1: the pinned noise is missing")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kbuild.reset_launches()
    timings = {}
    t0 = time.perf_counter()
    hist, x, solver, sigma_el = st1_multigrid(
        **ST1, dtype=torch.float32, method="pcg",
        solver_opts=dict(smoother="chebyshev", coarse_mg_tol=5e-2), noise=noise, device=dev,
        timings=timings)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kbuild.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    check(all(launches[k] > 0 for k in ST1_PATH), f"st1: a kernel never ran: {launches}")
    contrast = float(sigma_el.max() / sigma_el.min())
    check(abs(contrast / ST1_CONTRAST - 1) <= 1e-3, f"st1: contrast {contrast}")
    check(bool(torch.isfinite(x).all()), "st1: non-finite solution")
    marks = {}
    for level, within in ST1_MARKS:
        it = next((i for i, h in enumerate(hist) if h <= level), None)
        check(it is not None and it <= within, f"st1: residual {level} at iteration {it} > {within}")
        marks[str(level)] = it
    # seconds per PCG iteration between the solve's CUDA events (the host
    # reads one residual per iteration, as the JAX loop does)
    sec_iter = timings["solve_events_s"] / (len(hist) - 1)
    top = ST1["refinements"]
    dofs = solver.plan.base.nelements * solver.plan.n_local(top)
    say(21, ok=True, dofs=dofs, contrast=contrast, history=hist, iterations_to=marks,
        wall_s=wall, timings=timings, sec_per_pcg_iter=sec_iter, max_memory_allocated=peak,
        launches=launches, card=smi)
    return launches


# --------------------------------------------------------------------- #
# phase 3c: the launch-bound kernels' device times (a child process)
# --------------------------------------------------------------------- #
def annotated_device_us(prof):
    """{record_function label: [device us, kernels]} of a finished profile:
    each kernel, copy or memset counts for the label whose host range holds
    its launch call (matched by the trace's correlation ids)."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    ranges, launches, device = [], {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        corr = e.get("args", {}).get("correlation")
        if cat == "user_annotation":
            ranges.append((e["ts"], e["ts"] + e["dur"], e["name"]))
        elif cat in ("cuda_runtime", "cuda_driver") and corr is not None:
            launches[corr] = e["ts"]
        elif cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            device.append((corr, e["dur"]))
    out = {}
    for corr, dur in device:
        t = launches.get(corr)
        for t0, t1, name in ranges:
            if t is not None and t0 <= t <= t1:
                acc = out.setdefault(name, [0.0, 0])
                acc[0] += dur
                acc[1] += 1
                break
    return out


def launch_bound_device_times(base, dev, reps=50):
    """The device times of K6's apply and K7's segment sum at the main
    path's shapes (the lattice of ``base``, float32) beside their library
    calls (cuSPARSE's CSR mv: the sum of its kernels; index_add_ with its
    zero fill), and of K17a and K17b at phase 21's 32^3 beside the launch
    floor (an empty kernel through the same launcher), from one
    torch.profiler session: after unlabelled warm-up calls, TIMING_ROUNDS
    rounds each timing ``reps`` calls of each in turns (K6, CSR, CSR, K6,
    K7, index_add_, index_add_, K7, K17a, K17b, floor, floor, K17b, K17a);
    before the session, K17a's, K17b's and the floor's ms per call by CUDA
    events over 20 calls in turns, as phase 19 times them late in the main
    process. Returns ({name: median over the rounds of the device ms per
    call}, {name: samples}, {name: kernels per call}, {name: ms per call}).
    Runs in a process of its own
    (``device_times_subprocess``): sessions after a process's first lost
    kernel records on the H100, and a session before phase 15b's cost that
    one its coverage (PERF.md)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from homogenization_jl_tpu_torch.csrc import build as kbuild
    from homogenization_jl_tpu_torch.ops import interfaces as k_if
    from homogenization_jl_tpu_torch.ops import stencil as k_st
    from homogenization_jl_tpu_torch.utils import fft_field as k_ff

    g = torch.Generator(device=dev).manual_seed(2222)
    st = k_st.build_lattice_stencil(base)
    N, K = (st.n + 1) ** st.dim, len(st.deltas)
    W = torch.randn((K, N), generator=g, device=dev)
    u, b = (torch.randn(N, generator=g, device=dev) for _ in range(2))
    m = torch.rand(N, generator=g, device=dev) < 0.9
    A_csr = stencil_csr(W, st)
    tab = k_if.build_segment_tables(base.elements, base.nnodes, dev)
    vals = torch.randn((base.nelements, base.dim + 1), generator=g, device=dev)
    keys = torch.as_tensor(base.elements.reshape(-1), device=dev)
    fns = {
        "k6": lambda: k_st.lattice_apply(u, W, st, m=m, b=b),
        "csr_mv": lambda: torch.mv(A_csr, u),
        "k7": lambda: k_if.segment_sum(vals, tab),
        "index_add": lambda: torch.zeros(tab.n_seg, device=dev).index_add_(0, keys, vals.view(-1)),
    }
    shape = (32, 32, 32)
    F = torch.fft.rfftn(torch.as_tensor(k_ff.pinned_noise(3, shape), device=dev)).contiguous()
    f = torch.fft.irfftn(k_ff.spectral_filter_plain(F, shape, 1.5), s=shape).contiguous()
    fns.update(k17a=lambda: k_ff.spectral_filter(F, shape, 1.5),
               k17b=lambda: k_ff.exp_abs(f, ST1["alpha"]),
               floor=lambda: kbuild.launch("hz_launch_floor"))
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    ms_per_call, _ = turns_ms({k: fns[k] for k in ("k17a", "k17b", "floor")}, 20)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.ones(1).to(dev)
        torch.cuda.synchronize()
        time.sleep(PROFILE_MARGIN_S)
        for fn in fns.values():  # unlabelled: a lost prefix of records falls here
            for _ in range(reps):
                fn()
        torch.cuda.synchronize()
        for r in range(TIMING_ROUNDS):
            for grp in (("k6", "csr_mv"), ("k7", "index_add"), ("k17a", "k17b", "floor")):
                for k in grp + grp[::-1]:
                    with record_function(f"hz_{k}_{r}"):
                        for _ in range(reps):
                            fns[k]()
                    torch.cuda.synchronize()
    got = annotated_device_us(prof)
    samples = {k: [] for k in fns}
    kernels = {k: [] for k in fns}
    for r in range(TIMING_ROUNDS):
        for k in fns:
            us, cnt = got.get(f"hz_{k}_{r}", (0.0, 0))
            check(cnt > 0, f"3c: no device record of {k}")
            per_call = max(round(cnt / (2 * reps)), 1)  # kernels per call
            samples[k].append(us / (cnt / per_call) / 1e3)
            kernels[k].append(cnt / (2 * reps))
    # one kernel per call (a lost record lowers the count, never raises it)
    one = ("k6", "k7", "k17a", "k17b", "floor")
    check(all(0.5 < c <= 1.0 for k in one for c in kernels[k]),
          f"3c: kernels per call {[kernels[k] for k in one]}")
    return {k: float(np.median(v)) for k, v in samples.items()}, samples, kernels, ms_per_call


def device_times_subprocess(n, smi):
    """Phase 3c: ``launch_bound_device_times`` in a child process (its
    profiler session the process's first; the kernels' build is already on
    disk), read from the child's last line. Returns {kernel: {"device_ms",
    "library_device_ms"}} for K6 (lattice_stencil) and K7 (coarse_gather),
    {kernel: {"device_ms", "launch_floor_device_ms", "fresh_process_ms",
    "launch_floor_fresh_process_ms"}} for K17 (spectral_filter, exp_abs)."""
    res = subprocess.run([sys.executable, os.path.abspath(__file__), "--device-times",
                          "--n", str(n)], capture_output=True, text=True, timeout=600)
    check(res.returncode == 0, f"3c: the device-time process failed (rc {res.returncode}): "
          f"{res.stderr[-3000:]}")
    med, samples, kernels, per_call = json.loads(res.stdout.strip().splitlines()[-1])
    say("3c", ok=True, device_ms_median=med, device_ms_samples=samples,
        kernels_per_call=kernels, rounds=TIMING_ROUNDS, calls_per_turn=50,
        k17_over_floor=dict(k17a=med["k17a"] / med["floor"], k17b=med["k17b"] / med["floor"]),
        ms_per_call_fresh_process=per_call, card=smi)
    k17 = dict(launch_floor_device_ms=med["floor"],
               launch_floor_fresh_process_ms=per_call["floor"])
    return {"lattice_stencil": dict(device_ms=med["k6"], library_device_ms=med["csr_mv"]),
            "coarse_gather": dict(device_ms=med["k7"], library_device_ms=med["index_add"]),
            "spectral_filter": dict(device_ms=med["k17a"], fresh_process_ms=per_call["k17a"], **k17),
            "exp_abs": dict(device_ms=med["k17b"], fresh_process_ms=per_call["k17b"], **k17)}


def slice_phases(kbuild, dev, smi):
    """Phases 19-21. Returns ({kernel: entry}, {kernel: launches on its
    path}) of K13, K14 and K17."""
    import torch

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    timing, report = check_multishift_kernels(dev)
    kbuild.reset_launches()  # comparison launches do not count
    say(19, ok=True, f64=timing, report=report, card=smi)
    launches_a, launches_d = config4(kbuild, dev, smi)
    torch.cuda.empty_cache()
    launches_s = st1_rescue(kbuild, dev, smi)
    torch.cuda.empty_cache()
    launches = dict(multishift_update=launches_d["multishift_update"],
                    jacobi_cg=launches_a["jacobi_cg"], mass_dot=launches_a["mass_dot"],
                    basis_combine=launches_a["basis_combine"],
                    spectral_filter=launches_s["spectral_filter"],
                    exp_abs=launches_s["exp_abs"])
    say("19-21", ok=True, wall_s=time.perf_counter() - t0)
    return timing, launches


# --------------------------------------------------------------------- #
# phases 22-24: the Poisson demos, step files and VTK, the entry points
# --------------------------------------------------------------------- #
def history_close(got, ref):
    """The largest |h_i - j_i| / max(POISSON_HISTORY_REL j_i,
    POISSON_HISTORY_FLOOR j_0) of a card history h against a JAX record j
    (at most 1 passes)."""
    got, ref = np.asarray(got), np.asarray(ref)
    check(got.shape == ref.shape, f"a history of {len(got)} entries, the record's {len(ref)}")
    allowed = np.maximum(POISSON_HISTORY_REL * ref, POISSON_HISTORY_FLOOR * ref[0])
    return float((np.abs(got - ref) / allowed).max())


def poisson(hz, kbuild, dev, smi):
    """Phase 22: BASELINE configs 1 and 3 against the JAX records, then the
    demo at 190,513,152 DOFs with coarse="mg", twice."""
    import torch

    from homogenization_jl_tpu_torch.models import poisson as k_poisson
    from homogenization_jl_tpu_torch.solver.multigrid import MultigridSolver

    t_phase = time.perf_counter()
    # (a) config 1, tests/test_multigrid.py:71-96's loop
    base = hz.hypercube(2, 8, scale=1.0 / 8.0)
    sigma = np.ones((base.nelements, 2))
    solver = MultigridSolver(hz.build_grid_plan(base, 3, slot_tables=False), device=dev)
    coeff = solver.coefficients(sigma, 0.0)
    chol = solver.coarse_cholesky(sigma, 0.0)
    x, _ = solver.zero_states()
    b = k_poisson.local_unit_rhs(solver)
    kbuild.reset_launches()
    h1 = []
    for _ in range(40):
        x, r = solver.vcycle(x, b, coeff, chol)
        h1.append(float(solver.residual_norm(r)))
        if h1[-1] <= 1e-8:
            break
    launches_1 = dict(kbuild.LAUNCHES)
    check(h1[-1] <= 1e-8 and len(h1) <= 30, f"22a: config 1 reached {h1[-1]} in {len(h1)} cycles")
    check(all(launches_1[k] > 0 for k in POISSON_CHOL_PATH), f"22a: a kernel never ran: {launches_1}")
    c1 = history_close(h1, CONFIG1_JAX_HISTORY)
    check(c1 <= 1, f"22a: config 1's history is {c1} x its bar from JAX's: {h1}")
    del solver, coeff, chol, x, b, r

    # (b) config 3
    kbuild.reset_launches()
    h3, x3, _ = k_poisson.checkerboard_hypercube_multigrid(2, dim=3, refinements=3, max_cycles=12,
                                                           device=dev)
    launches_3 = dict(kbuild.LAUNCHES)
    check(bool(torch.isfinite(x3).all()) and h3[-1] < 1e-4 * h3[0],
          f"22b: config 3's contraction: {h3}")
    check(all(launches_3[k] > 0 for k in POISSON_CHOL_PATH), f"22b: a kernel never ran: {launches_3}")
    c3 = history_close(h3, CONFIG3_JAX_HISTORY)
    check(c3 <= 1, f"22b: config 3's history is {c3} x its bar from JAX's: {h3}")
    say("22ab", ok=True, config1=dict(history=h1, cycles=len(h1), vs_jax_bar=c1,
                                      launches=launches_1),
        config3=dict(history=h3, vs_jax_bar=c3, launches=launches_3))
    del x3
    torch.cuda.empty_cache()

    # (c) at full size, twice; the first run's V-cycles between CUDA events
    events, first_cycle = [], []
    vcycle = MultigridSolver.vcycle

    def timed_vcycle(self, *args, **kwargs):
        if not events:
            first_cycle.append(time.perf_counter())
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = vcycle(self, *args, **kwargs)
        e1.record()
        events.append((e0, e1))
        return out

    runs = []
    for i in range(2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kbuild.reset_launches()
        t0 = time.perf_counter()
        if i == 0:
            MultigridSolver.vcycle = timed_vcycle
        try:
            hist, x, solver = k_poisson.checkerboard_hypercube_multigrid(**POISSON_FULL, device=dev)
        finally:
            MultigridSolver.vcycle = vcycle
        torch.cuda.synchronize()
        runs.append(dict(hist=hist, x=x, t0=t0, wall_s=time.perf_counter() - t0,
                         launches=dict(kbuild.LAUNCHES), peak=torch.cuda.max_memory_allocated()))
        dofs = solver.plan.base.nelements * solver.plan.n_local(POISSON_FULL["refinements"])
        coarse = solver.coarse_kind
        del solver, x
    first, second = runs
    check(dofs == 190_513_152 and coarse == "mg", f"22c: {dofs} DOFs, coarse {coarse}")
    check(second["hist"] == first["hist"],
          f"22c: the histories differ: {first['hist']} vs {second['hist']}")
    check(torch.equal(_bits(second["x"]), _bits(first["x"])), "22c: the solutions differ")
    check(all(first["launches"][k] > 0 for k in POISSON_MG_PATH),
          f"22c: a kernel never ran: {first['launches']}")
    h = first["hist"]
    rates = [b_ / a for a, b_ in zip(h, h[1:])]
    bars = [POISSON_RATE_MARGIN * b_ / a
            for a, b_ in zip(POISSON_N4_JAX_HISTORY, POISSON_N4_JAX_HISTORY[1:])][:len(rates)]
    check(all(math.isfinite(v) for v in h) and all(r <= c for r, c in zip(rates, bars)),
          f"22c: contraction {rates} against {bars}")
    sec = [e0.elapsed_time(e1) / 1e3 for e0, e1 in events]
    # the host's setup: plan, solver, coefficients, coarse setup, start
    say("22c", ok=True, dofs=dofs, coarse=coarse, history=h, rates=rates, rate_bars=bars,
        second_run_bitwise_equal=True, sec_per_vcycle=sec,
        sec_per_vcycle_mean=sum(sec) / len(sec), sec_per_vcycle_median=float(np.median(sec)),
        setup_s=first_cycle[0] - first["t0"],
        wall_s=[r["wall_s"] for r in runs], max_memory_allocated=[r["peak"] for r in runs],
        launches=first["launches"], card=smi)
    del runs, first, second
    torch.cuda.empty_cache()
    say(22, ok=True, wall_s=time.perf_counter() - t_phase)


_VTU_TYPES = {"Float64": np.float64, "Float32": np.float32, "Int64": np.int64,
              "Int32": np.int32, "UInt8": np.uint8}


def parse_vtu(path):
    """{name: values} of every binary DataArray of a .vtu file, with the
    piece's point and cell counts under "_points" / "_cells"."""
    import base64
    import struct

    with open(path) as f:
        text = f.read()
    out = {}
    for t, name, payload in re.findall(
            r'<DataArray type="(\w+)" Name="([^"]+)"[^>]*format="binary">([^<]+)<', text):
        raw = base64.b64decode(payload)
        (nbytes,) = struct.unpack("<I", raw[:4])
        check(len(raw) == 4 + nbytes, f"{path}: {name} holds {len(raw) - 4} of {nbytes} bytes")
        out[name] = np.frombuffer(raw[4:], dtype=_VTU_TYPES[t])
    piece = re.search(r'<Piece NumberOfPoints="(\d+)" NumberOfCells="(\d+)">', text)
    out["_points"], out["_cells"] = int(piece.group(1)), int(piece.group(2))
    return out


def checkpoints_vtk(kbuild, dev, smi):
    """Phase 23: phase 8's recurrence with step files and level-2 VTK files
    in both geometries, resumed from step_0.npz; every file re-parsed; st1's
    save=."""
    import torch

    from homogenization_jl_tpu_torch.mesh.reference import (
        refined_reference,
        with_contiguous_interface_layout,
    )
    from homogenization_jl_tpu_torch.models.checkerboard import checkerboard_homogenization
    from homogenization_jl_tpu_torch.models.st1 import st1_multigrid
    from homogenization_jl_tpu_torch.utils.checkpoint import load_step

    t_phase = time.perf_counter()
    top = RECURRENCE_2D["refinements"]
    ref = with_contiguous_interface_layout(refined_reference(2, top + 1))
    sel = ref.level_in_level(SAVE_LEVEL, top)
    n_save, cells_save = ref.levels[SAVE_LEVEL].nnodes, ref.levels[SAVE_LEVEL].nelements
    tmp = tempfile.mkdtemp(prefix="chip_smoke_files_")
    cwd = os.getcwd()
    rep = {}
    try:
        os.chdir(tmp)  # save_level writes checkerboard.vtu into the working directory
        for geometry, path in (("ordered", ORDERED_2D_PATH), ("lattice", LATTICE_2D_PATH)):
            d = os.path.join(tmp, geometry)
            os.makedirs(d)
            kw = dict(**RECURRENCE_2D, dtype=torch.float64, tolerance=1e-8,
                      smoother="chebyshev", inner="pcg", coarse="mg", seed=3,
                      geometry=geometry, return_trace=True, device=dev)
            kbuild.reset_launches()
            t0 = time.perf_counter()
            sigma, trace = checkerboard_homogenization(
                **kw, checkpoint_dir=os.path.join(d, "ck"), save_level=SAVE_LEVEL,
                save_prefix=os.path.join(d, "v"))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(kbuild.LAUNCHES)
            check(all(launches[k] > 0 for k in path), f"23 {geometry}: a kernel never ran: {launches}")
            check(len(trace.sigma_steps) == 2, f"23 {geometry}: {len(trace.sigma_steps)} steps")
            os.replace("checkerboard.vtu", os.path.join(d, "checkerboard.vtu"))
            kbuild.reset_launches()
            t0 = time.perf_counter()
            resumed, rtrace = checkerboard_homogenization(
                **kw, resume_from=os.path.join(d, "ck", "step_0.npz"))
            torch.cuda.synchronize()
            wall_r = time.perf_counter() - t0
            launches_r = dict(kbuild.LAUNCHES)
            check(all(launches_r[k] > 0 for k in path),
                  f"23 {geometry} resumed: a kernel never ran: {launches_r}")
            check(resumed == sigma and rtrace.residuals[-1] == trace.residuals[-1],
                  f"23 {geometry}: resumed sigma {resumed} (residual {rtrace.residuals}) vs "
                  f"{sigma} ({trace.residuals}): {abs(resumed - sigma) / abs(sigma)} relative")
            files = {}
            for k in range(2):
                st = load_step(os.path.join(d, "ck", f"step_{k}.npz"))
                check(st["k"] == k and st["x"].dtype == np.float64
                      and st["sigma"] == trace.sigma_steps[k], f"23 {geometry}: step_{k}.npz")
                v = parse_vtu(os.path.join(d, f"v_{k}.vtu"))
                E = st["x"].shape[0]
                check(v["_points"] == E * n_save and v["_cells"] == E * cells_save
                      and v["Points"].size == 3 * E * n_save,
                      f"23 {geometry}: v_{k}.vtu has {v['_points']} points, E = {E}")
                check(np.array_equal(v["v"], st["x"][:, sel].reshape(-1)),
                      f"23 {geometry}: v_{k}.vtu's values are not the state's")
                files[f"step_{k}"] = dict(E=E, total_radius=st["total_radius"],
                                          vtu_bytes=os.path.getsize(os.path.join(d, f"v_{k}.vtu")))
            cond = parse_vtu(os.path.join(d, "checkerboard.vtu"))
            check(cond["_cells"] == files["step_0"]["E"]
                  and set(np.unique(cond["a"]).tolist()) <= {1.0, 9.0},
                  f"23 {geometry}: checkerboard.vtu")
            rep[geometry] = dict(sigma=sigma, resumed_bitwise_equal=True, wall_s=wall,
                                 resumed_wall_s=wall_r, cycles_per_step=trace.cycles_per_step,
                                 resumed_cycles=rtrace.cycles_per_step, files=files,
                                 launches=launches, resumed_launches=launches_r)
        # st1's save= (the finest level, level 2)
        kbuild.reset_launches()
        path = os.path.join(tmp, "st1")
        hist, x, solver, _ = st1_multigrid(**ST1_SAVE, dtype=torch.float32, method="pcg",
                                           save=path, device=dev)
        launches_s = dict(kbuild.LAUNCHES)
        check(launches_s["spectral_filter"] > 0 and launches_s["element_apply"] > 0,
              f"23 st1: a kernel never ran: {launches_s}")
        v = parse_vtu(path + ".vtu")
        E = solver.plan.base.nelements
        check(v["_points"] == E * solver.plan.n_local(ST1_SAVE["refinements"])
              and np.array_equal(v["v"], x.cpu().numpy().reshape(-1)),
              f"23 st1: st1.vtu has {v['_points']} points, not the state's values")
        rep["st1"] = dict(points=v["_points"], vtu_bytes=os.path.getsize(path + ".vtu"),
                          history=hist, launches=launches_s)
        del x, solver
    finally:
        os.chdir(cwd)
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    say(23, ok=True, **rep, wall_s=time.perf_counter() - t_phase, card=smi)


def profile_trace_child(logdir):
    """``--profile-trace``: one PCG iteration of a small float32 solve
    (hypercube(3, 8), 3 levels, Chebyshev, coarse "chol") inside
    utils/logging.py::profile_trace(logdir), in this fresh process. Prints
    the trace file and its kernels' names as one JSON line."""
    import torch

    import homogenization_jl_tpu_torch as hz
    from homogenization_jl_tpu_torch.csrc import build as kbuild
    from homogenization_jl_tpu_torch.utils.logging import profile_trace

    kbuild.kernels_lib()
    dev = torch.device("cuda", 0)
    _, sigma, plan, b_np = problem(hz, 8, 3)
    s = hz.MultigridSolver(plan, dtype=torch.float32, device=dev, smoother="chebyshev",
                           coarse="chol")
    coeff = s.coefficients(sigma, 0.0)
    setup = s.coarse_setup(sigma, 0.0)
    init, step = s.pcg_stepper(coeff, setup, s.estimate_lambda_max(coeff))
    state = step(init(torch.as_tensor(b_np, dtype=torch.float32, device=dev)))
    torch.cuda.synchronize()
    kbuild.reset_launches()
    with profile_trace(logdir):
        state = step(state)
    files = sorted(os.listdir(logdir))
    with open(os.path.join(logdir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    kernels = sorted({kernel_function(e["name"]) for e in events if e.get("cat") == "kernel"})
    print(json.dumps(dict(files=files, kernels=kernels, launches=dict(kbuild.LAUNCHES))),
          flush=True)


def entry_points(dev, smi):
    """Phase 24: the entry points in child processes, started together:
    run_flagship's line, run_slab's sharded kinds under torchrun in a world
    of one (each equal to the single device), profile_trace's file."""
    import torch

    tmp = tempfile.mkdtemp(prefix="chip_smoke_entry_")
    torchrun = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc-per-node=1", "-m", "homogenization_jl_tpu_torch.parallel.run_slab"]
    cmds = {
        "run_flagship": [sys.executable, "-m", "homogenization_jl_tpu_torch.run_flagship",
                         "2", "1", "1e-3"],
        "sharded": torchrun + ["--kind", "sharded", "--cubes", "8", "--levels", "3", "--compare"],
        "ordered_driver": torchrun + ["--kind", "ordered_driver", "--coarse", "mg", "--cubes", "1",
                                      "--levels", "2", "--smoother", "chebyshev", "--compare"],
        "profile_trace": [sys.executable, os.path.abspath(__file__), "--profile-trace",
                          os.path.join(tmp, "trace")],
    }
    procs, out = {}, {}
    t0 = time.perf_counter()
    try:
        for name, cmd in cmds.items():
            logs = [open(os.path.join(tmp, f"{name}.{k}"), "w") for k in ("out", "err")]
            # a process group of its own: torchrun's ranks are killed with it
            procs[name] = (subprocess.Popen(cmd, cwd=ROOT, stdout=logs[0], stderr=logs[1],
                                            start_new_session=True), logs)
        for name, (proc, logs) in procs.items():
            rc = proc.wait(timeout=max(ENTRY_TIMEOUT_S - (time.perf_counter() - t0), 1))
            for f in logs:
                f.close()
            with open(os.path.join(tmp, f"{name}.out")) as f:
                lines = [ln for ln in f.read().splitlines() if ln.startswith("{")]
            with open(os.path.join(tmp, f"{name}.err")) as f:
                err = f.read()
            check(rc == 0 and lines, f"24 {name}: exit {rc}: {err[-3000:]}")
            out[name] = dict(json.loads(lines[-1]), wall_s=time.perf_counter() - t0)
    finally:
        for proc, logs in procs.values():
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
            for f in logs:
                f.close()
        shutil.rmtree(tmp, ignore_errors=True)
    f = out["run_flagship"]
    check(all(k in f for k in FLAGSHIP_LINE_KEYS) and math.isfinite(f["sigma"])
          and (f["n"], f["refinements"], f["tolerance"]) == (1, 2, 1e-3),
          f"24 run_flagship: the line {f}")
    sh = out["sharded"]
    check(sh["rank"] == 0 and sh["device"] == torch.cuda.get_device_name(0)
          and sh["hist"] == sh["hist_single"] and sh["x_rel_diff"] == 0.0,
          f"24 sharded: a world of one against the single device: {sh}")
    check(all(sh["launches"][k] > 0 for k in SHARDED_CLI_PATH),
          f"24 sharded: a kernel never ran: {sh['launches']}")
    od = out["ordered_driver"]
    check(od["rank"] == 0 and od["sigma"] == od["sigma_single"] and math.isfinite(od["sigma"]),
          f"24 ordered_driver: a world of one against the single device: {od}")
    check(all(od["launches"][k] > 0 for k in FLAGSHIP_ORDERED_PATH),
          f"24 ordered_driver: a kernel never ran: {od['launches']}")
    pt = out["profile_trace"]
    check(len(pt["files"]) == 1 and "element_apply_kernel" in pt["kernels"],
          f"24 profile_trace: {pt}")
    say(24, ok=True, **out, wall_s=time.perf_counter() - t0, card=smi)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=32, help="cubes per axis of the base")
    ap.add_argument("--profile", metavar="DIR",
                    help="trace one PCG iteration with torch.profiler; "
                    "write the kernel table into DIR")
    ap.add_argument("--device-times", action="store_true",
                    help="phase 3c's child: print K6's and K7's device times (one JSON "
                    "line) and exit")
    ap.add_argument("--config4-repeat", action="store_true",
                    help="phase 20c's call twice with its seed and twice without, with a "
                    "digest of its library calls (one JSON line), and exit")
    ap.add_argument("--profile-trace", metavar="DIR",
                    help="phase 24's child: one PCG iteration inside profile_trace(DIR); "
                    "print the trace's kernels (one JSON line) and exit")
    args = ap.parse_args(argv)
    t_all = time.perf_counter()

    # ---- phase 1: the card -------------------------------------------
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only on the card")
    sys.path.insert(0, ROOT)
    import homogenization_jl_tpu_torch as hz
    from homogenization_jl_tpu_torch.csrc import build as kbuild
    from homogenization_jl_tpu_torch.ops.chebyshev import chebyshev_update

    if args.profile_trace:
        profile_trace_child(args.profile_trace)
        return
    if args.device_times:
        from homogenization_jl_tpu_torch.csrc import build as kbuild

        kbuild.kernels_lib()
        print(json.dumps(launch_bound_device_times(hz.hypercube(3, args.n, order="type"),
                                                   torch.device("cuda", 0))), flush=True)
        return
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.config4_repeat:
        kbuild.kernels_lib()
        config4_repeat(dev, smi)
        return
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
    # the wrappers' raw stream is PyTorch's current stream (a side stream too)
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        check(kbuild.current_stream() == torch.cuda.current_stream().cuda_stream != 0,
              "the kernels' stream is not PyTorch's current stream")
    check(kbuild.current_stream() == torch.cuda.current_stream().cuda_stream,
          "the kernels' stream is not PyTorch's current stream")
    say(2, nvcc_s=t_nvcc, triton_warmup_s=time.perf_counter() - t0 - t_nvcc,
        ptxas=ptxas)

    # ---- host setup of the main path (used by phases 3, 5 and 6) -------
    t0 = time.perf_counter()
    base, sigma, plan, b_np = problem(hz, args.n, 5, seed=0)
    t_plan = time.perf_counter() - t0
    # the bench's default dense limit coarsens n = 32 once; a rehearsal size
    # gets the limit that also coarsens it once (m = 1)
    dense = {} if args.n == 32 else dict(coarse_mg_dense_limit=(args.n // 2 - 1) ** 3 + 1)
    solver = hz.MultigridSolver(plan, dtype=torch.float32, device=dev,
                                smoother="chebyshev", coarse="mg",
                                coarse_mg_tol=5e-2, **dense)
    t_setup = time.perf_counter() - t0
    dofs = plan.base.nelements * plan.n_local(4)

    # ---- phase 3: kernels vs plain ----------------------------------
    from homogenization_jl_tpu_torch.fem.local_operators import element_coefficients

    coeff64 = torch.as_tensor(element_coefficients(base, sigma, 0.0), device=dev)
    timing, report = check_kernels(solver, plan, coeff64, dev)
    timing_c, report_c = check_coarse_kernels(solver, coeff64, dev)
    timing.update(timing_c)
    device_times = device_times_subprocess(args.n, smi)
    for name in ("lattice_stencil", "coarse_gather"):
        timing[name].update(device_times[name])
    torch.cuda.empty_cache()
    forms = check_new_forms(solver, plan, coeff64, dev)
    del coeff64
    timing["elementwise"] = forms["mask"]
    timing["element_apply"]["library_ms"] = forms.pop("element_apply_library_ms")
    torch.cuda.empty_cache()
    timing_g, report_g = check_cg_kernels(solver, plan, dev)
    timing.update(timing_g)
    kbuild.reset_launches()  # comparison launches do not count
    say(3, ok=True, per_level=report, coarse=report_c, cg_path=report_g, main_f32=timing,
        new_forms_f32=forms)
    timing_d, report_d = check_driver_kernels(hz, solver, plan, dev)
    timing.update(timing_d)
    kbuild.reset_launches()
    say("3b", ok=True, report=report_d,
        f32={k: timing[k] for k in ("integrals", "gather_combine")})

    # ---- phase 4: small float64 solves vs scipy -------------------------
    small = {}
    for label, n_small, kw in (
        ("chol", 4, dict(coarse="chol")),
        # dense limit 30: coarsening depth 1, aux hierarchy on hypercube(3, 4)
        ("mg", 8, dict(coarse="mg", coarse_mg_dense_limit=30)),
        ("cg", 4, dict(coarse="chol", smoother="cg")),
        ("cg_exact", 4, dict(coarse="chol", smoother="cg_exact")),
        ("cg_exact_W", 4, dict(coarse="chol", smoother="cg_exact", cycle="W")),
    ):
        err, its = small_solve_error(hz, dev, n_small, **kw)
        check(err <= 1e-7, f"small f64 solve ({label}): rel err {err} vs spsolve")
        small[label] = dict(n=n_small, rel_err_vs_spsolve=err, iters=its)
    kbuild.reset_launches()
    say(4, ok=True, **small)

    # ---- phase 5: the main path (coarse="mg") ------------------------------
    b = torch.as_tensor(b_np, device=dev, dtype=torch.float32)

    def solve_main(s):
        return s.solve(b, sigma, 0.0, tol=1e-4, method="auto", max_cycles=30)

    def iters_to(hist, tol):
        return next((i - 1 for i in range(1, len(hist)) if hist[i] < tol), None)

    def check_solve(label, x, hist, launches, path, rhs=None):
        rhs = b if rhs is None else rhs
        check(all(launches[k] > 0 for k in path), f"{label}: a kernel never ran: {launches}")
        check(x.shape == rhs.shape and bool(torch.isfinite(x).all()), f"{label}: non-finite solution")
        check(hist[-1] < 1e-4, f"{label}: relative residual {hist[-1]} >= 1e-4")
        check(len(hist) - 2 <= 20, f"{label}: {len(hist) - 2} PCG iterations > 20")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    solver.coarse_iterations.clear()
    solver.host_syncs = 0
    kbuild.reset_launches()
    t0 = time.perf_counter()
    x, hist = solve_main(solver)
    torch.cuda.synchronize()
    t_solve = time.perf_counter() - t0
    launches = dict(kbuild.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    check_solve("coarse=mg", x, hist, launches, MAIN_PATH)
    cits = list(solver.coarse_iterations)
    loop_syncs = solver.host_syncs

    # the same solve again: bitwise equal history and solution; every
    # synchronizing CUDA call of the solve is counted on this run
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            x2, hist2 = solve_main(solver)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    check(hist2 == hist, f"second solve: history differs: {hist2} vs {hist}")
    check(torch.equal(_bits(x2), _bits(x)), "second solve: solution differs")
    del x2

    # timing of the cycle and of one PCG iteration (after the solves)
    coeff = solver.coefficients(sigma, 0.0)
    setup = solver.coarse_setup(sigma, 0.0)
    lam_max = solver.estimate_lambda_max(coeff)
    xv = torch.zeros_like(b)
    sec_vcycle = cuda_ms(
        lambda: solver._vcycle_impl(xv, b, coeff, setup, lam_max), 5) / 1e3
    del xv
    state = list(solver._pcg_init_impl(torch.zeros_like(b), b, coeff, setup, lam_max))

    def pcg_step():
        state[:] = solver._pcg_step_impl(*state[:4], coeff, setup, lam_max, flexible=True)

    sec_iter = cuda_ms(pcg_step, 5) / 1e3
    # one PCG iteration under torch.profiler is taken after phase 15 (read by
    # phase 15c): a profiler session after the first one in this process,
    # while the NCCL group of phases 12-15 is alive, lost a prefix of its
    # step's kernels on every attempt (15b covered 0.43 of its step), where
    # 15b's profile as the process's first session, and a later session
    # with no group alive, were covered (PERF.md §6)
    say(5, ok=True, coarse="mg", dofs=dofs, history=hist,
        iters_to_1e3=iters_to(hist, 1e-3), iters_to_1e4=iters_to(hist, 1e-4),
        solve_wall_s=t_solve, sec_per_vcycle=sec_vcycle, sec_per_pcg_iter=sec_iter,
        vcycle_dof_per_s=dofs / sec_vcycle, pcg_dof_per_s=dofs / sec_iter,
        max_memory_allocated=peak, host_plan_s=t_plan, host_setup_s=t_setup,
        coarse_solves=len(cits),
        coarse_pcg_iters=dict(min=min(cits), mean=sum(cits) / len(cits), max=max(cits)),
        coarse_loop_syncs=loop_syncs, sync_calls_per_solve=syncs,
        second_solve_bitwise_equal=True, launches=launches, card=smi)

    # ---- phase 6: the dense Cholesky coarse solve (coarse="chol") ----------
    del x  # phase 5's solver and PCG state stay for its profile (above)
    torch.cuda.empty_cache()
    n_chol = min(CHOL_N, args.n)
    _, sigma_c, plan_c, b_np_c = problem(hz, n_chol, 5, seed=0)
    b_c = torch.as_tensor(b_np_c, device=dev, dtype=torch.float32)
    t0 = time.perf_counter()
    solver_c = hz.MultigridSolver(plan_c, dtype=torch.float32, device=dev,
                                  smoother="chebyshev", coarse="chol")
    t_setup_c = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kbuild.reset_launches()
    t0 = time.perf_counter()
    xc, hist_c = solver_c.solve(b_c, sigma_c, 0.0, tol=1e-4, method="auto", max_cycles=30)
    torch.cuda.synchronize()
    t_solve_c = time.perf_counter() - t0
    launches_c = dict(kbuild.LAUNCHES)
    check_solve("coarse=chol", xc, hist_c, launches_c,
                [k for k in MAIN_PATH if k != "lattice_stencil"], rhs=b_c)
    say(6, ok=True, coarse="chol", n=n_chol, history=hist_c,
        iters_to_1e3=iters_to(hist_c, 1e-3), iters_to_1e4=iters_to(hist_c, 1e-4),
        solve_wall_s=t_solve_c, host_solver_s=t_setup_c,
        max_memory_allocated=torch.cuda.max_memory_allocated(), launches=dict(kbuild.LAUNCHES))
    del solver_c, xc, b_c, plan_c
    torch.cuda.empty_cache()

    # ---- phase 7: the flagship driver at full size ------------------------
    launches_f, flagship_sec_iter = flagship_driver(hz, kbuild, dev, timing, smi)

    # ---- phase 8: the 2D recurrence with a shrink -------------------------
    launches_2d = recurrence_2d(kbuild, dev)

    # ---- phase 9: the bench's vcycle mode (cg_exact) ----------------------
    del b
    torch.cuda.empty_cache()
    bench_vcycle(hz, kbuild, plan, sigma, b_np, dev, smi, dense)
    del b_np
    torch.cuda.empty_cache()

    # ---- phase 10: the flagship driver with inner="vcycle" ----------------
    launches_v = flagship_vcycle(kbuild, dev, smi)

    # ---- phases 11-13: the slab-sharded path ------------------------------
    from homogenization_jl_tpu_torch.parallel import run_slab
    from homogenization_jl_tpu_torch.parallel.group import SlabGroup

    t_slab = time.perf_counter()
    t0 = time.perf_counter()
    prob_c = run_slab.problem(3, args.n, 5)
    t_plan_c = time.perf_counter() - t0
    timing["slab_combine"] = check_slab_kernel(prob_c[0], dev, smi, t_plan_c)
    kbuild.reset_launches()
    store = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    group = SlabGroup.from_file(os.path.join(store, "store"), 0, 1, device=dev)
    try:
        del prob_c
        n_slab = min(SLAB_RUN_N, args.n)
        slab_run(run_slab, group, run_slab.problem(3, n_slab, 5), n_slab, smi)
        torch.cuda.empty_cache()
        launches_s = flagship_slab(kbuild, group, smi, flagship_sec_iter)
        say("11-13", ok=True, wall_s=time.perf_counter() - t_slab)

        # ---- phases 14-15: the gather-sharded path -------------------------
        t_shard = time.perf_counter()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        plan_o, sigma_o = ordered_flagship_problem(hz)
        t_plan_o = time.perf_counter() - t0
        timing["sharded_combine"] = check_sharded_kernel(hz, kbuild, plan_o, dev, smi, t_plan_o)
        sharded_pcg_compare(hz, kbuild, group, plan_o, sigma_o, dev, smi)
        del plan_o, sigma_o
        torch.cuda.empty_cache()
        driver_profiles, driver_coverage = flagship_ordered_sharded(
            kbuild, group, smi, flagship_sec_iter)
    finally:
        SlabGroup.destroy()
        shutil.rmtree(store, ignore_errors=True)
    # phase 5's PCG iteration under torch.profiler, the group gone (above)
    pcg_profile, prof = covered_profile(pcg_step, "phase 5")
    if args.profile:
        os.makedirs(args.profile, exist_ok=True)
        with open(os.path.join(args.profile, "profile_pcg_iter.txt"), "w") as f:
            f.write(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=40))
    del state, prof, pcg_step, solver, coeff, setup
    torch.cuda.empty_cache()
    profiles_report(pcg_profile, driver_profiles, driver_coverage, smi)
    launches_d = sharded_shared_card(dev, smi)
    say("14-15", ok=True, wall_s=time.perf_counter() - t_shard)

    # ---- phases 16-18b: the precision surface -----------------------------
    from homogenization_jl_tpu_torch.fem.local_operators import load_vector
    from homogenization_jl_tpu_torch.mesh.grid import affine_maps
    from homogenization_jl_tpu_torch.parallel.run_slab import mixed_pair

    t_prec = time.perf_counter()
    _, _, detJ, _ = affine_maps(base)
    b_np = detJ[:, None] * load_vector(plan.reference.levels[4])[None, :]
    # run_mixed_pcg's pair on phase 5's plan (its problem at n = 32)
    outer, inner = mixed_pair(
        plan, lambda dtype, **kw: hz.MultigridSolver(plan, dtype=dtype, device=dev, **kw))
    coeff64 = torch.as_tensor(element_coefficients(base, sigma, 0.0), device=dev)
    timing_p, report_p = check_precision_kernels(outer, inner, plan, coeff64, dev)
    timing.update(timing_p)
    del coeff64
    kbuild.reset_launches()
    say(16, ok=True, f32_bf16=timing_p, card=smi, **report_p)
    bench_line = bench_entry(smi, args.n)
    report_b, launches_b, launches_bc = bf16_directions(hz, kbuild, plan, sigma, b_np, dev, dense,
                                                        sec_iter)
    say(17, ok=True, bench=bench_line, bf16=report_b, card=smi)
    launches_m = mixed_solve(kbuild, outer, inner, sigma, b_np, dev, smi)
    del outer, inner, b_np
    torch.cuda.empty_cache()
    mixed_slab(dev, smi, min(MIXED_SLAB_N, args.n))
    say("16-18", ok=True, wall_s=time.perf_counter() - t_prec)

    # ---- phases 19-21: the multishift recurrence and st1 -------------------
    timing_slice, launches_slice = slice_phases(kbuild, dev, smi)
    timing.update(timing_slice)
    for name in ("spectral_filter", "exp_abs"):
        timing[name].update(device_times[name])

    # ---- phases 22-24: the Poisson demos, step files and VTK, entry points --
    poisson(hz, kbuild, dev, smi)
    checkpoints_vtk(kbuild, dev, smi)
    entry_points(dev, smi)
    kbuild.reset_launches()

    path_launches = {name: launches_f[name] for name in KERNELS}
    path_launches["gather_combine"] = launches_2d["ordered"]["gather_combine"]
    for name in ("transfer", "masked_dot", "cg_update"):
        path_launches[name] = launches_v[name]
    path_launches["slab_combine"] = launches_s["slab_combine"]
    path_launches["sharded_combine"] = launches_d["sharded_combine"]
    for name in ("direction_apply", "direction_chebyshev"):
        path_launches[name] = launches_b[name]
    for name in ("direction_dot", "direction_cg"):
        path_launches[name] = launches_bc[name]
    path_launches["mixed_boundary"] = launches_m["mixed_boundary"]
    path_launches.update(launches_slice)
    kernels = [
        dict(name=name, **meta, launches=path_launches[name], **timing[name])
        for name, meta in KERNELS.items()
    ]
    say("all", ok=True, wall_s=time.perf_counter() - t_all)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
