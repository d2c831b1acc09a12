"""Build and load the hand-written CUDA kernels (csrc/*.cu).

On first use the sources (``*.cu``, which include the shared ``*.cuh``
headers) are compiled by ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``), one ``nvcc`` process per source
started together, and linked into one shared library with a plain C
interface under ``build/kernels/`` at the root of the checkout (listed in
.gitignore), and loaded with ctypes. The library name carries a
hash of the sources, so an edited source is never served a stale build.
Nothing here includes PyTorch's headers: a build takes seconds, not minutes.

``LAUNCHES`` counts the launches of every hand kernel of the package (the
CUDA ones and the Triton ones, K3's ``chebyshev_update`` and K16's
``direction_chebyshev``). A wrapper adds one exactly where it launches its kernel;
the plain CPU path never counts. ``hz_launch_floor`` (an empty kernel,
csrc/launch_floor.cu) is a measurement fixture on no path of the port: it
is built with the rest only so that chip_smoke.py can time it as the least
time a launch through ``launch`` takes.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess

LAUNCHES = {
    "element_apply": 0,
    "structured_combine": 0,
    "chebyshev_update": 0,
    "lattice_stencil": 0,
    "coarse_gather": 0,
    "gather_combine": 0,
    "integrals": 0,
    "transfer": 0,
    "masked_dot": 0,
    "cg_update": 0,
    "slab_combine": 0,
    "sharded_combine": 0,
    "elementwise": 0,
    "direction_apply": 0,
    "direction_chebyshev": 0,
    "direction_dot": 0,
    "direction_cg": 0,
    "mixed_boundary": 0,
    "multishift_update": 0,
    "jacobi_cg": 0,
    "mass_dot": 0,
    "basis_combine": 0,
    "spectral_filter": 0,
    "exp_abs": 0,
}

_CSRC = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(_CSRC)), "build", "kernels"
)
_LIB = None
BUILD_LOG = ""

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_D = ctypes.c_double
# C entry points: name -> argtypes (every entry returns cudaGetLastError())
_SIGNATURES = {
    # dtype(0 f32, 1 f64), x, coeff, table slot words, slot values, R, PP,
    # V, b (or NULL), row sums (with b), mask (or NULL), out, E, n, P, stream
    "hz_element_apply": [_I, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _L, _I, _I, _P],
    # dtype, xtype (0 f32, 2 bf16, 3 f16), then as hz_element_apply
    "hz_element_apply_half": [_I, _I, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _L, _I, _I,
                              _P],
    # dtype, x, out, mask (or NULL), E, n_local, i0, n, d, ept, type_major,
    # mode, tab, stream
    "hz_structured_combine": [_I, _P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _I, _P, _P],
    # dtype, x, halo_lo, halo_hi, out, mask (or NULL), B, n_local, i0, n, d,
    # ept, x0, W, pad, mode, tab, stream
    "hz_structured_combine_slab": [_I, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _I,
                                   _I, _I, _P, _P],
    # dtype, coeff, stack0, W, P, x0, planes, tab (host), stream
    "hz_lattice_weights": [_I, _P, _P, _P, _I, _I, _I, _P, _P],
    # dtype, u, W, m (or NULL), b (or NULL), out, tab, stream
    "hz_lattice_apply": [_I, _P, _P, _P, _P, _P, _P, _P],
    # dtype, y, out, x0, planes, tab, stream
    "hz_lattice_assemble": [_I, _P, _P, _I, _I, _P, _P],
    # dtype, u, out, x0, planes, tab, stream
    "hz_lattice_distribute": [_I, _P, _P, _I, _I, _P, _P],
    # dtype, itype (0 int32, 1 int64), vals, perm, start, out, n_seg, stream
    "hz_segment_sum": [_I, _I, _P, _P, _P, _P, _L, _P],
    # dtype, itype, src, idx, mask (or NULL), out, total, stream
    "hz_gather_scale": [_I, _I, _P, _P, _P, _P, _L, _P],
    # dtype, itype (owner tables: 0 int32, 1 int64), x, out, mask (or NULL), E,
    # n_local, i0, ncls, classes (host), stream
    "hz_gather_combine": [_I, _I, _P, _P, _P, _L, _I, _I, _I, _P, _P],
    # dtype, mode, x, mass table cols, vals, counts, R, w, detJ, mask, partA,
    # partB, fixed-sum scratch, out, E, n, scale, stream
    "hz_integrals": [_I, _I, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _L, _I, _D, _P],
    # dtype, x_fine (or NULL), x_coarse, out, cols, wts, E, n_f, n_c, G, stream
    "hz_prolong_add": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # dtype, r, out, colptr, rows, wts, E, n_f, n_c, G, stream
    "hz_restrict": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # dtype, a, b, mask (or NULL), scale (or NULL), fixed-sum scratch, out, N,
    # stream
    "hz_masked_dot": [_I, _P, _P, _P, _P, _P, _P, _L, _P],
    # dtype, atype (the stored type of a), then as hz_masked_dot
    "hz_masked_dot_half": [_I, _I, _P, _P, _P, _P, _P, _P, _L, _P],
    # dtype, x, r (or NULL), p, Ap, num, den, r_out (or NULL), x_zero, N, stream
    "hz_cg_step": [_I, _P, _P, _P, _P, _P, _P, _P, _I, _L, _P],
    # dtype, out, rc, p, num, den, N, stream
    "hz_cg_direction": [_I, _P, _P, _P, _P, _P, _L, _P],
    # dtype, ptype (the stored type of p), then as hz_cg_step / hz_cg_direction
    "hz_cg_step_half": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _L, _P],
    "hz_cg_direction_half": [_I, _I, _P, _P, _P, _P, _P, _L, _P],
    # c (f64), s (f32, or NULL), out (f32), N, stream
    "hz_downcast_scale": [_P, _P, _P, _L, _P],
    # z (f32), out (f64), N, stream
    "hz_upcast": [_P, _P, _L, _P],
    # dtype, x, mask, out, N, stream
    "hz_ew_mask": [_I, _P, _P, _P, _L, _P],
    # dtype, a, b, out, N, stream
    "hz_ew_mul": [_I, _P, _P, _P, _L, _P],
    # dtype, u, v, w (or NULL), alpha, beta, out, N, stream
    "hz_ew_lanczos": [_I, _P, _P, _P, _P, _P, _P, _L, _P],
    # dtype, v, s, out, N, stream
    "hz_ew_div_nz": [_I, _P, _P, _P, _L, _P],
    # dtype, d, out, N, stream
    "hz_ew_inv_positive": [_I, _P, _P, _L, _P],
    # dtype, coeff, diag_ref, out, E, P, n, stream
    "hz_ew_diagonal": [_I, _P, _P, _P, _L, _I, _I, _P],
    # dtype, x, perm, start, gid (int32), partial, n_groups, n_local_groups, stream
    "hz_cross_partial": [_I, _P, _P, _P, _P, _P, _L, _L, _P],
    # dtype, out, total, idx (int32), grp (int32), mask (or NULL), n_slots, stream
    "hz_cross_scatter": [_I, _P, _P, _P, _P, _P, _L, _P],
    # dtype, v, W, xs, shifts, t_curr, t_prev, D_prev, y_prev, D_curr,
    # y_curr, coef, n_shifts, N, first, stream
    "hz_multishift_step": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _L, _I, _P],
    # dtype, x, r, p, Ap, d, w (or NULL), num, den, z, fixed-sum scratch, rz,
    # rs, r_out (or NULL), x_zero, N, stream
    "hz_jacobi_cg_step": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _L, _P],
    # dtype, V, Y, ldy, out, m, K, N, stream
    "hz_basis_combine": [_I, _P, _P, _I, _P, _I, _I, _L, _P],
    # dtype, v, c, ldc, sums, K, N, first, stream
    "hz_basis_accumulate": [_I, _P, _P, _I, _P, _I, _L, _I, _P],
    # F, out (complex64), total, D0, D1, L, p, stream
    "hz_spectral_filter": [_P, _P, _I, _I, _I, _I, _D, _P],
    # f, out (float32), N, alpha, stream
    "hz_exp_abs": [_P, _P, _I, _D, _P],
    # stream (an empty kernel)
    "hz_launch_floor": [_P],
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (
        os.path.join(home, "bin", "nvcc") if home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def kernels_lib() -> ctypes.CDLL:
    """The loaded kernel library, built from csrc/*.cu on first call."""
    global _LIB, BUILD_LOG
    if _LIB is not None:
        return _LIB
    srcs = sorted(glob.glob(os.path.join(_CSRC, "*.cu")))
    h = hashlib.sha256()
    for s in srcs + sorted(glob.glob(os.path.join(_CSRC, "*.cuh"))):
        with open(s, "rb") as f:
            h.update(f.read())
    so = os.path.join(BUILD_DIR, f"libhz_kernels_{h.hexdigest()[:12]}.so")
    log = so[:-3] + ".log"
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tag = f"{h.hexdigest()[:12]}.{os.getpid()}"
        flags = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                 "-Xcompiler", "-fPIC"]
        objs, procs = [], []
        for src in srcs:
            obj = os.path.join(BUILD_DIR, f"{os.path.basename(src)[:-3]}.{tag}.o")
            cmd = [_nvcc(), *flags, "-Xptxas", "-v", "-c", "-o", obj, src]
            objs.append(obj)
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        logs, failed = [], []
        for cmd, proc in procs:
            out, err = proc.communicate()
            logs.append(" ".join(cmd) + "\n" + out + err)
            if proc.returncode != 0:
                failed.append(f"{cmd[-1]} (rc {proc.returncode}):\n{err[-4000:]}")
        tmp = f"{so}.{os.getpid()}.tmp"
        if not failed:
            cmd = [_nvcc(), *flags, "-shared", "-o", tmp, *objs]
            res = subprocess.run(cmd, capture_output=True, text=True)
            logs.append(" ".join(cmd) + "\n" + res.stdout + res.stderr)
            if res.returncode != 0:
                failed.append(f"link (rc {res.returncode}):\n{res.stderr[-4000:]}")
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
        with open(log, "w") as f:
            f.write("\n".join(logs))
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        os.replace(tmp, so)
    if os.path.exists(log):
        with open(log) as f:
            BUILD_LOG = f.read()
    lib = ctypes.CDLL(so)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _LIB = lib
    return lib


def current_stream() -> int:
    """The current CUDA stream of the current device, as a raw pointer (the
    one PyTorch launches on; chip_smoke.py phase 2 checks it)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())


def launch(name: str, *args, stream: int | None = None) -> None:
    """Call the C entry ``name`` on ``stream`` (default: the current CUDA
    stream) and raise if the launch was refused (cudaGetLastError() != 0)."""
    err = getattr(kernels_lib(), name)(*args, current_stream() if stream is None else stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
