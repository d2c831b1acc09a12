"""Build and load the hand-written CUDA kernels (csrc/*.cu).

On first use the sources are compiled by ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into one shared library with a
plain C interface under ``build/kernels/`` at the root of the checkout
(listed in .gitignore), and loaded with ctypes. The library name carries a
hash of the sources, so an edited source is never served a stale build.
Nothing here includes PyTorch's headers: a build takes seconds, not minutes.

``LAUNCHES`` counts the launches of every hand kernel of the package (the
CUDA ones and the Triton ``chebyshev_update``). A wrapper adds one exactly
where it launches its kernel; the plain CPU path never counts.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess

LAUNCHES = {"element_apply": 0, "structured_combine": 0, "chebyshev_update": 0}

_CSRC = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(_CSRC)), "build", "kernels"
)
_LIB = None
BUILD_LOG = ""

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C entry points: name -> argtypes (every entry returns cudaGetLastError())
_SIGNATURES = {
    # dtype(0 f32, 1 f64), x, coeff, stack, b (or NULL), out, E, n, P, stream
    "hz_element_apply": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    # dtype, x, out, E, n_local, i0, n, d, ept, type_major, mode, tab, stream
    "hz_structured_combine": [_I, _P, _P, _L, _I, _I, _I, _I, _I, _I, _I, _P, _P],
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
    for s in srcs:
        with open(s, "rb") as f:
            h.update(f.read())
    so = os.path.join(BUILD_DIR, f"libhz_kernels_{h.hexdigest()[:12]}.so")
    log = so[:-3] + ".log"
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [
            _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
            "-o", tmp, *srcs,
        ]
        res = subprocess.run(cmd, capture_output=True, text=True)
        with open(log, "w") as f:
            f.write(" ".join(cmd) + "\n" + res.stdout + res.stderr)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed (rc {res.returncode}):\n{res.stderr[-4000:]}"
            )
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


def launch(name: str, *args) -> None:
    """Call the C entry ``name`` on the current CUDA stream and raise if the
    launch was refused (cudaGetLastError() != 0)."""
    import torch

    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(kernels_lib(), name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
