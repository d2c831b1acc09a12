"""Checkpoint / resume for the homogenization recurrence (port of
homogenization_jl_tpu/utils/checkpoint.py, the same npz format).

The recurrence state is small and explicit: (k, sigma, lam, box_radius,
total_radius, the finest x, b, v_prev, the conductivity field, xi, n,
refinements), so one compressed npz per outer step is enough to resume a
multi-hour run. A step file written by either package resumes in the other:
tensors are stored through ``.cpu().numpy()`` in the state's dtype, a
missing ``v_prev`` as ``zeros(0)``.
"""

from __future__ import annotations

import numpy as np
import torch


def _host(a) -> np.ndarray:
    """A tensor's values on the host in its own dtype, or a host array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def save_step(path: str, *, k, sigma, lam, box_radius, total_radius, x, b,
              v_prev, cond_field, xi, n, refinements) -> str:
    """Write one outer step's state to ``path`` (".npz" appended when
    missing); returns the path written."""
    if not path.endswith(".npz"):
        path += ".npz"
    np.savez_compressed(
        path,
        k=k,
        sigma=sigma,
        lam=lam,
        box_radius=box_radius,
        total_radius=total_radius,
        x=_host(x),
        b=_host(b),
        v_prev=_host(v_prev) if v_prev is not None else np.zeros(0),
        cond_field=_host(cond_field),
        xi=_host(xi),
        n=n,
        refinements=refinements,
    )
    return path


def load_step(path: str) -> dict:
    """The state of a step file: host arrays, Python ints and floats, and
    ``v_prev`` None where the file holds none."""
    with np.load(path) as z:
        out = {key: z[key] for key in z.files}
    for key in ("k", "n", "refinements", "box_radius", "total_radius"):
        out[key] = int(out[key])
    for key in ("sigma", "lam"):
        out[key] = float(out[key])
    if out["v_prev"].size == 0:
        out["v_prev"] = None
    return out
