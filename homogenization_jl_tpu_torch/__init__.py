"""homogenization_jl_tpu_torch — the PyTorch/CUDA port of homogenization_jl_tpu.

Matrix-free geometric multigrid on implicit fine grids for
-div(a(x) grad u) + lambda u = f in 2D/3D, on one NVIDIA H100. The JAX
package beside it is the reference; this package imports torch, numpy and
scipy and never jax.

Layer map (host precompute in NumPy, device compute in PyTorch):
  mesh/    — meshes, refinement, multilevel reference element (host copy)
  fem/     — quadrature, dense reference operators, explicit assembly (host copy)
  native/  — g++ host helper for plan construction (host copy)
  ops/     — grid plan (host copy) + device ops with their hand kernels:
             apply (K1, CUDA), structured combine (K2, CUDA),
             chebyshev update (K3, Triton), lattice stencil (K6, CUDA),
             coarse gathers / segment sum (K7, CUDA, in interfaces),
             transfer
  csrc/    — the CUDA sources and their nvcc build
  solver/  — multigrid (structured, chebyshev; coarse chol / inv / cg / mg
             with the aux hierarchy of coarse.py; FMG + PCG)
  models/  — checkerboard conductivity fields
"""

from .mesh.grid import Mesh, hypercube, interior_nodes
from .mesh.refine import refine_uniformly
from .mesh.reference import refined_reference
from .ops.plan import build_grid_plan
from .solver.multigrid import MultigridSolver

__all__ = [
    "Mesh",
    "hypercube",
    "interior_nodes",
    "refine_uniformly",
    "refined_reference",
    "build_grid_plan",
    "MultigridSolver",
]

__version__ = "0.1.0"
