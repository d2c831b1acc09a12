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
             transfer, the gather-sharded combine (K12, CUDA, sharded),
             the state-sized elementwise passes (K18, CUDA, elementwise)
  csrc/    — the CUDA sources and their nvcc build
  solver/  — multigrid (structured, chebyshev; coarse chol / inv / cg / mg
             with the aux hierarchy of coarse.py; FMG + PCG); CG and
             multishift CG (cg.py; per-shift update K13, CUDA, ops/multishift)
  models/  — checkerboard conductivity fields and the homogenization
             driver (step files and resume, VTK export); the multishift
             recurrence (Jacobi CG step, M-inner product, basis passes:
             K14, CUDA, ops/recurrence and K9); the st1 field solve; the
             Poisson demos (poisson.py: BASELINE configs 1 and 3)
  utils/   — st1 spectral fields (the FFTs and K17, CUDA), step files
             (checkpoint.py, the JAX package's npz format), the VTU writer
             (vtk.py), StepLogger and the torch.profiler trace (logging.py)
  parallel/ — the sharded solvers over torch.distributed (SlabGroup;
             SlabShardedMultigridSolver, slab combine K11, CUDA;
             ShardedMultigridSolver, gather-sharded combine K12) and
             run_slab's torchrun entry point
Entry points (python -m homogenization_jl_tpu_torch.<name>): bench,
run_flagship, run_mixed_pcg, run_st1, run_multishift_compare,
parallel.run_slab.
"""

from .mesh.grid import Mesh, hypercube, interior_nodes
from .mesh.refine import refine_uniformly
from .mesh.reference import refined_reference
from .ops.plan import build_grid_plan
from .parallel.group import SlabGroup
from .parallel.sharding import ShardedMultigridSolver
from .parallel.slab import SlabShardedMultigridSolver
from .models.checkerboard import checkerboard_homogenization
from .models.st1 import st1_multigrid
from .solver.cg import multishift_cg
from .solver.multigrid import MultigridSolver

__all__ = [
    "Mesh",
    "hypercube",
    "interior_nodes",
    "refine_uniformly",
    "refined_reference",
    "build_grid_plan",
    "MultigridSolver",
    "SlabGroup",
    "ShardedMultigridSolver",
    "SlabShardedMultigridSolver",
    "checkerboard_homogenization",
    "multishift_cg",
    "st1_multigrid",
]

__version__ = "0.1.0"
