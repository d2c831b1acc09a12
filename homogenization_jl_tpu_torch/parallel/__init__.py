"""Element-axis sharding over torch.distributed (port of
homogenization_jl_tpu/parallel/): ``group.SlabGroup`` (the 1D device mesh),
``slab.SlabShardedMultigridSolver`` (the slab-sharded solver, kernel K11)
and ``run_slab`` (its large run, ``torchrun`` entry point and CPU test
worker)."""
