"""Element-axis sharding over torch.distributed (port of
homogenization_jl_tpu/parallel/): ``group.SlabGroup`` (the 1D device mesh),
``slab.SlabShardedMultigridSolver`` (the slab-sharded solver, kernel K11),
``sharding.ShardedMultigridSolver`` (the gather-sharded solver, kernel K12)
and ``run_slab`` (the slab solver's large run, its ``torchrun`` entry point,
and the CPU test workers of both solvers)."""
