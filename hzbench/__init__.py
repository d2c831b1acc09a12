"""hzbench: the benchmark of homogenization_jl_tpu_torch on one NVIDIA H100.

    python3 -m hzbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of BENCHMARK.json (at the root of the checkout) and prints
one JSON line. Everything a cell needs is data found by name:

  configs/<config>.json    the problem and the solver options as run
  traffic/<mix>.json       a traffic mix: ``kind`` (kinds/<kind>.py) and
                           its parameters
  limits/<cell>.json       the limits of the numbers that decide ``correct``
  metrics/<metric>.json    a per-layer metric: the reader (readers.py) and
                           its parameters; or metrics/<metric>.py with a
                           ``read(run)`` of its own
  counts/                  bytes and operations of a JAX function's
                           operands, from shapes, and the card's peaks
  reference/               the plain reference (NumPy and PyTorch; imports
                           nothing of the program)

The program under test is imported from homogenization_jl_tpu_torch;
nothing here imports jax or the JAX package.
"""
