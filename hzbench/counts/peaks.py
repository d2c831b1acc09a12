"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its full 700 W power limit; the benchmark prints the card's limit beside
every share of them): 80 GB of HBM3 at 3.35 TB/s, 67 TFLOP/s in float32
and 34 TFLOP/s in float64 outside the tensor cores (67 TFLOP/s on the
float64 tensor cores, which no kernel of the port uses)."""

HBM_BYTES_PER_S = 3.35e12
_FLOPS = {"float32": 67e12, "float64": 34e12}


def flops_per_s(dtype: str) -> float:
    return _FLOPS[dtype]
