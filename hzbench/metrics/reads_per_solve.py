"""Device-to-host reads of the program per solve: its ``hz.read`` spans
(the coarse loops' stop tests, PCG's residual norms) over the traced
window's ``hzbench.solve`` ranges. The benchmark's own reads (the rhs
norm, the FMG residual) are not counted."""

from hzbench.spans import span_count


def read(run):
    return span_count(run, "reads_per_solve", "hzbench.solve", "hz.read")
