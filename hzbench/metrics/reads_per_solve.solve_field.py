"""Device-to-host reads of the program per solve in solve_field: its
``hz.read`` spans (the field's set-up, the coarse loops' stop tests, PCG's
residual norms) over the traced window's ``hzbench.solve`` ranges. The
benchmark's own reads (the rhs norm, the FMG residual) are not counted."""

from hzbench.spans import span_count


def read(run):
    return span_count(run, "reads_per_solve.solve_field", "hzbench.solve", "hz.read")
