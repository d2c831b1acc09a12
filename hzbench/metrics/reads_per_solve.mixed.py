"""Device-to-host reads of the program per solve in the mixed cell: its
``hz.read`` spans (each outer step's residual norm, the inner coarse loops'
stop tests) over the traced window's ``hzbench.solve`` ranges."""

from hzbench.spans import span_count


def read(run):
    return span_count(run, "reads_per_solve.mixed", "hzbench.solve", "hz.read")
