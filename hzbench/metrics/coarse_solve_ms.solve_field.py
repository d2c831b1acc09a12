"""Host-clock milliseconds per solve inside the coarse solves in
solve_field: the outermost ``hz.coarse_solve`` spans of the traced window
(those of the field's set-up, the FMG's, the PCG init's and every
V-cycle's level-0 solve), over the window's ``hzbench.solve`` ranges."""

from hzbench.spans import span_ms


def read(run):
    return span_ms(run, "coarse_solve_ms.solve_field", "hzbench.solve", "hz.coarse_solve")
