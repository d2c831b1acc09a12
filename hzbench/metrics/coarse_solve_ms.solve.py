"""Host-clock milliseconds per solve inside the coarse solves: the
outermost ``hz.coarse_solve`` spans of the traced window (the FMG's, the
PCG init's and every V-cycle's level-0 solve, the aux hierarchy's inside
them), over the window's ``hzbench.solve`` ranges."""

from hzbench.spans import span_ms


def read(run):
    return span_ms(run, "coarse_solve_ms.solve", "hzbench.solve", "hz.coarse_solve")
