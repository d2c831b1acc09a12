"""Milliseconds of device idle per solve in the gaps that began while a
``hz.coarse_solve`` span was open (its host reads, the launches of the
coarse PCG and of the aux hierarchy), every gap of the traced window
walked, over the window's ``hzbench.solve`` ranges."""

from hzbench.spans import idle_ms


def read(run):
    return idle_ms(run, "coarse_idle_ms.solve", "hzbench.solve", "hz.coarse_solve")
