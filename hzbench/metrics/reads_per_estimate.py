"""Device-to-host reads of the program per estimate: its ``hz.read`` spans
(each mass-CG iteration's stop test, the Lanczos step's two M-inner
products, the sigma integrals) over the traced window's ``hz.estimate``
spans."""

from hzbench.spans import span_count


def read(run):
    return span_count(run, "reads_per_estimate", "hz.estimate", "hz.read")
