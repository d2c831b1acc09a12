"""Host-clock milliseconds of each estimate's own set-up (plan, solver,
tables, the mass diagonal, the start vector: the interval the driver's
``stats["setup_seconds"]`` times), the ``hz.estimate_setup`` spans over the
traced window's ``hz.estimate`` spans."""

from hzbench.spans import span_ms


def read(run):
    return span_ms(run, "estimate_setup_ms.lanczos", "hz.estimate", "hz.estimate_setup")
