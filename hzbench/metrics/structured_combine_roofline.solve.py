"""K2's JAX functions in the solve cell: the bound of the logged
combine_structured and constrain_structured calls over the device time of
what their hz.op.* spans launch
(metrics/structured_combine_roofline.solve.json)."""

from hzbench.spans import roofline_file


def read(run):
    return roofline_file(run, __file__)
