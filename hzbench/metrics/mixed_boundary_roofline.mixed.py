"""K15's JAX function in the mixed cell: the bound of the logged
downcast_scale and upcast calls over the device time of what the
hz.op.downcast_scale and hz.op.upcast spans launch
(metrics/mixed_boundary_roofline.mixed.json)."""

from hzbench.spans import roofline_file


def read(run):
    return roofline_file(run, __file__)
