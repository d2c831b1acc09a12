"""K1's JAX function in the mixed cell: the bound of the logged
element_apply calls, float64 and float32 each at its own shape, over the
device time of what the hz.op.element_apply spans launch
(metrics/element_apply_roofline.mixed.json)."""

from hzbench.spans import roofline_file


def read(run):
    return roofline_file(run, __file__)
