"""K1's JAX function in the sigma cell: the bound of the logged
element_apply calls over the device time of what the hz.op.element_apply
spans launch (metrics/element_apply_roofline.lanczos.json)."""

from hzbench.spans import roofline_file


def read(run):
    return roofline_file(run, __file__)
