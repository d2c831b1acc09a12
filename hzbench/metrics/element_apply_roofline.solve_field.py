"""K1's JAX function in solve_field: the bound of the logged
element_apply calls, each at its own level's shape, over the
device time of what the hz.op.element_apply spans launch
(metrics/element_apply_roofline.solve_field.json)."""

from hzbench.spans import roofline_file


def read(run):
    return roofline_file(run, __file__)
