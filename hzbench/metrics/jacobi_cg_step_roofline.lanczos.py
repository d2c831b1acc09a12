"""K14a's JAX function in the sigma cell: the bound of the logged
jacobi_cg_step calls over the device time of what the
hz.op.jacobi_cg_step spans launch (metrics/jacobi_cg_step_roofline.lanczos.json)."""

from hzbench.spans import roofline_file


def read(run):
    return roofline_file(run, __file__)
