"""The ray-query kernels' share of their roofline in a step: the least
time of the step's queries (rtbench.roofline, from the cell's inputs) over
the device time of the kernels below, %."""

from rtbench.trace import QUERY_KERNELS, cast_share


def read(st):
    return cast_share(st, QUERY_KERNELS)
