"""Device ms a step outside the ray-query kernels: shading, the
wavefront's bookkeeping, the backward's torch ops, copies (the shading
and glue layer)."""

from rtbench.trace import QUERY_KERNELS, glue_ms


def read(st):
    return glue_ms(st, QUERY_KERNELS)
