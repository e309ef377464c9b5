"""Host calls that enqueue device work (kernels, memsets, copies) inside
the ``rt.march`` span, its casts included, a frame (shading and glue
layer)."""

from rtbench.spans import launch_calls


def read(st):
    return launch_calls(st, "rt.march")
