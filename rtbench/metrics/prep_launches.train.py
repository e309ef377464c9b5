"""Host calls that enqueue device work (kernels, memsets, copies) inside
the ``rt.prep`` span, a step (scene prep layer)."""

from rtbench.spans import launch_calls


def read(st):
    return launch_calls(st, "rt.prep")
