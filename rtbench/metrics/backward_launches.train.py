"""Host calls that enqueue device work (kernels, memsets, copies) inside
the ``rt.backward`` span, on any thread (autograd runs the backward on a
device thread of its own), a step (backward layer)."""

from rtbench.spans import launch_calls


def read(st):
    return launch_calls(st, "rt.backward")
