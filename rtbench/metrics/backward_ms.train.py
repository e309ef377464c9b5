"""Wall time of the backward a step (the ``rt.backward`` span: the main
thread waiting on autograd), ms (backward layer)."""

from rtbench.spans import wall_ms


def read(st):
    return wall_ms(st, "rt.backward")
