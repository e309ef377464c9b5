"""Self time of the scene prep a step (the ``rt.prep`` span of its forward
frame: world geometry, the cast's tables and LBVH), ms (scene prep
layer)."""

from rtbench.spans import self_ms


def read(st):
    return self_ms(st, "rt.prep")
