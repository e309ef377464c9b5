"""Self time of the scene prep a frame (the ``rt.prep`` span: world geometry,
the cast's tables and LBVH), ms (scene prep layer)."""

from rtbench.spans import self_ms


def read(st):
    return self_ms(st, "rt.prep")
