"""Self time of the cast calls a frame (the ``rt.cast`` span: the closest
hit and the any-hit queries: packing, checks, the kernel launch), ms (the
cast layer's host side)."""

from rtbench.spans import self_ms


def read(st):
    return self_ms(st, "rt.cast")
