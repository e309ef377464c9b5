"""Self time of shading a frame (the ``rt.shade`` span of each round: hit
attributes, material rows, the lights; its shadow queries are ``rt.cast``),
ms (shading and glue layer)."""

from rtbench.spans import self_ms


def read(st):
    return self_ms(st, "rt.shade")
