"""Self time of the transmissive shadow march a frame (the ``rt.march``
span of each light's march: its glue, less its closest-hit casts
``rt.cast`` and its early exits ``rt.sync``), ms (shading and glue
layer).  A world without glass never opens the span."""

from rtbench.spans import self_ms


def read(st):
    return self_ms(st, "rt.march")
