"""Wall time of the deliberate host reads of device data a frame (the
``rt.sync`` spans: the early exits of the bounce rounds and the shadow
march), ms: the time the host waited on the card (entry and wavefront
layer)."""

from rtbench.spans import wall_ms


def read(st):
    return wall_ms(st, "rt.sync")
