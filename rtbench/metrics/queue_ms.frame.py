"""Self time of the child queue a frame (the ``rt.queue`` spans: spawning
children, compaction or parking, adding a round into the frame), ms (entry
and wavefront layer)."""

from rtbench.spans import self_ms


def read(st):
    return self_ms(st, "rt.queue")
