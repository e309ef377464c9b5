"""The share of a frame's transmissive shadow marches that ran as one
fused kernel: the ``rt.march`` spans that hold an ``rt.march_fused`` span
(the empty span the program opens before the kernel's launch) on their
thread, % (shading and glue layer).  0 where every march took the loop of
torch ops; None where no march opens."""

from rtbench.spans import spans


def read(st):
    marches = spans(st, "rt.march")
    if not marches:
        return None
    fused = spans(st, "rt.march_fused")
    return 100.0 * sum(1 for a, b, t in marches
                       if any(thread == t and a <= s and e <= b
                              for s, e, thread in fused)) / len(marches)
