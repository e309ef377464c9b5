"""The share of a frame's shading rounds that ran on the two shading
kernels: the ``rt.shade`` spans that hold an ``rt.shade_fused`` span (the
empty span the program opens before the first kernel's launch) on their
thread, % (shading and glue layer).  0 where every round took the torch
ops; None where no round shades."""

from rtbench.spans import spans


def read(st):
    shades = spans(st, "rt.shade")
    if not shades:
        return None
    fused = spans(st, "rt.shade_fused")
    return 100.0 * sum(1 for a, b, t in shades
                       if any(thread == t and a <= s and e <= b
                              for s, e, thread in fused)) / len(shades)
