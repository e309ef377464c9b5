"""The closest-hit queries the transmissive shadow march made a frame:
the ``rt.cast`` spans that open inside an ``rt.march`` span on its
thread, an item (shading and glue layer).  At most a light's
``shadow_steps`` a bounce round; fewer where the early exit finds no
shadow ray marching on."""

from rtbench.spans import spans


def read(st):
    marches = spans(st, "rt.march")
    if not marches:
        return None
    casts = spans(st, "rt.cast")
    return sum(1 for s, e, thread in casts
               if any(thread == t and a <= s and e <= b
                      for a, b, t in marches)) / st.items
