"""The least time a frame's ray queries need on one NVIDIA H100.

Counted from the cell's inputs alone (canvas, samples, lights, boxes, and
the rays that really bounce, as the plain reference counts them for the
camera), never from the program's counters or launch shapes, so the count
reads the same whatever kernel, fusion or recompute answers the queries.

* a closest-hit query reads its ray (origin and direction, 24 B) and
  writes its answer once: hit time, triangle, barycentrics, normal and
  material (4 + 4 + 8 + 12 + 4 = 32 B);
* an any-hit (shadow) query reads its ray and its range (28 B) and writes
  one byte;
* the scene's tables are read once a frame: a box and a material row a
  box (24 + 4 B);
* each query needs at least the slab test of the box that answers it
  (24 FP32 operations).

The least time is the larger of bytes over the HBM bandwidth and
operations over the FP32 peak (NVIDIA's data sheet, SXM part, at the full
700 W power limit): at these counts the bytes bound it.
"""

from __future__ import annotations

from typing import Sequence

PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
CLOSEST_BYTES = 24 + 32
ANY_BYTES = 28 + 1
BOX_BYTES = 24 + 4
QUERY_FLOPS = 24


def frame_queries(pixels: int, lights: int, bounced: Sequence[int]):
    """``(closest, any)`` queries of one sample: a closest hit and one
    shadow query a light for every pixel, and the same for every ray of
    each bounce round."""
    rays = pixels + sum(bounced)
    return rays, rays * lights


def least_seconds(closest: int, any_hit: int, frames: int, boxes: int
                  ) -> float:
    """The least device time of ``closest`` + ``any_hit`` queries over
    ``frames`` frames of a world of ``boxes`` boxes."""
    nbytes = (closest * CLOSEST_BYTES + any_hit * ANY_BYTES
              + frames * boxes * BOX_BYTES)
    flops = (closest + any_hit) * QUERY_FLOPS
    return max(nbytes / PEAK_BYTES_S, flops / PEAK_FP32_S)
