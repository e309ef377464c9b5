"""Structured logging and per-step statistics.

Counterpart of ``raytracer_tpu/tracing.py``: ``log`` prints one JSON line
with a monotonic timestamp to stderr, and ``FrameStats`` times steps on the
host clock and logs each.  A host clock only times device work that ends in
a synchronisation: a training step does (it reads the loss back), a bare
``render_frame`` on the card does not.  Device traces (``profile_trace``)
are not ported.
"""

from __future__ import annotations

import json
import sys
import time
from dataclasses import dataclass
from typing import Optional


def log(event: str, **fields) -> None:
    rec = {"t": time.monotonic(), "event": event}
    rec.update(fields)
    print(json.dumps(rec), file=sys.stderr, flush=True)


def profile_trace(logdir: str = "trace"):
    raise NotImplementedError(
        "profile_trace is not ported (ROADMAP.md Queue 1 item 9: the ops "
        "surface, tracing on torch.profiler)")


@dataclass
class FrameStats:
    """Accumulates step statistics; logs one ``frame`` JSON line each."""

    width: int
    height: int
    spp: int = 1
    frames: int = 0
    _t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        ms = (time.perf_counter() - self._t0) * 1e3
        self.frames += 1
        rays = self.width * self.height * self.spp
        log("frame", frame=self.frames, ms=round(ms, 3),
            mrays_per_s=round(rays / ms / 1e3, 3))
        return False
