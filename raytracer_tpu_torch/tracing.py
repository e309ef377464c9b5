"""Structured logging, device traces and per-step statistics.

Counterpart of ``raytracer_tpu/tracing.py``: ``log`` prints one JSON line
with a monotonic timestamp to stderr; ``profile_trace`` records the
enclosed block with ``torch.profiler`` (host activity, and the card's
kernels and copies when CUDA is available) and writes a Chrome trace into
its directory, which TensorBoard and ``chrome://tracing`` read;
``FrameStats`` times steps on the host clock and logs each.  A host clock
only times device work that ends in a synchronisation: a training step does
(it reads the loss back), a bare ``render_frame`` on the card does not.
``span`` marks a layer of the port (``rt.frame``, ``rt.prep``, ``rt.cast``,
...) as a profiler event, on the clock of the card's activity in the same
trace; with no profiler recording it does nothing.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from dataclasses import dataclass
from typing import Optional

import torch

# one shared do-nothing span: no profiler, no cost beyond the flag's read
_OFF = contextlib.nullcontext()
_profiling = torch._C._autograd._profiler_enabled


def log(event: str, **fields) -> None:
    rec = {"t": time.monotonic(), "event": event}
    rec.update(fields)
    print(json.dumps(rec), file=sys.stderr, flush=True)


def span(name: str):
    """A ``torch.profiler.record_function`` span named ``name`` while a
    profiler records on this thread (host-side only: it launches nothing on
    the card), else one shared ``nullcontext``."""
    if not _profiling():
        return _OFF
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def profile_trace(logdir: str = "trace"):
    """Trace the enclosed block with ``torch.profiler`` and write it to
    ``logdir/trace_<pid>_<ns>.json`` (Chrome trace format) on exit, also
    when the block raises; yields ``logdir``.  An error of the profiler
    itself propagates."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield logdir
    finally:
        prof.stop()
        path = os.path.join(logdir,
                            f"trace_{os.getpid()}_{time.time_ns()}.json")
        prof.export_chrome_trace(path)
        log("profile_trace_written", logdir=logdir, path=path)


@dataclass
class FrameStats:
    """Accumulates step statistics; logs one ``frame`` JSON line each."""

    width: int
    height: int
    spp: int = 1
    frames: int = 0
    total_ms: float = 0.0
    _t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        ms = (time.perf_counter() - self._t0) * 1e3
        self.frames += 1
        self.total_ms += ms
        rays = self.width * self.height * self.spp
        log("frame", frame=self.frames, ms=round(ms, 3),
            mrays_per_s=round(rays / ms / 1e3, 3))
        return False

    @property
    def mean_ms(self) -> float:
        return self.total_ms / max(self.frames, 1)
