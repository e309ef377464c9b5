"""The program's own spans in a traced stretch.

The port opens ``torch.profiler.record_function`` spans at its layer
boundaries while a profiler records (``raytracer_tpu_torch.tracing.span``):
``rt.frame``, ``rt.step``, ``rt.prep``, ``rt.cast``, ``rt.shade``,
``rt.queue``, ``rt.sync`` and ``rt.backward``.  They arrive among the host
events of a :class:`rtbench.trace.Stretch`, on the device ops' clock.  A
program without them (an older commit) gives none, and every reader here
then returns None.

* wall time: a span's duration;
* self time: its duration less the part of it that the ``rt.*`` spans
  nested in it on its thread cover;
* launch calls: host events that enqueue device work (the names in
  :data:`LAUNCH_CALLS`) whose start lies inside the span, on any thread
  (the backward's launches come from autograd's device thread).

Every value is a sum over the stretch's spans of one name, per item.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

PREFIX = "rt."
KERNEL_CALLS = ("cudaLaunch", "cuLaunch", "cudaMemsetAsync")
LAUNCH_CALLS = KERNEL_CALLS + ("cudaMemcpyAsync",)

Interval = Tuple[float, float]


def _clip(st, s: float, e: float) -> Interval:
    return max(s, st.start), min(e, st.end)


def spans(st, name: str) -> List[Tuple[float, float, int]]:
    """``(start, end, thread)`` of each ``name`` span in the stretch, cut
    to the stretch."""
    out = []
    for s, e, n, thread in st.host:
        if n == name:
            s, e = _clip(st, s, e)
            if e > s:
                out.append((s, e, thread))
    return out


def _union(intervals: Sequence[Interval]) -> float:
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def _by_thread(st) -> Dict[int, List[Interval]]:
    """Every ``rt.*`` span of the stretch by thread, cut to the stretch."""
    out = defaultdict(list)
    for s, e, n, thread in st.host:
        if n.startswith(PREFIX):
            s, e = _clip(st, s, e)
            if e > s:
                out[thread].append((s, e))
    return out


def wall_ms(st, name: str) -> Optional[float]:
    """The ``name`` spans' wall time, ms an item."""
    found = spans(st, name)
    if not found:
        return None
    return sum(e - s for s, e, _ in found) * 1e-3 / st.items


def self_ms(st, name: str) -> Optional[float]:
    """The ``name`` spans' self time, ms an item."""
    found = spans(st, name)
    if not found:
        return None
    others = _by_thread(st)
    total = 0.0
    for s, e, thread in found:
        inner = [(a, b) for a, b in others[thread]
                 if a >= s and b <= e and (a, b) != (s, e)]
        total += (e - s) - _union(inner)
    return total * 1e-3 / st.items


def launch_calls(st, name: str,
                 calls: Sequence[str] = LAUNCH_CALLS) -> Optional[float]:
    """Host calls that enqueue device work (names starting with one of
    ``calls``) whose start lies inside a ``name`` span, on any thread, an
    item."""
    windows = [(s, e) for s, e, _ in spans(st, name)]
    if not windows:
        return None
    starts = [s for s, _, n, _ in st.host if n.startswith(tuple(calls))]
    return sum(1 for a, b in windows for s in starts
               if a <= s < b) / st.items
