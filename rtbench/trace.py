"""The traced stretch of a window, read from ``torch.profiler``'s events.

``--trace 1`` profiles a few items of the window (host ops and CUDA
activity, kept in memory; no trace file is written) inside a
``record_function`` span of its own, ``rtbench.traced``.  What the readers
of ``rtbench/metrics`` see is a :class:`Stretch`: the span's wall time, the
device operations in it (kernels, memsets and copies, with their device
times), the host ops, and the work the items asked for.
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

SPAN = "rtbench.traced"

# the port's closest-hit and any-hit kernels, by the names the profiler
# shows: the kernels of ``cast_roofline`` and what ``glue_device_ms``
# leaves out, named once so that the two layers cannot part
QUERY_KERNELS = ("bvh_cast_kernel", "bvh_occlude2_kernel",
                 "bvh_occlude_kernel", "cull_cast_kernel",
                 "cull_occlude_kernel", "mxu_tiles_kernel",
                 "mxu_chunks_kernel", "mxu_resolve_kernel")


@dataclass
class DeviceOp:
    name: str
    start: float  # us
    end: float  # us
    kind: str  # "kernel", "memset" or "memcpy"


@dataclass
class Stretch:
    """One traced stretch: ``items`` frames or steps in ``[start, end]``
    (us, the profiler's clock)."""

    start: float
    end: float
    items: int
    ops: List[DeviceOp]
    host: List[Tuple[float, float, str, int]]  # start, end, name, thread
    least_cast_s: Optional[float] = None  # per item (rtbench.roofline)
    # the run's untraced window before the stretch: its seconds on the
    # host's clock, its items, and the work an item does (a step's rays)
    window_clock_s: Optional[float] = None
    window_items: int = 0
    item_work: Optional[float] = None

    @property
    def window_s(self) -> float:
        return (self.end - self.start) * 1e-6

    def busy_s(self) -> float:
        """The union of the device operations' intervals."""
        busy, cur_s, cur_e = 0.0, None, None
        for op in sorted(self.ops, key=lambda o: o.start):
            if cur_e is None or op.start > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                cur_s, cur_e = op.start, op.end
            else:
                cur_e = max(cur_e, op.end)
        if cur_e is not None:
            busy += cur_e - cur_s
        return busy * 1e-6

    def matching(self, names: Sequence[str]) -> List[DeviceOp]:
        """The device ops whose name holds one of ``names`` as a word."""
        pat = re.compile(r"(?<![A-Za-z0-9_])(" + "|".join(
            re.escape(n) for n in names) + r")(?![A-Za-z0-9_])")
        return [op for op in self.ops if pat.search(op.name)]

    def device_s(self, ops: Sequence[DeviceOp]) -> float:
        return sum(op.end - op.start for op in ops) * 1e-6


def _kind(evt) -> str:
    name = evt.name
    if name.startswith("Memset"):
        return "memset"
    if name.startswith("Memcpy"):
        return "memcpy"
    return "kernel"


def stretch_from(prof, items: int) -> Stretch:
    """The :data:`SPAN` of a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    events = prof.events()
    # a record_function span has a host event and, under CUDA activity, a
    # device-side annotation of the same name: neither is device work
    spans = [e for e in events
             if e.name == SPAN and e.device_type != DeviceType.CUDA]
    if len(spans) != 1:
        raise RuntimeError(f"expected one {SPAN} span, found {len(spans)}")
    start, end = spans[0].time_range.start, spans[0].time_range.end
    ops, host = [], []
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False) or e.name == SPAN:
                continue
            if s >= start and t <= end:
                ops.append(DeviceOp(e.name, s, t, _kind(e)))
        elif e.name != SPAN and t > start and s < end:
            host.append((s, t, e.name, e.thread))
    return Stretch(start=start, end=end, items=items, ops=ops, host=host)


def idle_gaps(st: Stretch) -> List[Tuple[float, float]]:
    """The intervals of the stretch in which no device op ran."""
    gaps, cur = [], st.start
    for op in sorted(st.ops, key=lambda o: o.start):
        if op.start > cur:
            gaps.append((cur, op.start))
        cur = max(cur, op.end)
    if st.end > cur:
        gaps.append((cur, st.end))
    return gaps


def _innermost(host, points: List[float]) -> List[str]:
    """For each point (sorted), the name of the latest-starting host op
    that contains it: what the host was doing then."""
    host = sorted(host)
    starts = [h[0] for h in host]
    out = []
    for p in points:
        i = bisect.bisect_right(starts, p) - 1
        name = "host (no op)"
        # nested ops start later and end earlier: walk back to the first
        # (latest-starting) op still open at p, within a bounded look-back
        for j in range(i, max(-1, i - 4096), -1):
            if host[j][1] > p:
                name = host[j][2]
                break
        out.append(name)
    return out


def _short(name: str, width: int = 120) -> str:
    return name if len(name) <= width else name[:width - 3] + "..."


def breakdown(st: Stretch, top: int = 10) -> dict:
    """The device ops that took most time, and the idle time by what the
    host was doing, summed over the stretch's gaps; seconds."""
    by_op = defaultdict(float)
    for op in st.ops:
        by_op[_short(op.name)] += (op.end - op.start) * 1e-6
    gaps = idle_gaps(st)
    names = _innermost(st.host, [(a + b) / 2 for a, b in gaps])
    by_host = defaultdict(float)
    for (a, b), name in zip(gaps, names):
        by_host[_short(name)] += (b - a) * 1e-6
    return {
        "device_ops": [[n, s] for n, s in sorted(
            by_op.items(), key=lambda kv: -kv[1])[:top]],
        "idle_gaps": [[n, s] for n, s in sorted(
            by_host.items(), key=lambda kv: -kv[1])[:top]],
    }


# ------------------------------------------------ what the metric readers use

def idle_share(st: Stretch) -> Optional[float]:
    """1 - device busy / wall time of the stretch, %."""
    if not st.ops or st.window_s <= 0:
        return None
    return 100.0 * (1.0 - st.busy_s() / st.window_s)


def launches(st: Stretch) -> Optional[float]:
    """Device kernels and memsets an item."""
    n = sum(op.kind != "memcpy" for op in st.ops)
    return n / st.items if n else None


def cast_share(st: Stretch, kernels: Sequence[str]) -> Optional[float]:
    """The least time of an item's ray queries over the device time of the
    kernels that answered them, %; nothing without such a kernel."""
    t = st.device_s(st.matching(kernels)) / st.items
    if t <= 0 or st.least_cast_s is None:
        return None
    return 100.0 * st.least_cast_s / t


def window_rate(st: Stretch) -> Optional[float]:
    """The work done a second in the run's untraced window, / 1e6."""
    if not st.window_items or not st.window_clock_s or st.item_work is None:
        return None
    return st.window_items * st.item_work / st.window_clock_s / 1e6


def glue_ms(st: Stretch, kernels: Sequence[str]) -> Optional[float]:
    """Device ms an item outside the ray-query kernels."""
    if not st.ops:
        return None
    cast = st.device_s(st.matching(kernels))
    return (st.device_s(st.ops) - cast) * 1e3 / st.items
