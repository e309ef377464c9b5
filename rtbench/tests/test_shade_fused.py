"""CPU test of the reader of ``shade_fused.frame`` on a synthetic
stretch: 100 where every ``rt.shade`` span holds an ``rt.shade_fused``
span on its thread, the share where some do, 0 where none does, None
where no ``rt.shade`` opens; a fused span on another thread or outside
the shading round does not count.

Run it with ``python -m pytest rtbench/tests -q``.
"""

import pytest

from rtbench import spec
from rtbench import trace as tr

MAIN, OTHER = 1, 7  # thread ids


def _stretch(fused):
    """Two frames in [0, 1000] us, each with shading rounds on the main
    thread (100-200, 300-400, 600-700, 800-900), and the ``rt.shade_fused``
    spans ``fused`` as ``(start, end, thread)``."""
    shades = [(100, 200), (300, 400), (600, 700), (800, 900)]
    host = [(float(s), float(e), "rt.shade", MAIN) for s, e in shades]
    host += [(150.0, 160.0, "rt.cast", MAIN), (500.0, 990.0, "rt.frame", MAIN)]
    host += [(float(s), float(e), "rt.shade_fused", t) for s, e, t in fused]
    return tr.Stretch(start=0.0, end=1000.0, items=2, ops=[], host=host)


def read(st):
    return spec.metric_reader("shade_fused.frame").read(st)


@pytest.mark.parametrize("fused,want", [
    ([(101, 101.5, MAIN), (301, 301.5, MAIN), (601, 601.5, MAIN),
      (801, 801.5, MAIN)], 100.0),
    ([(101, 101.5, MAIN), (601, 601.5, MAIN)], 50.0),
    ([(301, 301.5, OTHER), (450, 451, MAIN)], 0.0),
    ([], 0.0),
])
def test_share_of_shading_rounds_that_hold_a_fused_span(fused, want):
    assert read(_stretch(fused)) == pytest.approx(want)


def test_no_shading_round_reads_as_nothing():
    st = _stretch([(101, 101.5, MAIN)])
    st.host = [h for h in st.host if h[2] != "rt.shade"]
    assert read(st) is None
