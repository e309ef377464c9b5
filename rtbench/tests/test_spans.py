"""CPU tests of the readers of the program's ``rt.*`` spans
(``rtbench/spans.py`` and the metrics that read it) on a synthetic
stretch: self time, wall time, launch calls per span on any thread, the
division by items, nothing where a span never opened, and no import of
JAX by any of them.

Run them with ``python -m pytest rtbench/tests -q``.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from rtbench import spans, spec
from rtbench import trace as tr

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SPAN_METRICS = [m["name"] for m in BENCH["per_layer"]
                if m["source"] == "program_span"]

MAIN, AUTOGRAD = 1, 7  # thread ids


def _stretch():
    """Two items in [0, 1000] us.  Main thread: a frame 100-400 holding
    prep 110-150, a cast 160-200 and shading 200-300 that holds a cast
    220-240 and an early exit 250-260; a step 500-900 holding a frame
    510-600 (prep 520-530 in it) and a backward 600-880.  Autograd's
    thread: a cast 650-700 during the backward (a recompute)."""
    rt = [(100, 400, "rt.frame", MAIN), (110, 150, "rt.prep", MAIN),
          (160, 200, "rt.cast", MAIN), (200, 300, "rt.shade", MAIN),
          (220, 240, "rt.cast", MAIN), (250, 260, "rt.sync", MAIN),
          (500, 900, "rt.step", MAIN), (510, 600, "rt.frame", MAIN),
          (520, 530, "rt.prep", MAIN), (600, 880, "rt.backward", MAIN),
          (650, 700, "rt.cast", AUTOGRAD)]
    calls = [(112, 113, "cudaLaunchKernel", MAIN),
             (120, 121, "cudaMemsetAsync", MAIN),
             (130, 131, "cudaMemcpyAsync", MAIN),
             (165, 166, "cuLaunchKernel", MAIN),
             (225, 226, "cudaLaunchKernelExC", MAIN),
             (522, 523, "cudaLaunchKernel", MAIN),
             (660, 661, "cudaLaunchKernel", AUTOGRAD),
             (610, 611, "cudaLaunchKernel", AUTOGRAD),
             (870, 871, "cudaMemsetAsync", AUTOGRAD),
             (890, 891, "cudaLaunchKernel", MAIN),  # after the backward
             (140, 141, "aten::mul", MAIN)]  # not a launch call
    ops = [tr.DeviceOp("kernel_a", 114, 118, "kernel"),
           tr.DeviceOp("Memset (Device)", 122, 123, "memset")]
    host = [(float(s), float(e), n, t) for s, e, n, t in rt + calls]
    return tr.Stretch(start=0.0, end=1000.0, items=2, ops=ops, host=host)


def test_self_time_takes_out_the_nested_spans_of_its_thread():
    st = _stretch()
    # frames: 300 - (40 + 40 + 100) and 90 - 10, over 2 items, in ms
    assert spans.self_ms(st, "rt.frame") == pytest.approx(
        (120 + 80) * 1e-3 / 2)
    # shading holds a cast and an early exit: 100 - 20 - 10
    assert spans.self_ms(st, "rt.shade") == pytest.approx(70e-3 / 2)
    # casts hold nothing, on either thread: 40 + 20 + 50
    assert spans.self_ms(st, "rt.cast") == pytest.approx(110e-3 / 2)
    assert spans.self_ms(st, "rt.prep") == pytest.approx(50e-3 / 2)
    # the step's frame and backward cover 370 of its 400; the autograd
    # thread's cast is not the main thread's child
    assert spans.self_ms(st, "rt.step") == pytest.approx(30e-3 / 2)
    assert spans.self_ms(st, "rt.backward") == pytest.approx(280e-3 / 2)


def test_wall_time_keeps_the_nested_spans():
    st = _stretch()
    assert spans.wall_ms(st, "rt.backward") == pytest.approx(280e-3 / 2)
    assert spans.wall_ms(st, "rt.frame") == pytest.approx(390e-3 / 2)
    assert spans.wall_ms(st, "rt.sync") == pytest.approx(10e-3 / 2)


def test_launch_calls_count_every_thread_inside_the_span():
    st = _stretch()
    # prep: a kernel, a memset and a copy in the first frame, a kernel in
    # the second; aten ops are not launch calls
    assert spans.launch_calls(st, "rt.prep") == pytest.approx(4 / 2)
    assert spans.launch_calls(st, "rt.prep",
                              spans.KERNEL_CALLS) == pytest.approx(3 / 2)
    # the backward: autograd's thread launches, the main thread waits
    assert spans.launch_calls(st, "rt.backward") == pytest.approx(3 / 2)
    # nested spans count for each span that holds them
    assert spans.launch_calls(st, "rt.cast") == pytest.approx(3 / 2)
    assert spans.launch_calls(st, "rt.step") == pytest.approx(5 / 2)


def test_values_are_per_item():
    one, two = _stretch(), _stretch()
    one.items = 1
    for fn in (spans.self_ms, spans.wall_ms, spans.launch_calls):
        assert fn(one, "rt.frame") == pytest.approx(2 * fn(two, "rt.frame"))


def test_spans_are_cut_to_the_stretch():
    st = _stretch()
    st.start, st.end = 150.0, 1000.0
    # the first frame from 150 on; its prep (110-150) lies outside
    assert spans.wall_ms(st, "rt.frame") == pytest.approx((250 + 90) * 1e-3
                                                          / 2)
    assert spans.launch_calls(st, "rt.prep") == pytest.approx(1 / 2)


def test_the_readers_on_the_synthetic_stretch():
    st = _stretch()

    def read(name):
        return spec.metric_reader(name).read(st)

    assert read("prep_ms.frame") == read("prep_ms.train") == pytest.approx(
        50e-3 / 2)
    assert read("prep_launches.frame") == pytest.approx(2.0)
    assert read("prep_launches.train") == pytest.approx(2.0)
    assert read("cast_host_ms.frame") == pytest.approx(110e-3 / 2)
    assert read("shade_ms.frame") == pytest.approx(70e-3 / 2)
    assert read("sync_wait_ms.frame") == pytest.approx(10e-3 / 2)
    assert read("backward_ms.train") == pytest.approx(280e-3 / 2)
    assert read("backward_launches.train") == pytest.approx(1.5)
    assert read("queue_ms.frame") is None  # no rt.queue span here


def test_no_span_reads_as_nothing():
    """A program without spans (an older commit), or a cell whose items
    never open a span: every span metric is absent from the line, even
    where device ops and launch calls are there."""
    st = _stretch()
    st.host = [h for h in st.host if not h[2].startswith("rt.")]
    assert st.ops and st.host
    assert SPAN_METRICS
    for name in SPAN_METRICS:
        assert spec.metric_reader(name).read(st) is None


IMPORTS = """
import json, sys
from rtbench import spans, spec
for name in %r:
    spec.metric_reader(name)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_no_reader_imports_jax_or_the_program():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", IMPORTS % SPAN_METRICS],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    tops = json.loads(out.stdout.strip().splitlines()[-1])
    for name in ("jax", "jaxlib", "flax", "raytracer_tpu",
                 "raytracer_tpu_torch"):
        assert name not in tops
