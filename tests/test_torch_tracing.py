"""``tracing.py`` of the port against the JAX package's, on the CPU.

* ``FrameStats``: one list of step times (``time.perf_counter`` patched
  in each module) gives both classes the same ``frames``, ``total_ms``
  and ``mean_ms``, and the same ``frame`` lines.
* ``profile_trace`` writes a Chrome trace into its directory that names
  the frame's ops, logs ``profile_trace_written``, writes the trace when
  the block raises and lets the error through; ``--profile-dir`` traces
  the CLI's training loop.
* ``span``: the shared null context and no record-function op without a
  profiler; under one, the port's ``rt.*`` spans nest as its layers do
  (a frame's prep, casts and shading; a bounce world's queue and early
  exits a round; a step's frame and backward; a glass world's shadow
  march, its casts and early exits, also under grad), and the frame's
  pixels and the step's gradients are bit for bit those of an untraced
  run.
* the march's readers (``rtbench/metrics/march_*.frame.py``) on a
  synthetic stretch: ``march_fused.frame`` 100 where every march holds an
  ``rt.march_fused`` span, 0 where none does, None where none opens.
* ``cli -b`` reports the median of its repeats, with their minimum and
  95th percentile beside it.
"""

import dataclasses
import json
import os
import types

import pytest
import torch

from raytracer_tpu import tracing as jtracing

import raytracer_tpu_torch as rtt
from raytracer_tpu_torch import cli, diff, tracing, tree
from raytracer_tpu_torch import raymath as rm
from raytracer_tpu_torch.builder import scale_camera
from raytracer_tpu_torch.render.engine import (_frame_rays_blocked,
                                               make_cast, render_frame,
                                               render_frame_with_stats)
from raytracer_tpu_torch.render.geometry import expand_geometry
from raytracer_tpu_torch.render.shading import march_transmissive
from rtbench import spec
from rtbench import trace as rtrace

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TERRAIN8 = os.path.join(REPO, "raytracer_tpu_torch", "worlds",
                        "terrain8.json")
STRESS = os.path.join(REPO, "raytracer_tpu_torch", "worlds",
                      "terrain8_stress.json")
MIXED = os.path.join(REPO, "raytracer_tpu_torch", "worlds",
                     "terrain8_mixed.json")


class _Clock:
    """``perf_counter`` stand-in: enter and exit times in turn."""

    def __init__(self, stamps):
        self._stamps = iter(stamps)

    def __call__(self):
        return next(self._stamps)


def _frame_lines(err):
    return [{k: v for k, v in json.loads(line).items() if k != "t"}
            for line in err.splitlines() if '"frame"' in line]


@pytest.mark.parametrize("seconds", [[0.5, 12.25, 3.0], [], [1e-3] * 7])
def test_frame_stats_total_and_mean_match_jax(monkeypatch, capsys,
                                              seconds):
    stamps = []
    t = 100.0
    for s in seconds:
        stamps += [t, t + s]
        t += s + 1.0
    stats = {}
    lines = {}
    for name, mod in (("jax", jtracing), ("port", tracing)):
        monkeypatch.setattr(mod.time, "perf_counter", _Clock(stamps))
        st = mod.FrameStats(width=64, height=48, spp=2)
        for _ in seconds:
            with st:
                pass
        stats[name] = (st.frames, st.total_ms, st.mean_ms)
        lines[name] = _frame_lines(capsys.readouterr().err)
        monkeypatch.undo()
    assert stats["port"] == stats["jax"]
    assert lines["port"] == lines["jax"]
    assert stats["port"][0] == len(seconds)
    assert stats["port"][1] == pytest.approx(1e3 * sum(seconds))


def _world(path, width=32, height=24):
    w = rtt.generate(path)
    scene = rtt.to_device(w.scene, "cpu")
    cam = rtt.to_device(scale_camera(w.camera, width, w.config.width), "cpu")
    return scene, cam, w.config.replace(width=width, height=height,
                                        engine="cuda")


@pytest.fixture(scope="module")
def small():
    return _world(TERRAIN8)


@pytest.fixture(scope="module")
def stress():
    return _world(STRESS)


@pytest.fixture(scope="module")
def mixed():
    return _world(MIXED)


@pytest.fixture(scope="module")
def mixed16():
    return _world(MIXED, 16, 12)


def _trace_names(logdir):
    files = os.listdir(logdir)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(os.path.join(logdir, files[0])) as fh:
        return {e.get("name") for e in json.load(fh)["traceEvents"]}


def test_profile_trace_writes_a_trace_of_the_frame(small, tmp_path,
                                                   capsys):
    scene, cam, cfg = small
    logdir = str(tmp_path / "trace")
    with tracing.profile_trace(logdir) as got:
        img = render_frame(scene, cam, cfg)
    assert got == logdir and img.shape == (24, 32, 4)
    names = _trace_names(logdir)
    assert {"aten::where", "aten::index", "aten::minimum"} <= names
    err = capsys.readouterr().err
    rec = [json.loads(line) for line in err.splitlines()
           if '"profile_trace_written"' in line]
    assert len(rec) == 1 and rec[0]["logdir"] == logdir


def test_profile_trace_writes_and_raises_on_error(tmp_path):
    logdir = str(tmp_path / "trace")
    with pytest.raises(ZeroDivisionError):
        with tracing.profile_trace(logdir):
            torch.ones(3) / 1
            1 / 0
    assert "aten::div" in _trace_names(logdir)


def test_cli_profile_dir_traces_the_training_loop(tmp_path, capsys):
    logdir = str(tmp_path / "prof")
    assert cli.main(["-c", TERRAIN8, "--width", "24", "--height", "16",
                     "--device", "cpu", "--train", "1", "--checkpoint",
                     str(tmp_path / "ck.npz"), "--profile-dir",
                     logdir]) == 0
    names = _trace_names(logdir)
    assert "aten::index_add_" in names  # the material rows' backward
    assert '"profile_trace_written"' in capsys.readouterr().err


def _refuse(*_a, **_k):
    raise AssertionError("a span called the profiler with no profiler on")


def test_span_is_the_shared_null_context_without_a_profiler(small,
                                                            monkeypatch):
    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new",
                        _refuse)
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    a, b = tracing.span("rt.frame"), tracing.span("rt.cast")
    assert a is b
    with a:
        pass
    # a whole frame, every span of it, calls neither
    img, stats = render_frame_with_stats(*small)
    assert img.shape == (24, 32, 4) and int(stats["dropped"]) == 0


def _traced(fn):
    """``fn()``'s result and its ``rt.*`` spans ``(name, start, end,
    thread)`` under ``torch.profiler`` (host activity).  Read from the
    profiler's raw events: ``prof.events()`` builds a tree of the plain
    walks' million ops first, which takes minutes here."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
                  e.start_thread_id())
                 for e in prof.profiler.kineto_results.events()
                 if e.name().startswith("rt.")]


def _named(spans, name):
    return [s for s in spans if s[0] == name]


def _inside(inner, outer):
    return (inner[3] == outer[3] and outer[1] <= inner[1]
            and inner[2] <= outer[2])


def test_a_frame_is_one_span_holding_prep_casts_and_shading(small):
    scene, cam, cfg = small
    (img, _), spans = _traced(lambda: render_frame_with_stats(scene, cam,
                                                              cfg))
    (frame,) = _named(spans, "rt.frame")
    (prep,) = _named(spans, "rt.prep")
    # terrain8 is opaque: one round, its closest hit and the fused shadow
    # query (K2's occlude2), no child queue and no early exit
    assert len(_named(spans, "rt.cast")) == 2
    assert len(_named(spans, "rt.shade")) == 1
    assert not _named(spans, "rt.queue") and not _named(spans, "rt.sync")
    assert all(_inside(s, frame) for s in spans if s is not frame)
    # the shadow query is cast from inside shading; prep precedes both
    (shade,) = _named(spans, "rt.shade")
    first, second = sorted(_named(spans, "rt.cast"), key=lambda s: s[1])
    assert not _inside(first, shade) and _inside(second, shade)
    assert prep[2] <= first[1]
    untraced, _ = render_frame_with_stats(scene, cam, cfg)
    assert torch.equal(img, untraced)


def test_a_bounce_frame_adds_the_queue_and_an_early_exit_a_round(stress):
    scene, cam, cfg = stress
    depth = cfg.recurse_depth
    assert depth == 2 and cfg.early_exit and cfg.any_reflective
    (img, stats), spans = _traced(lambda: render_frame_with_stats(
        scene, cam, cfg))
    (frame,) = _named(spans, "rt.frame")
    assert all(_inside(s, frame) for s in spans if s is not frame)
    # one early-exit read before each round after the primary one
    syncs = _named(spans, "rt.sync")
    assert len(syncs) == depth
    shades = sorted(_named(spans, "rt.shade"), key=lambda s: s[1])
    assert len(shades) == depth + 1
    assert all(shades[r][2] <= syncs[r][1] <= shades[r + 1][1]
               for r in range(depth))
    # after each round's shading: its children spawned (all rounds but the
    # last), and the round added into the frame (all after the primary)
    # with the next queue parked, before the next round's early exit
    queues = _named(spans, "rt.queue")
    ends = [s[1] for s in syncs] + [frame[2]]
    per_round = [sum(shades[r][2] <= q[1] and q[2] <= ends[r]
                     for q in queues) for r in range(depth + 1)]
    assert per_round == [2] * depth + [1] and len(queues) == 2 * depth + 1
    untraced, _ = render_frame_with_stats(scene, cam, cfg)
    assert torch.equal(img, untraced) and int(stats["dropped"]) == 0


@pytest.mark.parametrize("name", ["small", "stress"])
def test_no_march_opens_in_an_opaque_or_mirror_world(name, request):
    scene, cam, cfg = request.getfixturevalue(name)
    assert not cfg.any_refractive
    _, spans = _traced(lambda: render_frame_with_stats(scene, cam, cfg))
    assert _named(spans, "rt.shade") and not _named(spans, "rt.march")


def test_a_glass_frame_marches_in_one_span_a_light_and_round(mixed):
    """Each round's shading marches once a light, inside its ``rt.shade``;
    on CPU rays each march is the loop of torch ops (the fused kernel's
    path, marked by an ``rt.march_fused`` span, is the card's): it holds
    its closest-hit casts, at most ``shadow_steps``, and before each an
    early exit, one more where no shadow ray walked on."""
    scene, cam, cfg = mixed
    assert cfg.any_refractive and cfg.any_reflective and cfg.early_exit
    (img, stats), spans = _traced(lambda: render_frame_with_stats(
        scene, cam, cfg))
    lights = scene.lights.point_pos.shape[0] + scene.lights.dir_dir.shape[0]
    shades = _named(spans, "rt.shade")
    marches = _named(spans, "rt.march")
    assert len(shades) == cfg.recurse_depth + 1 and lights == 2
    assert len(marches) == lights * len(shades)
    assert all(sum(_inside(m, s) for s in shades) == 1 for m in marches)
    assert not _named(spans, "rt.march_fused")
    casts, syncs = _named(spans, "rt.cast"), _named(spans, "rt.sync")
    steps = []
    for m in marches:
        mc = [c for c in casts if _inside(c, m)]
        ms = [y for y in syncs if _inside(y, m)]
        assert 1 <= len(mc) <= cfg.shadow_steps
        assert len(ms) - len(mc) in (0, 1)
        steps.append(len(mc))
    # the round's own cast is outside the march; the walk's steps are not
    assert len(casts) == len(shades) + sum(steps)
    assert max(steps) >= 2  # some shadow ray went through glass
    untraced, _ = render_frame_with_stats(scene, cam, cfg)
    assert torch.equal(img, untraced) and int(stats["dropped"]) == 0


def test_a_glass_march_under_grad_steps_in_torch_ops(mixed16):
    """With ``kt`` requiring grad each light's march is the loop of torch
    ops (on the card too): it holds its closest-hit casts, at most
    ``shadow_steps``, and before each an early exit, one more where no
    shadow ray walked on; no ``rt.march_fused`` opens, and the light is
    the one of the march without grad."""
    scene, cam, cfg = mixed16
    geom = expand_geometry(scene)
    cast = make_cast(scene, geom, cfg)
    ro, rd, _, _ = _frame_rays_blocked(cam, cfg)
    hit = cast(ro, rd)
    pos = ro + torch.where(hit.valid, hit.t, 1.0)[:, None] * rd
    disp = scene.lights.point_pos[0] - pos
    kt = scene.materials.kt.clone().requires_grad_(True)
    graded = dataclasses.replace(scene, materials=dataclasses.replace(
        scene.materials, kt=kt))
    lights = [(rm.normalize(disp), rm.norm(disp), scene.lights.point_col[0]),
              (rm.normalize(-scene.lights.dir_dir[0]), float("inf"),
               scene.lights.dir_col[0])]
    steps = []
    for dir_unit, max_t, col in lights:
        args = (geom, cast, cfg, pos, dir_unit, max_t, col, hit.valid)
        rv, spans = _traced(lambda: march_transmissive(graded, *args))
        (march,) = _named(spans, "rt.march")
        assert not _named(spans, "rt.march_fused")
        casts, syncs = _named(spans, "rt.cast"), _named(spans, "rt.sync")
        assert all(_inside(c, march) for c in casts + syncs)
        assert 1 <= len(casts) <= cfg.shadow_steps
        assert len(syncs) - len(casts) in (0, 1)
        steps.append(len(casts))
        assert rv.requires_grad
        assert torch.equal(rv.detach(), march_transmissive(scene, *args))
    assert max(steps) >= 2  # some shadow ray went through glass


def _march_stretch():
    """Two items in [0, 1000] us.  Main thread: shading 100-400 holding a
    march 110-300 with two casts (120-150, 200-230) and an early exit
    (160-170); a round's cast 320-350 outside the march; a second march
    500-600 with one cast 510-540.  Autograd's thread: a cast 130-140
    during the first march, not the march's."""
    main, other = 1, 7
    rt = [(100, 400, "rt.shade", main), (110, 300, "rt.march", main),
          (120, 150, "rt.cast", main), (160, 170, "rt.sync", main),
          (200, 230, "rt.cast", main), (320, 350, "rt.cast", main),
          (500, 600, "rt.march", main), (510, 540, "rt.cast", main),
          (130, 140, "rt.cast", other)]
    calls = [(125, 126, "cudaLaunchKernel", main),
             (180, 181, "cudaLaunchKernel", main),
             (135, 136, "cudaLaunchKernel", other),
             (330, 331, "cudaLaunchKernel", main),
             (550, 551, "cudaMemsetAsync", main)]
    host = [(float(a), float(b), n, t) for a, b, n, t in rt + calls]
    return rtrace.Stretch(start=0.0, end=1000.0, items=2, ops=[], host=host)


def test_the_march_readers_on_a_synthetic_stretch():
    st = _march_stretch()

    def read(name):
        return spec.metric_reader(name).read(st)

    # three casts open inside a march on its thread, over two items
    assert read("march_steps.frame") == pytest.approx(3 / 2)
    # self time: 190 - (30 + 10 + 30) and 100 - 30, us, over two items
    assert read("march_ms.frame") == pytest.approx((120 + 70) * 1e-3 / 2)
    # launch calls inside a march, on any thread
    assert read("march_launches.frame") == pytest.approx(4 / 2)
    # shading's self time no longer holds the march's glue
    assert read("shade_ms.frame") == pytest.approx((300 - 190 - 30) * 1e-3
                                                   / 2)
    # neither march took the fused kernel
    assert read("march_fused.frame") == 0.0
    st.host = [h for h in st.host if h[2] != "rt.march"]
    for name in ("march_steps.frame", "march_ms.frame",
                 "march_launches.frame", "march_fused.frame"):
        assert read(name) is None


@pytest.mark.parametrize("fused, share", [
    ([(120, 280, 1), (510, 590, 1)], 100.0),  # both marches fused
    ([(120, 280, 1)], 50.0),
    ([(120, 280, 7), (610, 700, 1)], 0.0),  # another thread; no march's
])
def test_the_fused_march_reader_on_a_synthetic_stretch(fused, share):
    st = _march_stretch()
    st.host += [(float(a), float(b), "rt.march_fused", t)
                for a, b, t in fused]
    read = spec.metric_reader("march_fused.frame").read
    assert read(st) == pytest.approx(share)
    st.host = [h for h in st.host if h[2] != "rt.march"]
    assert read(st) is None


def test_a_step_is_one_span_holding_its_frame_and_backward(small):
    scene, cam, cfg = small
    cfg = cfg.replace(early_exit=False)
    target = torch.zeros(cfg.height, cfg.width, 4)

    def step():
        params = diff.trainable_params(scene, cam)
        return diff.train_step(scene, cam, cfg, target, params, lr=1e-2)

    (loss, grads, _), spans = _traced(step)
    (st,) = _named(spans, "rt.step")
    (frame,) = _named(spans, "rt.frame")
    (bwd,) = _named(spans, "rt.backward")
    assert _inside(frame, st) and _inside(bwd, st)
    assert frame[2] <= bwd[1]
    loss0, grads0, _ = step()
    assert torch.equal(loss, loss0)
    for g, g0 in zip(tree.leaves(grads), tree.leaves(grads0)):
        assert torch.equal(g, g0)


def test_cli_bench_reports_the_median_min_and_p95(tmp_path, monkeypatch,
                                                  capsys):
    ms = [4.0, 1.0, 3.0, 10.0, 2.0]
    stamps = []
    for t0, dt in zip(range(0, 100, 20), ms):
        stamps += [float(t0), t0 + dt * 1e-3]
    monkeypatch.setattr(cli, "time",
                        types.SimpleNamespace(perf_counter=_Clock(stamps)))
    assert cli.main(["-c", TERRAIN8, "--width", "16", "--height", "16",
                     "--device", "cpu", "-b", "--repeats", "5"]) == 0
    out = capsys.readouterr().out.splitlines()
    rec = json.loads(out[-1])
    assert rec["repeats"] == 5
    assert rec["value"] == pytest.approx(3.0)  # the median
    assert rec["min_ms"] == pytest.approx(1.0)
    # numpy's linear 95th percentile: 4 + 0.8 * (10 - 4)
    assert rec["p95_ms"] == pytest.approx(8.8)
    assert out[-2] == "Time: 3.000 ms"
    assert rec["primary_mrays_per_s"] == pytest.approx(16 * 16 / 3.0 / 1e3)
