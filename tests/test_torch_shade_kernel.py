"""A wavefront round's shading kernels (``fused_shading.shade_rays`` /
``shade_phong``) against the torch path of ``engine.process_round``, on
the card.

Marked ``gpu``: each test skips (with a reason) when
``torch.cuda.is_available()`` is false, decided inside a fixture, never at
import.  Run on a GPU machine with::

    python -m pytest --noconftest tests/test_torch_shade_kernel.py -q -m gpu

In the three shadow modes -- K2's fused pair (terrain8, and terrain8_stress
over its three rounds), one K3 query a light (terrain8_lights3) and each
light's fused march (terrain8_mixed: refracted rays inside glass among the
later rounds) -- every round's contribution and children through the
kernels agree with the torch path's on the same queue within 4 float32
steps: the kernels repeat the torch ops one by one (``-fmad=false``), and
only ``powf`` may round otherwise than torch's ``pow`` in its last place
(the specular term, ``Kt^t`` inside a medium); the children's origins, the
flags and the pixels are equal.  The RGBA8 frames at 640x480 equal the
torch path's, and the kernels launch once each a round.  Traced, each
``rt.shade`` holds one ``rt.shade_fused`` and ``shade_fused.frame`` reads
100; a training step (its inputs require grad) takes the torch path.
"""

import os

import pytest
import torch

import raytracer_tpu_torch as rtt
from raytracer_tpu_torch import diff
from raytracer_tpu_torch.builder import scale_camera
from raytracer_tpu_torch.probe_kernels import float32_steps
from raytracer_tpu_torch.render import engine, fused_shading
from rtbench import spec
from rtbench.trace import Stretch

pytestmark = pytest.mark.gpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ULPS = 4
WORLDS = ("terrain8", "terrain8_stress", "terrain8_lights3", "terrain8_mixed")


@pytest.fixture(scope="module", params=WORLDS)
def world(request):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    dev = torch.device("cuda", 0)
    w = rtt.generate(os.path.join(REPO, "raytracer_tpu_torch", "worlds",
                                  request.param + ".json"))
    scene = rtt.to_device(w.scene, dev)
    cfg = w.config.replace(engine="cuda", width=640, height=480)
    cam = rtt.to_device(scale_camera(w.camera, 640, w.config.width), dev)
    return dict(name=request.param, scene=scene, cfg=cfg, cam=cam)


def _torch_path(monkeypatch):
    monkeypatch.setattr(fused_shading, "eligible", lambda *args: False)


def _counts():
    fs = fused_shading
    return fs.shade_rays.launches, fs.shade_phong.launches


def test_rounds_match_the_torch_path(world, monkeypatch):
    """Each round's queue, shaded through the kernels and through the torch
    ops: contributions and children's attenuation within ``ULPS`` float32
    steps, everything else equal."""
    scene, cfg = world["scene"], world["cfg"]
    geom, aux = engine.prepared(scene, cfg)
    cast = engine.make_cast(scene, geom, cfg, aux=aux)
    ro, rd, _, _ = engine._frame_rays_blocked(world["cam"], cfg)
    waves = []
    with torch.no_grad():
        engine.radiance(scene, geom, cast, cfg, ro, rd,
                        on_round=lambda r, st: waves.append(st))
    depth = cfg.recurse_depth if (cfg.any_reflective
                                  or cfg.any_refractive) else 0
    assert len(waves) == depth + 1
    inside = 0
    for r, st in enumerate(waves):
        spawn = r < depth
        n = _counts()
        with torch.no_grad():
            fused, kids = engine.process_round(scene, geom, cast, cfg, st,
                                               spawn)
        assert _counts() == (n[0] + 1, n[1] + 1)
        with monkeypatch.context() as m:
            _torch_path(m)
            with torch.no_grad():
                plain, kids_p = engine.process_round(scene, geom, cast, cfg,
                                                     st, spawn)
        assert _counts() == (n[0] + 1, n[1] + 1)
        torch.cuda.synchronize()
        assert float32_steps(fused, plain) <= ULPS, r
        assert float(plain.abs().max()) > 0.0
        if spawn:
            assert float32_steps(kids.atten, kids_p.atten) <= ULPS, r
            for name in ("o", "d", "in_obj", "active", "pixel"):
                assert torch.equal(getattr(kids, name),
                                   getattr(kids_p, name)), (r, name)
        inside += int((st.active & st.in_obj).sum())
    assert (inside > 0) == (world["name"] == "terrain8_mixed")


def test_frames_equal_the_torch_path(world, monkeypatch):
    """The RGBA8 frame through the kernels equals the torch path's; the
    kernels launch once each a round."""
    scene, cam, cfg = world["scene"], world["cam"], world["cfg"]
    rounds = []
    plain_round = engine.process_round

    def counted(*args, **kw):
        rounds.append(1)
        return plain_round(*args, **kw)

    monkeypatch.setattr(engine, "process_round", counted)
    n = _counts()
    img, stats = engine.render_frame_with_stats(scene, cam, cfg)
    fused = engine.frame_to_u8(img)
    torch.cuda.synchronize()
    k = len(rounds)
    assert k >= 1 and int(stats["dropped"]) == 0
    assert _counts() == (n[0] + k, n[1] + k)
    _torch_path(monkeypatch)
    plain = engine.frame_to_u8(engine.render_frame(scene, cam, cfg))
    assert len(rounds) == 2 * k and _counts() == (n[0] + k, n[1] + k)
    assert torch.equal(fused, plain)


def test_a_traced_frame_marks_each_fused_round(world):
    """Each ``rt.shade`` span holds one ``rt.shade_fused``, and the reader
    of ``shade_fused.frame`` finds it: 100."""
    scene, cam, cfg = world["scene"], world["cam"], world["cfg"]
    engine.render_frame(scene, cam, cfg)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        engine.render_frame(scene, cam, cfg)
        torch.cuda.synchronize()
    host = [(e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3,
             e.name(), e.start_thread_id())
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith("rt.")]

    def named(name):
        return [h for h in host if h[2] == name]

    def inside(a, b):
        return a[3] == b[3] and b[0] <= a[0] and a[1] <= b[1]

    shades, fused = named("rt.shade"), named("rt.shade_fused")
    assert shades and len(fused) == len(shades)
    assert all(sum(inside(f, s) for f in fused) == 1 for s in shades)
    st = Stretch(start=min(h[0] for h in host), end=max(h[1] for h in host),
                 items=1, ops=[], host=host)
    assert spec.metric_reader("shade_fused.frame").read(st) == 100.0


def test_a_training_step_takes_the_torch_path(world):
    """Inputs that require grad keep the torch path: no shading kernel
    launches in a loss and its gradient."""
    scene, cam, cfg = world["scene"], world["cam"], world["cfg"]
    cfg = cfg.replace(width=160, height=120)
    target = torch.zeros(cfg.height, cfg.width, 4, device=cam.pos.device)
    params = diff.trainable_params(scene, cam)
    n = _counts()
    loss = diff.make_loss_fn(scene, cam, cfg, target)(params)
    grads = diff.grad_of(loss, params)
    torch.cuda.synchronize()
    assert _counts() == n
    assert bool(torch.isfinite(grads["cam_pos"]).all())
