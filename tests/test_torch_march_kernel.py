"""The transmissive shadow march's kernel (``cuda_engine.bvh_march``)
against its plain version (``shading.march_steps`` over the same cast), on
the card.

Marked ``gpu``: each test skips (with a reason) when
``torch.cuda.is_available()`` is false, decided inside a fixture, never at
import.  Run on a GPU machine with::

    python -m pytest --noconftest tests/test_torch_march_kernel.py -q -m gpu

On terrain8_mixed at the 1080p queue (both lights' marches from the
primary hits, the point light at ``max_t [R]`` and the directional one at
+inf, inactive lanes among them), on lanes that use every one of 1, 2 and
4 steps, and on random shadow rays against opaque blockers and blockers
beyond the light, the kernel's light agrees with the plain loop's within 2
float32 ulps: the walk, the moves and the masks are the loop's own
operations (``-fmad=false``), and only ``powf`` may round otherwise than
torch's ``pow``.  Eight seeded orbit views render RGBA8 frames equal to
the torch loop's, each march one launch.  Traced, each of a frame's
marches holds one ``rt.march_fused`` span and no ``rt.cast``, and
``march_fused.frame`` reads 100.
"""

import math
import os

import numpy as np
import pytest
import torch

import raytracer_tpu_torch as rtt
from raytracer_tpu_torch import raymath as rm
from raytracer_tpu_torch.builder import scale_camera
from raytracer_tpu_torch.camera_motion import orbit_frames, rotate
from raytracer_tpu_torch.probe_kernels import float32_steps
from raytracer_tpu_torch.render import cuda_engine as ce
from raytracer_tpu_torch.render import engine, shading
from raytracer_tpu_torch.render.engine import _frame_rays_blocked
from raytracer_tpu_torch.render.geometry import expand_geometry
from rtbench import spec
from rtbench.trace import Stretch

pytestmark = pytest.mark.gpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MIXED = os.path.join(REPO, "raytracer_tpu_torch", "worlds",
                     "terrain8_mixed.json")
ULPS = 2


@pytest.fixture(scope="module")
def mixed():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    dev = torch.device("cuda", 0)
    w = rtt.generate(MIXED)
    scene = rtt.to_device(w.scene, dev)
    cfg = w.config.replace(engine="cuda", width=1920, height=1080)
    cam = rtt.to_device(scale_camera(w.camera, 1920, w.config.width), dev)
    geom = expand_geometry(scene)
    data = ce.prepare_cast(scene, geom, cfg)
    cast = ce.make_cuda_cast(data, cfg, plain=False)
    ro, rd, _, _ = _frame_rays_blocked(cam, cfg)
    with torch.no_grad():
        hit = cast(ro, rd)
    active = hit.valid
    pos = ro + torch.where(active, hit.t, 1.0)[:, None] * rd
    disp = scene.lights.point_pos[0] - pos
    lights = {
        "point": (rm.normalize(disp), rm.norm(disp),
                  scene.lights.point_col[0]),
        "directional": (rm.normalize(-scene.lights.dir_dir[0]),
                        float("inf"), scene.lights.dir_col[0])}
    return dict(scene=scene, cam=cam, cfg=cfg, geom=geom, data=data,
                cast=cast, pos=pos, active=active, lights=lights)


def _both(m, origin, dir_unit, max_t, light, active, steps):
    """``(kernel, plain)`` light of one march; the kernel launched once."""
    mats = m["scene"].materials
    n = ce.bvh_march.launches
    with torch.no_grad():
        rv_k = m["cast"].march(origin, dir_unit, max_t, light, active,
                               mats.kt, steps)
        rv_p = shading.march_steps(m["cast"], m["geom"], mats, origin,
                                   dir_unit, max_t, light, active, steps,
                                   False)
    torch.cuda.synchronize()
    assert ce.bvh_march.launches == n + 1
    return rv_k, rv_p


@pytest.mark.parametrize("light", ["point", "directional"])
@pytest.mark.parametrize("steps", [1, 2, 4])
def test_march_kernel_matches_plain_at_the_1080p_queue(mixed, light, steps):
    m = mixed
    dir_unit, max_t, col = m["lights"][light]
    active = m["active"]
    assert active.shape[0] >= 1920 * 1080 and not bool(active.all())
    rv_k, rv_p = _both(m, m["pos"], dir_unit, max_t, col, active, steps)
    assert float32_steps(rv_k, rv_p) <= ULPS
    # inactive lanes take the light as it is, and walk nothing
    assert torch.equal(rv_k[~active], col.expand(int((~active).sum()), 4))
    # lanes still marching after the last step: the next step moves them
    more, _ = _both(m, m["pos"], dir_unit, max_t, col, active, steps + 1)
    used_all = (more != rv_k).any(-1)
    assert int(used_all.sum()) > 0
    assert int((rv_k == 0.0).all(-1).sum()) > 0  # opaque blockers


def test_march_kernel_opaque_and_beyond_the_light(mixed):
    """Random shadow rays from the primary hits: each lane's first
    blocker at ``t``; ``max_t`` half of it (the blocker lies beyond the
    light: the light arrives whole) or three times it."""
    m = mixed
    g = torch.Generator(device="cpu").manual_seed(7)
    lanes = torch.nonzero(m["active"]).flatten()
    pick = lanes[torch.randperm(lanes.numel(), generator=g)[:65536].to(
        lanes.device)]
    o = m["pos"][pick]
    d = torch.randn(pick.numel(), 3, generator=g).to(o.device)
    d = rm.normalize(d)
    with torch.no_grad():
        first = m["cast"](o + rm.THRESHOLD * d, d)
    kt = m["scene"].materials.kt[first.mat.long()]
    opaque = first.valid & ~(kt > 0.0).any(-1)
    t = torch.where(first.valid, first.t, 1.0)
    half = torch.arange(pick.numel(), device=o.device) % 2 == 0
    max_t = torch.where(half, 0.5 * t, 3.0 * t)
    col = m["lights"]["point"][2]
    active = torch.ones_like(first.valid)
    rv_k, rv_p = _both(m, o, d, max_t, col, active, 4)
    assert float32_steps(rv_k, rv_p) <= ULPS
    beyond = first.valid & half
    assert int(beyond.sum()) > 0 and int((opaque & ~half).sum()) > 0
    assert torch.equal(rv_k[beyond], col.expand(int(beyond.sum()), 4))
    assert bool((rv_k[opaque & ~half] == 0.0).all())


def test_orbit_frames_equal_the_torch_loop(mixed, monkeypatch):
    """Eight views of a seeded orbit at 1080p: the RGBA8 frame through the
    kernel equals the torch loop's (the path of a march under grad), and
    each march is one launch and no K1 cast."""
    m = mixed
    scene, cfg = m["scene"], m["cfg"]
    rng = np.random.default_rng(2026)
    start = rm.quat_from_axis_angle(
        torch.tensor([0.0, 1.0, 0.0], device=m["cam"].rot.device),
        float(math.radians(rng.uniform(0.0, 360.0))))
    views = list(orbit_frames(rotate(m["cam"], start), 8, 45.0))
    marches = []
    plain_march = shading.march_transmissive

    def counted(*args):
        marches.append(1)
        return plain_march(*args)

    for cam in views:
        monkeypatch.setattr(shading, "march_transmissive", counted)
        n_march, n_k1 = ce.bvh_march.launches, ce.bvh_cast.launches
        marches.clear()
        img, stats = engine.render_frame_with_stats(scene, cam, cfg)
        fused = engine.frame_to_u8(img)
        torch.cuda.synchronize()
        rounds = cfg.recurse_depth + 1
        assert len(marches) == 2 * rounds
        assert ce.bvh_march.launches - n_march == len(marches)
        assert ce.bvh_cast.launches - n_k1 == rounds
        assert int(stats["dropped"]) == 0
        monkeypatch.setattr(shading, "_requires_grad", lambda *xs: True)
        loop = engine.frame_to_u8(engine.render_frame(scene, cam, cfg))
        monkeypatch.undo()
        assert torch.equal(fused, loop)


def test_a_traced_frame_marks_each_fused_march(mixed):
    """The kernel's path opens an ``rt.march_fused`` span in each
    ``rt.march`` (the rounds' casts are the frame's only ``rt.cast``), and
    the reader of ``march_fused.frame`` finds it: 100."""
    scene, cam, cfg = mixed["scene"], mixed["cam"], mixed["cfg"]
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

    marches, fused = named("rt.march"), named("rt.march_fused")
    rounds = cfg.recurse_depth + 1
    assert len(marches) == 2 * rounds and len(fused) == len(marches)
    assert all(sum(inside(f, m) for f in fused) == 1 for m in marches)
    assert not any(inside(c, m) for c in named("rt.cast") for m in marches)
    assert len(named("rt.cast")) == rounds
    st = Stretch(start=min(h[0] for h in host), end=max(h[1] for h in host),
                 items=1, ops=[], host=host)
    assert spec.metric_reader("march_fused.frame").read(st) == 100.0
