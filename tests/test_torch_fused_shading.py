"""Where a wavefront round shades, on the CPU: the two shading kernels
(``render/fused_shading.py``) or the torch ops of ``engine.process_round``.

The kernels run only on the card, so this file stubs what tells the card
apart (``fused_shading._on_card``) and the launcher (``fused_shading.
_launch``), which records the entry points it is asked for and launches
nothing; the round's cast answers with hits cast once, and the spans
opened are recorded.  Each case that must keep the torch path -- CPU
tensors, an input that requires grad, texture mapping, the edge-aware
band, a hit without a normal (the MXU cast's), a recording mask tape, the
``"torch"`` engine, a glass world on a cast without a fused march -- asks
for no launch and opens no ``rt.shade_fused`` span; the eligible round
asks for ``rt_shade_rays`` then ``rt_shade_phong`` and opens one.  The
kernels' values are held to the torch path's on the card
(``tests/test_torch_shade_kernel.py``).
"""

import dataclasses
import os

import pytest
import torch

import raytracer_tpu_torch as rtt
from raytracer_tpu_torch import tracing
from raytracer_tpu_torch.builder import scale_camera
from raytracer_tpu_torch.render import engine, fused_shading, shading
from raytracer_tpu_torch.render.cast import Cast

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = os.path.join(REPO, "raytracer_tpu_torch", "worlds", "terrain8.json")


@pytest.fixture(scope="module")
def round0():
    """terrain8's scene, a 64-ray primary queue (32x32 frame) and a cast
    that answers with that queue's closest hits, cast once, and no
    blocker: the choice of path is under test, not the queries."""
    w = rtt.generate(WORLD)
    scene = rtt.to_device(w.scene, "cpu")
    cam = rtt.to_device(scale_camera(w.camera, 32, w.config.width), "cpu")
    cfg = w.config.replace(width=32, height=32, engine="cuda")
    geom, aux = engine.prepared(scene, cfg)
    ro, rd, _, _ = engine._frame_rays_blocked(cam, cfg)
    wave = engine.primary_wave(ro[::16].contiguous(), rd[::16].contiguous())
    with torch.no_grad():
        hit = engine.make_cast(scene, geom, cfg, aux=aux)(wave.o, wave.d)
    assert bool(hit.valid.any())
    clear = torch.zeros(64, dtype=torch.bool)
    cast = Cast(closest=lambda o, d: hit, occlude=lambda o, d, mt: clear,
                occlude2=lambda *args: (clear, clear))
    return dict(scene=scene, cfg=cfg, geom=geom, cast=cast, wave=wave)


def _grad_scene(scene):
    kd = scene.materials.kd.clone().requires_grad_(True)
    return dataclasses.replace(
        scene, materials=dataclasses.replace(scene.materials, kd=kd))


# case -> what it changes (False: nothing, and the tensors stay on the CPU)
CASES = {
    "cpu_tensors": False,
    "requires_grad": "grad",
    "texture": "texture",
    "edge_band": "edge",
    "no_normal": "normal",
    "mask_tape": "tape",
    "torch_engine": "engine",
    "glass_without_fused_march": "glass",
    "eligible": None,
}


@pytest.mark.parametrize("case", list(CASES))
def test_the_round_shades_on_the_kernels_only_where_eligible(
        round0, monkeypatch, case):
    change = CASES[case]
    scene, cfg = round0["scene"], round0["cfg"]
    if change == "grad":
        scene = _grad_scene(scene)
    elif change == "texture":
        cfg = cfg.replace(texture_mapping=True)
    elif change == "edge":
        cfg = cfg.replace(edge_aware_grads=True)
    elif change == "engine":
        cfg = cfg.replace(engine="torch")
    elif change == "glass":
        cfg = cfg.replace(any_refractive=True)
    cast = round0["cast"]
    if change == "normal":
        hit = dataclasses.replace(cast.closest(None, None), normal=None)
        cast = dataclasses.replace(cast, closest=lambda o, d: hit)
    if change is not False:
        monkeypatch.setattr(fused_shading, "_on_card", lambda x: True)
    asked, opened = [], []
    monkeypatch.setattr(fused_shading, "_launch",
                        lambda name, device, *args: asked.append(name))

    def span(name):
        opened.append(name)
        return tracing._OFF

    monkeypatch.setattr(engine, "span", span)
    tape = (shading.mask_tape_contexts()[0] if change == "tape"
            else tracing._OFF)
    with tape:
        contrib, _ = engine.process_round(
            scene, round0["geom"], cast, cfg, round0["wave"], False,
            engine.band_table(round0["geom"]))
    assert contrib.shape == (64, 4)
    assert opened.count("rt.shade") == 1
    if change is None:
        assert asked == ["rt_shade_rays", "rt_shade_phong"]
        assert opened.count("rt.shade_fused") == 1
    else:
        assert asked == []
        assert "rt.shade_fused" not in opened
        assert bool(torch.isfinite(contrib).all())
