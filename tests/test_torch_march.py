"""The transmissive shadow march's two paths, on the CPU.

``shading.march_transmissive`` takes the cast's own ``march`` (the LBVH
walk's under ``engine="cuda"`` over CUDA tables: one launch of
``cuda_engine.bvh_march``) where it has one and no input of the march
requires grad, else the loop of torch ops (``shading.march_steps``) whose
graph the backward takes:

* the walk's cast over CPU tables has no ``march``: the loop runs, for the
  point light (``max_t [R]``) and the directional one (+inf); inactive
  lanes take the light as it is; a cast given a ``march`` gets the call;
* with ``kt`` requiring grad the loop runs, ``march`` or not, and the
  gradient is the loop's own;
* the plain engine's, the candidate-list cull's and the MXU's casts have
  no ``march``; ``bvh_march`` launches or raises.

terrain8_mixed at 16x12, its primary hits' shadow rays.  The kernel's path
is held to the loop on the card (``tests/test_torch_march_kernel.py``).
"""

import dataclasses
import os

import pytest
import torch

import raytracer_tpu_torch as rtt
from raytracer_tpu_torch import raymath as rm
from raytracer_tpu_torch.builder import scale_camera
from raytracer_tpu_torch.render import cuda_engine as ce
from raytracer_tpu_torch.render.engine import _frame_rays_blocked, make_cast
from raytracer_tpu_torch.render.geometry import expand_geometry
from raytracer_tpu_torch.render.shading import (march_steps,
                                                march_transmissive)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MIXED = os.path.join(REPO, "raytracer_tpu_torch", "worlds",
                     "terrain8_mixed.json")


@pytest.fixture(scope="module")
def mixed():
    w = rtt.generate(MIXED)
    scene = rtt.to_device(w.scene, "cpu")
    cam = rtt.to_device(scale_camera(w.camera, 16, w.config.width), "cpu")
    cfg = w.config.replace(width=16, height=12, engine="cuda")
    geom = expand_geometry(scene)
    ro, rd, _, _ = _frame_rays_blocked(cam, cfg)
    hit = make_cast(scene, geom, cfg)(ro, rd)
    pos = ro + torch.where(hit.valid, hit.t, 1.0)[:, None] * rd
    disp = scene.lights.point_pos[0] - pos
    lights = {"point": (rm.normalize(disp), rm.norm(disp),
                        scene.lights.point_col[0]),
              "directional": (rm.normalize(-scene.lights.dir_dir[0]),
                              float("inf"), scene.lights.dir_col[0])}
    return dict(scene=scene, cfg=cfg, geom=geom, pos=pos, active=hit.valid,
                lights=lights)


class _Spy:
    """A ``march`` that counts its calls and answers with the loop's light
    (the kernel's stand-in on the CPU)."""

    def __init__(self, cast, geom, mats):
        self.cast, self.geom, self.mats, self.calls = cast, geom, mats, 0

    def __call__(self, origin, dir_unit, max_t, light_col, active, kt,
                 steps):
        self.calls += 1
        return march_steps(self.cast, self.geom, self.mats, origin, dir_unit,
                           max_t, light_col, active, steps, False)


@pytest.mark.parametrize("light", ["point", "directional"])
def test_march_on_cpu_rays_takes_the_torch_loop(mixed, light):
    """The walk's cast over CPU tables has no ``march``: the frame's march
    is the loop.  A cast that has one gets the call, in ``rt.march``."""
    m = mixed
    scene, geom, cfg = m["scene"], m["geom"], m["cfg"]
    cast = make_cast(scene, geom, cfg)
    assert cast.march is None
    dir_unit, max_t, col = m["lights"][light]
    args = (m["pos"], dir_unit, max_t, col, m["active"])
    with torch.no_grad():
        rv = march_transmissive(scene, geom, cast, cfg, *args)
    loop = march_steps(cast, geom, scene.materials, *args,
                       cfg.shadow_steps, cfg.early_exit)
    assert torch.equal(rv, loop)
    inactive = ~m["active"]
    assert bool(inactive.any())
    assert torch.equal(rv[inactive], col.expand(int(inactive.sum()), 4))
    assert bool((rv[m["active"]] != col).any())  # some light was blocked
    spy = _Spy(cast, geom, scene.materials)
    with torch.no_grad():
        fused = march_transmissive(scene, geom, dataclasses.replace(
            cast, march=spy), cfg, *args)
    assert spy.calls == 1 and torch.equal(fused, rv)


def test_march_under_grad_takes_the_torch_loop(mixed):
    """With ``kt`` requiring grad the loop runs though the cast has a
    ``march``, and the gradient is the loop's own."""
    m = mixed
    scene, geom, cfg = m["scene"], m["geom"], m["cfg"]
    cast = make_cast(scene, geom, cfg)
    spy = _Spy(cast, geom, scene.materials)
    dir_unit, max_t, col = m["lights"]["point"]
    args = (m["pos"], dir_unit, max_t, col, m["active"])
    kt = scene.materials.kt.clone().requires_grad_(True)
    graded = dataclasses.replace(scene, materials=dataclasses.replace(
        scene.materials, kt=kt))
    rv = march_transmissive(graded, geom, dataclasses.replace(
        cast, march=spy), cfg, *args)
    assert spy.calls == 0 and rv.requires_grad
    (g,) = torch.autograd.grad(rv.sum(), kt)
    kt0 = scene.materials.kt.clone().requires_grad_(True)
    loop = march_steps(cast, geom, dataclasses.replace(
        scene.materials, kt=kt0), *args, cfg.shadow_steps, cfg.early_exit)
    (g0,) = torch.autograd.grad(loop.sum(), kt0)
    assert torch.equal(rv, loop) and torch.equal(g, g0)
    assert float(g.abs().max()) > 0.0  # some shadow ray left a glass box


@pytest.mark.parametrize("path", [dict(pallas_traversal="cull"),
                                  dict(pallas_kernel="mxu")])
def test_cull_and_mxu_casts_have_no_march(mixed, path):
    for engine in ("cuda", "torch"):
        cfg = mixed["cfg"].replace(engine=engine, **path)
        assert make_cast(mixed["scene"], mixed["geom"], cfg).march is None


@pytest.mark.parametrize("light", ["point", "directional"])
def test_the_plain_engine_has_no_march_and_the_kernel_no_fallback(mixed,
                                                                  light):
    """The plain engine marches in the loop alone; the kernel's
    ``bvh_march`` launches on CUDA tensors or raises: it has no plain
    version inside."""
    m = mixed
    scene, geom, cfg = m["scene"], m["geom"], m["cfg"]
    assert make_cast(scene, geom, cfg.replace(engine="torch")).march is None
    data = ce.prepare_cast(scene, geom, cfg)
    dir_unit, max_t, col = m["lights"][light]
    with pytest.raises(ValueError, match="on CUDA tensors only"):
        ce.bvh_march(m["pos"], dir_unit, max_t, col, m["active"],
                     scene.materials.kt, cfg.shadow_steps, data)
