"""The transmissive shadow march's two paths, on the CPU.

``shading.march_transmissive`` takes the cast's own ``march`` (the LBVH
walk's under ``engine="cuda"``: one launch of ``cuda_engine.bvh_march``)
where the rays are CUDA tensors and no input of the march requires grad,
else the loop of torch ops (``shading.march_steps``) whose graph the
backward takes:

* on CPU rays the loop runs and ``cast.march`` is not called, for the
  point light (``max_t [R]``) and the directional one (+inf); inactive
  lanes take the light as it is;
* with ``kt`` requiring grad the loop runs and the gradient is the loop's
  own;
* only the LBVH walk's cast under ``engine="cuda"`` has a ``march``: not
  the plain engine's, the candidate-list cull's or the MXU's; it launches
  or raises.

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
    """A cast whose ``march`` counts its calls."""

    def __init__(self, cast):
        self.cast, self.calls = cast, 0

    def __call__(self, ro, rd):
        return self.cast(ro, rd)

    def march(self, *args):
        self.calls += 1
        return self.cast.march(*args)


@pytest.mark.parametrize("light", ["point", "directional"])
def test_march_on_cpu_rays_takes_the_torch_loop(mixed, light):
    m = mixed
    scene, geom, cfg = m["scene"], m["geom"], m["cfg"]
    spy = _Spy(make_cast(scene, geom, cfg))
    dir_unit, max_t, col = m["lights"][light]
    args = (m["pos"], dir_unit, max_t, col, m["active"])
    with torch.no_grad():
        rv = march_transmissive(scene, geom, spy, cfg, *args)
    assert spy.calls == 0
    loop = march_steps(spy.cast, geom, scene.materials, *args,
                       cfg.shadow_steps, cfg.early_exit)
    assert torch.equal(rv, loop)
    inactive = ~m["active"]
    assert bool(inactive.any())
    assert torch.equal(rv[inactive], col.expand(int(inactive.sum()), 4))
    assert bool((rv[m["active"]] != col).any())  # some light was blocked


def test_march_under_grad_takes_the_torch_loop(mixed):
    m = mixed
    scene, geom, cfg = m["scene"], m["geom"], m["cfg"]
    spy = _Spy(make_cast(scene, geom, cfg))
    dir_unit, max_t, col = m["lights"]["point"]
    args = (m["pos"], dir_unit, max_t, col, m["active"])
    kt = scene.materials.kt.clone().requires_grad_(True)
    graded = dataclasses.replace(scene, materials=dataclasses.replace(
        scene.materials, kt=kt))
    rv = march_transmissive(graded, geom, spy, cfg, *args)
    assert spy.calls == 0 and rv.requires_grad
    (g,) = torch.autograd.grad(rv.sum(), kt)
    kt0 = scene.materials.kt.clone().requires_grad_(True)
    loop = march_steps(spy.cast, geom, dataclasses.replace(
        scene.materials, kt=kt0), *args, cfg.shadow_steps, cfg.early_exit)
    (g0,) = torch.autograd.grad(loop.sum(), kt0)
    assert torch.equal(rv, loop) and torch.equal(g, g0)
    assert float(g.abs().max()) > 0.0  # some shadow ray left a glass box


@pytest.mark.parametrize("path", [dict(pallas_traversal="cull"),
                                  dict(pallas_kernel="mxu")])
def test_cull_and_mxu_casts_have_no_march(mixed, path):
    cast = make_cast(mixed["scene"], mixed["geom"],
                     mixed["cfg"].replace(**path))
    assert getattr(cast, "march", None) is None
    assert getattr(make_cast(mixed["scene"], mixed["geom"], mixed["cfg"]),
                   "march", None) is not None


@pytest.mark.parametrize("light", ["point", "directional"])
def test_the_plain_engine_has_no_march_and_the_kernel_no_fallback(mixed,
                                                                  light):
    """The plain engine marches in the loop alone; the kernel's ``march``
    launches on CUDA tensors or raises: it has no plain version inside."""
    m = mixed
    scene, geom, cfg = m["scene"], m["geom"], m["cfg"]
    assert getattr(make_cast(scene, geom, cfg.replace(engine="torch")),
                   "march", None) is None
    dir_unit, max_t, col = m["lights"][light]
    with pytest.raises(ValueError, match="on CUDA tensors only"):
        make_cast(scene, geom, cfg).march(m["pos"], dir_unit, max_t, col,
                                          m["active"], scene.materials.kt,
                                          cfg.shadow_steps)
