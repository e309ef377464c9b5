"""The engine's ``Cast``: which queries each kind of cast has.

``engine.make_cast`` picks the LBVH walk, the candidate-list cull or the
MXU cast, each over its kernels (``engine="cuda"``) or their plain versions
(``"torch"``), and returns a :class:`Cast`: ``closest`` and ``occlude``
always; ``occlude2`` on the walk (K2) and the cull (two K5 queries);
``visit_counts`` on the walk; ``march`` only on the walk over CUDA tables,
so never here.  Every ``occlude`` answers as the closest-hit stand-in
(``occlude_by_closest``) does: a hit within ``max_t``.

terrain6 (204 instances) at 16x12, its primary hits' shadow rays to the
point light (``max_t [R]``) and along the directional one (+inf); misses
park at 1e30.
"""

import os

import pytest
import torch

import raytracer_tpu_torch as rtt
from raytracer_tpu_torch.builder import scale_camera
from raytracer_tpu_torch.render.cast import Cast, occlude_by_closest
from raytracer_tpu_torch.render.engine import _frame_rays_blocked, make_cast
from raytracer_tpu_torch.render.geometry import expand_geometry
from raytracer_tpu_torch.render.shading import shadow_rays

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = os.path.join(REPO, "raytracer_tpu_torch", "worlds", "terrain6.json")

# path -> (cfg fields, the optional queries its cast has)
PATHS = {
    "walk": (dict(pallas_traversal="bvh"), {"occlude2", "visit_counts"}),
    "cull": (dict(pallas_traversal="cull"), {"occlude2"}),
    "mxu": (dict(pallas_kernel="mxu"), set()),
}


@pytest.fixture(scope="module")
def world():
    w = rtt.generate(WORLD)
    scene = rtt.to_device(w.scene, "cpu")
    cam = rtt.to_device(scale_camera(w.camera, 16, w.config.width), "cpu")
    cfg = w.config.replace(width=16, height=12)
    return dict(scene=scene, cam=cam, cfg=cfg, geom=expand_geometry(scene))


@pytest.mark.parametrize("engine", ["torch", "cuda"])
@pytest.mark.parametrize("path", sorted(PATHS))
def test_cast_has_its_queries_and_occlude_is_a_closest_hit(world, path,
                                                            engine):
    fields, optional = PATHS[path]
    scene, geom = world["scene"], world["geom"]
    cfg = world["cfg"].replace(engine=engine, **fields)
    cast = make_cast(scene, geom, cfg)
    assert isinstance(cast, Cast)
    have = {"occlude2": cast.occlude2, "march": cast.march,
            "visit_counts": cast.visit_counts}
    assert {name for name, fn in have.items() if fn is not None} == optional
    ro, rd, _, _ = _frame_rays_blocked(world["cam"], cfg)
    with torch.no_grad():
        hit = cast(ro, rd)
        pos = ro + torch.where(hit.valid, hit.t, 1.0)[:, None] * rd
        o1, d1, dist, o2, d2 = shadow_rays(scene, pos, hit.valid)
        stand_in = occlude_by_closest(cast.closest)
        blocked = []
        for o, d, max_t in ((o1, d1, dist), (o2, d2.contiguous(),
                                             float("inf"))):
            got = cast.occlude(o, d, max_t)
            assert got.dtype == torch.bool and got.shape == hit.valid.shape
            assert torch.equal(got, stand_in(o, d, max_t))
            blocked.append(int((got & hit.valid).sum()))
    assert bool(hit.valid.any()) and sum(blocked) > 0
