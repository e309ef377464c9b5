"""The plain glass reference (``rtbench/reference/glass.py``) and the cell
``terrain8_mixed.frame.1080p`` that it checks, on the CPU.

* the port's frames of the frozen terrain8_mixed world (``"cuda"``, whose
  wrappers run the plain walks here, and ``"torch"``) equal the
  reference's at 64x48 on seeded orbit views that see glass;
* the reference's ``refract`` on closed-form cases: normal and oblique
  incidence with DEVIATIONS.md's sign quirk, total internal reflection,
  and the port's ``raymath.refract`` on the same rays;
* its march through one glass box gives ``Kt^d``, an opaque box blacks the
  light out, a box beyond the light leaves it, and the march stops after
  ``shadow_steps`` steps;
* the world drops no child at ``queue_factor`` 1.0;
* the cell, shrunk to 32x24, runs correct through ``rtbench.run.run_cell``
  and its bfloat16 control fails;
* the reference imports nothing of the program or of JAX.
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from rtbench import control, generate, program, spec
from rtbench.reference import cubes, glass
from rtbench.run import run_cell
from rtbench.world import load as load_world

from raytracer_tpu_torch import raymath
from raytracer_tpu_torch.render.engine import render_frame_with_stats

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
CELL = "terrain8_mixed.frame.1080p"
DOC = spec.load_json(ROOT / "rtbench/configs/terrain8_mixed.json")["world"]
SEEDS = [11, 2**31 + 5, 3_000_000_019]


@pytest.fixture(scope="module")
def world():
    return load_world(DOC)


def _views(world, seed, frame=40):
    return generate.orbit_view(world.cam_pos, world.cam_rot,
                               generate.orbit_start(seed), 2.01, frame)


def _reference(world, pos, rot, w, h, dtype=torch.float32):
    sc = glass.make_scene(world, "cpu", dtype)
    P = glass.world_params(world, "cpu", dtype)
    P["cam_pos"] = torch.as_tensor(pos).to(dtype)
    P["cam_rot"] = torch.as_tensor(rot).to(dtype)
    view = glass.View(float(world.cam_near),
                      float(program.unit_to_pixels(world, w)), w, h)
    return sc, P, view


def test_the_frozen_world_is_the_ports_mixed_world():
    with open(ROOT / "raytracer_tpu_torch/worlds/terrain8_mixed.json") as fh:
        assert json.load(fh) == DOC
    w = load_world(DOC)
    assert w.box_lo.shape[0] == 760 and w.depth == 2
    assert w.any_reflective and w.any_refractive
    # no material both reflects and transmits: a ray spawns one child
    both = (w.materials["kr"] > 0).any(-1) & (w.materials["kt"] > 0).any(-1)
    assert not both.any()


@pytest.mark.parametrize("engine", ["cuda", "torch"])
@pytest.mark.parametrize("seed", SEEDS)
def test_port_frame_equals_the_glass_reference(world, seed, engine):
    w, h = 64, 48
    pos, rot = _views(world, seed)
    sc, P, view = _reference(world, pos, rot, w, h)
    # the view sees glass: primary hits on it, and refracted children
    px = torch.arange(w * h)
    o, d = cubes.camera_rays(P, view, px)
    valid, _, box, _, _ = cubes.closest_hit(sc, o, d)
    kt = P["materials.kt"][sc.mat[box[valid]]]
    assert int((kt > 0).any(-1).sum()) > 50
    want = glass.render_frame(sc, P, view)
    scene, cfg = program.load_world(DOC, "cpu", w, h, 1)
    assert cfg.any_reflective and cfg.any_refractive
    cam = program.camera(pos, rot, world.cam_near,
                         program.unit_to_pixels(world, w), "cpu")
    got, stats = render_frame_with_stats(scene, cam,
                                         cfg.replace(engine=engine))
    assert int(stats["dropped"]) == 0
    assert float(got.sum()) > 0
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_the_reference_sees_the_glass_it_renders(world):
    """Transmission moves the reference's frame (without ``Kt`` the glass
    renders opaque), and refracted or reflected children are cast."""
    w, h = 48, 36
    pos, rot = _views(world, SEEDS[0])
    sc, P, view = _reference(world, pos, rot, w, h)
    base = glass.render_frame(sc, P, view)
    opaque = dict(P, **{"materials.kt": torch.zeros_like(
        P["materials.kt"])})
    assert (glass.render_frame(sc, opaque, view) - base).abs().max() > 0.05
    counts = glass.live_rays(sc, P, view, torch.arange(w * h))
    assert counts[0] == w * h and len(counts) == 3 and counts[1] > 0


# ------------------------------------------------------------------ refract

def _refract(d, n, ratio):
    out, tir = glass.refract(torch.tensor([d], dtype=torch.float64),
                             torch.tensor([n], dtype=torch.float64),
                             torch.tensor([ratio], dtype=torch.float64))
    return out[0].numpy(), bool(tir[0])


def test_refract_at_normal_incidence_keeps_the_quirks_length():
    # cosi = d.n = -1 keeps its sign: ratio d + (-ratio - 1) n
    r = 1 / 0.9
    out, tir = _refract([0.0, -1.0, 0.0], [0.0, 1.0, 0.0], r)
    assert not tir
    np.testing.assert_allclose(out, [0.0, -(2 * r + 1), 0.0], rtol=1e-12)


@pytest.mark.parametrize("deg", [10.0, 30.0, 60.0])
def test_refract_oblique_is_the_upstream_form_not_snells(deg):
    r = 1 / 0.9
    s, c = math.sin(math.radians(deg)), math.cos(math.radians(deg))
    out, tir = _refract([s, -c, 0.0], [0.0, 1.0, 0.0], r)
    root = math.sqrt(1 - r * r * s * s)
    assert not tir
    # the upstream's eta d + (eta cosi - sqrt(1 - sint2)) n, cosi = -c
    np.testing.assert_allclose(out, [r * s, -2 * r * c - root, 0.0],
                               rtol=1e-12, atol=1e-15)
    # Snell's transmitted ray would be (r s, -root, 0)
    assert abs(out[1] + root) > 0.5


def test_refract_total_internal_reflection_mirrors_and_flags():
    r = 1 / 0.9  # sint2 = r^2 sin^2(70 deg) = 1.09
    s, c = math.sin(math.radians(70)), math.cos(math.radians(70))
    out, tir = _refract([2 * s, -2 * c, 0.0], [0.0, 1.0, 0.0], r)
    assert tir
    np.testing.assert_allclose(out, [2 * s, 2 * c, 0.0], rtol=1e-12)
    # leaving glass of eta 0.9 refracts at every angle
    assert not _refract([s, -c, 0.0], [0.0, 1.0, 0.0], 0.9)[1]


def test_refract_equals_the_ports_raymath():
    g = torch.Generator().manual_seed(7)
    d = torch.randn(4096, 3, generator=g)
    n = torch.nn.functional.one_hot(torch.randint(0, 3, (4096,),
                                                  generator=g), 3).float()
    n = n * torch.where(torch.rand(4096, generator=g) < 0.5, 1.0, -1.0)[:,
                                                                       None]
    inside = torch.rand(4096, generator=g) < 0.5
    eta = torch.full((4096,), 0.9)
    one = torch.ones(4096)
    n1, n2 = torch.where(inside, eta, one), torch.where(inside, one, eta)
    want, want_tir = raymath.refract(d, n, n1, n2)
    got, tir = glass.refract(d, n, n1 / n2)
    assert torch.equal(tir, want_tir) and 0 < int(tir.sum()) < 4096
    assert torch.equal(got, want)


# -------------------------------------------------------------------- march

def _slab_scene(boxes, kts):
    """Boxes ``[(lo, hi)]`` on the z axis, each with its own ``Kt``."""
    sc = glass.Scene(lo=torch.tensor([b[0] for b in boxes]),
                     hi=torch.tensor([b[1] for b in boxes]),
                     mat=torch.arange(len(boxes)),
                     ambience=torch.zeros(4), dist_atten=torch.zeros(3),
                     depth=0, reflective=False)
    return sc, {"materials.kt": torch.tensor(kts)}


def _box(z0, z1):
    return ([-1.0, -1.0, z0], [1.0, 1.0, z1])


KT = [0.9, 0.8, 0.7, 1.0]
COL = torch.tensor([1.0, 0.5, 0.25, 1.0])


def _march(sc, P, max_t):
    o = torch.tensor([[0.0, 0.0, -5.0]])
    d = torch.tensor([[0.0, 0.0, 1.0]])
    return glass.march(sc, P, o, d, max_t, COL)[0]


@pytest.mark.parametrize("max_t", [10.0, float("inf")])
def test_march_through_one_glass_box_is_kt_to_its_depth(max_t):
    sc, P = _slab_scene([_box(-1.0, 1.5)], [KT])
    got = _march(sc, P, max_t)
    want = COL * torch.tensor(KT) ** 2.5  # 2.5 units of glass
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)


def test_march_opaque_blocker_and_a_box_beyond_the_light():
    sc, P = _slab_scene([_box(-1.0, 1.0)], [[0.0] * 4])
    assert torch.equal(_march(sc, P, 10.0), torch.zeros(4))
    # the light lies before the box: nothing blocks it
    assert torch.equal(_march(sc, P, 3.0), COL)
    # glass then an opaque box: black
    sc, P = _slab_scene([_box(-1.0, 1.0), _box(2.0, 3.0)], [KT, [0.0] * 4])
    assert torch.equal(_march(sc, P, 10.0), torch.zeros(4))


def test_march_stops_after_its_steps():
    # three glass boxes take six steps; the march takes four, and the ray
    # reaches the light with the first two boxes' attenuation alone
    boxes = [_box(-1.0, 0.0), _box(1.0, 2.0), _box(3.0, 4.0)]
    sc, P = _slab_scene(boxes, [KT] * 3)
    assert glass.SHADOW_STEPS == 4
    torch.testing.assert_close(_march(sc, P, 20.0),
                               COL * torch.tensor(KT) ** 2, rtol=1e-5,
                               atol=0)


# ------------------------------------------------------------ queue and cell

@pytest.mark.parametrize("factor,drops", [(1.0, False), (0.02, True)])
def test_mixed_world_drops_nothing_at_queue_factor_one(world, factor,
                                                       drops):
    w, h = 32, 24
    scene, cfg = program.load_world(DOC, "cpu", w, h, 1)
    assert cfg.queue_factor == 1.0 and cfg.shadow_steps == 4
    pos, rot = _views(world, SEEDS[1])
    cam = program.camera(pos, rot, world.cam_near,
                         program.unit_to_pixels(world, w), "cpu")
    _, stats = render_frame_with_stats(scene, cam,
                                       cfg.replace(queue_factor=factor))
    assert (int(stats["dropped"]) > 0) == drops


def test_the_cell_runs_correct_and_its_bfloat16_control_fails():
    cell = spec.load_cell(CELL)
    assert cell.config["reference"] == "glass" and cell.config["reduced"] == []
    assert cell.reference() is glass
    cell.traffic = dict(cell.traffic, width=32, height=24, check_frames=2,
                        check_pixels=300, warmup_frames=1)
    res, compared = run_cell(cell, 2**31 + 12_345, 0.2, False,
                             torch.device("cpu"))
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert compared["px_off_pct"][0] == 0.0
    limit = cell.limits["limits"]["px_off_pct"]["limit"]
    got = control.control_numbers(cell, 2**31 + 1, torch.device("cpu"))
    assert got["px_off_pct"] > 2 * limit


REFERENCE_ONLY = """
import json, sys
from rtbench import generate, roofline, world
from rtbench.reference import glass
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_the_glass_reference_loads_nothing_of_the_program():
    env = dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", REFERENCE_ONLY], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    tops = json.loads(out.stdout.strip().splitlines()[-1])
    assert "torch" in tops
    for name in ("jax", "jaxlib", "flax", "raytracer_tpu",
                 "raytracer_tpu_torch"):
        assert name not in tops
