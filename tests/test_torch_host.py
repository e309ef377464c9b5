"""Host layer of the PyTorch port against the JAX package, on the CPU.

The same world config (``raytracer_tpu_torch/worlds/terrain8.json``) and the
same seeded numpy inputs go through both packages (through ``convert.py``);
the loaders must agree bit for bit, the LBVH exactly, the kernel tables to
1e-6 (ints exact) and the camera rays to 1e-6."""

import dataclasses
import math
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracer_tpu as jrt
from raytracer_tpu import accel as jaccel
from raytracer_tpu import raymath as jrm
from raytracer_tpu.builder import scale_camera as jscale_camera
from raytracer_tpu.render import geometry as jgeometry
from raytracer_tpu.render import pallas_engine as pe
from raytracer_tpu.scene import device_scene

import raytracer_tpu_torch as rtt
from raytracer_tpu_torch import accel, convert, raymath as rm
from raytracer_tpu_torch.builder import scale_camera
from raytracer_tpu_torch.perlin import Perlin
from raytracer_tpu_torch.render import cuda_engine as ce
from raytracer_tpu_torch.render import geometry

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = os.path.join(REPO, "raytracer_tpu_torch", "worlds", "terrain8.json")
GOLDEN = os.path.join(REPO, "tests", "golden", "terrain_heights.txt")
f32 = np.float32


@pytest.fixture(scope="module")
def worlds():
    jw = jrt.generate(WORLD)
    tw = rtt.generate(WORLD)
    jscene = device_scene(jw.scene)
    jgeom = jgeometry.expand_geometry(jscene)
    scene = convert.scene_from_numpy(jw.scene, device="cpu")
    geom = geometry.expand_geometry(scene)
    return jw, tw, jscene, jgeom, scene, geom


def _leaves(obj, prefix=""):
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            yield from _leaves(v, prefix + f.name + ".")
        else:
            yield prefix + f.name, np.asarray(v)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_generate_matches_jax_loader_bit_exact(worlds):
    jw, tw, *_ = worlds
    jleaves = dict(_leaves(jw.scene))
    tleaves = dict(_leaves(tw.scene))
    assert jleaves.keys() == tleaves.keys()
    for name, jv in jleaves.items():
        tv = tleaves[name]
        assert tv.dtype == jv.dtype, name
        assert tv.shape == jv.shape, name
        assert tv.tobytes() == jv.tobytes(), name
    for name, jv in _leaves(jw.camera):
        assert np.asarray(getattr(tw.camera, name)).tobytes() == jv.tobytes()
    jcfg = dataclasses.asdict(jw.config)
    tcfg = dataclasses.asdict(tw.config)
    jcfg.pop("engine")
    tcfg.pop("engine")
    assert jcfg == tcfg
    # the shape this slice is sized for
    assert tw.scene.inst_pos.shape[0] == 380
    assert tw.scene.wtri_tri.shape[0] == 4560
    assert not tw.config.any_reflective and not tw.config.any_refractive
    assert (tw.scene.lights.point_pos.shape[0],
            tw.scene.lights.dir_dir.shape[0]) == (1, 1)


def _golden_runs():
    runs, cur = [], []
    with open(GOLDEN) as fh:
        for ln in fh:
            cur.append(ln.split())
            if ln.startswith("max_height"):
                runs.append(cur)
                cur = []
    return runs


@pytest.mark.parametrize("run_idx,grid", [(0, 1), (1, 2), (2, 4), (3, 8),
                                          (4, 16)])
def test_terrain_matches_golden(run_idx, grid):
    run = _golden_runs()[run_idx]
    golden, golden_max = {}, None
    for parts in run:
        if parts[0] == "max_height":
            golden_max = float(parts[1])
            continue
        golden[(int(parts[1]), int(parts[3]), int(parts[4]))] = (
            float(parts[6]), float(parts[8]))
    last = np.zeros(grid * grid, np.float32)
    max_h = 0.0
    for c in range(2):
        p = Perlin(42, (grid + 4) // 5)
        p.set_amplitude(4.0)
        p.set_period(grid)
        for i in range(grid):
            for j in range(grid):
                s = p.sample(f32(i), f32(j), f32(0.0))
                yoff = f32(math.floor(f32(0.5) * (s + f32(4.0))) + 1)
                gs, gy = golden[(c, i, j)]
                assert abs(float(s) - gs) <= 1e-6 * max(1.0, abs(gs))
                assert float(yoff) == gy
                last[i * grid + j] += yoff
                max_h = max(max_h, float(last[i * grid + j]))
    assert max_h == golden_max


def test_convert_carries_jax_scene_exactly(worlds):
    jw, tw, *_ = worlds
    a = convert.scene_from_numpy(jw.scene, device="cpu")
    b = rtt.to_device(tw.scene, "cpu")
    for (na, va), (nb, vb) in zip(_leaves(a), _leaves(b)):
        assert na == nb
        assert torch.equal(torch.as_tensor(va), torch.as_tensor(vb)), na
    cam = convert.camera_from_numpy(jw.camera, device="cpu")
    assert torch.equal(cam.rot, torch.from_numpy(np.asarray(jw.camera.rot)))


def test_convert_requires_a_device(worlds):
    """The carry names its device: without one it raises, and never
    falls back to the CPU; ``params_from_numpy`` builds its leaves there,
    each with ``requires_grad``."""
    jw, *_ = worlds
    jparams = {"cam_pos": np.asarray(jw.camera.pos)}
    for fn, arg in ((convert.scene_from_numpy, jw.scene),
                    (convert.camera_from_numpy, jw.camera),
                    (convert.params_from_numpy, jparams)):
        with pytest.raises(TypeError):
            fn(arg)
    (leaf,) = convert.params_from_numpy(jparams, device="cpu").values()
    assert leaf.device.type == "cpu" and leaf.requires_grad


def _random_boxes(rng, n, dup=0):
    lo = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.1, 3, (n, 3)).astype(np.float32)
    if dup:  # identical boxes -> equal Morton codes: the sort must be stable
        lo[:dup] = lo[0]
        hi[:dup] = hi[0]
    return lo, hi


@pytest.mark.parametrize("case", ["terrain8", "random300_dups", "random5",
                                  "single"])
def test_build_lbvh_matches(worlds, case):
    *_, geom = worlds
    rng = np.random.default_rng(7)
    if case == "terrain8":
        lo, hi = geom.aabb_min.numpy(), geom.aabb_max.numpy()
    elif case == "random300_dups":
        lo, hi = _random_boxes(rng, 300, dup=40)
    elif case == "random5":
        lo, hi = _random_boxes(rng, 5)
    else:
        lo, hi = _random_boxes(rng, 1)
    jb = jaccel.build_lbvh(jnp.asarray(lo), jnp.asarray(hi))
    tb = accel.build_lbvh(torch.from_numpy(lo), torch.from_numpy(hi))
    np.testing.assert_array_equal(tb.ordering.numpy(), np.asarray(jb.ordering))
    np.testing.assert_array_equal(tb.valid.numpy(), np.asarray(jb.valid))
    np.testing.assert_array_equal(tb.box_min.numpy(), np.asarray(jb.box_min))
    np.testing.assert_array_equal(tb.box_max.numpy(), np.asarray(jb.box_max))


def test_z_order_matches():
    rng = np.random.default_rng(3)
    c = rng.uniform(-5, 9, (2000, 3)).astype(np.float32)
    lo, hi = c.min(0), c.max(0)
    jc = jrm.z_order_quantized(jnp.asarray(c), jnp.asarray(lo),
                               jnp.asarray(hi))
    tc = rm.z_order_quantized(torch.from_numpy(c), torch.from_numpy(lo),
                              torch.from_numpy(hi))
    np.testing.assert_array_equal(tc.numpy(),
                                  np.asarray(jc).astype(np.int64))


def test_expand_geometry_matches(worlds):
    *_, jgeom, scene, geom = worlds
    for f in dataclasses.fields(geom):
        np.testing.assert_allclose(_np(getattr(geom, f.name)),
                                   np.asarray(getattr(jgeom, f.name)),
                                   rtol=0, atol=1e-6, err_msg=f.name)


@pytest.mark.parametrize("exact_uv", [False, True])
def test_build_tables_matches(worlds, exact_uv):
    _, _, jscene, jgeom, scene, geom = worlds
    jt = pe.build_tables(jscene, jgeom, exact_uv=exact_uv)
    tt = ce.build_tables(scene, geom, exact_uv=exact_uv)
    np.testing.assert_array_equal(tt.inst_i32.numpy(),
                                  np.asarray(jt.inst_i32))
    np.testing.assert_allclose(tt.inst_f32.numpy(), np.asarray(jt.inst_f32),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(tt.tmpl.numpy(), np.asarray(jt.tmpl),
                               rtol=0, atol=1e-6)
    n_box = int(tt.inst_i32[:, ce._II_IS_BOX].sum())
    assert n_box == (0 if exact_uv else scene.inst_pos.shape[0])


def test_detect_box_meshes_matches(worlds):
    _, _, jscene, _, scene, _ = worlds
    jout = pe._detect_box_meshes(jscene)
    tout = ce._detect_box_meshes(scene, *geometry.mesh_boxes(scene))
    for j, t in zip(jout, tout):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert bool(tout[0].all())


def test_prepare_cast_nodes_match(worlds):
    jw, tw, jscene, jgeom, scene, geom = worlds
    jaux = pe.prepare_pallas_cast(jscene, jgeom, jw.config)
    data = ce.prepare_cast(scene, geom, tw.config)
    np.testing.assert_array_equal(data.ordering.numpy(),
                                  np.asarray(jaux["ordering"]))
    np.testing.assert_array_equal(data.nodes.numpy(),
                                  np.asarray(jaux["nodes"]))


@pytest.mark.parametrize("size", [(640, 480), (97, 61)])
def test_camera_rays_match(worlds, size):
    jw, tw, *_ = worlds
    w, h = size
    jcam = jax.tree_util.tree_map(
        jnp.asarray, jscale_camera(jw.camera, w, jw.config.width))
    cam = convert.camera_from_numpy(
        scale_camera(tw.camera, w, tw.config.width), device="cpu")
    jo, jd = jgeometry.camera_rays(jcam, w, h)
    to, td = geometry.camera_rays(cam, w, h)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=1e-6)


def _rand(shape, seed, lo=-2.0, hi=2.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(
        np.float32)


@pytest.mark.parametrize("fn", ["normalize", "reflect", "quat_mul",
                                "quat_rotate", "quat_rotate_inv",
                                "safe_pow", "norm"])
def test_raymath_matches(fn):
    v = _rand((512, 3), 1)
    n = _rand((512, 3), 2)
    q = _rand((512, 4), 3)
    q2 = _rand((512, 4), 4)
    v[:8] = 0.0  # the zero-length branches
    args = {
        "normalize": (v,), "reflect": (v, n), "quat_mul": (q, q2),
        "quat_rotate": (q, v), "quat_rotate_inv": (q, v), "norm": (v,),
        "safe_pow": (np.abs(v[:, 0]), np.abs(n[:, 0]) * 10),
    }[fn]
    if fn == "safe_pow":
        args[1][:4] = 0.0  # pow(0, 0) == 1
    jv = np.asarray(getattr(jrm, fn)(*[jnp.asarray(a) for a in args]))
    tv = getattr(rm, fn)(*[torch.from_numpy(a) for a in args]).numpy()
    np.testing.assert_allclose(tv, jv, rtol=1e-6, atol=1e-6)


def test_png_roundtrip(tmp_path):
    from raytracer_tpu_torch import pngio

    img = np.random.default_rng(5).integers(0, 256, (7, 9, 4), np.uint8)
    path = str(tmp_path / "x.png")
    pngio.write_png(path, img)
    np.testing.assert_array_equal(pngio.read_png(path), img)


def test_table_layout_matches_cuda_header():
    """The CUDA sources hardcode the table columns; they must equal the
    Python layout the tables are built with."""
    with open(os.path.join(REPO, "raytracer_tpu_torch", "csrc",
                           "bvh_walk.cuh")) as fh:
        src = fh.read()
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert consts, "no constants parsed"
    for name, value in consts.items():
        py = "_NODE_WIDTH" if name == "NODE_WIDTH" else "_" + name
        assert getattr(ce, py) == int(value), name


def test_import_keeps_jax_out():
    code = (
        "import sys\n"
        "import raytracer_tpu_torch, raytracer_tpu_torch.cli, "
        "raytracer_tpu_torch.convert\n"
        "import raytracer_tpu_torch.render.engine, "
        "raytracer_tpu_torch.render.kernels\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('raytracer_tpu.') or m == 'raytracer_tpu']\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
