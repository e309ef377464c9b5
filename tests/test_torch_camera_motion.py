"""Camera motion, the quaternion and intersection helpers of ``raymath``, and
the CLI's ``--orbit`` / ``--interactive`` of the port, against the JAX
package on the CPU.

* Every ``raymath`` name the render path did not need before (quaternions,
  entity frames, the ray/plane, ray/triangle and ray/box tests, the float
  bit Morton code) on ``tests/test_raymath.py``'s cases and on seeded
  random batches: values at atol 1e-6; ray tests: hit flags exact, ``t``
  at rtol 1e-5 where both hit.  The random triangle tests run the JAX side
  op by op (``jax.disable_jit``): jitted, ``jnp.cross`` contracts its
  products into FMAs, which moves ``t`` by up to 1e-4 relative on rays
  nearly parallel to a triangle; the port rounds each product, as the JAX
  package does op by op.
* ``camera_motion`` on terrain8's camera and on a random one: basis,
  translate, rotate, mouse look (``0, 0`` the identity, no NaN), WASD and a
  30-frame orbit, pos and rot at atol 1e-6.
* One orbit frame at 64x48: the port's ``"torch"`` engine against the JAX
  package's Pallas engine (interpret mode), both fed the JAX package's
  camera, so that camera and frame are compared apart.
* ``python -m raytracer_tpu_torch.cli --orbit 3`` and ``--interactive``
  (``w``, ``a``, ``mouse``, ``click``, ``bogus``, ``quit`` on stdin) as
  ``--device cpu`` processes at 32x24: the files, the printed lines, the
  frames equal to in-process renders of the port's moved cameras, and the
  probe's colour equal to its frame pixel at 1e-4.
"""

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
from raytracer_tpu import camera_motion as jcm
from raytracer_tpu import raymath as jrm
from raytracer_tpu.builder import scale_camera as jscale_camera
from raytracer_tpu.render import render_frame as jrender_frame
from raytracer_tpu.scene import Camera as JCamera
from raytracer_tpu.scene import device_scene

import raytracer_tpu_torch as rtt
from raytracer_tpu_torch import camera_motion as cm
from raytracer_tpu_torch import convert
from raytracer_tpu_torch import raymath as rm
from raytracer_tpu_torch.builder import scale_camera
from raytracer_tpu_torch.pngio import read_png
from raytracer_tpu_torch.render.engine import frame_to_u8, render_frame

from test_torch_bounce import assert_frame_matches_jax

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = os.path.join(REPO, "raytracer_tpu_torch", "worlds", "terrain8.json")
ATOL, RTOL_T = 1e-6, 1e-5
N = 512


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                               atol=atol)


def _unit(rng, n):
    v = rng.standard_normal((n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


# ---- raymath ---------------------------------------------------------------

def test_identity_quat_and_normalize_match_jax():
    assert rm.IDENTITY_QUAT.device.type == "cpu"
    _close(rm.IDENTITY_QUAT, jrm.IDENTITY_QUAT, atol=0)
    rng = np.random.default_rng(0)
    q = rng.standard_normal((N, 4)).astype(np.float32)
    q[:8] *= 1e-7  # below the threshold: zero
    out = rm.quat_normalize(_t(q))
    _close(out, jrm.quat_normalize(jnp.asarray(q)))
    assert float(out[:8].abs().max()) == 0.0


@pytest.mark.parametrize("theta", [np.pi / 2, 0.7, -2.5, 0.0])
def test_quat_from_axis_angle_matches_jax(theta):
    rng = np.random.default_rng(1)
    for axis in [[0.0, 0.0, 1.0], [0.0, 1.0, 0.0], *_unit(rng, 8).tolist()]:
        want = jrm.quat_from_axis_angle(jnp.asarray(axis), jnp.float32(theta))
        # a Python float and a 0-d float32 tensor give the same quaternion
        for th in (float(theta), torch.tensor(theta, dtype=torch.float32)):
            got = rm.quat_from_axis_angle(_t(axis), th)
            assert got.dtype == torch.float32 and got.shape == (4,)
            _close(got, want)
        # a list axis on the CPU
        _close(rm.quat_from_axis_angle(axis, float(theta)), want)


def test_quat_rotate_axis_angle_cases():
    q = rm.quat_from_axis_angle(_t([0.0, 0.0, 1.0]), np.pi / 2)
    _close(rm.quat_rotate(q, _t([1.0, 0.0, 0.0])), [0.0, 1.0, 0.0])
    q = rm.quat_from_axis_angle(rm.normalize(_t([1.0, 2.0, 3.0])), 0.7)
    v = _t([0.3, -1.2, 2.0])
    _close(rm.quat_rotate_inv(q, rm.quat_rotate(q, v)), v, atol=1e-5)


def test_entity_frames_match_jax():
    rng = np.random.default_rng(2)
    q = rng.standard_normal((N, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    p = rng.uniform(-5, 5, (N, 3)).astype(np.float32)
    v = rng.uniform(-5, 5, (N, 3)).astype(np.float32)
    jq, jp, jv = jnp.asarray(q), jnp.asarray(p), jnp.asarray(v)
    _close(rm.point_to_local(_t(q), _t(p), _t(v)),
           jrm.point_to_local(jq, jp, jv), atol=1e-5)
    _close(rm.point_from_local(_t(q), _t(p), _t(v)),
           jrm.point_from_local(jq, jp, jv), atol=1e-5)
    _close(rm.vec_to_local(_t(q), _t(v)), jrm.vec_to_local(jq, jv),
           atol=1e-5)
    _close(rm.vec_from_local(_t(q), _t(v)), jrm.vec_from_local(jq, jv),
           atol=1e-5)
    # a frame round trip
    back = rm.point_from_local(_t(q), _t(p),
                               rm.point_to_local(_t(q), _t(p), _t(v)))
    _close(back, v, atol=1e-5)


def _hits_match(got, want):
    """``(hit, t, ...)`` of a ray test: hit flags exact, t at rtol 1e-5
    where both hit, any further output at atol 1e-5 there."""
    hit = got[0].numpy()
    np.testing.assert_array_equal(hit, np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy()[hit], np.asarray(want[1])[hit],
                               rtol=RTOL_T, atol=0)
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_allclose(g.numpy()[hit], np.asarray(w)[hit],
                                   rtol=0, atol=1e-5)
    return hit


def _triangles(seed):
    rng = np.random.RandomState(seed)
    a, b, c = (rng.randn(N, 3).astype(np.float32) for _ in range(3))
    ro = rng.randn(N, 3).astype(np.float32) * 3
    rd = np.array(jrm.normalize(jnp.asarray(
        rng.randn(N, 3).astype(np.float32))))
    # rays aimed at a point inside each triangle, so about half hit
    w = rng.dirichlet([1, 1, 1], N).astype(np.float32)
    aim = w[:, :1] * a + w[:, 1:2] * b + w[:, 2:] * c
    rd[::2] = np.asarray(jrm.normalize(jnp.asarray(aim - ro)))[::2]
    return ro, rd, a, b, c


_TRI_CASES = [  # tests/test_raymath.py: hit, miss outside, parallel miss
    ([0.25, 0.25, 1.0], [0.0, 0.0, -1.0], True),
    ([0.8, 0.8, 1.0], [0.0, 0.0, -1.0], False),
    ([0.0, 0.0, 1.0], [1.0, 0.0, 0.0], False),
]


@pytest.mark.parametrize("name", ["ray_triangle_areas", "ray_triangle_mt"])
def test_ray_triangle_matches_jax(name):
    fn, jfn = getattr(rm, name), getattr(jrm, name)
    a, b, c = [0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]
    for ro, rd, expect in _TRI_CASES:
        got = fn(_t(ro), _t(rd), _t(a), _t(b), _t(c))
        assert bool(got[0]) == expect
        _hits_match([x[None] for x in got],
                    [np.asarray(x)[None] for x in jfn(
                        *(jnp.asarray(v) for v in (ro, rd, a, b, c)))])
    hit, t, uv = fn(_t([0.25, 0.25, 1.0]), _t([0.0, 0.0, -1.0]), _t(a),
                    _t(b), _t(c))
    _close(t, 1.0, atol=1e-5)
    _close(uv, [0.25, 0.25], atol=1e-4)
    for seed in (0, 1):
        ro, rd, a, b, c = _triangles(seed)
        with jax.disable_jit():  # op by op: jnp.cross jitted contracts FMAs
            want = jfn(*map(jnp.asarray, (ro, rd, a, b, c)))
        hit = _hits_match(fn(*map(_t, (ro, rd, a, b, c))), want)
        assert 0.2 < hit.mean() < 0.8


def test_ray_plane_matches_jax():
    rng = np.random.default_rng(3)
    ro = rng.uniform(-4, 4, (N, 3)).astype(np.float32)
    rd = _unit(rng, N)
    po = rng.uniform(-4, 4, (N, 3)).astype(np.float32)
    pn = _unit(rng, N)
    rd[:16] = np.cross(pn[:16], _unit(rng, 16))  # parallel: not ok
    rd[:16] /= np.linalg.norm(rd[:16], axis=-1, keepdims=True)
    ok, t = rm.ray_plane(*map(_t, (ro, rd, po, pn)))
    jok, jt = jrm.ray_plane(*map(jnp.asarray, (ro, rd, po, pn)))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    assert not ok[:16].any()
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=RTOL_T,
                               atol=1e-6)


def _box_rays(seed):
    rng = np.random.default_rng(seed)
    bmin = rng.uniform(-2, 0, (N, 3)).astype(np.float32)
    bmax = bmin + rng.uniform(0.1, 2, (N, 3)).astype(np.float32)
    ro = rng.uniform(-5, 5, (N, 3)).astype(np.float32)
    rd = _unit(rng, N)
    rd[: N // 4, rng.integers(0, 3, N // 4)] = 0.0  # axis-parallel rays
    rd[: N // 8, 1] = 0.0
    return ro, rd, bmin, bmax


def test_ray_aabb_matches_jax():
    bmin, bmax = _t([0.0, 0.0, 0.0]), _t([1.0, 1.0, 1.0])
    cases = [  # tests/test_raymath.py: hit, behind, parallel outside, inside
        ([0.5, 0.5, 2.0], [0.0, 0.0, -1.0], True, 1.0),
        ([0.5, 0.5, 2.0], [0.0, 0.0, 1.0], False, None),
        ([0.5, 0.5, 2.0], [0.0, -1.0, 0.0], True, None),
        ([0.5, 2.0, 0.5], [0.0, -1.0, 0.0], True, 1.0),
    ]
    for ro, rd, expect, t_want in cases:
        hit, t = rm.ray_aabb(_t(ro), _t(rd), bmin, bmax)
        jhit, jt = jrm.ray_aabb(jnp.asarray(ro), jnp.asarray(rd),
                                jnp.zeros(3), jnp.ones(3))
        assert bool(hit) == bool(jhit) == expect
        _close(t, jt, atol=1e-6)
        if t_want is not None:
            _close(t, t_want, atol=1e-5)
    ro, rd, lo, hi = _box_rays(4)
    nondeg = np.random.default_rng(5).random(N) > 0.1
    for nd in (True, False, nondeg):
        got = rm.ray_aabb(*map(_t, (ro, rd, lo, hi)), nondegenerate=(
            torch.from_numpy(nd) if isinstance(nd, np.ndarray) else nd))
        want = jrm.ray_aabb(*map(jnp.asarray, (ro, rd, lo, hi)),
                            nondegenerate=nd)
        hit = _hits_match(got, want)
        if nd is True:
            assert 0.05 < hit.mean() < 0.95
        if nd is False:
            assert not hit.any()
        # t_entry on the misses too (the value the reference returns)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                   rtol=RTOL_T, atol=1e-6)


def test_z_order_f32bits_matches_jax():
    pts = np.array([[1.5, -2.25, 0.75], [0.0, 3.0, -1.0]], dtype=np.float32)
    rng = np.random.RandomState(3)
    for p in (pts, rng.randn(256, 3).astype(np.float32), pts[0]):
        got = rm.z_order_f32bits_np(p)
        assert got.dtype == np.uint64
        np.testing.assert_array_equal(got, jrm.z_order_f32bits_np(p))


# ---- camera_motion ---------------------------------------------------------

def _cameras():
    """terrain8's camera and a random one, as numpy leaves."""
    w = rtt.generate(WORLD)
    rng = np.random.default_rng(6)
    q = rng.standard_normal(4).astype(np.float32)
    rand = rtt.Camera(pos=rng.uniform(-5, 5, 3).astype(np.float32),
                      rot=(q / np.linalg.norm(q)).astype(np.float32),
                      global_near=np.float32(2.0),
                      unit_to_pixels=np.float32(40.0))
    return [w.camera, rand]


def _port_cam(cam):
    return rtt.to_device(cam, "cpu")


def _jax_cam(cam):
    return JCamera(**{k: jnp.asarray(getattr(cam, k)) for k in (
        "pos", "rot", "global_near", "unit_to_pixels")})


def _same_camera(got, want):
    assert got.pos.device.type == "cpu" and got.rot.dtype == torch.float32
    _close(got.pos, want.pos)
    _close(got.rot, want.rot)


@pytest.mark.parametrize("k", [0, 1])
def test_camera_moves_match_jax(k):
    cam = _cameras()[k]
    pc, jc = _port_cam(cam), _jax_cam(cam)
    for got, want in zip(cm.camera_basis(pc), jcm.camera_basis(jc)):
        _close(got, want)
    _same_camera(cm.translate(pc, [0.3, -1.0, 2.0]),
                 jcm.translate(jc, [0.3, -1.0, 2.0]))
    dr = np.asarray(jrm.quat_from_axis_angle(jnp.asarray([0.0, 0.6, 0.8]),
                                             jnp.float32(0.3)))
    _same_camera(cm.rotate(pc, _t(dr)), jcm.rotate(jc, jnp.asarray(dr)))
    for key in "wasd":
        _same_camera(cm.key_move(pc, key), jcm.key_move(jc, key))
    _same_camera(cm.key_move(pc, "w", speed=1.5),
                 jcm.key_move(jc, "w", speed=1.5))
    for dx, dy in ((5.0, -3.0), (0.0, 7.0), (-120.0, 0.5), (0.0, 0.0)):
        got = cm.mouse_look(pc, dx, dy)
        _same_camera(got, jcm.mouse_look(jc, dx, dy))
        assert bool(torch.isfinite(got.rot).all())
    # no motion: the identity rotation, the camera unchanged
    assert torch.equal(cm.mouse_look(pc, 0, 0).rot, pc.rot)
    # a chain: the interactive loop's moves
    got, want = pc, jc
    for step in ("w", "a", (5.0, -3.0), "d", (-2.0, 1.0), "s"):
        if isinstance(step, str):
            got, want = cm.key_move(got, step), jcm.key_move(want, step)
        else:
            got, want = cm.mouse_look(got, *step), jcm.mouse_look(want, *step)
        _same_camera(got, want)


@pytest.mark.parametrize("k", [0, 1])
def test_orbit_frames_match_jax(k):
    cam = _cameras()[k]
    got = list(cm.orbit_frames(_port_cam(cam), 30))
    want = list(jcm.orbit_frames(_jax_cam(cam), 30))
    assert len(got) == len(want) == 30
    for g, w in zip(got, want):
        _same_camera(g, w)
        assert torch.equal(g.pos, got[0].pos)  # a turntable turns in place
    _same_camera(next(cm.orbit_frames(_port_cam(cam), 1,
                                      degrees_per_frame=5.0)),
                 next(jcm.orbit_frames(_jax_cam(cam), 1, 5.0)))


def test_orbit_frame_matches_jax_pallas():
    """The 30th orbit camera at 64x48: the port's frame from the JAX
    package's camera, against the JAX Pallas frame (interpret mode)."""
    w, h = 64, 48
    jw = jrt.generate(WORLD)
    jcam = jax.tree_util.tree_map(
        jnp.asarray, jscale_camera(jw.camera, w, jw.config.width))
    *_, jcam29 = jcm.orbit_frames(jcam, 30)
    jcfg = jw.config.replace(width=w, height=h, engine="pallas")
    jimg = np.asarray(jax.jit(jrender_frame, static_argnames=("cfg",))(
        device_scene(jw.scene), jcam29, jcfg))
    scene = convert.scene_from_numpy(jw.scene, device="cpu")
    cam29 = convert.camera_from_numpy(jcam29, device="cpu")
    cfg = convert.config_from_jax(jcfg).replace(engine="torch")
    img = render_frame(scene, cam29, cfg)
    assert_frame_matches_jax(img, jimg)
    # the turn moved the frame
    img0 = render_frame(scene, convert.camera_from_numpy(jcam, device="cpu"),
                        cfg)
    assert float((img - img0).abs().max()) > 0.1


# ---- the CLI ---------------------------------------------------------------

CLI_W, CLI_H = 32, 24
CLICK = (16, 12)
SCRIPT = (f"w\na\nmouse 5 -3\nclick {CLICK[0]} {CLICK[1]}\nbogus\n"
          f"click {CLI_W} 0\nmouse 1\nquit\nw\n")


def _cli(*argv, stdin=None):
    return subprocess.Popen(
        [sys.executable, "-m", "raytracer_tpu_torch.cli", "-c", WORLD,
         "--width", str(CLI_W), "--height", str(CLI_H), "--device", "cpu",
         *argv], cwd=REPO, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env={**os.environ, "OMP_NUM_THREADS": "2"})


def _frame(cam):
    w = rtt.generate(WORLD)
    cfg = w.config.replace(width=CLI_W, height=CLI_H, engine="cuda")
    scene = rtt.to_device(w.scene, "cpu")
    return render_frame(scene, cam, cfg), (scene, cfg)


def test_cli_orbit_and_interactive(tmp_path):
    out_dir, frame = tmp_path / "frames", tmp_path / "live.png"
    orbit = _cli("--orbit", "3", "--out-dir", str(out_dir))
    live = _cli("--interactive", "-o", str(frame))
    said, err = live.communicate(SCRIPT, timeout=300)
    assert live.returncode == 0, said + err
    o_said, o_err = orbit.communicate(timeout=300)
    assert orbit.returncode == 0, o_said + o_err

    w = rtt.generate(WORLD)
    cam = rtt.to_device(scale_camera(w.camera, CLI_W, w.config.width), "cpu")
    # --orbit: the files and their last frame
    assert f"wrote 3 frames to {out_dir}/" in o_said
    assert sorted(os.listdir(out_dir)) == [f"frame_{i:04d}.png"
                                           for i in range(3)]
    *_, cam2 = cm.orbit_frames(cam, 3)
    img2, _ = _frame(cam2)
    png = read_png(str(out_dir / "frame_0002.png"))
    np.testing.assert_array_equal(png[..., :3],
                                  frame_to_u8(img2).numpy()[..., :3])
    assert (png[..., 3] == 255).all()

    # --interactive: three moves rendered, the click probed, the bogus
    # lines refused (a click outside the frame among them), nothing read
    # after quit
    lines = said.splitlines()
    assert sum(bool(re.fullmatch(r"frame: [\d.]+ ms \([\d.]+ FPS\)", x))
               for x in lines) == 3
    assert [x for x in lines if x.startswith("? ")] == [
        "? bogus", f"? click {CLI_W} 0", "? mouse 1"]
    assert lines[-1] == "Exiting..."
    moved = cm.mouse_look(cm.key_move(cm.key_move(cam, "w"), "a"), 5, -3)
    img, (scene, cfg) = _frame(moved)
    np.testing.assert_array_equal(read_png(str(frame))[..., :3],
                                  frame_to_u8(img).numpy()[..., :3])
    (color,) = [x for x in lines
                if x.startswith(f"pixel ({CLICK[0]}, {CLICK[1]}) final")]
    color = np.array(color.split("[")[1].rstrip("]").split(), np.float32)
    np.testing.assert_allclose(color, img[CLICK[1], CLICK[0]].numpy(),
                               rtol=1e-4, atol=1e-4)
    assert color[:3].max() > 0  # the pixel is a hit
