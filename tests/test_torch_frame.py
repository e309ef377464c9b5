"""The PyTorch port's forward frame against the JAX package, on the CPU.

``render_frame(engine="torch")`` of the port against the JAX package's
``render_frame(engine="pallas")`` (Pallas in interpret mode) on terrain8 at
64x48, atol 1e-5: the fused two-light round, the per-light round
(``fused_shadows=False``, K3) and ``terrain8_lights3`` (2 point + 1
directional light, K3).  The ``"cuda"`` engine on CPU tensors goes through
the kernel wrappers, which take the plain versions there, and must give the
same frame; the per-light frame must equal the fused one bit for bit.  Also
the frame plumbing (block order, u8 conversion), the CLI, and the settings
that later slices ported (bounce rounds, tile caps, texture mapping: the
JAX frame)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracer_tpu as jrt
from raytracer_tpu.builder import scale_camera as jscale_camera
from raytracer_tpu.render import render_frame as jrender_frame
from raytracer_tpu.scene import device_scene

from raytracer_tpu_torch import cli, convert, diff
from raytracer_tpu_torch.render import engine
from raytracer_tpu_torch.render.engine import frame_to_u8, render_frame

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = os.path.join(REPO, "raytracer_tpu_torch", "worlds")
WORLD = os.path.join(WORLDS, "terrain8.json")
LIGHTS3 = os.path.join(WORLDS, "terrain8_lights3.json")
W, H = 64, 48


def _frames(path, **change):
    jw = jrt.generate(path)
    jcam = jax.tree_util.tree_map(
        jnp.asarray, jscale_camera(jw.camera, W, jw.config.width))
    jcfg = jw.config.replace(width=W, height=H, engine="pallas", **change)
    jimg = np.asarray(jax.jit(jrender_frame, static_argnames=("cfg",))(
        device_scene(jw.scene), jcam, jcfg))
    scene = convert.scene_from_numpy(jw.scene, device="cpu")
    cam = convert.camera_from_numpy(
        jscale_camera(jw.camera, W, jw.config.width), device="cpu")
    cfg = convert.config_from_jax(jcfg).replace(engine="torch")
    return dict(jimg=jimg, scene=scene, cam=cam, cfg=cfg)


@pytest.fixture(scope="module")
def frames():
    return _frames(WORLD)


@pytest.fixture(scope="module", params=["per_light", "lights3"])
def per_light(request):
    if request.param == "per_light":
        return _frames(WORLD, fused_shadows=False)
    return _frames(LIGHTS3)


def test_frame_matches_jax_pallas(frames):
    img = render_frame(frames["scene"], frames["cam"], frames["cfg"])
    assert img.shape == (H, W, 4) and img.dtype == torch.float32
    jimg = frames["jimg"]
    np.testing.assert_allclose(img.numpy(), jimg, rtol=0, atol=1e-5)
    # the comparison tests something: hits, shadows, no saturated frame
    hits = jimg[..., :3].max(-1) > 0
    assert 0.05 < hits.mean() < 0.5
    assert (jimg[..., :3] < 1.0).all(-1)[hits].any()


def test_cuda_engine_on_cpu_equals_torch_engine(frames):
    a = render_frame(frames["scene"], frames["cam"], frames["cfg"])
    b = render_frame(frames["scene"], frames["cam"],
                     frames["cfg"].replace(engine="cuda"))
    assert torch.equal(a, b)


def test_per_light_frame_matches_jax_pallas(per_light, frames):
    """The per-light round (K3 per light) against the JAX package; on
    terrain8 it must also equal the fused round bit for bit, as the JAX
    package asserts (``tests/test_pallas.py:260-277``)."""
    f = per_light
    img = render_frame(f["scene"], f["cam"], f["cfg"].replace(engine="cuda"))
    np.testing.assert_allclose(img.numpy(), f["jimg"], rtol=0, atol=1e-5)
    assert torch.equal(img, render_frame(f["scene"], f["cam"], f["cfg"]))
    if not f["cfg"].fused_shadows:
        fused = render_frame(frames["scene"], frames["cam"], frames["cfg"])
        assert torch.equal(img, fused)
    else:  # the second point light changes the frame
        assert not np.allclose(f["jimg"], frames["jimg"], atol=1e-3)


@pytest.mark.parametrize("hw", [(64, 64), (40, 70)])
def test_blocks_roundtrip(hw):
    hp, wp = hw
    x = torch.arange(hp * wp * 3, dtype=torch.float32).reshape(hp, wp, 3)
    if hp % engine.BLOCK or wp % engine.BLOCK:
        hp = -(-hp // engine.BLOCK) * engine.BLOCK
        wp = -(-wp // engine.BLOCK) * engine.BLOCK
        x = torch.nn.functional.pad(x, (0, 0, 0, wp - hw[1], 0, hp - hw[0]))
    b = engine._to_blocks(x, hp, wp)
    # one 32x32 screen block is one contiguous run of 1024 rays
    assert torch.equal(b[:engine.BLOCK], x[0, :engine.BLOCK])
    assert torch.equal(engine._from_blocks(b, hp, wp), x)


def test_frame_rays_blocked_pads_like_jax(frames):
    cfg = frames["cfg"].replace(width=40, height=30)
    ro, rd, hp, wp = engine._frame_rays_blocked(frames["cam"], cfg)
    assert (hp, wp) == (32, 64) and ro.shape == (hp * wp, 3)
    grid_d = engine._from_blocks(rd, hp, wp)
    grid_o = engine._from_blocks(ro, hp, wp)
    assert torch.equal(grid_d[30:, :], torch.tensor([0.0, 0.0, 1.0]).expand(
        2, wp, 3))
    assert torch.equal(grid_d[:, 40:], torch.tensor([0.0, 0.0, 1.0]).expand(
        hp, 24, 3))
    assert torch.equal(grid_o[30:], torch.zeros(2, wp, 3))


def test_frame_to_u8_truncates():
    img = torch.tensor([[[0.0, 0.999, 1.5, -0.2]]])
    assert frame_to_u8(img).tolist() == [[[0, 254, 255, 0]]]


def _material_world(tmp_path, change):
    import json

    with open(WORLD) as fh:
        doc = json.load(fh)
    key = "Kr" if change == "reflective" else "Kt"
    doc["cubes"][-1][key] = [0.3, 0.3, 0.3, 0.3]  # the top layer
    p = tmp_path / f"{change}.json"
    p.write_text(json.dumps(doc))
    return str(p)


@pytest.mark.parametrize("change", [
    "traversal_cull", "kernel_mxu", "edge_aware", "spp", "tile_cap",
    "texture", "reflective", "refractive", "vertex grads"])
def test_unported_settings_raise(frames, tmp_path, change):
    """Every setting is ported (none raises any more) and renders: the cull
    and the MXU kernel give terrain8's frame (equal to the LBVH walk's); so
    do edge-aware gradients, on every cast (the frame unchanged), and
    vertex parameters train.  Texture mapping on terrain8, whose triangles
    are all untextured, gives the JAX package's frame and, on the walk and
    the MXU cast, the frame without it bit for bit (textured worlds:
    ``test_torch_texture.py``).  A reflective world (the pixel-aligned bounce
    stream), a refractive one (the aligned stream with the transmissive
    shadow march), a wavefront tile cap and spp = 4 give the JAX package's
    frame at 64x48; ``static_tile_cap`` at spp = 1 leaves the frame as it
    is, as in the JAX package."""
    scene, cam, cfg = frames["scene"], frames["cam"], frames["cfg"]
    if change == "spp":
        f = _frames(WORLD, spp=4)
        img, stats = engine.render_frame_with_stats(
            f["scene"], f["cam"], f["cfg"].replace(engine="cuda"))
        np.testing.assert_allclose(img.numpy(), f["jimg"], rtol=0, atol=1e-5)
        assert int(stats["dropped"]) == 0
        assert not np.allclose(f["jimg"], frames["jimg"], atol=1e-3)
        assert torch.equal(render_frame(scene, cam, cfg.replace(
            static_tile_cap=0.5)), render_frame(scene, cam, cfg))
        return
    if change in ("tile_cap", "reflective", "refractive"):
        if change == "tile_cap":
            f = _frames(WORLD, wavefront_tile_cap=0.5)
        else:
            f = _frames(_material_world(tmp_path, change))
            assert f["cfg"].any_reflective == (change == "reflective")
            assert f["cfg"].any_refractive == (change == "refractive")
        img, stats = engine.render_frame_with_stats(
            f["scene"], f["cam"], f["cfg"].replace(engine="cuda"))
        np.testing.assert_allclose(img.numpy(), f["jimg"], rtol=0, atol=1e-5)
        if change == "tile_cap":  # 2 of the frame's 4 tiles are kept
            assert int(stats["dropped"]) > 0
            assert not np.allclose(f["jimg"], frames["jimg"], atol=1e-3)
        else:  # the bounces change the frame
            assert int(stats["dropped"]) == 0
            img0 = render_frame(f["scene"], f["cam"],
                                f["cfg"].replace(recurse_depth=0))
            assert int(((img - img0).abs().amax(-1) > 1e-3).sum()) > 10
        return
    cfg = cfg.replace(engine="cuda", width=8, height=8)
    if change in ("traversal_cull", "kernel_mxu", "edge_aware"):
        ported = {"traversal_cull": cfg.replace(pallas_traversal="cull"),
                  "kernel_mxu": cfg.replace(pallas_kernel="mxu"),
                  "edge_aware": cfg}[change]
        img = render_frame(scene, cam, ported)
        np.testing.assert_allclose(img.numpy(),
                                   render_frame(scene, cam, cfg).numpy(),
                                   rtol=0, atol=1e-5)
        assert torch.equal(render_frame(
            scene, cam, ported.replace(edge_aware_grads=True)), img)
        return
    elif change == "texture":
        # every triangle of terrain8 is untextured: Kd stays, on the walk
        # and on the MXU cast (its uv from the resolve step)
        img = render_frame(scene, cam, frames["cfg"].replace(
            engine="cuda", texture_mapping=True))
        np.testing.assert_allclose(img.numpy(), frames["jimg"], rtol=0,
                                   atol=1e-5)
        for ported in (cfg, cfg.replace(pallas_kernel="mxu")):
            assert torch.equal(
                render_frame(scene, cam, ported.replace(texture_mapping=True)),
                render_frame(scene, cam, ported))
        return
    elif change == "vertex grads":
        params = diff.trainable_params(scene, cam, include_vertices=True)
        assert torch.equal(params["verts"], scene.verts)
        assert params["verts"].requires_grad and params["verts"].is_leaf
        return


def test_cli_writes_png_on_cpu(tmp_path, capsys):
    from raytracer_tpu_torch.pngio import read_png

    out = str(tmp_path / "f.png")
    assert cli.main(["-c", WORLD, "--width", "32", "--height", "24",
                     "--device", "cpu", "-o", out]) == 0
    png = read_png(out)
    assert png.shape == (24, 32, 4)
    assert png[..., :3].max() > 0


def test_cli_device_cuda_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: --device cuda is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["-c", WORLD, "--width", "8", "--height", "8"])
