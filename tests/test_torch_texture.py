"""Texture mapping in the port against the JAX package, on the CPU.

The four cases of ``tests/test_texture.py`` on both packages: the texel of
``sample_atlas``, a textured cube that renders otherwise than a flat one,
its frame through the port's ``"cuda"`` engine (the kernels' plain versions
on the CPU) against the JAX Pallas engine (interpret mode) at atol 1e-5 and
the JAX ``jnp`` engine at 1e-4 (that test's own tolerance), and an
untextured cube that keeps the box fast path.

Then the textured worlds: terrain8 (the LBVH walk) and terrain6 (the cull,
and the MXU cast) with their top cube type textured from a checker atlas of
256x256 texels, each texel its own colour (``textured``; ``chip_smoke.py``
builds the same scene), against the JAX package's frames at atol 1e-5 on
every pixel; the same on the bounce streams (terrain8_stress, the mixed
world) and at spp 2; and the loss gradients with texture mapping on against
``jax.grad`` at rtol 1e-5 / atol 1e-6, with no NaN.  A texel index is
``int(rect + uv * size)``: one ulp of a product can move a hit to the next
texel where it lies on a texel edge, so these frames are compared strictly
and a flip would show as a failure here.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracer_tpu as jrt
from raytracer_tpu import diff as jdiff
from raytracer_tpu import synth as jsynth
from raytracer_tpu.builder import Material as JMaterial
from raytracer_tpu.builder import SceneBuilder as JSceneBuilder
from raytracer_tpu.builder import TextureCoords as JTextureCoords
from raytracer_tpu.builder import make_camera as jmake_camera
from raytracer_tpu.builder import scale_camera as jscale_camera
from raytracer_tpu.render import engine as jengine
from raytracer_tpu.render import pallas_engine as jpallas
from raytracer_tpu.render import shading as jshading
from raytracer_tpu.render.cast import Hit as JHit
from raytracer_tpu.render.geometry import expand_geometry as jexpand
from raytracer_tpu.scene import RenderConfig as JRenderConfig
from raytracer_tpu.scene import device_scene
from raytracer_tpu.scene import scene_render_flags as jrender_flags

from raytracer_tpu_torch import convert, diff, tree
from raytracer_tpu_torch.render import cuda_engine, engine, shading
from raytracer_tpu_torch.render.cast import Hit
from raytracer_tpu_torch.render.geometry import expand_geometry

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = os.path.join(REPO, "raytracer_tpu_torch", "worlds")
W, H = 48, 32
ATOL_FRAME = 1e-5
RTOL, ATOL = 1e-5, 1e-6


def checker_atlas(n):
    """An ``n x n`` RGBA atlas with a colour of its own in every texel."""
    x = np.arange(n, dtype=np.float32)[None, :].repeat(n, 0)
    y = np.arange(n, dtype=np.float32)[:, None].repeat(n, 1)
    return np.stack([x / n, y / n, (x + y) / (2 * n),
                     np.ones((n, n), np.float32)], -1)


def textured(scene, mesh=-1, n=256):
    """The numpy ``scene`` with mesh ``mesh``'s triangles textured: each
    triangle ``k`` of the mesh maps to its own 63x63 rect of a checker
    atlas of ``n x n`` texels."""
    start = int(scene.mesh_tri_start[mesh])
    count = int(scene.mesh_tri_count[mesh])
    rect = np.array(scene.tri_coord_rect, np.float32)
    degenerate = np.array(scene.tri_coord_degenerate, bool)
    for k in range(count):
        rect[start + k] = [(k % 4) * 64, (k // 4) * 64, 63, 63]
        degenerate[start + k] = False
    return dataclasses.replace(scene, tri_coord_rect=rect,
                               tri_coord_degenerate=degenerate,
                               atlas=checker_atlas(n))


def _pair(jscene_np, jcam_np, jcfg):
    return dict(jscene=device_scene(jscene_np),
                jcam=jax.tree_util.tree_map(jnp.asarray, jcam_np), jcfg=jcfg,
                scene=convert.scene_from_numpy(jscene_np, device="cpu"),
                cam=convert.camera_from_numpy(jcam_np, device="cpu"),
                cfg=convert.config_from_jax(jcfg).replace(engine="cuda"))


def _jax_frame(p, **change):
    return np.asarray(jax.jit(jengine.render_frame, static_argnames=("cfg",))(
        p["jscene"], p["jcam"], p["jcfg"].replace(**change)))


def _world(name, size=(W, H), mesh=-1, **change):
    jw = jrt.generate(os.path.join(WORLDS, f"{name}.json"))
    jcam = jscale_camera(jw.camera, size[0], jw.config.width)
    jcfg = jw.config.replace(width=size[0], height=size[1], engine="pallas",
                             texture_mapping=True, **change)
    return _pair(textured(jw.scene, mesh), jcam, jcfg)


# ---------------------------------------------------------------------------
# tests/test_texture.py on both packages
# ---------------------------------------------------------------------------

def test_sample_atlas_picks_expected_texel():
    sb = JSceneBuilder()
    mat = JMaterial(kd=np.array([1, 1, 1, 1], np.float32))
    tc = JTextureCoords(texture_x=2.0, texture_y=1.0, u=4.0, v=4.0,
                        degenerate=False)
    m = sb.create_mesh()
    mb = sb.get_mesh_builder(m)
    tri = [sb.add_vertex([0.0, 0.0, 0.0]), sb.add_vertex([1.0, 0.0, 0.0]),
           sb.add_vertex([0.0, 1.0, 0.0])]
    mb.add_triangle(tri, tc, mat)
    sb.add_trans(mb)
    atlas = checker_atlas(8)
    scene_np = dataclasses.replace(sb.finish(), atlas=atlas)
    scene = convert.scene_from_numpy(scene_np, device="cpu")
    # barycentric (0.5, 0.25) -> texel (2 + 0.5 * 4, 1 + 0.25 * 4) = (4, 2);
    # then seeded uv, some outside [0, 1] (the clamp)
    rng = np.random.default_rng(5)
    uv = np.concatenate([[[0.5, 0.25]], rng.uniform(
        -0.3, 1.3, (255, 2))]).astype(np.float32)
    n = uv.shape[0]
    tex, degen = shading.sample_atlas(scene, Hit(
        valid=torch.ones(n, dtype=torch.bool), t=torch.ones(n),
        wtri=torch.zeros(n, dtype=torch.int32), uv=torch.from_numpy(uv)))
    jtex, jdegen = jshading.sample_atlas(
        device_scene(scene_np), None, JHit(
            valid=jnp.ones(n, bool), t=jnp.ones(n),
            wtri=jnp.zeros(n, jnp.int32), uv=jnp.asarray(uv)))
    assert not bool(degen.any()) and not bool(np.asarray(jdegen).any())
    np.testing.assert_array_equal(tex[0].numpy(), atlas[2, 4])
    np.testing.assert_array_equal(tex.numpy(), np.asarray(jtex))
    assert len(np.unique(tex.numpy(), axis=0)) > 20


def _cube(textured_faces: bool):
    """One unit cube with white Kd (red when untextured), its 12 triangles
    on the 8x8 checker atlas when ``textured_faces``."""
    sb = JSceneBuilder()
    if textured_faces:
        mat = JMaterial(kd=np.array([1.0, 1.0, 1.0, 1.0], np.float32))
        tc = JTextureCoords(texture_x=0.0, texture_y=0.0, u=7.0, v=7.0,
                            degenerate=False)
    else:
        mat = JMaterial(kd=np.array([1.0, 0.0, 0.0, 1.0], np.float32))
        tc = JTextureCoords()
    sb.add_trans(sb.get_mesh_builder(sb.build_cube(1.0, tc, mat)))
    sb.add_directional_light([0.3, -0.5, 1.0], [1.0, 1.0, 1.0, 1.0])
    return dataclasses.replace(
        sb.finish(), atlas=checker_atlas(8),
        ambience=np.array([0.2, 0.2, 0.2, 1.0], np.float32))


@pytest.fixture(scope="module")
def textured_cube():
    scene = _cube(True)
    cam = dataclasses.replace(jmake_camera(0.6, 48.0, 64, 64),
                              pos=np.array([0.0, 0.0, -3.0], np.float32))
    cfg = JRenderConfig(width=64, height=64, recurse_depth=0,
                        texture_mapping=True, engine="pallas",
                        **jrender_flags(scene))
    return _pair(scene, cam, cfg)


def test_textured_render_differs_from_flat(textured_cube):
    p = textured_cube
    img_tex = engine.render_frame(p["scene"], p["cam"], p["cfg"]).numpy()
    img_flat = engine.render_frame(p["scene"], p["cam"], p["cfg"].replace(
        texture_mapping=False)).numpy()
    assert img_flat[..., :3].max() > 0.05  # the cube is visible
    assert np.abs(img_tex - img_flat).max() > 0.05  # the texture shows


def test_textured_render_matches_jax(textured_cube):
    """The template path's true uv on the textured cube: the port's cuda
    engine equals the JAX Pallas engine at 1e-5 and its jnp oracle at
    1e-4, and the port's torch engine bit for bit."""
    p = textured_cube
    img = engine.render_frame(p["scene"], p["cam"], p["cfg"])
    np.testing.assert_allclose(img.numpy(), _jax_frame(p), rtol=0,
                               atol=ATOL_FRAME)
    np.testing.assert_allclose(img.numpy(), _jax_frame(p, engine="jnp"),
                               rtol=1e-4, atol=1e-4)
    assert torch.equal(img, engine.render_frame(
        p["scene"], p["cam"], p["cfg"].replace(engine="torch")))


def _is_box(scene_np, **kw):
    scene = convert.scene_from_numpy(scene_np, device="cpu")
    tables = cuda_engine.build_tables(scene, expand_geometry(scene), **kw)
    port = tables.inst_i32[:, cuda_engine._II_IS_BOX].numpy()
    jscene = device_scene(scene_np)
    jtables = jpallas.build_tables(jscene, jexpand(jscene), **kw)
    np.testing.assert_array_equal(
        port, np.asarray(jtables.inst_i32[:, jpallas._II_IS_BOX]))
    return int(port.sum())


def test_untextured_cube_keeps_box_fast_path():
    """``texture_mapping`` keeps the box fast path for an untextured cube
    and takes it from a textured one, also under the edge-aware grads'
    ``box_exact_uv`` tables: ``is_box`` equal to the JAX package's."""
    plain = _cube(False)
    assert _is_box(plain, texture_mapping=True) == 1
    assert _is_box(plain, exact_uv=True) == 0
    tex = _cube(True)
    assert _is_box(tex) == 1
    assert _is_box(tex, texture_mapping=True) == 0
    assert _is_box(tex, exact_uv=True, box_exact_uv=True,
                   texture_mapping=True) == 0


# ---------------------------------------------------------------------------
# the textured worlds: walk, cull, MXU, bounce streams, spp
# ---------------------------------------------------------------------------

WORLD_CASES = {
    "terrain8_walk": ("terrain8", {}),
    "terrain6_cull": ("terrain6", {}),
    "terrain6_mxu": ("terrain6", {"pallas_kernel": "mxu"}),
    "terrain8_stress": ("terrain8_stress", {}),
    "terrain8_spp2": ("terrain8", {"spp": 2}),
}


@pytest.mark.parametrize("case", sorted(WORLD_CASES))
def test_textured_world_matches_jax(case):
    """The top cube type textured: the frame equals the JAX package's at
    atol 1e-5 on every pixel, differs from the untextured frame, and the
    textured instances leave the box fast path (the walk and the cull)."""
    name, change = WORLD_CASES[case]
    p = _world(name, **change)
    img, stats = engine.render_frame_with_stats(p["scene"], p["cam"],
                                                p["cfg"])
    assert int(stats["dropped"]) == 0
    jimg = _jax_frame(p)
    np.testing.assert_allclose(img.numpy(), jimg, rtol=0, atol=ATOL_FRAME)
    flat = engine.render_frame(p["scene"], p["cam"], p["cfg"].replace(
        texture_mapping=False))
    changed = (img - flat).abs().amax(-1) > 1e-3
    assert int(changed.sum()) > 20
    if change.get("pallas_kernel") != "mxu":
        geom = expand_geometry(p["scene"])
        box = cuda_engine.prepare_cast(p["scene"], geom, p["cfg"]).tables
        flat_box = cuda_engine.prepare_cast(p["scene"], geom, p["cfg"].replace(
            texture_mapping=False)).tables
        top = p["scene"].inst_mesh == p["scene"].mesh_tri_start.shape[0] - 1
        is_box = box.inst_i32[:, cuda_engine._II_IS_BOX].bool()
        assert not bool(is_box[top].any())
        assert bool(is_box[~top].all())
        assert bool(flat_box.inst_i32[:, cuda_engine._II_IS_BOX].bool().all())


def _mixed(mesh, size=(64, 48)):
    scene, cam, cfg = jsynth.make_mixed_world(depth=3)
    cfg = cfg.replace(width=size[0], height=size[1], engine="pallas",
                      texture_mapping=True)
    return _pair(textured(scene, mesh=mesh),
                 jscale_camera(cam, size[0], 128), cfg)


def test_textured_mixed_world_matches_jax():
    """The compacted 2x stream with the mirror cube (the mixed world's
    second mesh) textured: the JAX package's frame on every pixel."""
    p = _mixed(mesh=1)
    img, stats = engine.render_frame_with_stats(p["scene"], p["cam"],
                                                p["cfg"])
    assert int(stats["dropped"]) == 0
    np.testing.assert_allclose(img.numpy(), _jax_frame(p), rtol=0,
                               atol=ATOL_FRAME)
    flat = engine.render_frame(p["scene"], p["cam"], p["cfg"].replace(
        texture_mapping=False))
    assert int(((img - flat).abs().amax(-1) > 1e-3).sum()) > 20


def test_textured_floor_known_differences():
    """Known differences on the mixed world's textured floor, whose 25
    cubes abut on exact grid planes and which an axis-aligned camera sees
    at exact fractions.  The primary hits of the port (the cull, K4's
    plain version) and of the JAX Pallas cast over the frame's rays differ
    in two ways only:

    * the JAX kernel runs a template instance's triangle loop for every
      ray of a tile when any of them hits the instance's box, and keeps a
      hit that the triangle test accepts on an edge of a box whose slab
      this ray misses by an ulp (tmin > tmax); the port tests each ray's
      own box, as the JAX cast of that ray alone does.  So where the two
      differ in the hit or its triangle (3 of 3,072 rays here), the JAX
      cast of the ray alone gives the port's hit;
    * the template loop's uv agree to an ulp or two, not bit for bit
      (``test_torch_geomgrad.py``: uv to atol 1e-5); a hit on a texel edge
      (``rect + uv * size`` an integer) can then take the next texel
      (3 rays here), each within 1e-4 of the edge in both packages.

    Frames of such a world differ on those pixels; the other worlds of
    this file match on every pixel."""
    p = _mixed(mesh=0)
    jgeom = jexpand(p["jscene"])
    jcast = jengine.make_cast(p["jscene"], jgeom, p["jcfg"])
    geom = expand_geometry(p["scene"])
    cast = engine.make_cast(p["scene"], geom, p["cfg"])
    ro, rd, _, _ = engine._frame_rays_blocked(p["cam"], p["cfg"])
    hp = cast(ro, rd)
    hj = jcast(jnp.asarray(ro.numpy()), jnp.asarray(rd.numpy()))
    jv, jw = np.asarray(hj.valid), np.asarray(hj.wtri)
    pv, pw = hp.valid.numpy(), hp.wtri.numpy()
    other = np.flatnonzero((jv != pv) | (jv & (jw != pw)))
    assert 0 < len(other) <= 0.002 * pv.size, other.tolist()
    for i in other:
        one = jcast(jnp.asarray(ro[i:i + 1].numpy()),
                    jnp.asarray(rd[i:i + 1].numpy()))
        assert bool(one.valid[0]) == pv[i] and int(one.wtri[0]) == pw[i]
        assert float(one.t[0]) == float(hp.t[i])
    same = np.flatnonzero(jv & pv & (jw == pw))
    tri = p["scene"].wtri_tri[hp.wtri.long()].long()
    rect = p["scene"].tri_coord_rect[tri].numpy()
    degenerate = p["scene"].tri_coord_degenerate[tri].numpy()
    tp = rect[:, :2] + hp.uv.numpy() * rect[:, 2:]
    tj = rect[:, :2] + np.asarray(hj.uv) * rect[:, 2:]
    flips = same[(~degenerate[same])
                 & (np.floor(tp[same]) != np.floor(tj[same])).any(-1)]
    assert len(flips) <= 0.002 * pv.size, flips.tolist()
    for texel in (tp[flips], tj[flips]):
        near = np.abs(texel - np.round(texel)) <= 1e-4
        assert near.any(-1).all()
    # the other hits take the same texel: the same colour
    np.testing.assert_allclose(hp.uv.numpy()[same], np.asarray(hj.uv)[same],
                               rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# gradients with texture mapping on
# ---------------------------------------------------------------------------

GRAD_CASES = {"terrain8_walk": ("terrain8", {}),
              "terrain6_cull": ("terrain6", {})}


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_texture_grads_match_jax(case):
    """``make_loss_fn``'s gradients with the top cube type textured against
    ``jax.grad`` of the JAX package's (Pallas in interpret mode), leaf by
    leaf, at rtol 1e-5 / atol 1e-6 (the loss at rtol 1e-5); every gradient
    finite.  The textured material's ``kd`` takes no gradient (the texel
    replaces it)."""
    name, change = GRAD_CASES[case]
    p = _world(name, **change)
    target = np.random.default_rng(11).uniform(
        0.0, 0.6, (H, W, 4)).astype(np.float32)
    jparams = jdiff.trainable_params(p["jscene"], p["jcam"])
    jloss, jg = jax.jit(jax.value_and_grad(jdiff.make_loss_fn(
        p["jscene"], p["jcam"], p["jcfg"], jnp.asarray(target))))(jparams)
    params = convert.params_from_numpy(jparams, device="cpu")
    loss = diff.make_loss_fn(p["scene"], p["cam"], p["cfg"],
                             torch.from_numpy(target))(params)
    # a sum of 6,144 FP32 squares, added in another order
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=RTOL)
    g = diff.grad_of(loss, params)
    jflat, _ = jax.tree_util.tree_flatten(jg)
    tl = tree.leaves_with_paths(convert.params_to_numpy(g))
    assert len(tl) == len(jflat)
    for (key, gt), gj in zip(tl, jflat):
        assert np.isfinite(gt).all(), key
        np.testing.assert_allclose(gt, np.asarray(gj), rtol=RTOL, atol=ATOL,
                                   err_msg=f"{case} {key}")
    by_key = dict(tl)
    top_mat = int(p["scene"].tri_mat[int(p["scene"].mesh_tri_start[-1])])
    assert np.abs(by_key["['materials']/.kd"][top_mat]).max() == 0.0
    for key in ("['cam_pos']", "['lights']/.point_col", "['materials']/.ka"):
        assert np.abs(by_key[key]).max() > 10 * ATOL, key
