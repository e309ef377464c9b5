"""The geometry-gradient path of the PyTorch port against the JAX package.

``edge_aware_grads=True`` with vertex positions trainable: the kernels'
``exact_uv`` branch (K1 on the walk, K4 on the cull), the reparam cast rule
(``cast_vjp.ReparamCast``) on all three casts and the edge-aware band.  On
the CPU, with the same numpy-made inputs in both packages (the JAX side with
``engine="pallas"``, Pallas in interpret mode):

* tables: ``build_tables(exact_uv, box_exact_uv)`` equal to the JAX tables;
* the exact_uv casts (terrain8 through the walk, terrain6 through the
  cull): valid and t (rtol 1e-5), the triangle id exactly and uv to atol
  1e-5, ``tests/test_pallas.py:29-59``'s tolerances; a ray within 1e-5 of a
  face diagonal may take the other triangle (none does here);
* the box fast path's exact uv against the template loop (tables without
  any fast path): the same triangle, uv to 1e-5 (t at rtol and atol 1e-5,
  the slab time against the plane time, as ``test_pallas.py`` has it);
* the forward frame with ``edge_aware_grads`` ``torch.equal`` to the frame
  without, on the walk, the cull and the MXU cast;
* ``diff.make_loss_fn`` with ``include_vertices=True`` at 48x32 against
  ``jax.grad`` leaf by leaf on terrain8, terrain6 and terrain6-MXU:
  materials, lights and camera at rtol 1e-5 / atol 1e-6; ``verts`` at rtol
  1e-4 / atol 1e-6 max|g| (a vertex sums many rows' cotangents, in another
  order);
* AD against a central difference of a uniform vertex scaling (spp=1, the
  close-up, yawed camera of ``tests/test_diff.py``, mesh boxes scaled with
  the vertices): both positive, and the port's AD/FD ratio equal to the JAX
  package's to 1e-3 relative;
* the vertices scaled alone (``test_diff.py``'s setup; the stored mesh
  boxes stale): the port derives its boxes from the vertices
  (``geometry.mesh_boxes``, bit-equal to the loader's on unedited worlds),
  so its frames equal the JAX package's with the boxes scaled too (1e-5,
  at s = -0.03, 0, +0.03), its FD and AD that package's, and its primary
  hits the JAX brute-force oracle's on the stale scene; the JAX Pallas
  cast with stale boxes finds hits outside a box only where its tile
  voted (a reference-side quirk, recorded);
* the material gather: its forward equal to eight row gathers, its
  blocked-sum backward equal to the gather's autograd.
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
from raytracer_tpu import raymath as jrm
from raytracer_tpu import synth
from raytracer_tpu.builder import scale_camera as jscale_camera
from raytracer_tpu.render import cast_vjp as jcast_vjp
from raytracer_tpu.render.cast import make_brute_cast
from raytracer_tpu.render import geometry as jgeometry
from raytracer_tpu.render import pallas_engine as pe
from raytracer_tpu.render.engine import render_frame as jrender_frame
from raytracer_tpu.scene import device_scene

from raytracer_tpu_torch import convert, diff, tree
from raytracer_tpu_torch.builder import Material, SceneBuilder, TextureCoords
from raytracer_tpu_torch.render import cuda_engine as ce
from raytracer_tpu_torch.render import cull, geometry, shading
from raytracer_tpu_torch.render.engine import make_cast, render_frame
from raytracer_tpu_torch.scene import to_device

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = os.path.join(REPO, "raytracer_tpu_torch", "worlds")
W, H = 48, 32
RTOL, ATOL = 1e-5, 1e-6
RTOL_VERTS, ATOL_VERTS = 1e-4, 1e-6  # atol relative to max |g|
EPS_DIAG = 1e-5


def _world(name):
    jw = jrt.generate(os.path.join(WORLDS, f"{name}.json"))
    jscene = device_scene(jw.scene)
    scene = convert.scene_from_numpy(jw.scene, device="cpu")
    return dict(jw=jw, jscene=jscene, jgeom=jgeometry.expand_geometry(jscene),
                scene=scene, geom=geometry.expand_geometry(scene))


@pytest.fixture(scope="module")
def worlds():
    return {name: _world(name) for name in ("terrain8", "terrain6")}


def _rays(world, w=96, h=64, n_random=1024):
    """The primary rays of a ``w`` x ``h`` frame and ``n_random`` seeded
    random rays, as numpy arrays."""
    jw = world["jw"]
    cam = jax.tree_util.tree_map(jnp.asarray, jscale_camera(
        jw.camera, w, jw.config.width))
    ro, rd = jgeometry.camera_rays(cam, w, h)
    rng = np.random.default_rng(5)
    o = rng.uniform(-6, 6, (n_random, 3)).astype(np.float32)
    o[:, 1] += 4.0
    d = rng.standard_normal((n_random, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return {"primary": (np.array(ro, np.float32).reshape(-1, 3),
                        np.array(rd, np.float32).reshape(-1, 3)),
            "random": (o, d)}


# ---------------------------------------------------------------------------
# tables and casts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["terrain8", "terrain6"])
@pytest.mark.parametrize("exact_uv,box_exact_uv",
                         [(True, True), (True, False), (False, True)])
def test_build_tables_box_exact_uv_match_jax(worlds, name, exact_uv,
                                            box_exact_uv):
    wd = worlds[name]
    jt = pe.build_tables(wd["jscene"], wd["jgeom"], exact_uv=exact_uv,
                         box_exact_uv=box_exact_uv)
    tt = ce.build_tables(wd["scene"], wd["geom"], exact_uv=exact_uv,
                         box_exact_uv=box_exact_uv)
    np.testing.assert_array_equal(tt.inst_i32.numpy(),
                                  np.asarray(jt.inst_i32))
    np.testing.assert_allclose(tt.inst_f32.numpy(), np.asarray(jt.inst_f32),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(tt.tmpl.numpy(), np.asarray(jt.tmpl),
                               rtol=0, atol=1e-6)
    n_box = int(tt.inst_i32[:, ce._II_IS_BOX].sum())
    fast = not exact_uv or box_exact_uv
    assert n_box == (wd["scene"].inst_pos.shape[0] if fast else 0)
    # the second triangle of each face differs from the first
    w1 = tt.inst_i32[:, ce._II_FACE_WTRI:ce._II_FACE_WTRI + 6]
    w2 = tt.inst_i32[:, ce._II_FACE_WTRI2:ce._II_FACE_WTRI2 + 6]
    assert bool((w1 != w2).all())


def test_prepare_cast_takes_box_exact_uv_tables(worlds):
    wd = worlds["terrain8"]
    cfg = wd["jw"].config.replace(engine="cuda", edge_aware_grads=True)
    data = ce.prepare_cast(wd["scene"], wd["geom"], cfg)
    want = ce.build_tables(wd["scene"], wd["geom"], exact_uv=True,
                           box_exact_uv=True)
    for f in ("inst_f32", "inst_i32", "tmpl"):
        assert torch.equal(getattr(data.tables, f), getattr(want, f)), f
    assert int(data.tables.inst_i32[:, ce._II_IS_BOX].sum()) > 0


def _near_diagonal(uv):
    """Hits within EPS_DIAG (in barycentric terms) of the boundary of their
    triangle: where a face's two triangles both contain the point."""
    u, v = uv[:, 0], uv[:, 1]
    return np.minimum(np.minimum(u, v), 1.0 - u - v) <= EPS_DIAG


def _port_exact_cast(wd, o, d):
    """The port's exact_uv cast of ``o, d`` (numpy): the walk on terrain8,
    the cull's engine cast (chunks, lists, K4's plain version) on
    terrain6."""
    cfg = convert.config_from_jax(wd["jw"].config.replace(
        engine="pallas", edge_aware_grads=True))
    cast = make_cast(wd["scene"], wd["geom"], cfg)
    return cast(torch.from_numpy(o), torch.from_numpy(d))


@pytest.mark.parametrize("name", ["terrain8", "terrain6"])
@pytest.mark.parametrize("rays", ["primary", "random"])
def test_exact_uv_cast_matches_jax(worlds, name, rays):
    wd = worlds[name]
    o, d = _rays(wd)[rays]
    jcfg = wd["jw"].config.replace(engine="pallas", edge_aware_grads=True)
    jaux = pe.prepare_pallas_cast(wd["jscene"], wd["jgeom"], jcfg)
    jh = jcast_vjp._pallas_chunked_cast(jcfg, jnp.asarray(o), jnp.asarray(d),
                                        jaux)
    th = _port_exact_cast(wd, o, d)
    jv, tv = np.asarray(jh.valid), th.valid.numpy()
    np.testing.assert_array_equal(tv, jv)
    assert jv.sum() > 0
    np.testing.assert_allclose(th.t.numpy()[jv], np.asarray(jh.t)[jv],
                               rtol=1e-5, atol=0)
    juv = np.asarray(jh.uv)[jv]
    tuv = th.uv.numpy()[jv]
    other = th.wtri.numpy()[jv] != np.asarray(jh.wtri)[jv]
    # a different triangle only on a face diagonal; there are none here
    assert bool(_near_diagonal(juv)[other].all())
    assert int(other.sum()) == 0, f"{int(other.sum())} rays on a diagonal"
    np.testing.assert_allclose(tuv, juv, rtol=0, atol=1e-5)
    # the exact branch ran: not every hit has uv (1/3, 1/3)
    assert np.abs(tuv - 1.0 / 3.0).max() > 0.1
    np.testing.assert_array_equal(th.mat.numpy()[jv],
                                  np.asarray(jh.mat)[jv])


@pytest.mark.parametrize("name", ["terrain8", "terrain6"])
@pytest.mark.parametrize("rays", ["primary", "random"])
def test_box_exact_uv_equals_template_loop(worlds, name, rays):
    """K1's and K4's plain versions with the box fast path's exact branch
    against the same casts over tables without any fast path."""
    wd = worlds[name]
    o, d = (torch.from_numpy(x) for x in _rays(wd)[rays])
    fast = ce.build_tables(wd["scene"], wd["geom"], exact_uv=True,
                           box_exact_uv=True)
    loop = ce.build_tables(wd["scene"], wd["geom"], exact_uv=True)
    if name == "terrain8":
        cfg = wd["jw"].config.replace(engine="cuda")
        base = ce.prepare_cast(wd["scene"], wd["geom"], cfg)
        hits = [ce.bvh_cast(o, d, ce.CastData(tables=t, nodes=base.nodes,
                                              ordering=base.ordering),
                            exact_uv=True) for t in (fast, loop)]
    else:
        tile = 8 * cull.LANES
        lay = cull.CullLayout.of(o.shape[0], 1 << 19, tile)
        o_p, d_p = lay.pad_rays(o, d, 1.0e30)
        cand, info = cull.tile_candidates(o_p, d_p, tile, fast.inst_f32,
                                          cull.MAX_CAND)
        hits = [cull.cull_cast(o_p, d_p, cand, info, tile, t, exact_uv=True)
                for t in (fast, loop)]
    hf, hl = hits
    assert torch.equal(hf.valid, hl.valid) and int(hf.valid.sum()) > 0
    v = hf.valid
    # the slab time against the plane time: test_pallas.py's t tolerance
    torch.testing.assert_close(hf.t[v], hl.t[v], rtol=1e-5, atol=1e-5)
    near = torch.from_numpy(_near_diagonal(hl.uv[v].numpy()))
    same = hf.wtri[v] == hl.wtri[v]
    assert bool((same | near).all())
    assert bool(same.all()), f"{int((~same).sum())} rays on a diagonal"
    torch.testing.assert_close(hf.uv[v], hl.uv[v], rtol=0, atol=1e-5)
    torch.testing.assert_close(hf.normal[v], hl.normal[v], rtol=0,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# the forward frame and the loss gradients
# ---------------------------------------------------------------------------

CASES = {
    "terrain8": ("terrain8", {}),
    "terrain6": ("terrain6", {}),
    "terrain6_mxu": ("terrain6", {"pallas_kernel": "mxu"}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_edge_aware_forward_frame_is_unchanged(worlds, case):
    name, change = CASES[case]
    wd = worlds[name]
    cam = convert.camera_from_numpy(jscale_camera(wd["jw"].camera, W, 640),
                                    device="cpu")
    cfg = convert.config_from_jax(wd["jw"].config).replace(
        width=W, height=H, engine="cuda", **change)
    img0 = render_frame(wd["scene"], cam, cfg)
    img1 = render_frame(wd["scene"], cam, cfg.replace(edge_aware_grads=True))
    assert torch.equal(img0, img1)
    assert float(img0[..., :3].amax()) > 0.0


@pytest.fixture(scope="module", params=sorted(CASES))
def grads(worlds, request):
    name, change = CASES[request.param]
    wd = worlds[name]
    jw = wd["jw"]
    jcam_np = jscale_camera(jw.camera, W, jw.config.width)
    jcam = jax.tree_util.tree_map(jnp.asarray, jcam_np)
    jcfg = jw.config.replace(width=W, height=H, engine="pallas",
                             edge_aware_grads=True, **change)
    target = np.random.default_rng(11).uniform(
        0.0, 0.6, (H, W, 4)).astype(np.float32)
    jparams = jdiff.trainable_params(wd["jscene"], jcam,
                                     include_vertices=True)
    jloss, jg = jax.jit(jax.value_and_grad(jdiff.make_loss_fn(
        wd["jscene"], jcam, jcfg, jnp.asarray(target))))(jparams)
    cam = convert.camera_from_numpy(jcam_np, device="cpu")
    cfg = convert.config_from_jax(jcfg)
    out = {}
    for engine in ("torch", "cuda"):
        params = convert.params_from_numpy(jparams, device="cpu")
        loss = diff.make_loss_fn(wd["scene"], cam, cfg.replace(engine=engine),
                                 torch.from_numpy(target))(params)
        out[engine] = (float(loss.detach()), diff.grad_of(loss, params))
    flat, _ = jax.tree_util.tree_flatten_with_path(jg)
    jl = [("/".join(str(p) for p in path), np.asarray(v))
          for path, v in flat]
    return dict(case=request.param, jloss=float(jloss), jl=jl, port=out)


def test_vertex_loss_grads_match_jax_pallas(grads):
    loss, g = grads["port"]["torch"]
    assert loss == pytest.approx(grads["jloss"], rel=1e-5)
    tl = tree.leaves_with_paths(convert.params_to_numpy(g))
    assert [k for k, _ in tl] == [k for k, _ in grads["jl"]]
    for (key, gt), (_, gj) in zip(tl, grads["jl"]):
        assert np.isfinite(gt).all(), key
        if key == "['verts']":
            np.testing.assert_allclose(
                gt, gj, rtol=RTOL_VERTS,
                atol=ATOL_VERTS * float(np.abs(gj).max()),
                err_msg=f"{grads['case']} {key}")
        else:
            np.testing.assert_allclose(gt, gj, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{grads['case']} {key}")
    by_key = dict(tl)
    for key in ("['cam_pos']", "['verts']", "['materials']/.kd",
                "['lights']/.point_col"):
        assert np.abs(by_key[key]).max() > 10 * ATOL, key


def test_vertex_grads_cuda_engine_on_cpu_equal_torch_engine(grads):
    lt, gt = grads["port"]["torch"]
    lc, gc = grads["port"]["cuda"]
    assert lt == lc
    for a, b in zip(tree.leaves(gt), tree.leaves(gc)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# AD against a finite difference
# ---------------------------------------------------------------------------

def _closeup_camera(jw, jscene, width):
    """``tests/test_diff.py``'s close-up, yawed view (35 degrees), of the
    whole terrain."""
    geom = jgeometry.expand_geometry(jscene)
    center = (geom.aabb_min.min(0) + geom.aabb_max.max(0)) / 2
    radius = float(jnp.max(geom.aabb_max.max(0) - geom.aabb_min.min(0))) / 2
    qy = jrm.quat_from_axis_angle(jnp.array([0.0, 1.0, 0.0]),
                                  jnp.float32(35 * np.pi / 180))
    rot = jrm.quat_normalize(jrm.quat_mul(qy, jnp.asarray(jw.camera.rot)))
    fwd = jrm.normalize(jrm.quat_to_mat(rot)[:, 2])
    cam = dataclasses.replace(
        jax.tree_util.tree_map(jnp.asarray, jw.camera),
        pos=center - fwd * (3.0 * radius), rot=rot)
    return jax.tree_util.tree_map(
        np.asarray, jscale_camera(cam, width, jw.config.width))


def _scaled(scene, s):
    """``scene`` with every mesh vertex scaled by ``1 + s``, and the mesh
    bounding boxes with them: the JAX package reads the stored boxes, which
    must bound the geometry (the port derives its own from the vertices)."""
    return dataclasses.replace(scene, verts=scene.verts * (1.0 + s),
                               mesh_aabb_min=scene.mesh_aabb_min * (1.0 + s),
                               mesh_aabb_max=scene.mesh_aabb_max * (1.0 + s))


def test_vertex_scaling_ad_over_fd_matches_jax(worlds):
    """Scaling the cube vertices sweeps every silhouette (``tests/
    test_diff.py``'s check, at spp=1): AD and a central difference (h =
    0.03) of the mean RGB are both positive, and the AD/FD ratio (below 1:
    the band's one-sided occlusion bias) is the JAX package's to 1e-3."""
    wd = worlds["terrain8"]
    jw, jscene = wd["jw"], wd["jscene"]
    w, h = 96, 72
    cam_np = _closeup_camera(jw, jscene, w)
    jcam = jax.tree_util.tree_map(jnp.asarray, cam_np)
    jcfg = jw.config.replace(width=w, height=h, edge_aware_grads=True,
                             recurse_depth=0, edge_px=1.5, engine="pallas",
                             pallas_kernel="scalar")
    step = 0.03

    def jloss(s):
        return jnp.mean(jrender_frame(_scaled(jscene, s), jcam, jcfg)[..., :3])

    j_ad = float(jax.grad(jloss)(0.0))
    j_fd = (float(jloss(step)) - float(jloss(-step))) / (2 * step)

    cam = convert.camera_from_numpy(cam_np, device="cpu")
    cfg = convert.config_from_jax(jcfg)

    def loss(s):
        return torch.mean(render_frame(_scaled(wd["scene"], s), cam,
                                       cfg)[..., :3])

    s0 = torch.zeros((), requires_grad=True)
    ad = float(torch.autograd.grad(loss(s0), s0)[0])
    with torch.no_grad():
        fd = (float(loss(torch.tensor(step)))
              - float(loss(torch.tensor(-step)))) / (2 * step)
    print(f"vertex scaling, terrain8 {w}x{h}: AD {ad:.6g} FD {fd:.6g} "
          f"AD/FD {ad / fd:.6g}; JAX package AD {j_ad:.6g} FD {j_fd:.6g} "
          f"AD/FD {j_ad / j_fd:.6g}")
    assert ad > 0.0 and fd > 0.0 and j_ad > 0.0 and j_fd > 0.0
    assert ad / fd == pytest.approx(j_ad / j_fd, rel=1e-3), (ad, fd, j_ad,
                                                             j_fd)
    assert 0.5 < ad / fd < 1.6


# ---------------------------------------------------------------------------
# the vertices scaled alone: stale stored mesh boxes (ROADMAP Queue 3 C)
# ---------------------------------------------------------------------------

STEP = 0.03
SCALES = (-STEP, 0.0, STEP)
STALE_W, STALE_H = 96, 72
# pixels of the JAX package's Pallas frame with stale boxes (its tile walk)
# that differ from the exact frame at s = +STEP, on terrain8 96x72
STALE_PALLAS_PIXELS = 0


@pytest.fixture(scope="module")
def stale(worlds):
    """``tests/test_diff.py``'s setup: terrain8's vertices scaled by ``1 +
    s`` alone, as the same numpy arrays in both packages, which leaves the
    stored mesh boxes stale.  The JAX package gets the scene twice: with
    the boxes scaled too (fresh, which bound the geometry; ``min(v) * f ==
    min(v * f)`` for ``f > 0`` in every rounding) and stale.  Frames of the
    close-up camera at 96x72 with ``edge_aware_grads``."""
    wd = worlds["terrain8"]
    jw, jscene = wd["jw"], wd["jscene"]
    cam_np = _closeup_camera(jw, jscene, STALE_W)
    jcam = jax.tree_util.tree_map(jnp.asarray, cam_np)
    jcfg = jw.config.replace(width=STALE_W, height=STALE_H,
                             edge_aware_grads=True, recurse_depth=0,
                             edge_px=1.5, engine="pallas",
                             pallas_kernel="scalar")
    verts = np.asarray(jw.scene.verts, np.float32)
    bmin = np.asarray(jw.scene.mesh_aabb_min, np.float32)
    bmax = np.asarray(jw.scene.mesh_aabb_max, np.float32)
    out = dict(wd=wd, jcam=jcam, jcfg=jcfg, cam=convert.camera_from_numpy(
        cam_np, device="cpu"), cfg=convert.config_from_jax(jcfg), scenes={},
        frames={}, jframes={})
    for s in SCALES:
        f = np.float32(1.0 + s)
        v = verts * f
        fresh = dataclasses.replace(jscene, verts=jnp.asarray(v),
                                    mesh_aabb_min=jnp.asarray(bmin * f),
                                    mesh_aabb_max=jnp.asarray(bmax * f))
        scene = dataclasses.replace(wd["scene"], verts=torch.from_numpy(v))
        out["scenes"][s] = (scene, fresh, dataclasses.replace(
            jscene, verts=jnp.asarray(v)))
        out["jframes"][s] = np.asarray(jrender_frame(fresh, jcam, jcfg))
        with torch.no_grad():
            out["frames"][s] = render_frame(scene, out["cam"],
                                            out["cfg"]).numpy()
    return out


@pytest.mark.parametrize("s", SCALES)
def test_vertex_scaling_frame_equals_jax_with_fresh_boxes(stale, s):
    """The port derives the mesh boxes from the vertices
    (``geometry.mesh_boxes``), so with the vertices scaled alone its frame
    is the JAX package's frame of the scene whose boxes were scaled too,
    at the frame tolerance; those boxes are the port's bit for bit."""
    scene, fresh, _ = stale["scenes"][s]
    lo, hi = geometry.mesh_boxes(scene)
    assert np.array_equal(lo.numpy(), np.asarray(fresh.mesh_aabb_min))
    assert np.array_equal(hi.numpy(), np.asarray(fresh.mesh_aabb_max))
    np.testing.assert_allclose(stale["frames"][s], stale["jframes"][s],
                               rtol=0.0, atol=1e-5)


def test_vertex_scaling_primary_hits_equal_brute_oracle(stale):
    """At s = +STEP the scaled cubes poke out of their stale stored boxes:
    the port's primary hits (the walk's plain version, exact_uv) equal the
    JAX package's brute-force oracle on the stale scene, which reads no
    box: valid exactly, t at rtol 1e-5 (the slab time against the plane
    time; ``tests/test_pallas.py``'s ``_compare``), and the port's triangle
    is one the ray hits at that t.  Neighbouring cubes now overlap, and the
    top faces of two cubes of one height are coplanar: where both are hit
    at one t the two casts may name either instance (a tie), so the box
    face is compared where the instance agrees."""
    scene, fresh, jstale = stale["scenes"][STEP]
    ro, rd = jgeometry.camera_rays(stale["jcam"], STALE_W, STALE_H)
    ro = np.array(ro, np.float32).reshape(-1, 3)
    rd = np.array(rd, np.float32).reshape(-1, 3)
    jgeom = jgeometry.expand_geometry(jstale)
    hb = make_brute_cast(jgeom)(jnp.asarray(ro), jnp.asarray(rd))
    cast = make_cast(scene, geometry.expand_geometry(scene), stale["cfg"])
    with torch.no_grad():
        hp = cast(torch.from_numpy(ro), torch.from_numpy(rd))
    vb = np.asarray(hb.valid)
    assert np.array_equal(hp.valid.numpy(), vb) and vb.sum() > 0
    tb = np.asarray(hb.t)[vb]
    np.testing.assert_allclose(hp.t.numpy()[vb], tb, rtol=1e-5)
    wp, wb = hp.wtri.numpy()[vb], np.asarray(hb.wtri)[vb]
    own, t_own, _ = jrm.ray_triangle_areas(
        jnp.asarray(ro[vb]), jnp.asarray(rd[vb]), jgeom.a[wp], jgeom.b[wp],
        jgeom.c[wp])
    assert np.asarray(own).all()
    np.testing.assert_allclose(np.asarray(t_own), tb, rtol=1e-5)
    face_of = np.asarray(pe._detect_box_meshes(fresh)[3])
    wtri_tri = np.asarray(jstale.wtri_tri)
    inst = np.asarray(jgeom.inst)
    same = inst[wp] == inst[wb]
    print(f"stale boxes, s = +{STEP}: {int(vb.sum())} hits, "
          f"{int((~same).sum())} ties between overlapping cubes")
    assert np.array_equal(face_of[wtri_tri[wp[same]]],
                          face_of[wtri_tri[wb[same]]])


def test_vertex_scaling_fd_and_ad_equal_jax_with_fresh_boxes(stale):
    """The vertices scaled alone: the port's central difference (h = STEP)
    of the mean RGB is the JAX package's with the boxes scaled too, at rel
    1e-4, and so is its AD at s = 0 (rel 1e-5)."""
    fr, jf = stale["frames"], stale["jframes"]
    fd = (float(fr[STEP][..., :3].mean()) - float(fr[-STEP][..., :3].mean())
          ) / (2 * STEP)
    j_fd = (float(jf[STEP][..., :3].mean()) - float(jf[-STEP][..., :3].mean())
            ) / (2 * STEP)
    jscene = stale["wd"]["jscene"]

    def jloss(s):
        return jnp.mean(jrender_frame(_scaled(jscene, s), stale["jcam"],
                                      stale["jcfg"])[..., :3])

    j_ad = float(jax.grad(jloss)(0.0))
    s0 = torch.zeros((), requires_grad=True)
    scene = dataclasses.replace(stale["wd"]["scene"],
                                verts=stale["wd"]["scene"].verts * (1.0 + s0))
    ad = float(torch.autograd.grad(torch.mean(render_frame(
        scene, stale["cam"], stale["cfg"])[..., :3]), s0)[0])
    print(f"vertex scaling, vertices alone, terrain8 {STALE_W}x{STALE_H}: AD "
          f"{ad:.6g} FD {fd:.6g}; JAX package, boxes scaled too: AD "
          f"{j_ad:.6g} FD {j_fd:.6g}")
    assert fd > 0.0
    assert fd == pytest.approx(j_fd, rel=1e-4)
    assert ad == pytest.approx(j_ad, rel=1e-5)


def test_vertex_scaling_with_stale_boxes_differs_from_jax(stale):
    """A reference-side quirk, not the port's.  With the boxes stale, a
    scaled-up cube is no box mesh (the template loop) and pokes out of its
    instance box; the JAX package's Pallas tile walk tests a leaf's
    triangles for every ray of a tile once one ray's box test passes, so
    which of the hits outside the box it finds depends on its tiling.
    Vertical rays through the sliver that the scaled border cube adds
    beyond its stale box's +x face reach no stale box: alone in a tile the
    JAX cast misses every one; with one ray through the cube's centre in
    the same tile it finds them all.  The port's hits (and the brute
    oracle's) are the same in both.  On the close-up frame the quirk shows
    in STALE_PALLAS_PIXELS pixels at s = +STEP and none at s = -STEP, where
    the geometry shrinks inside its stale boxes (ROADMAP, reference-side
    faults)."""
    for s, n_differ in ((-STEP, 0), (STEP, STALE_PALLAS_PIXELS)):
        jf = np.asarray(jrender_frame(stale["scenes"][s][2], stale["jcam"],
                                      stale["jcfg"]))
        differ = np.abs(stale["frames"][s] - jf).max(-1) > 1e-5
        assert int(differ.sum()) == n_differ, (s, int(differ.sum()))

    scene, fresh, jstale = stale["scenes"][STEP]
    jg_stale = jgeometry.expand_geometry(jstale)
    lo_s, hi_s = (np.asarray(jg_stale.aabb_min), np.asarray(jg_stale.aabb_max))
    hi_f = np.asarray(jgeometry.expand_geometry(fresh).aabb_max)
    border = np.flatnonzero(hi_s[:, 0] == hi_s[:, 0].max())
    k = border[np.argmax(hi_s[border, 1])]  # the top cube of a border column
    assert hi_f[k, 0] > hi_s[k, 0]
    n = 1024  # one tile of 8 x 128 rays
    f = np.float32
    x = np.linspace(hi_s[k, 0], hi_f[k, 0], n + 2, dtype=f)[1:-1]
    z = np.linspace(lo_s[k, 2], hi_s[k, 2], n + 2, dtype=f)[1:-1]
    o = np.stack([x, np.full(n, hi_f[k, 1] + 2.0, f), z], -1)
    d = np.tile(f([0.0, -1.0, 0.0]), (n, 1))
    centre = o[-1:].copy()
    centre[0, 0] = f(0.5) * (lo_s[k, 0] + hi_s[k, 0])
    o_mixed = np.concatenate([o[:-1], centre])
    jcast = pe.make_pallas_cast(jstale, jg_stale, stale["jcfg"], tile_rows=8)
    port = make_cast(scene, geometry.expand_geometry(scene), stale["cfg"])
    brute = make_brute_cast(jg_stale)
    for rays, j_hits in ((o, 0), (o_mixed, n)):
        jh = jcast(jnp.asarray(rays), jnp.asarray(d))
        hb = brute(jnp.asarray(rays), jnp.asarray(d))
        with torch.no_grad():
            hp = port(torch.from_numpy(rays), torch.from_numpy(d))
        assert int(np.asarray(jh.valid).sum()) == j_hits
        assert np.asarray(hb.valid).all() and hp.valid.all()
        np.testing.assert_allclose(hp.t.numpy(), np.asarray(hb.t), rtol=1e-5)


@pytest.mark.parametrize("world", ["terrain8", "terrain6", "spheres",
                                   "random_meshes"])
def test_mesh_boxes_equal_stored_boxes(worlds, world):
    """``geometry.mesh_boxes`` of an unedited scene is bit-equal to the
    loader's ``mesh_aabb_min/max``: on the terrains (box meshes), on the
    JAX package's icosphere world (the template loop) and on a world of
    seeded random triangles with an empty mesh and unreferenced vertices
    (which keeps zeros, and which no box counts)."""
    if world in worlds:
        scene = worlds[world]["scene"]
    elif world == "spheres":
        scene = convert.scene_from_numpy(synth.make_sphere_world(8)[0],
                                         device="cpu")
    else:
        rng = np.random.default_rng(11)
        sb = SceneBuilder()
        mat = Material(kd=np.array([0.5, 0.5, 0.5, 1.0], np.float32))
        for n_tris in (7, 0, 3):
            mb = sb.get_mesh_builder(sb.create_mesh())
            ids = [sb.add_vertex(v) for v in
                   rng.uniform(-3, 3, (n_tris + 2, 3)).astype(np.float32)]
            sb.add_vertex(np.float32([40.0, -40.0, 40.0]))  # unreferenced
            for k in range(n_tris):
                mb.add_triangle([ids[k], ids[k + 1], ids[k + 2]],
                                TextureCoords(), mat)
            sb.add_trans(mb)
        scene = to_device(sb.finish(), "cpu")
        assert torch.equal(scene.mesh_aabb_min[1], torch.zeros(3))
    lo, hi = geometry.mesh_boxes(scene)
    assert torch.equal(lo, scene.mesh_aabb_min)
    assert torch.equal(hi, scene.mesh_aabb_max)


# ---------------------------------------------------------------------------
# the material gather
# ---------------------------------------------------------------------------

def test_material_gather_forward_bit_equal_and_backward_sums(worlds):
    """The packed gather gives the eight row gathers' values bit for bit;
    its blocked-sum backward gives the gather's autograd (up to the order
    of additions)."""
    mats = worlds["terrain8"]["scene"].materials
    rng = np.random.default_rng(3)
    k = mats.kd.shape[0]
    idx = torch.from_numpy(rng.integers(0, k, 4099).astype(np.int32))
    leaves = {f.name: getattr(mats, f.name).detach().clone()
              .requires_grad_(True) for f in dataclasses.fields(mats)}
    rows = shading.gather_material_rows(type(mats)(**leaves), idx)
    plain = {n: x[idx.long()] for n, x in leaves.items()}
    cots = {n: torch.from_numpy(rng.standard_normal(
        tuple(plain[n].shape)).astype(np.float32)) for n in plain}
    for n in plain:
        assert torch.equal(getattr(rows, n), plain[n]), n
    names = sorted(plain)
    got = torch.autograd.grad([getattr(rows, n) for n in names],
                              [leaves[n] for n in names],
                              [cots[n] for n in names])
    want = torch.autograd.grad([plain[n] for n in names],
                               [leaves[n] for n in names],
                               [cots[n] for n in names])
    for n, a, b in zip(names, got, want):
        # ~1,400 unit cotangents a material, added in another order: the
        # sum of their magnitudes (~1,100) times a few f32 epsilons
        torch.testing.assert_close(a, b, rtol=1e-5, atol=2e-4, msg=n)
        assert float(a.abs().max()) > 0.0, n
