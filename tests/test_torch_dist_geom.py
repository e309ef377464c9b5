"""The port's geometry sharding (``raytracer_tpu_torch/dist.py``) against
the JAX package's and against its own single-process results, on the CPU:
the instance split, the merged cast's frame, the ring cast and the
geometry-sharded training step.

One launch of 4 ranks on gloo (a 2x2 ``("rays", "geom")`` mesh,
``tests/torch_dist_ranks.py`` ``geom``) computes the port's side; the JAX
side runs ``engine="pallas"`` (Pallas in interpret mode) on the test
process's virtual CPU devices.  terrain8's 380 instances split into 2
shards of 191 (190 and the parked pad instance): each shard takes the
candidate-list cull, where the whole scene takes the LBVH walk.

* ``split_scene_by_instances`` equals the JAX arrays exactly.
* The frame (64x48, ``engine="torch"``) equals the single-process frame at
  1e-5 (the shards' cull against the whole scene's walk) and the JAX
  ``make_geom_sharded_render`` frame on ``make_mesh2d(2, 2)`` at 1e-5, save
  1 pixel in 10,000 (``test_torch_bounce.assert_frame_matches_jax``).
* The ring cast on the 2 geom shards equals the full cast
  (``tests/test_dist.py``'s ring test) and the JAX package's ring cast on
  ``make_mesh2d(2, 2)``: ``valid``, ``wtri`` and ``mat`` exact, ``t``
  rtol 1e-5 and normals atol 1e-5 on the hits, uv atol 1e-5.
* The geometry-sharded step (32x32; materials, lights, camera and vertices
  under ``edge_aware_grads``; a sum over ``rays``, a mean over ``geom``)
  equals the single-process grads and the JAX package's sharded grads at
  ``tests/test_dist.py``'s rtol 2e-4 / atol 1e-7.
"""

import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import raytracer_tpu as jrt
from raytracer_tpu import diff as jdiff
from raytracer_tpu import dist as jdist
from raytracer_tpu.builder import scale_camera as jscale_camera
from raytracer_tpu.render.geometry import camera_rays as jcamera_rays
from raytracer_tpu.scene import device_scene

from raytracer_tpu_torch import convert, diff, dist
from raytracer_tpu_torch.render import engine
from raytracer_tpu_torch.render.geometry import camera_rays, expand_geometry

from test_torch_bounce import assert_frame_matches_jax
from torch_dist_ranks import RING, STEP, step_target

torch.set_num_threads(2)

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
WORLD = os.path.join(REPO, "raytracer_tpu_torch", "worlds", "terrain8.json")
RTOL_GEOM, ATOL_GEOM = 2e-4, 1e-7  # tests/test_dist.py's geometry step


def _terrain(w, h, **change):
    jw = jrt.generate(WORLD)
    cam = jscale_camera(jw.camera, w, jw.config.width)
    jcfg = jw.config.replace(width=w, height=h, engine="pallas",
                             pallas_kernel="scalar", **change)
    return dict(jscene=device_scene(jw.scene),
                jcam=jax.tree_util.tree_map(jnp.asarray, cam), jcfg=jcfg,
                scene=convert.scene_from_numpy(jw.scene, device="cpu"),
                cam=convert.camera_from_numpy(cam, device="cpu"),
                cfg=convert.config_from_jax(jcfg).replace(engine="torch"))


@pytest.fixture(scope="module")
def geom():
    """The 4-rank launch on the 2x2 mesh; rank r sits at (r // 2, r % 2)."""
    t0 = time.perf_counter()
    out = dist.launch("torch_dist_ranks:geom", 4, backend="gloo",
                      device="cpu", threads=1, timeout=240.0,
                      pythonpath=[TESTS])
    print(f"geom launch: {time.perf_counter() - t0:.1f} s")
    return [r["result"] for r in out]


@pytest.mark.parametrize("n_shards", [2, 4])
def test_split_matches_jax(n_shards):
    t = _terrain(64, 48)
    got = dist.split_scene_by_instances(t["scene"], n_shards)
    want = jdist.split_scene_by_instances(t["jscene"], n_shards)
    assert sorted(got) == sorted(want)
    for k in got:
        w = np.asarray(want[k])
        assert got[k].dtype == w.dtype and np.array_equal(got[k], w), k
    n = t["scene"].inst_pos.shape[0]
    per = -(-n // n_shards) + 1
    assert got["inst_pos"].shape[1] == per
    assert (got["inst_pos"][:, per - 1] == 1e30).all()  # the parked pad


def test_geom_sharded_frame_matches_single_and_jax(geom):
    t = _terrain(64, 48)
    single = engine.render_frame(t["scene"], t["cam"], t["cfg"])
    for r in geom:
        assert torch.equal(r["frame"], geom[0]["frame"])
    img = geom[0]["frame"]
    assert float((img - single).abs().max()) <= 1e-5
    assert float((img[..., :3].amax(-1) > 0).float().mean()) > 0.05
    jimg = np.asarray(jdist.make_geom_sharded_render(
        t["jscene"], t["jcam"], t["jcfg"], jdist.make_mesh2d(2, 2))())
    assert_frame_matches_jax(img, jimg)


def _jax_ring(t):
    """The JAX package's ring cast (``make_ring_geom_cast`` under
    ``shard_map`` on ``make_mesh2d(2, 2)``) of the ``RING`` primary rays,
    each ``rays`` row of the mesh casting its block of rows."""
    jscene, jcfg = t["jscene"], t["jcfg"]
    ro, rd = jcamera_rays(t["jcam"], *RING)
    shards = jdist.split_scene_by_instances(jscene, 2)

    def body(shards_, ro_b, rd_b):
        shard = jax.tree_util.tree_map(lambda x: x[0], shards_)
        h = jdist.make_ring_geom_cast(jscene, jcfg, shard)(ro_b, rd_b)
        return h.valid, h.t, h.wtri, h.uv, h.normal, h.mat

    ray = P(jdist.RAY_AXIS)
    out = jax.shard_map(
        body, mesh=jdist.make_mesh2d(2, 2),
        in_specs=(P(jdist.GEOM_AXIS), ray, ray), out_specs=(ray,) * 6,
        check_vma=False)(shards, ro.reshape(-1, 3), rd.reshape(-1, 3))
    return dict(zip(("valid", "t", "wtri", "uv", "normal", "mat"),
                    (np.asarray(x) for x in out)))


def test_ring_cast_matches_full_cast_and_jax(geom):
    """Rank (i, j) holds the hits of ray block i; both geom ranks of a
    block agree, and the blocks together equal the full scene's cast and
    the JAX package's ring cast (its strict-< fold, its shard passing, a
    miss keeping wtri 0)."""
    t = _terrain(*RING)
    ro, rd = camera_rays(t["cam"], *RING)
    scene = t["scene"]
    want = engine.make_cast(scene, expand_geometry(scene), t["cfg"])(
        ro.reshape(-1, 3), rd.reshape(-1, 3))
    got = {k: torch.cat([geom[0]["ring"][k], geom[2]["ring"][k]])
           for k in geom[0]["ring"]}
    for a, b in ((0, 1), (2, 3)):
        for k, v in geom[a]["ring"].items():
            assert torch.equal(v, geom[b]["ring"][k]), k
    assert torch.equal(got["valid"], want.valid)
    both = want.valid
    assert int(both.sum()) > 0.05 * both.numel()
    np.testing.assert_allclose(got["t"][both], want.t[both], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got["normal"][both], want.normal[both],
                               atol=1e-5)
    assert torch.equal(got["mat"][both], want.mat[both])
    assert torch.equal(got["wtri"][both], want.wtri[both])  # global ids
    assert (got["wtri"][~both] == 0).all()  # a miss keeps 0, as in JAX

    jr = _jax_ring(t)
    for k in ("valid", "wtri", "mat"):  # misses included
        assert np.array_equal(got[k].numpy(), jr[k]), k
    for k in ("t", "normal"):
        np.testing.assert_allclose(got[k][both], jr[k][both], rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    np.testing.assert_allclose(got["uv"], jr["uv"], atol=1e-5)


def _jax_geom_grads(t, target):
    """``tests/test_dist.py``'s geometry-sharded step on a 2x2 mesh:
    rays from the merged camera, each device's row block through
    ``geom_sharded_render_rays``, psum over rays and pmean over geom."""
    jscene, jcam, jcfg = t["jscene"], t["jcam"], t["jcfg"]
    h, w = target.shape[:2]
    params = jdiff.trainable_params(jscene, jcam, include_vertices=True)
    mesh = jdist.make_mesh2d(2, 2)
    shards = jdist.split_scene_by_instances(jscene, 2)
    n_px = float(target.size)
    rows = h // 2

    def shard_loss(p_, shard, tgt_b):
        shard = jax.tree_util.tree_map(lambda x: x[0], shard)
        s, c = jdiff.merge_params(jscene, jcam, p_)
        ro, rd = jcamera_rays(c, w, h)
        i = jax.lax.axis_index(jdist.RAY_AXIS)
        ro_b = jax.lax.dynamic_slice_in_dim(ro, i * rows, rows, 0)
        rd_b = jax.lax.dynamic_slice_in_dim(rd, i * rows, rows, 0)
        pixel_angle = 1.0 / (jcam.unit_to_pixels * jcam.global_near)
        img = jdist.geom_sharded_render_rays(s, jcfg, shard, ro_b, rd_b,
                                             pixel_angle=pixel_angle)
        return jnp.sum((img - tgt_b) ** 2) / n_px

    def body(p_, shard, tgt_b):
        g = jax.grad(shard_loss)(p_, shard, tgt_b)
        return jax.lax.pmean(jax.lax.psum(g, jdist.RAY_AXIS), jdist.GEOM_AXIS)

    g = jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(), P(jdist.GEOM_AXIS), P(jdist.RAY_AXIS)), out_specs=P(),
        check_vma=False))(params, shards, jnp.asarray(target))
    return {"/".join(str(p) for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(g)[0]}


def test_geom_sharded_step_matches_single_and_jax(geom):
    t = _terrain(*STEP, early_exit=False, edge_aware_grads=True)
    target = step_target(*STEP)
    params = diff.trainable_params(t["scene"], t["cam"],
                                   include_vertices=True)
    loss = diff.make_loss_fn(t["scene"], t["cam"], t["cfg"],
                             torch.from_numpy(target))(params)
    single = dist.flat_tree(diff.grad_of(loss, params))
    jg = _jax_geom_grads(t, target)
    assert sorted(single) == sorted(jg)
    for r in geom:
        assert r["staged"] == []  # gloo on the CPU: nothing staged
        assert float(r["step"]["loss"]) == pytest.approx(
            float(loss.detach()), rel=1e-5)
        g = r["step"]["grads"]
        assert sorted(g) == sorted(single)
        for key in g:
            for ref in (single[key], jg[key]):
                np.testing.assert_allclose(g[key], ref, rtol=RTOL_GEOM,
                                           atol=ATOL_GEOM, err_msg=key)
    for key in ("['verts']", "['cam_pos']", "['materials']/.kd"):
        assert np.abs(np.asarray(geom[0]["step"]["grads"][key])).max() > 1e-5


@pytest.mark.parametrize("factory", ["make_geom_sharded_cast",
                                     "make_ring_geom_cast"])
def test_merged_casts_refuse_the_mxu_cast(factory):
    """The merges read each shard's normal and material, which the MXU cast
    does not give: both factories raise before touching the mesh."""
    t = _terrain(64, 48)
    shard = dist.take_shard(dist.split_scene_by_instances(t["scene"], 2), 0,
                            "cpu")
    with pytest.raises(ValueError, match="scalar cast"):
        getattr(dist, factory)(t["scene"],
                               t["cfg"].replace(pallas_kernel="mxu"), shard,
                               None)
