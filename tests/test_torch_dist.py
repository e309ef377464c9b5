"""The port's distribution layer (``raytracer_tpu_torch/dist.py``) against
the JAX package's ``raytracer_tpu/dist.py`` and against its own
single-process results, on the CPU: row sharding, the training steps, the
multi-process cluster, the dryrun step and the launcher.

The port's ranks are processes on gloo (``dist.launch``, each under a
wall-clock timeout; their functions are in ``tests/torch_dist_ranks.py``).
The JAX side runs on the test process's virtual CPU devices with
``engine="pallas"`` (Pallas in interpret mode), as its own tests run it;
both packages build terrain8 from the port's world file.

* Row sharding on 2 ranks, terrain8 at 64x48, ``engine="torch"``: the
  frame equals the port's single-process ``render_frame`` bit for bit (the
  LBVH walk: a ray's hit does not depend on its batch) and the JAX
  ``make_sharded_render`` frame on 2 devices at 1e-5 (save 1 pixel in
  10,000, ``test_torch_bounce.assert_frame_matches_jax``); cyclic bands
  equal contiguous stripes bit for bit; 64x52 pads 52 rows to 64 and
  crops them; spp 3 equals the single-process spp frame bit for bit and
  differs from the spp-1 frame.
* The row-sharded step (32x32; materials, lights, camera): loss and every
  all-reduced gradient leaf equal the single-process ``grad_of`` of the same
  loss at rtol 1e-5 / atol 1e-6.
* The cluster: 2 processes over TCP agree on a frame sum, and an
  all-reduce of ``arange(16)^2`` reads 1240.0.
* ``dryrun_multichip(2)`` (32x16): its loss and grads equal the same step
  of the JAX package on a 2-device ``shard_map`` (``__graft_entry__.py``'s
  step, written out here on terrain8) at rtol 1e-5 / atol 1e-6, vertices
  rtol 1e-4 / atol 1e-6 max|g|.
* A rank that raises fails the launch at once with its stderr; a rank
  that hangs fails it at the timeout; neither the module nor a rank holds
  JAX.
"""

import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

import raytracer_tpu as jrt
from raytracer_tpu import diff as jdiff
from raytracer_tpu import dist as jdist
from raytracer_tpu.builder import scale_camera as jscale_camera
from raytracer_tpu.render import engine as jengine
from raytracer_tpu.render.geometry import camera_rays as jcamera_rays
from raytracer_tpu.render.geometry import expand_geometry as jexpand
from raytracer_tpu.scene import device_scene

from raytracer_tpu_torch import convert, diff, dist
from raytracer_tpu_torch.render import engine

from test_torch_bounce import assert_frame_matches_jax
from torch_dist_ranks import FRAMES, STEP, step_target

torch.set_num_threads(2)

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
WORLD = os.path.join(REPO, "raytracer_tpu_torch", "worlds", "terrain8.json")
RTOL, ATOL = 1e-5, 1e-6
RTOL_VERTS, ATOL_VERTS = 1e-4, 1e-6  # atol relative to max |g|
TIMEOUT = 240.0


def launch(role, n, **kw):
    return dist.launch(role, n, backend="gloo", device="cpu", threads=2,
                       timeout=TIMEOUT, pythonpath=[TESTS], **kw)


def _terrain(w, h, **change):
    """Both packages' terrain8 at ``w`` x ``h`` (the full field of view);
    the port's config takes ``engine="torch"``."""
    jw = jrt.generate(WORLD)
    cam = jscale_camera(jw.camera, w, jw.config.width)
    jcfg = jw.config.replace(width=w, height=h, engine="pallas", **change)
    return dict(jscene=device_scene(jw.scene),
                jcam=jax.tree_util.tree_map(jnp.asarray, cam), jcfg=jcfg,
                scene=convert.scene_from_numpy(jw.scene, device="cpu"),
                cam=convert.camera_from_numpy(cam, device="cpu"),
                cfg=convert.config_from_jax(jcfg).replace(engine="torch"))


def _jax_flat(jg):
    return {"/".join(str(p) for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(jg)[0]}


def _assert_grads(g, ref, rtol=RTOL, atol=ATOL):
    """Flat gradient dicts leaf by leaf (``verts`` at rtol 1e-4 / atol
    1e-6 max|g|); the camera and light grads must be non-zero."""
    assert sorted(g) == sorted(ref)
    for key in g:
        a, b = np.asarray(g[key]), np.asarray(ref[key])
        assert np.isfinite(a).all(), key
        if key == "['verts']":
            np.testing.assert_allclose(
                a, b, rtol=RTOL_VERTS,
                atol=ATOL_VERTS * float(np.abs(b).max()), err_msg=key)
        else:
            np.testing.assert_allclose(a, b, rtol=rtol, atol=atol,
                                       err_msg=key)
    for key in ("['cam_pos']", "['lights']/.point_col"):
        assert np.abs(np.asarray(g[key])).max() > 10 * ATOL, key


@pytest.fixture(scope="module")
def rows():
    """The 2-rank row-sharding launch (``torch_dist_ranks.rows``)."""
    t0 = time.perf_counter()
    out = launch("torch_dist_ranks:rows", 2)
    print(f"rows launch: {time.perf_counter() - t0:.1f} s")
    return [r["result"] for r in out]


def _port_single(key):
    w, h, change, _ = FRAMES[key]
    t = _terrain(w, h, **change)
    return engine.render_frame(t["scene"], t["cam"], t["cfg"]), t


def _jax_sharded(t, balance="contiguous"):
    mesh = jdist.make_mesh(jax.devices()[:2])
    return np.asarray(jdist.make_sharded_render(
        t["jscene"], t["jcam"], t["jcfg"], mesh, balance=balance)())


@pytest.mark.parametrize("key", ["contiguous", "uneven"])
def test_row_sharded_frame_matches_single_and_jax(rows, key):
    single, t = _port_single(key)
    for r in rows:  # every rank holds the whole frame
        assert torch.equal(r[key], single), key
    img = rows[0][key]
    assert img.shape == (FRAMES[key][1], FRAMES[key][0], 4)
    assert float((img[..., :3].amax(-1) > 0).float().mean()) > 0.05
    assert_frame_matches_jax(img, _jax_sharded(t))


@pytest.mark.parametrize("key", ["cyclic", "uneven_cyclic"])
def test_cyclic_bands_equal_contiguous(rows, key):
    """Band b of 8 rows on rank b mod 2: the same frame, bit for bit, and
    the JAX package's cyclic frame."""
    plain = key.replace("cyclic", "contiguous").replace("_contiguous", "")
    for r in rows:
        assert torch.equal(r[key], r[plain])
    _, t = _port_single(key)
    assert_frame_matches_jax(rows[0][key], _jax_sharded(t, "cyclic"))


def test_row_sharded_spp_frame(rows):
    """spp 3: the single-process spp frame bit for bit (the same jitter
    sweep, the same order of sums), not the spp-1 frame, and the JAX
    package's sharded spp frame."""
    single, t = _port_single("spp")
    for r in rows:
        assert torch.equal(r["spp"], single)
    assert float((rows[0]["spp"] - rows[0]["contiguous"]).abs().max()) > 1e-6
    assert_frame_matches_jax(rows[0]["spp"], _jax_sharded(t))


def test_row_sharded_step_matches_single(rows):
    t = _terrain(*STEP, early_exit=False)
    params = diff.trainable_params(t["scene"], t["cam"])
    loss = diff.make_loss_fn(t["scene"], t["cam"], t["cfg"], torch.from_numpy(
        step_target(*STEP)))(params)
    ref = dist.flat_tree(diff.grad_of(loss, params))
    for r in rows:
        assert float(r["step"]["loss"]) == pytest.approx(
            float(loss.detach()), rel=RTOL)
        _assert_grads(r["step"]["grads"], ref)


def test_two_process_cluster():
    """``initialize_distributed`` over TCP on 2 processes: the same
    row-sharded frame sum on both, and the all-reduce of each rank's share
    of ``arange(16)^2`` reads 1240.0 on both."""
    out = launch("cluster", 2, kwargs={"width": 32, "height": 32})
    lines = [r["stdout"].strip().splitlines()[-1] for r in out]
    sums = {line.split()[2] for line in lines}
    assert len(sums) == 1 and sums.pop().startswith("frame_sum="), lines
    assert all(line.endswith("collective=1240.0") for line in lines), lines
    assert out[0]["result"]["frame_sum"] > 0.0


def _jax_dryrun_step(n, width, height):
    """``__graft_entry__.dryrun_multichip``'s step on terrain8 (that file
    loads a world this repo does not hold): the Pallas cast, spp 2 as a
    checkpointed sample scan over each device's row block, edge-aware
    vertex, camera, material and light grads, psum over ``rays``.  Returns
    ``(loss, grads)``."""
    from jax.sharding import Mesh

    jw = jrt.generate(WORLD)
    cfg = jw.config.replace(width=width, height=height,
                            ray_chunk=width * height, early_exit=False,
                            shadow_steps=2, engine="pallas",
                            pallas_kernel="scalar", spp=2,
                            edge_aware_grads=True)
    scene = device_scene(jw.scene)
    camera = jax.tree_util.tree_map(
        jnp.asarray, jscale_camera(jw.camera, width, jw.config.width))
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("rays",))
    params = jdiff.trainable_params(scene, camera, include_camera=True,
                                    include_vertices=True)
    target = jnp.zeros((height, width, 4), jnp.float32)
    rows_per = height // n
    n_px = float(height * width * 4)

    def shard_loss(p, tgt_b):
        s, c = jdiff.merge_params(scene, camera, p)
        geom = jexpand(s)
        aux = jengine.prepare_cast(s, geom, cfg)
        offs, shift = jengine.spp_jitter_grid(cfg.spp, cfg.width, cfg.height)
        i = jax.lax.axis_index("rays")

        def sample(s_, geom_, aux_, c_, off, shift_full):
            cast = jengine.make_cast(s_, geom_, cfg, aux=aux_)
            ro, rd = jcamera_rays(c_, cfg.width, cfg.height,
                                  jitter=(off + shift_full) % 1.0)
            ro_b = jax.lax.dynamic_slice_in_dim(ro, i * rows_per, rows_per, 0)
            rd_b = jax.lax.dynamic_slice_in_dim(rd, i * rows_per, rows_per, 0)
            pixel_angle = jax.lax.stop_gradient(
                1.0 / (c_.unit_to_pixels * c_.global_near))
            img, _ = jengine.render_rays_stats(s_, geom_, cast, cfg, ro_b,
                                               rd_b, pixel_angle=pixel_angle)
            return img

        sample = jax.checkpoint(sample)
        acc, _ = jax.lax.scan(
            lambda a, off: (a + sample(s, geom, aux, c, off, shift), None),
            jnp.zeros((rows_per, cfg.width, 4), jnp.float32), offs)
        img = acc / cfg.spp
        return jnp.sum((img - tgt_b) ** 2) / n_px

    def body(p, tgt_b):
        value, grads = jax.value_and_grad(shard_loss)(p, tgt_b)
        return jax.lax.psum(value, "rays"), jax.lax.psum(grads, "rays")

    step = jax.jit(shard_map(body, mesh=mesh, in_specs=(P(), P("rays")),
                             out_specs=(P(), P()), check_vma=False))
    return step(params, target)


def test_dryrun_multichip_matches_jax():
    """``dryrun_multichip(2)`` on 2 ranks at the JAX function's default
    size (32x16) against the JAX step: loss and every gradient leaf."""
    out = launch("dryrun", 2)
    assert "dryrun_multichip(2): loss=" in out[0]["stdout"]
    jloss, jg = _jax_dryrun_step(2, 32, 16)
    ref = _jax_flat(jg)
    for r in out:
        res = r["result"]
        assert res["loss"] == pytest.approx(float(jloss), rel=RTOL)
        _assert_grads(res["grads"], ref)
        assert np.abs(np.asarray(res["grads"]["['verts']"])).max() > 0.0
        lr = 1e-2  # sgd_step's
        for key, p in res["new_params"].items():
            assert torch.isfinite(p).all(), key
        assert torch.allclose(
            res["new_params"]["['cam_pos']"],
            torch.from_numpy(np.asarray(
                jrt.generate(WORLD).camera.pos)).float()
            - lr * res["grads"]["['cam_pos']"], rtol=0.0, atol=1e-6)


def test_failing_rank_fails_the_launch_with_its_stderr():
    t0 = time.perf_counter()
    with pytest.raises(dist.LaunchError, match="rank 1 fails on purpose"):
        launch("torch_dist_ranks:fail", 2)
    assert time.perf_counter() - t0 < TIMEOUT / 2


def test_hung_rank_fails_at_the_timeout():
    t0 = time.perf_counter()
    with pytest.raises(dist.LaunchError, match="timed out"):
        dist.launch("torch_dist_ranks:hang", 2, backend="gloo",
                    device="cpu", timeout=8.0, pythonpath=[TESTS])
    assert time.perf_counter() - t0 < 30.0


def test_dist_and_its_ranks_hold_no_jax():
    """The module, imported in a fresh process, and a launched rank hold
    no module of JAX or of the JAX package."""
    code = ("import sys, raytracer_tpu_torch.dist; print(sorted(m for m in "
            "sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
            "'raytracer_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "[]", out.stdout
    (r,) = launch("torch_dist_ranks:modules", 1)
    assert r["result"]["jax"] == []
