"""The port's bounce rounds against the JAX package, on the CPU: queue
capacities, tile caps and gradients.

The JAX side runs ``engine="pallas"`` (Pallas in interpret mode), as its
own tests run it; the inputs come from ``synth.make_mixed_world`` and the
port's world files, both packages building the same scene.

* ``queue_factor`` 1.0 and 2.0 give the same frame with nothing dropped; at
  0.02 the drop count is the JAX package's (the compacted 2x stream).
* ``wavefront_tile_cap`` and ``child_tile_cap`` at ample caps give the
  dense frame; starved, they drop what the JAX package drops, and render
  its frame.  ``auto_tile_caps`` returns the JAX package's dict, and a
  frame at its caps is the dense frame.
* The L2 loss gradient on the mixed world (``early_exit=False``,
  ``recurse_depth=2``, ``shadow_steps=1``: the JAX package's own test of it)
  equals ``jax.grad`` at rtol 1e-5 / atol 1e-6, leaf by leaf, with the
  mirror's ``kr`` and the glass's ``kt`` gradients non-zero and finite.
* The ``"cuda"`` engine on CPU tensors gives the ``"torch"`` engine's
  frame and gradients.

The bounce terrains are held to the JAX package in
``test_torch_worlds.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu import diff as jdiff
from raytracer_tpu import synth as jsynth
from raytracer_tpu.builder import scale_camera as jscale_camera
from raytracer_tpu.render import engine as jengine
from raytracer_tpu.scene import device_scene

from raytracer_tpu_torch import convert, diff, tree
from raytracer_tpu_torch.render import engine

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6


def _pair(jscene_np, jcam_np, jcfg):
    """Both packages' scene, camera and config from the JAX package's numpy
    scene (``jcfg`` with ``engine="pallas"``)."""
    return dict(jscene=device_scene(jscene_np),
                jcam=jax.tree_util.tree_map(jnp.asarray, jcam_np), jcfg=jcfg,
                scene=convert.scene_from_numpy(jscene_np, device="cpu"),
                cam=convert.camera_from_numpy(jcam_np, device="cpu"),
                cfg=convert.config_from_jax(jcfg).replace(engine="torch"))


def _jax_frame(w, **change):
    """The JAX package's frame and drop count."""
    img, stats = jax.jit(jengine.render_frame_with_stats,
                         static_argnames=("cfg",))(
        w["jscene"], w["jcam"], w["jcfg"].replace(**change))
    return np.asarray(img), int(stats["dropped"])


def assert_frame_matches_jax(img, jimg, max_off=0.0001):
    """The port's frame against the JAX package's at atol 1e-5, save for a
    share ``max_off`` of the pixels (1 in 10,000).  A hit point's last bits
    can differ between the packages: the jitted JAX frame computes ``o + t
    * d`` as a fused multiply-add (XLA contracts it; the port and the JAX
    package run op by op round the product first), and a template
    triangle's hit time may differ by an ulp or two (the tests hold hit
    times to rtol 1e-5).  Where a shadow ray then starts one ulp to either
    side of a face plane, or its own triangle's self-hit lands at the
    1e-5 offset, its query flips: one pixel of the mixed world at 128x96
    ((63, 64): lit in the port and in the JAX package run op by op) and one
    of the sphere world on the cull ((40, 44): t 9.847034 against
    9.8470325, the port's shadow ray re-hits its own triangle at
    1.48e-5)."""
    off = np.abs(img.numpy() - jimg).max(-1) > 1e-5
    assert off.sum() <= max_off * off.size, np.argwhere(off).tolist()


def _port_frame(w, **change):
    img, stats = engine.render_frame_with_stats(w["scene"], w["cam"],
                                                w["cfg"].replace(**change))
    return img, int(stats["dropped"])


@pytest.fixture(scope="module")
def mixed():
    """The mixed world at its own 128x96 (12 tiles of 1024 rays), depth 3."""
    jscene_np, jcam_np, jcfg = jsynth.make_mixed_world(depth=3)
    return _pair(jscene_np, jcam_np, jcfg.replace(engine="pallas"))


@pytest.fixture(scope="module")
def dense(mixed):
    img, dropped = _port_frame(mixed)
    assert dropped == 0
    return img


def test_queue_factor_drops_match_jax(mixed, dense):
    # the kernel wrappers on CPU tensors take their plain versions
    assert torch.equal(dense, _port_frame(mixed, engine="cuda")[0])
    for qf in (1.0, 2.0):
        img, dropped = _port_frame(mixed, queue_factor=qf)
        assert dropped == 0
        assert torch.equal(img, dense)
    jimg, jdropped = _jax_frame(mixed, queue_factor=0.02)
    img, dropped = _port_frame(mixed, queue_factor=0.02)
    assert jdropped > 0 and dropped == jdropped
    assert_frame_matches_jax(img, jimg)
    assert not np.allclose(img.numpy(), dense.numpy(), atol=1e-3)


@pytest.mark.parametrize("cap", ["wavefront_tile_cap", "child_tile_cap"])
def test_tile_caps_match_dense_and_jax_drops(mixed, dense, cap):
    """Ample caps keep every tile with a hit (or a child): the dense frame,
    nothing dropped.  A starved cap keeps one tile and drops what the JAX
    package drops."""
    img, dropped = _port_frame(mixed, **{cap: 0.75})
    assert dropped == 0
    np.testing.assert_allclose(img.numpy(), dense.numpy(), rtol=0, atol=1e-6)
    jimg, jdropped = _jax_frame(mixed, **{cap: 1e-9})
    img, dropped = _port_frame(mixed, **{cap: 1e-9})
    assert jdropped > 0 and dropped == jdropped
    assert_frame_matches_jax(img, jimg)


def test_auto_tile_caps_match_jax(mixed, dense):
    jcaps = jengine.auto_tile_caps(mixed["jscene"], mixed["jcam"],
                                   mixed["jcfg"])
    caps = engine.auto_tile_caps(mixed["scene"], mixed["cam"], mixed["cfg"])
    assert caps == jcaps
    assert caps["wavefront_tile_cap"] > 0.0 or caps["child_tile_cap"] > 0.0
    run = {k: v for k, v in caps.items() if k != "static_tile_cap"}
    img, dropped = _port_frame(mixed, **run)
    assert dropped == 0
    np.testing.assert_allclose(img.numpy(), dense.numpy(), rtol=0, atol=1e-6)
    # the spp sweep's kept tiles: at spp = 1 they play no part, as in the
    # JAX package (tests/test_torch_spp.py renders them at spp = 4)
    img, dropped = _port_frame(mixed, static_tile_cap=0.5)
    jimg, jdropped = _jax_frame(mixed, static_tile_cap=0.5)
    assert dropped == jdropped == 0 and torch.equal(img, dense)
    assert_frame_matches_jax(img, jimg)


def test_mixed_grads_match_jax(mixed):
    W, H = 64, 48
    jscene_np, jcam_np, jcfg = jsynth.make_mixed_world(depth=2)
    jcam_np = jscale_camera(jcam_np, W, jcfg.width)
    jcfg = jcfg.replace(width=W, height=H, engine="pallas", early_exit=False,
                        recurse_depth=2, shadow_steps=1)
    w = _pair(jscene_np, jcam_np, jcfg)
    target = np.random.default_rng(3).uniform(
        0.0, 0.5, (H, W, 4)).astype(np.float32)
    jparams = jdiff.trainable_params(w["jscene"], w["jcam"])
    jloss, jg = jax.jit(jax.value_and_grad(jdiff.make_loss_fn(
        w["jscene"], w["jcam"], jcfg, jnp.asarray(target))))(jparams)
    port = {}
    for eng in ("torch", "cuda"):
        params = convert.params_from_numpy(jparams, device="cpu")
        loss = diff.make_loss_fn(w["scene"], w["cam"],
                                 w["cfg"].replace(engine=eng),
                                 torch.from_numpy(target))(params)
        port[eng] = (float(loss.detach()), diff.grad_of(loss, params))
    loss, g = port["torch"]
    assert loss == pytest.approx(float(jloss), rel=1e-6)
    jl = [("/".join(str(p) for p in path), np.asarray(v)) for path, v in
          jax.tree_util.tree_flatten_with_path(jg)[0]]
    tl = tree.leaves_with_paths(convert.params_to_numpy(g))
    assert [k for k, _ in tl] == [k for k, _ in jl]
    for (key, gt), (_, gj) in zip(tl, jl):
        assert np.isfinite(gt).all(), key
        np.testing.assert_allclose(gt, gj, rtol=RTOL, atol=ATOL, err_msg=key)
    by_key = dict(tl)
    kr, kt = by_key["['materials']/.kr"], by_key["['materials']/.kt"]
    mats = w["scene"].materials
    mirror = int(torch.nonzero((mats.kr > 0).any(-1))[0])
    glass = int(torch.nonzero((mats.kt > 0).any(-1))[0])
    assert np.abs(kr[mirror]).max() > 10 * ATOL
    assert np.abs(kt[glass]).max() > 10 * ATOL
    for key in ("['cam_pos']", "['materials']/.eta"):
        assert np.abs(by_key[key]).max() > 10 * ATOL, key
    lc, gc = port["cuda"]
    assert lc == loss
    for a, b in zip(tree.leaves(g), tree.leaves(gc)):
        assert torch.equal(a, b)
