"""The port's spp > 1 path against the JAX package, on the CPU.

The JAX side runs ``engine="pallas"`` (Pallas in interpret mode), as its own
tests run it; both packages build the same scene from the JAX package's
numpy scene.

* ``spp_jitter_grid`` is bit-equal to the JAX grid computed op by op
  (``jax.disable_jit``; the jitted grid contracts ``a1 * x + a2 * y`` into a
  fused multiply-add, so the jitted JAX frames' jitter differs in its last
  bit on some pixels).
* ``render_frame(spp=4)`` at 64x48 equals the JAX package's at atol 1e-5 on
  terrain8 (the LBVH walk), terrain6 (the cull), terrain6 on the MXU cast
  and the mixed synthetic world (both child streams, the march), save 1
  pixel in 10,000 where an ulp flips a shadow query
  (``test_torch_bounce.assert_frame_matches_jax``); nothing is dropped.
* ``static_tile_cap``: on the mixed world in a 192x16 strip (6 tiles, the
  cluster in two), a starved cap drops what the JAX package drops and
  renders its frame; ``auto_tile_caps``' cap gives the uncapped frame.
* ``render_frame_sum`` over one-sample chunks adds up to ``spp`` times the
  spp frame bit for bit (the same order of sums); over two-sample chunks
  within 1e-6 (another order of sums), as ``tests/test_engines.py``.
* ``diff.make_spp_grad_fn``: loss and grads equal the JAX package's
  ``make_spp_grad_fn`` at rtol 1e-5 / atol 1e-6, leaf by leaf, whole and
  chunked (``spp_chunk`` None, 1, 2, with stats), and with vertices
  under ``edge_aware_grads`` (the band applied per sample; ``verts`` at
  rtol 1e-4 / atol 1e-6 max|g|).  The checkpointed grads equal the
  unchecked ones (``remat=False``).
* The backward's recompute runs no any-hit query (the plain versions
  wrapped by counters, which the ``"cuda"`` engine's wrappers take on CPU
  tensors) and recasts every closest hit of the forward: on the walk's
  fused and per-light shadows and on the cull.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracer_tpu as jrt
from raytracer_tpu import diff as jdiff
from raytracer_tpu import synth as jsynth
from raytracer_tpu.builder import scale_camera as jscale_camera
from raytracer_tpu.render import engine as jengine

from raytracer_tpu_torch import convert, diff, tree
from raytracer_tpu_torch.render import cuda_engine as ce
from raytracer_tpu_torch.render import cull, engine

from test_torch_bounce import _pair, assert_frame_matches_jax

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = os.path.join(REPO, "raytracer_tpu_torch", "worlds")
SPP = 4
RTOL, ATOL = 1e-5, 1e-6
RTOL_VERTS, ATOL_VERTS = 1e-4, 1e-6  # atol relative to max |g|


def _terrain(name, w, h, **change):
    jw = jrt.generate(os.path.join(WORLDS, f"{name}.json"))
    cam = jscale_camera(jw.camera, w, jw.config.width)
    return _pair(jw.scene, cam, jw.config.replace(
        width=w, height=h, engine="pallas", **change))


def _mixed(w, h, zoom=1):
    """The mixed world (depth 2) at ``w`` x ``h``, its cluster ``zoom``
    times smaller than its own framing."""
    s, c, cfg = jsynth.make_mixed_world(depth=2)
    c = jscale_camera(c, w, zoom * cfg.width)
    return _pair(s, c, cfg.replace(width=w, height=h, engine="pallas"))


def _jax_frame(w, **change):
    img, stats = jax.jit(jengine.render_frame_with_stats,
                         static_argnames=("cfg",))(
        w["jscene"], w["jcam"], w["jcfg"].replace(**change))
    return np.asarray(img), int(stats["dropped"])


def _port_frame(w, **change):
    img, stats = engine.render_frame_with_stats(w["scene"], w["cam"],
                                                w["cfg"].replace(**change))
    return img, int(stats["dropped"])


@pytest.mark.parametrize("spp,width,height", [(1, 7, 5), (4, 64, 48),
                                              (128, 1920, 1080)])
def test_jitter_grid_bit_equal_jax(spp, width, height):
    with jax.disable_jit():
        joffs, jshift = jengine.spp_jitter_grid(spp, width, height)
    offs, shift = engine.spp_jitter_grid(spp, width, height)
    assert offs.dtype == shift.dtype == torch.float32
    np.testing.assert_array_equal(offs.numpy(), np.asarray(joffs))
    np.testing.assert_array_equal(shift.numpy(), np.asarray(jshift))


SPP_WORLDS = {
    "terrain8": lambda: _terrain("terrain8", 64, 48),
    "terrain6_cull": lambda: _terrain("terrain6", 64, 48),
    "terrain6_mxu": lambda: _terrain("terrain6", 64, 48,
                                     pallas_kernel="mxu"),
    "mixed": lambda: _mixed(64, 48),
}


@pytest.mark.parametrize("name", sorted(SPP_WORLDS))
def test_spp_frame_matches_jax(name):
    w = SPP_WORLDS[name]()
    jimg, jdropped = _jax_frame(w, spp=SPP)
    img, dropped = _port_frame(w, spp=SPP)
    assert img.shape == (48, 64, 4) and dropped == jdropped == 0
    assert_frame_matches_jax(img, jimg)
    one = _port_frame(w)[0]  # the samples moved the frame
    assert float((img - one).abs().max()) > 1e-3
    if name == "mixed":  # both child streams: reflect and refract
        assert w["cfg"].any_reflective and w["cfg"].any_refractive


@pytest.fixture(scope="module")
def strip():
    """The mixed world in a 192x16 strip: 6 tiles, probe hits in tiles 2
    and 3, their ring 1-4."""
    return _mixed(192, 16, zoom=2)


def test_static_tile_cap_matches_jax(strip):
    caps = engine.auto_tile_caps(strip["scene"], strip["cam"], strip["cfg"])
    assert caps == jengine.auto_tile_caps(strip["jscene"], strip["jcam"],
                                          strip["jcfg"])
    cap = caps["static_tile_cap"]
    assert 0.0 < cap < 1.0  # 5 tiles of 6
    assert cap == engine.auto_static_tile_cap(strip["scene"], strip["cam"],
                                              strip["cfg"])
    dense, dropped = _port_frame(strip, spp=SPP)
    assert dropped == 0
    img, dropped = _port_frame(strip, spp=SPP, static_tile_cap=cap)
    assert dropped == 0 and torch.equal(img, dense)
    jimg, jdropped = _jax_frame(strip, spp=SPP, static_tile_cap=1e-9)
    img, dropped = _port_frame(strip, spp=SPP, static_tile_cap=1e-9)
    assert jdropped > 0 and dropped == jdropped
    assert_frame_matches_jax(img, jimg)
    assert not np.allclose(img.numpy(), dense.numpy(), atol=1e-3)
    # at spp = 1 the kept tiles play no part, as in the JAX package
    assert torch.equal(_port_frame(strip, static_tile_cap=1e-9)[0],
                       _port_frame(strip)[0])


@pytest.fixture(scope="module")
def spp_frame():
    w = _terrain("terrain8", 64, 48)
    return w, engine.render_frame(w["scene"], w["cam"],
                                  w["cfg"].replace(spp=SPP))


@pytest.mark.parametrize("chunk", [1, 2])
def test_frame_sum_chunks_add_up_to_spp_frame(spp_frame, chunk):
    w, img = spp_frame
    offs, _ = engine.spp_jitter_grid(SPP, 64, 48)
    acc = torch.zeros_like(img)
    for i in range(0, SPP, chunk):
        acc = acc + engine.render_frame_sum(w["scene"], w["cam"], w["cfg"],
                                            offs[i:i + chunk])
    if chunk == 1:  # the sums in render_frame's order
        assert torch.equal(acc / SPP, img)
    else:
        torch.testing.assert_close(acc / SPP, img, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# make_spp_grad_fn
# ---------------------------------------------------------------------------

GW, GH = 48, 32


@pytest.fixture(scope="module")
def grad_world():
    return _terrain("terrain8", GW, GH, early_exit=False)


def _target():
    return np.random.default_rng(3).uniform(
        0.0, 0.5, (GH, GW, 4)).astype(np.float32)


def _jax_step(w, include_vertices=False, **kw):
    jparams = jdiff.trainable_params(w["jscene"], w["jcam"],
                                     include_vertices=include_vertices)
    jcfg = w["jcfg"].replace(edge_aware_grads=include_vertices)
    loss, grads, stats = jdiff.make_spp_grad_fn(
        w["jscene"], w["jcam"], jcfg, SPP, with_stats=True, **kw)(
            jparams, jnp.asarray(_target()))
    return jparams, float(loss), grads, int(stats["dropped"])


def _port_step(w, jparams, include_vertices=False, **kw):
    params = convert.params_from_numpy(jparams, device="cpu")
    cfg = w["cfg"].replace(edge_aware_grads=include_vertices)
    return diff.make_spp_grad_fn(w["scene"], w["cam"], cfg, SPP, **kw)(
        params, torch.from_numpy(_target()))


def _assert_grads_match(g, jg, verts=False):
    jl = [("/".join(str(p) for p in path), np.asarray(v)) for path, v in
          jax.tree_util.tree_flatten_with_path(jg)[0]]
    tl = tree.leaves_with_paths(convert.params_to_numpy(g))
    assert [k for k, _ in tl] == [k for k, _ in jl]
    for (key, gt), (_, gj) in zip(tl, jl):
        assert np.isfinite(gt).all(), key
        if key == "['verts']":
            assert verts
            np.testing.assert_allclose(
                gt, gj, rtol=RTOL_VERTS,
                atol=ATOL_VERTS * float(np.abs(gj).max()), err_msg=key)
        else:
            np.testing.assert_allclose(gt, gj, rtol=RTOL, atol=ATOL,
                                       err_msg=key)
    return dict(tl)


@pytest.fixture(scope="module")
def jax_whole(grad_world):
    return _jax_step(grad_world)


@pytest.mark.parametrize("chunk", [None, 1, 2])
def test_spp_grads_match_jax(grad_world, jax_whole, chunk):
    """Every mode against the JAX package's whole step (its own tests hold
    its chunked steps to it, ``tests/test_engines.py``)."""
    jparams, jloss, jg, jdropped = jax_whole
    loss, g, stats = _port_step(grad_world, jparams, spp_chunk=chunk,
                                with_stats=True)
    assert int(stats["dropped"]) == jdropped == 0
    assert float(loss) == pytest.approx(jloss, rel=1e-6)
    by_key = _assert_grads_match(g, jg)
    for key in ("['cam_pos']", "['lights']/.point_col",
                "['materials']/.kd"):
        assert np.abs(by_key[key]).max() > 10 * ATOL, key


def test_spp_vertex_grads_match_jax(grad_world):
    jparams, jloss, jg, _ = _jax_step(grad_world, include_vertices=True)
    loss, g = _port_step(grad_world, jparams, include_vertices=True)
    assert float(loss) == pytest.approx(jloss, rel=1e-6)
    by_key = _assert_grads_match(g, jg, verts=True)
    assert np.abs(by_key["['verts']"]).max() > 10 * ATOL


def test_checkpointed_grads_equal_unchecked(grad_world, jax_whole):
    jparams = jax_whole[0]
    loss, g = _port_step(grad_world, jparams)
    loss_u, g_u = _port_step(grad_world, jparams, remat=False)
    assert float(loss) == float(loss_u)
    for a, b in zip(tree.leaves(g), tree.leaves(g_u)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="divide"):
        diff.make_spp_grad_fn(grad_world["scene"], grad_world["cam"],
                              grad_world["cfg"], SPP, spp_chunk=3)


def _counting(monkeypatch, module, name, counts):
    fn = getattr(module, name)

    def counted(*args, **kw):
        counts[name] = counts.get(name, 0) + 1
        return fn(*args, **kw)

    monkeypatch.setattr(module, name, counted)


@pytest.mark.parametrize("case", ["walk_fused", "walk_per_light", "cull"])
def test_backward_recompute_runs_no_any_hit_query(monkeypatch, case):
    """Counted calls of the plain any-hit versions (K2's, K3's and K5's)
    and closest-hit versions (K1's, K4's) between the end of the forward
    and the end of the backward."""
    name = "terrain6" if case == "cull" else "terrain8"
    w = _terrain(name, 32, 32, early_exit=False,
                 fused_shadows=case != "walk_per_light")
    counts = {}
    for module, fn in ((ce, "bvh_cast_reference"),
                       (ce, "bvh_occlude2_reference"),
                       (ce, "bvh_occlude_reference"),
                       (cull, "cull_cast_reference"),
                       (cull, "cull_occlude_reference")):
        _counting(monkeypatch, module, fn, counts)
    cast = "cull_cast_reference" if case == "cull" else "bvh_cast_reference"
    query = {"walk_fused": "bvh_occlude2_reference",
             "walk_per_light": "bvh_occlude_reference",
             "cull": "cull_occlude_reference"}[case]
    params = diff.trainable_params(w["scene"], w["cam"])
    loss = diff.make_loss_fn(w["scene"], w["cam"], w["cfg"].replace(
        engine="cuda", spp=SPP), torch.zeros(32, 32, 4))(params)
    fwd = dict(counts)
    assert fwd[query] >= SPP and fwd[cast] == SPP
    grads = diff.grad_of(loss, params)
    assert float(grads["cam_pos"].abs().max()) > 0.0
    bwd = {k: counts[k] - fwd.get(k, 0) for k in counts}
    assert bwd[cast] == fwd[cast]  # every cast recomputed
    assert sum(v for k, v in bwd.items() if k != cast) == 0, bwd
