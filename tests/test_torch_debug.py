"""The single-ray debug probe (``debug.debug_cast``) against the JAX
package's, on the CPU.

On the mixed world (``synth.make_mixed_world(depth=3)``: the compacted 2x
stream, reflect and refract children of one hit) at the pixels that
``tests/test_mixed_wavefront.py`` picks (six whose colour the bounces
change, two plain ones), the port's probe through the ``"cuda"`` engine
(the kernels' plain versions on the CPU) against the JAX probe through
``engine="pallas"`` (interpret mode): the same records, ``t`` at rtol
1e-5, ``inst`` and ``mat`` exactly, ``normal`` and ``contribution`` at
atol 1e-5, the same colour, and a narration of the same words in the same
order (the numbers aside).  The probe's colour also equals the port's own
frame pixel at rtol/atol 1e-4 (``test_mixed_wavefront.py``'s tolerance):
its recursion is independent of the wavefront.  On terrain8 (the fused
two-light round through ``occlude2``) the colour equals the frame pixel
too, and ``--debug-pixel`` prints the narration.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu import synth as jsynth
from raytracer_tpu.debug import debug_cast as jdebug_cast
from raytracer_tpu.scene import device_scene

import raytracer_tpu_torch as rtt
from raytracer_tpu_torch import cli, convert
from raytracer_tpu_torch.builder import scale_camera
from raytracer_tpu_torch.debug import debug_cast
from raytracer_tpu_torch.render.engine import render_frame

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TERRAIN8 = os.path.join(REPO, "raytracer_tpu_torch", "worlds",
                        "terrain8.json")
RTOL_T, ATOL_VEC, TOL_PIXEL = 1e-5, 1e-5, 1e-4
_NUMBER = re.compile(r"-?\d+\.?\d*(e[-+]?\d+)?")


@pytest.fixture(scope="module")
def mixed():
    scene, cam, cfg = jsynth.make_mixed_world(depth=3)
    port = dict(scene=convert.scene_from_numpy(scene, device="cpu"),
                cam=convert.camera_from_numpy(cam, device="cpu"),
                cfg=convert.config_from_jax(cfg).replace(engine="cuda"))
    img = render_frame(port["scene"], port["cam"], port["cfg"]).numpy()
    img0 = render_frame(port["scene"], port["cam"],
                        port["cfg"].replace(recurse_depth=0)).numpy()
    return dict(port, img=img, img0=img0, jscene=device_scene(scene),
                jcam=jax.tree_util.tree_map(jnp.asarray, cam),
                jcfg=cfg.replace(engine="pallas"))


def _pixels(img, img0, cfg):
    """``test_mixed_wavefront.py``'s pick: a spread of six pixels whose
    colour the bounces change, and two plain ones; ``(y, x)`` each."""
    bounce_px = np.argwhere(np.abs(img - img0).max(axis=-1) > 1e-3)
    sel = bounce_px[:: max(1, len(bounce_px) // 6)][:6].tolist()
    return sel + [[0, 0], [cfg.height - 1, cfg.width // 2]]


def _words(text):
    return [_NUMBER.sub("#", line.replace("[ ", "[")).split()
            for line in text.splitlines()]


@pytest.mark.parametrize("k", range(8))
def test_debug_cast_matches_jax(mixed, capsys, k):
    y, x = _pixels(mixed["img"], mixed["img0"], mixed["cfg"])[k]
    recs, color = debug_cast(mixed["scene"], mixed["cam"], mixed["cfg"],
                             x, y)
    said = capsys.readouterr().out
    jrecs, jcolor = jdebug_cast(mixed["jscene"], mixed["jcam"],
                                mixed["jcfg"], x, y)
    jsaid = capsys.readouterr().out
    assert _words(said) == _words(jsaid)
    assert f"pixel ({x}, {y}) final color" in said
    assert len(recs) == len(jrecs) >= 1
    for r, j in zip(recs, jrecs):
        assert sorted(r) == sorted(j)
        assert (r["level"], r["kind"], r["hit"]) == (j["level"], j["kind"],
                                                     j["hit"])
        np.testing.assert_allclose(r["o"], j["o"], rtol=0, atol=ATOL_VEC)
        np.testing.assert_allclose(r["d"], j["d"], rtol=0, atol=ATOL_VEC)
        if not r["hit"]:
            continue
        assert r["t"] == pytest.approx(j["t"], rel=RTOL_T)
        assert (r["inst"], r["mat"]) == (j["inst"], j["mat"])
        np.testing.assert_allclose(r["normal"], j["normal"], rtol=0,
                                   atol=ATOL_VEC)
        np.testing.assert_allclose(r["contribution"], j["contribution"],
                                   rtol=0, atol=ATOL_VEC)
    np.testing.assert_allclose(color, jcolor, rtol=0, atol=ATOL_VEC)
    np.testing.assert_allclose(color, mixed["img"][y, x], rtol=TOL_PIXEL,
                               atol=TOL_PIXEL)
    if k < 6:  # a bounce pixel: the probe follows a child ray
        assert max(r["level"] for r in recs) >= 1


@pytest.fixture(scope="module")
def terrain8():
    w = rtt.generate(TERRAIN8)
    scene = rtt.to_device(w.scene, "cpu")
    cam = rtt.to_device(scale_camera(w.camera, 48, w.config.width), "cpu")
    cfg = w.config.replace(width=48, height=32, engine="cuda")
    return scene, cam, cfg, render_frame(scene, cam, cfg).numpy()


def test_debug_cast_fused_round_equals_frame(terrain8, capsys):
    """terrain8 (one point and one directional light: the fused round's
    ``occlude2``) on two hit pixels and a miss."""
    scene, cam, cfg, img = terrain8
    lum = img[..., :3].max(-1)
    hits = np.argwhere(lum > 0)
    picks = [hits[0], hits[len(hits) // 2], np.argwhere(lum == 0)[0]]
    for y, x in picks:
        recs, color = debug_cast(scene, cam, cfg, int(x), int(y))
        np.testing.assert_allclose(color, img[y, x], rtol=TOL_PIXEL,
                                   atol=TOL_PIXEL)
        assert recs[0]["hit"] == bool(lum[y, x] > 0)
    assert "shadow ray" in capsys.readouterr().out


def test_cli_debug_pixel_prints_the_narration(capsys):
    assert cli.main(["-c", TERRAIN8, "--width", "48", "--height", "32",
                     "--device", "cpu", "--debug-pixel", "24", "20"]) == 0
    out = capsys.readouterr().out
    assert "[level 0] shooting a primary ray" in out
    assert "[point light 0] shadow ray" in out
    assert "pixel (24, 20) final color" in out
