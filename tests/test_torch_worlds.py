"""The port's bounce terrains and synthetic worlds against the JAX package,
on the CPU (``engine="pallas"``, Pallas in interpret mode, as the JAX
package's own tests run it).

* ``terrain8_stress`` (570 instances, a third, reflective cube type, 5x
  ``unit_length``, depth 2): the LBVH walk, the pixel-aligned stream and
  the fused two-light shadow round in every bounce round;
* ``terrain8_mixed`` (760 instances, a reflective and a refractive type):
  the compacted 2x stream and the transmissive shadow march through the
  closest-hit walk.

Each renders the JAX frame at atol 1e-5 with nothing dropped, and its
bounces change the frame; on ``terrain8_stress`` the per-light round
(``fused_shadows=False``, K3's path) gives the fused frame bit for bit.

* ``make_sphere_world`` (64 icospheres of 80 triangles: no box fast path)
  renders the JAX frame on the cull (K4/K5's plain versions; one pixel in
  10,000 may differ, ``test_torch_bounce.assert_frame_matches_jax``) and on
  the MXU cast (K6's), whose 384 staged columns hold 4 whole 80-triangle
  slots and 64 dead columns.
"""

import os

import numpy as np
import pytest
import torch

import raytracer_tpu as jrt
from raytracer_tpu import synth as jsynth
from raytracer_tpu.builder import scale_camera as jscale_camera

from test_torch_bounce import (_jax_frame, _pair, _port_frame,
                               assert_frame_matches_jax)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = os.path.join(REPO, "raytracer_tpu_torch", "worlds")

TERRAINS = {"terrain8_stress": (64, 48), "terrain8_mixed": (32, 24)}


@pytest.fixture(scope="module", params=sorted(TERRAINS))
def terrain(request):
    width, height = TERRAINS[request.param]
    jw = jrt.generate(os.path.join(WORLDS, request.param + ".json"))
    jcam_np = jscale_camera(jw.camera, width, jw.config.width)
    jcfg = jw.config.replace(width=width, height=height, engine="pallas")
    w = _pair(jw.scene, jcam_np, jcfg)
    w["name"] = request.param
    return w


def test_terrain_frames_match_jax(terrain):
    cfg = terrain["cfg"]
    assert cfg.recurse_depth == 2 and cfg.any_reflective
    assert cfg.any_refractive == (terrain["name"] == "terrain8_mixed")
    assert terrain["scene"].inst_pos.shape[0] > 256  # the LBVH walk
    jimg, jdropped = _jax_frame(terrain)
    img, dropped = _port_frame(terrain)
    assert dropped == 0 and jdropped == 0
    np.testing.assert_allclose(img.numpy(), jimg, rtol=0, atol=1e-5)
    img0, _ = _port_frame(terrain, recurse_depth=0)
    assert int(((img - img0).abs().amax(-1) > 1e-3).sum()) > 10
    if not cfg.any_refractive:
        # the per-light round (K3's path) gives the fused round's frame
        assert torch.equal(img, _port_frame(terrain,
                                            fused_shadows=False)[0])


@pytest.mark.parametrize("kernel", ["scalar", "mxu"])
def test_sphere_world_frames_match_jax(kernel):
    jscene_np, jcam_np, jcfg = jsynth.make_sphere_world()
    w = _pair(jscene_np, jcam_np, jcfg.replace(engine="pallas",
                                                 pallas_kernel=kernel))
    assert w["cfg"].max_tris_per_mesh == 80
    jimg, _ = _jax_frame(w)
    img, dropped = _port_frame(w)
    assert dropped == 0
    assert_frame_matches_jax(img, jimg)
    assert (img[..., :3].amax(-1) > 0).float().mean() > 0.05
    assert torch.equal(img, _port_frame(w, engine="cuda")[0])
