"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: each test skips (with a reason) when
``torch.cuda.is_available()`` is false, decided inside the test, never at
import.  Run on a GPU machine with::

    python -m pytest tests/test_torch_cuda.py -q -m gpu

K1 must give the plain version's valid, triangle and material exactly, t at
rtol 1e-5 and normals/uv at atol 1e-5; K2's and K3's masks must be identical
(K3's also to K2's); a frame through the kernels must equal the ``"torch"``
engine at atol 1e-5, the per-light frame (K3) the fused one bit for bit; and
the loss gradients of both engines must agree at rtol 1e-4 / atol 1e-6."""

import os

import numpy as np
import pytest
import torch

import raytracer_tpu_torch as rtt
from raytracer_tpu_torch import diff, tree
from raytracer_tpu_torch.builder import scale_camera
from raytracer_tpu_torch.render import cuda_engine as ce
from raytracer_tpu_torch.render.engine import _frame_rays_blocked, render_frame
from raytracer_tpu_torch.render.geometry import expand_geometry
from raytracer_tpu_torch.render.shading import shadow_rays

pytestmark = pytest.mark.gpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = os.path.join(REPO, "raytracer_tpu_torch", "worlds", "terrain8.json")


@pytest.fixture(scope="module")
def gpu_world():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    dev = torch.device("cuda", 0)
    w = rtt.generate(WORLD)
    scene = rtt.to_device(w.scene, dev)
    cfg = w.config.replace(engine="cuda", width=160, height=120)
    cam = rtt.to_device(scale_camera(w.camera, 160, w.config.width), dev)
    geom = expand_geometry(scene)
    data = ce.prepare_cast(scene, geom, cfg)
    data_t = ce.CastData(tables=ce.build_tables(scene, geom, exact_uv=True),
                         nodes=data.nodes, ordering=data.ordering)
    ro, rd, _, _ = _frame_rays_blocked(cam, cfg)
    rng = np.random.default_rng(1)
    o = rng.uniform(-6, 6, (4096, 3)).astype(np.float32)
    o[:, 1] += 4.0
    d = rng.standard_normal((4096, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = {"primary": (ro, rd),
            "random": (torch.from_numpy(o).to(dev),
                       torch.from_numpy(d).to(dev))}
    return dict(scene=scene, cam=cam, cfg=cfg,
                data={"box": data, "template": data_t}, rays=rays)


@pytest.mark.parametrize("tables", ["box", "template"])
@pytest.mark.parametrize("rays", ["primary", "random"])
def test_bvh_cast_kernel_matches_plain(gpu_world, tables, rays):
    data = gpu_world["data"][tables]
    o, d = gpu_world["rays"][rays]
    before = ce.bvh_cast.launches
    hk = ce.bvh_cast(o, d, data)
    assert ce.bvh_cast.launches == before + 1
    hp = ce.bvh_cast_reference(o, d, data)
    torch.cuda.synchronize()
    assert torch.equal(hk.valid, hp.valid)
    v = hk.valid
    assert int(v.sum()) > 0
    assert torch.equal(hk.wtri[v], hp.wtri[v])
    assert torch.equal(hk.mat[v], hp.mat[v])
    torch.testing.assert_close(hk.t[v], hp.t[v], rtol=1e-5, atol=0.0)
    torch.testing.assert_close(hk.normal, hp.normal, rtol=0.0, atol=1e-5)
    torch.testing.assert_close(hk.uv, hp.uv, rtol=0.0, atol=1e-5)


def _shadow_queries(gpu_world):
    """The primary frame's two shadow queries: to the point light (finite
    max_t) and along the directional light (+inf), as K2's six inputs."""
    ro, rd = gpu_world["rays"]["primary"]
    hit = ce.bvh_cast(ro, rd, gpu_world["data"]["box"])
    t = torch.where(hit.valid, hit.t, 1.0)
    o1, d1, dist, o2, d2 = shadow_rays(gpu_world["scene"],
                                       ro + t[:, None] * rd, hit.valid)
    return (o1, d1, dist, o2, d2.contiguous(), torch.full_like(dist, np.inf))


@pytest.mark.parametrize("tables", ["box", "template"])
def test_bvh_occlude2_kernel_matches_plain(gpu_world, tables):
    q = _shadow_queries(gpu_world)
    data = gpu_world["data"][tables]
    bk = ce.bvh_occlude2(*q, data)
    bp = ce.bvh_occlude2_reference(*q, data)
    torch.cuda.synchronize()
    for a, b in zip(bk, bp):
        assert torch.equal(a, b)
        assert 0 < int(a.sum()) < a.numel()


@pytest.mark.parametrize("tables", ["box", "template"])
@pytest.mark.parametrize("max_t", ["finite", "inf"])
def test_bvh_occlude_kernel_matches_plain(gpu_world, tables, max_t):
    q = _shadow_queries(gpu_world)
    data = gpu_world["data"][tables]
    k = 0 if max_t == "finite" else 1
    o, d, mt = q[3 * k: 3 * k + 3]
    before = ce.bvh_occlude.launches
    bk = ce.bvh_occlude(o, d, mt, data)
    assert ce.bvh_occlude.launches == before + 1
    bp = ce.bvh_occlude_reference(o, d, mt, data)
    pair = ce.bvh_occlude2(*q, data)
    torch.cuda.synchronize()
    assert bk.dtype == torch.bool and torch.equal(bk, bp)
    assert torch.equal(bk, pair[k])
    assert 0 < int(bk.sum()) < bk.numel()


def test_per_light_frame_equals_fused(gpu_world):
    s, cam, cfg = gpu_world["scene"], gpu_world["cam"], gpu_world["cfg"]
    fused = render_frame(s, cam, cfg)
    n3 = ce.bvh_occlude.launches
    img = render_frame(s, cam, cfg.replace(fused_shadows=False))
    assert ce.bvh_occlude.launches == n3 + 2  # one query per light
    assert torch.equal(img, fused)


def test_train_grads_cuda_match_torch_engine(gpu_world):
    s, cam, cfg = gpu_world["scene"], gpu_world["cam"], gpu_world["cfg"]
    target = torch.zeros(cfg.height, cfg.width, 4, device=cam.pos.device)
    grads = {}
    for engine in ("cuda", "torch"):
        params = diff.trainable_params(s, cam)
        loss = diff.make_loss_fn(s, cam, cfg.replace(engine=engine),
                                 target)(params)
        grads[engine] = diff.grad_of(loss, params)
    assert float(grads["cuda"]["cam_pos"].abs().max()) > 0.0
    # the atomic sums of the gather backward may add in another order
    for a, b in zip(tree.leaves(grads["cuda"]), tree.leaves(grads["torch"])):
        assert bool(torch.isfinite(a).all())
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)


def test_frame_cuda_engine_matches_torch_engine(gpu_world):
    s, cam, cfg = gpu_world["scene"], gpu_world["cam"], gpu_world["cfg"]
    n1, n2 = ce.bvh_cast.launches, ce.bvh_occlude2.launches
    img = render_frame(s, cam, cfg)
    assert ce.bvh_cast.launches == n1 + 1
    assert ce.bvh_occlude2.launches == n2 + 1
    ref = render_frame(s, cam, cfg.replace(engine="torch"))
    torch.testing.assert_close(img, ref, rtol=0.0, atol=1e-5)


def test_wrappers_reject_bad_inputs(gpu_world):
    data = gpu_world["data"]["box"]
    o, d = gpu_world["rays"]["random"]
    with pytest.raises(TypeError):
        ce.bvh_cast(o.double(), d.double(), data)
    with pytest.raises(ValueError):
        ce.bvh_cast(o[:, :2], d[:, :2], data)
    with pytest.raises(ValueError):
        ce.bvh_cast(o.t().contiguous().t(), d, data)
    with pytest.raises(ValueError):
        ce.bvh_cast(o.cpu(), d, data)
