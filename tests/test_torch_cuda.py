"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: each test skips (with a reason) when
``torch.cuda.is_available()`` is false, decided inside the test, never at
import.  Run on a GPU machine with::

    python -m pytest tests/test_torch_cuda.py -q -m gpu

K1 and K4 must give the plain version's valid, triangle and material
exactly, t at rtol 1e-5 and normals/uv at atol 1e-5; K2's, K3's and K5's
masks must be identical (K3's also to K2's); K6's t, id, u and v must equal
its plain version's; a frame through the kernels must equal the ``"torch"``
engine at atol 1e-5 (terrain8 on the LBVH walk, terrain6 on the cull and on
the MXU cast), the per-light frame (K3) the fused one bit for bit; and the
loss gradients of both engines must agree at rtol 1e-4 / atol 1e-6."""

import os

import numpy as np
import pytest
import torch

import raytracer_tpu_torch as rtt
from raytracer_tpu_torch import diff, tree
from raytracer_tpu_torch.builder import scale_camera
from raytracer_tpu_torch.render import cuda_engine as ce
from raytracer_tpu_torch.render import cull, mxu
from raytracer_tpu_torch.render.engine import _frame_rays_blocked, render_frame
from raytracer_tpu_torch.render.geometry import expand_geometry
from raytracer_tpu_torch.render.shading import shadow_rays

pytestmark = pytest.mark.gpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = os.path.join(REPO, "raytracer_tpu_torch", "worlds", "terrain8.json")
WORLD6 = os.path.join(REPO, "raytracer_tpu_torch", "worlds", "terrain6.json")


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


# ---------------------------------------------------------------------------
# terrain6: the candidate-list cull (K4, K5) and the MXU cast (K6)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gpu_world6():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    dev = torch.device("cuda", 0)
    w = rtt.generate(WORLD6)
    scene = rtt.to_device(w.scene, dev)
    cfg = w.config.replace(engine="cuda", width=160, height=120)
    cam = rtt.to_device(scale_camera(w.camera, 160, w.config.width), dev)
    geom = expand_geometry(scene)
    data = ce.prepare_cast(scene, geom, cfg)
    assert data.nodes is None
    tables = {"box": data.tables,
              "template": ce.build_tables(scene, geom, exact_uv=True)}
    ro, rd, _, _ = _frame_rays_blocked(cam, cfg)
    rng = np.random.default_rng(2)
    o = rng.uniform(-6, 6, (4096, 3)).astype(np.float32)
    o[:, 1] += 4.0
    d = rng.standard_normal((4096, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = {"primary": (ro, rd),
            "random": (torch.from_numpy(o).to(dev),
                       torch.from_numpy(d).to(dev))}
    return dict(scene=scene, cam=cam, cfg=cfg, geom=geom, tables=tables,
                rays=rays, tile=cull.tile_rows_of(cfg) * cull.LANES)


def _lists(gpu_world6, o, d):
    lay = cull.CullLayout.of(o.shape[0], gpu_world6["cfg"].pallas_ray_chunk,
                             gpu_world6["tile"])
    o_p, d_p = lay.pad_rays(o, d, 1.0e30)
    cand, info = cull.tile_candidates(o_p, d_p, gpu_world6["tile"],
                                      gpu_world6["tables"]["box"].inst_f32,
                                      cull.MAX_CAND)
    return o_p, d_p, cand, info


@pytest.mark.parametrize("tables", ["box", "template"])
@pytest.mark.parametrize("rays", ["primary", "random"])
def test_cull_cast_kernel_matches_plain(gpu_world6, tables, rays):
    o_p, d_p, cand, info = _lists(gpu_world6, *gpu_world6["rays"][rays])
    tab = gpu_world6["tables"][tables]
    tile = gpu_world6["tile"]
    before = cull.cull_cast.launches
    hk = cull.cull_cast(o_p, d_p, cand, info, tile, tab)
    assert cull.cull_cast.launches == before + 1
    hp = cull.cull_cast_reference(o_p, d_p, cand, info, tile, tab)
    torch.cuda.synchronize()
    assert torch.equal(hk.valid, hp.valid) and int(hk.valid.sum()) > 0
    v = hk.valid
    assert torch.equal(hk.wtri[v], hp.wtri[v])
    assert torch.equal(hk.mat[v], hp.mat[v])
    for a, b in ((hk.t, hp.t), (hk.normal, hp.normal), (hk.uv, hp.uv)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("tables", ["box", "template"])
@pytest.mark.parametrize("max_t", ["finite", "inf"])
def test_cull_occlude_kernel_matches_plain(gpu_world6, tables, max_t):
    ro, rd = gpu_world6["rays"]["primary"]
    tab = gpu_world6["tables"][tables]
    tile = gpu_world6["tile"]
    o_p, d_p, cand, info = _lists(gpu_world6, ro, rd)
    hit = cull.cull_cast(o_p, d_p, cand, info, tile, tab)
    hit_t = torch.where(hit.valid, hit.t, 1.0)
    sq = shadow_rays(gpu_world6["scene"], o_p + hit_t[:, None] * d_p,
                     hit.valid)
    k = 0 if max_t == "finite" else 3
    o, d = sq[k], sq[k + 1].contiguous()
    mt = sq[2] if max_t == "finite" else torch.full_like(sq[2], np.inf)
    cand, info = cull.tile_candidates(o, d, tile, tab.inst_f32,
                                      cull.MAX_CAND)
    before = cull.cull_occlude.launches
    bk = cull.cull_occlude(o, d, mt, cand, info, tile, tab)
    assert cull.cull_occlude.launches == before + 1
    bp = cull.cull_occlude_reference(o, d, mt, cand, info, tile, tab)
    torch.cuda.synchronize()
    assert bk.dtype == torch.bool and torch.equal(bk, bp)
    assert 0 < int(bk.sum()) < bk.numel()


@pytest.mark.parametrize("rays", ["primary", "random"])
def test_mxu_kernel_matches_plain(gpu_world6, rays):
    data = mxu.prepare_mxu_cast(gpu_world6["scene"], gpu_world6["geom"],
                                gpu_world6["cfg"])
    o, d = gpu_world6["rays"][rays]
    lay = cull.CullLayout.of(o.shape[0], 1 << 19, data.tile)
    o_p, d_p = lay.pad_rays(o, d, 0.0)
    staging = mxu.stage_mxu(o_p, d_p, data)
    args = (staging[0], data.columns, data.n_tris) + staging[1:]
    before = mxu.mxu_cast.launches
    out_k = mxu.mxu_cast(*args, data.tile)
    assert mxu.mxu_cast.launches == before + 1
    out_p = mxu.mxu_cast_reference(*args, data.tile)
    torch.cuda.synchronize()
    for a, b in zip(out_k, out_p):
        assert torch.equal(a, b)
    assert bool(torch.isfinite(out_k[0]).any())


_ALL = (ce.bvh_cast, ce.bvh_occlude, ce.bvh_occlude2, cull.cull_cast,
        cull.cull_occlude, mxu.mxu_cast)


@pytest.mark.parametrize("path", ["cull", "mxu"])
def test_terrain6_frame_cuda_matches_torch_engine(gpu_world6, path):
    s, cam, cfg = gpu_world6["scene"], gpu_world6["cam"], gpu_world6["cfg"]
    if path == "mxu":
        cfg = cfg.replace(pallas_kernel="mxu")
    before = [k.launches for k in _ALL]
    img = render_frame(s, cam, cfg)
    torch.cuda.synchronize()
    n = [k.launches - b for k, b in zip(_ALL, before)]
    # cull: one K4 cast and two K5 queries; mxu: one K6 cast per light too
    assert n == ([0, 0, 0, 1, 2, 0] if path == "cull" else [0] * 5 + [3])
    ref = render_frame(s, cam, cfg.replace(engine="torch"))
    torch.testing.assert_close(img, ref, rtol=0.0, atol=1e-5)
