"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: each test skips (with a reason) when
``torch.cuda.is_available()`` is false, decided inside the test, never at
import.  Run on a GPU machine with::

    python -m pytest tests/test_torch_cuda.py -q -m gpu

K1 and K4 must give the plain version's hits exactly (valid, t, triangle,
uv, normal, material; also at 1080p, on K4's overflowed, empty-list and
degenerate tiles, on terrain8 forced onto the cull and for ray counts off
the 32- and 128-ray grid); K2's, K3's and K5's
masks must be identical (K2's and K3's on both frames' shadow queries, on
random and degenerate rays at finite and +inf max_t; K3's also to K2's;
K5's also on overflowed tiles,
parked lanes and degenerate rays); K6's t, id, u and v must equal its plain
version's (listed, dense and sky tiles, ties between a tile's chunks); a frame through the kernels must equal the ``"torch"``
engine at atol 1e-5 (terrain8 on the LBVH walk, terrain6 on the cull and on
the MXU cast), the per-light frame (K3) the fused one bit for bit; and the
loss gradients of both engines must agree at rtol 1e-4 / atol 1e-6.

The geometry-gradient path: K1's and K4's exact_uv instantiations equal
their plain versions in every output (primary, random, degenerate and
1080p rays); K1's visit counts equal its walk's replay
(``cuda_engine.k1_walk_replay``) and hold the O(log N) envelope at 16,384
instances; K4 and K5 on 9,216 instances (lists staged in pieces) equal
their plain versions, and the forced cull's frame the walk's; the vertex
gradients of both engines agree (verts at atol 1e-6 max|g|).

The bounce rounds: terrain8_stress (the aligned stream, K2 every round)
and terrain8_mixed (the compacted stream, the march through K1) render the
``"torch"`` engine's frame with nothing dropped, K1 gives the plain
version's hits on every later round's rays (refracted rays inside glass
boxes among them), the per-light frame equals the fused one, both
engines' gradients agree; the synthetic worlds render the ``"torch"``
engine's frames on the cull, the MXU cast and the walk, the forced cull
the walk's.  The first ``--orbit`` camera (``camera_motion`` on the card)
renders the ``"torch"`` engine's frame through one K1 and one K2 launch."""

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
    _assert_same_hits(hk, hp)
    assert int(hk.valid.sum()) > 0


def _assert_same_hits(hk, hp):
    for name in ("valid", "t", "wtri", "uv", "normal", "mat"):
        assert torch.equal(getattr(hk, name), getattr(hp, name)), name


def _degenerate(o, d, boxes):
    """Origins inside a box or on its corner, axis-parallel directions,
    components so small that 1 / d overflows."""
    idx = torch.arange(o.shape[0], device=o.device)
    box = boxes[idx % boxes.shape[0]]
    o = torch.where((idx % 5 == 0)[:, None],
                    0.5 * (box[:, :3] + box[:, 3:6]), o)
    o = torch.where((idx % 7 == 0)[:, None], box[:, :3], o)
    d = d.clone()
    d[idx % 3 == 0, 0] = 0.0
    d[idx % 4 == 0, 2] = 0.0
    d[idx % 11 == 0, 1] = 1e-42
    d[idx % 13 == 0, 0] = -1e-42
    d[(d == 0.0).all(-1), 1] = -1.0
    return o.contiguous(), d


@pytest.mark.parametrize("case", ["1080p", "degenerate", "ragged"])
def test_bvh_cast_kernel_hard_inputs(gpu_world, case):
    """K1 on a 1920x1080 frame's rays, on degenerate rays (both table
    kinds), and on ray counts off the 32- and 128-ray grid."""
    data = gpu_world["data"]["box"]
    o, d = gpu_world["rays"]["random"]
    if case == "1080p":
        cfg = gpu_world["cfg"].replace(width=1920, height=1080)
        w = rtt.generate(WORLD)
        cam = rtt.to_device(scale_camera(w.camera, 1920, w.config.width),
                            o.device)
        o, d, _, _ = _frame_rays_blocked(cam, cfg)
        assert o.shape[0] == 1920 * 1088
    todo = [(o, d, data)]
    if case == "degenerate":
        o, d = _degenerate(o, d, data.tables.inst_f32[:, :6])
        todo = [(o, d, data), (o, d, gpu_world["data"]["template"])]
    elif case == "ragged":
        todo = [(o[:n].contiguous(), d[:n].contiguous(), data)
                for n in (1, 31, 33, 127, 129, 4000)]
    for o_, d_, data_ in todo:
        hk = ce.bvh_cast(o_, d_, data_)
        hp = ce.bvh_cast_reference(o_, d_, data_)
        torch.cuda.synchronize()
        _assert_same_hits(hk, hp)
    assert int(hk.valid.sum()) > 0


def _shadow_queries(gpu_world, case="shadow"):
    """K2's six inputs, query 1 at finite max_t and query 2 at +inf: a
    frame's two shadow queries (to the point light and along the
    directional light; ``shadow`` at 160x120, ``shadow_1080p`` at
    1920x1080), the random rays at seeded random max_t and reversed at
    +inf, or degenerate rays made from them at both."""
    data = gpu_world["data"]["box"]
    if case.startswith("shadow"):
        ro, rd = gpu_world["rays"]["primary"]
        scene = gpu_world["scene"]
        if case == "shadow_1080p":
            cfg = gpu_world["cfg"].replace(width=1920, height=1080)
            w = rtt.generate(WORLD)
            cam = rtt.to_device(scale_camera(w.camera, 1920, w.config.width),
                                ro.device)
            ro, rd, _, _ = _frame_rays_blocked(cam, cfg)
        hit = ce.bvh_cast(ro, rd, data)
        t = torch.where(hit.valid, hit.t, 1.0)
        o1, d1, dist, o2, d2 = shadow_rays(scene, ro + t[:, None] * rd,
                                           hit.valid)
        return (o1, d1, dist, o2, d2.contiguous(),
                torch.full_like(dist, np.inf))
    o, d = gpu_world["rays"]["random"]
    mt = torch.from_numpy(np.random.default_rng(2).uniform(
        0.5, 12.0, o.shape[0]).astype(np.float32)).to(o.device)
    inf = torch.full_like(mt, np.inf)
    if case == "random":
        return (o, d, mt, o, (-d).contiguous(), inf)
    assert case == "degenerate"
    o, d = _degenerate(o, d, data.tables.inst_f32[:, :6])
    return (o, d, mt, o, d, inf)


OCC_CASES = ["shadow", "shadow_1080p", "random", "degenerate"]


@pytest.mark.parametrize("tables", ["box", "template"])
@pytest.mark.parametrize("case", OCC_CASES)
def test_bvh_occlude2_kernel_matches_plain(gpu_world, tables, case):
    q = _shadow_queries(gpu_world, case)
    data = gpu_world["data"][tables]
    before = ce.bvh_occlude2.launches
    bk = ce.bvh_occlude2(*q, data)
    assert ce.bvh_occlude2.launches == before + 1
    bp = ce.bvh_occlude2_reference(*q, data)
    torch.cuda.synchronize()
    for a, b in zip(bk, bp):
        assert torch.equal(a, b)
        assert 0 < int(a.sum()) < a.numel()


@pytest.mark.parametrize("tables", ["box", "template"])
@pytest.mark.parametrize("max_t", ["finite", "inf"])
@pytest.mark.parametrize("case", OCC_CASES)
def test_bvh_occlude_kernel_matches_plain(gpu_world, tables, max_t, case):
    q = _shadow_queries(gpu_world, case)
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


def test_walk_kernels_on_one_leaf(gpu_world):
    """A world of one cube: its LBVH is one leaf, the root (the kernels'
    ``n_leaves == 1`` branch); K1's hits and K2's and K3's masks equal
    their plain versions on seeded rays through and around the cube."""
    from raytracer_tpu_torch.builder import make_grid_world

    dev = gpu_world["cam"].pos.device
    world, _, cfg = make_grid_world(1)
    scene = rtt.to_device(world, dev)
    data = ce.prepare_cast(scene, expand_geometry(scene),
                           cfg.replace(pallas_traversal="bvh"))
    assert data.n_leaves == 1
    rng = np.random.default_rng(4)
    o = rng.uniform(-3.0, 4.0, (4096, 3)).astype(np.float32)
    d = rng.uniform(-0.6, 0.6, (4096, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o, d = torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)
    mt = torch.from_numpy(rng.uniform(0.5, 8.0, 4096).astype(
        np.float32)).to(dev)
    inf = torch.full_like(mt, np.inf)
    hk = ce.bvh_cast(o, d, data)
    bk = ce.bvh_occlude2(o, d, mt, o, d, inf, data)
    b3 = ce.bvh_occlude(o, d, mt, data)
    torch.cuda.synchronize()
    _assert_same_hits(hk, ce.bvh_cast_reference(o, d, data))
    bp = ce.bvh_occlude2_reference(o, d, mt, o, d, inf, data)
    assert torch.equal(bk[0], bp[0]) and torch.equal(bk[1], bp[1])
    assert torch.equal(b3, bp[0]) and 0 < int(b3.sum()) < b3.numel()


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
    # the pair walks need every leaf at one depth: a power of two of them
    three = ce.CastData(data.tables, data.nodes[-5:].contiguous(),
                        data.ordering[:3].contiguous())
    mt = torch.full((o.shape[0],), 4.0, device=o.device)
    with pytest.raises(RuntimeError):
        ce.bvh_cast(o, d, three)
    with pytest.raises(RuntimeError):
        ce.bvh_occlude(o, d, mt, three)
    with pytest.raises(RuntimeError):
        ce.bvh_occlude2(o, d, mt, o, d, mt, three)
    # K2 and K3 load a node row in two 16-byte pieces
    flat = torch.empty(data.nodes.numel() + 1, device=o.device)
    shifted = flat[1:].view(data.nodes.shape)
    shifted.copy_(data.nodes)
    with pytest.raises(ValueError):
        ce.bvh_occlude(o, d, mt, ce.CastData(data.tables, shifted,
                                             data.ordering))


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
    _assert_same_hits(hk, hp)
    assert int(hk.valid.sum()) > 0


@pytest.mark.parametrize("tables", ["box", "template"])
@pytest.mark.parametrize("case", ["overflow", "empty", "degenerate",
                                  "1080p"])
def test_cull_cast_kernel_hard_tiles(gpu_world6, tables, case):
    """K4 on the tiles where its staging and its exits are at stake: tiles
    whose lists overflow (every instance staged, table order), tiles with
    an empty list (misses, no ray read), degenerate rays, and the lists of
    a 1920x1080 frame (8,192-ray tiles)."""
    tab = gpu_world6["tables"][tables]
    tile = gpu_world6["tile"]
    o, d = gpu_world6["rays"]["primary"]
    if case == "overflow":  # incoherent rays: every tile's list overflows
        o, d = gpu_world6["rays"]["random"]
    elif case == "empty":  # whole tiles of sky rays: no pad row widens them
        o, d = (x.repeat(3, 1)[:2 * tile].contiguous()
                for x in _mxu_rays(gpu_world6, "sky"))
    elif case == "degenerate":
        o, d = _degenerate(*gpu_world6["rays"]["random"],
                           tab.inst_f32[:, :6])
    elif case == "1080p":
        cfg = gpu_world6["cfg"].replace(width=1920, height=1080)
        w = rtt.generate(WORLD6)
        cam = rtt.to_device(scale_camera(w.camera, 1920, w.config.width),
                            o.device)
        o, d, _, _ = _frame_rays_blocked(cam, cfg)
        tile = cull.tile_rows_of(cfg) * cull.LANES
    lay = cull.CullLayout.of(o.shape[0], gpu_world6["cfg"].pallas_ray_chunk,
                             tile)
    o, d = lay.pad_rays(o, d, 1.0e30)
    cand, info = cull.tile_candidates(o, d, tile, tab.inst_f32,
                                      cull.MAX_CAND)
    if case == "overflow":
        assert bool((info[:, 1] > 0).all())
    if case == "empty":
        assert int(info[:, 0].max()) == 0
    hk = cull.cull_cast(o, d, cand, info, tile, tab)
    hp = cull.cull_cast_reference(o, d, cand, info, tile, tab)
    torch.cuda.synchronize()
    _assert_same_hits(hk, hp)
    if case == "empty":
        assert not bool(hk.valid.any())
    else:
        assert int(hk.valid.sum()) > 0


def test_cull_cast_kernel_stages_terrain8(gpu_world):
    """terrain8 (380 instances) forced onto the cull: an overflowed tile
    stages all 380 entries; identical to the plain version, and the frame
    equal to the walk's."""
    s, cam, cfg = gpu_world["scene"], gpu_world["cam"], gpu_world["cfg"]
    tab = gpu_world["data"]["box"].tables
    assert tab.inst_f32.shape[0] == 380
    o, d = gpu_world["rays"]["random"]
    tile = cull.tile_rows_of(cfg) * cull.LANES
    lay = cull.CullLayout.of(o.shape[0], cfg.pallas_ray_chunk, tile)
    o, d = lay.pad_rays(o, d, 1.0e30)
    cand, info = cull.tile_candidates(o, d, tile, tab.inst_f32,
                                      cull.MAX_CAND)
    assert int(info[:, 0].max()) == 380
    hk = cull.cull_cast(o, d, cand, info, tile, tab)
    hp = cull.cull_cast_reference(o, d, cand, info, tile, tab)
    torch.cuda.synchronize()
    _assert_same_hits(hk, hp)
    img = render_frame(s, cam, cfg.replace(pallas_traversal="cull"))
    torch.testing.assert_close(img, render_frame(s, cam, cfg), rtol=0.0,
                               atol=1e-5)


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


def _cull_shadow_query(gpu_world6, max_t):
    """A shadow query of the primary frame on padded rays (missed lanes
    parked at 1e30): to the point light (finite max_t) or along the
    directional light (+inf)."""
    ro, rd = gpu_world6["rays"]["primary"]
    tab = gpu_world6["tables"]["box"]
    tile = gpu_world6["tile"]
    o_p, d_p, cand, info = _lists(gpu_world6, ro, rd)
    hit = cull.cull_cast(o_p, d_p, cand, info, tile, tab)
    hit_t = torch.where(hit.valid, hit.t, 1.0)
    sq = shadow_rays(gpu_world6["scene"], o_p + hit_t[:, None] * d_p,
                     hit.valid)
    k = 0 if max_t == "finite" else 3
    mt = sq[2] if max_t == "finite" else torch.full_like(sq[2], np.inf)
    return sq[k], sq[k + 1].contiguous(), mt, hit.valid


@pytest.mark.parametrize("tables", ["box", "template"])
@pytest.mark.parametrize("case", ["overflow", "parked", "degenerate"])
def test_cull_occlude_kernel_hard_tiles(gpu_world6, tables, case):
    """K5 where its early exits and its list staging are at stake: tiles
    whose lists overflow (every instance staged), tiles whose lanes are all
    parked, and rays the slab arithmetic treats specially (axis-parallel,
    origins inside a box, directions so small that 1 / d overflows, max_t of
    inf, 0 and NaN)."""
    tab = gpu_world6["tables"][tables]
    tile = gpu_world6["tile"]
    o, d, mt, valid = _cull_shadow_query(gpu_world6, "finite")
    if case == "parked":
        o = torch.full_like(o, 1.0e30)
    elif case == "degenerate":
        n = o.shape[0]
        idx = torch.arange(n, device=o.device)
        box = tab.inst_f32[idx % tab.inst_f32.shape[0]]
        centre = 0.5 * (box[:, ce._IF_BMIN:ce._IF_BMIN + 3]
                        + box[:, ce._IF_BMAX:ce._IF_BMAX + 3])
        o = torch.where((idx % 5 == 0)[:, None], centre, o)  # inside a box
        o = torch.where((idx % 7 == 0)[:, None],
                        box[:, ce._IF_BMIN:ce._IF_BMIN + 3], o)  # on a corner
        d = d.clone()
        d[idx % 3 == 0, 0] = 0.0  # axis-parallel
        d[idx % 4 == 0, 2] = 0.0
        d[idx % 11 == 0, 1] = 1e-42  # 1 / d overflows
        d[idx % 13 == 0, 0] = -1e-42
        mt = mt.clone()
        mt[idx % 2 == 0] = np.inf
        mt[idx % 17 == 0] = 0.0
        mt[idx % 19 == 0] = np.nan
    cand, info = cull.tile_candidates(o, d, tile, tab.inst_f32,
                                      cull.MAX_CAND)
    if case == "overflow":
        assert bool((info[:, 1] > 0).any())
        sel = torch.nonzero(info[:, 1] > 0).flatten()
        rows = (sel[:, None] * tile + torch.arange(
            tile, device=o.device)[None]).flatten()
        o, d, mt = o[rows].contiguous(), d[rows].contiguous(), mt[rows]
        cand, info = cand[sel].contiguous(), info[sel].contiguous()
        assert int(info[:, 0].min()) == tab.inst_f32.shape[0]
    bk = cull.cull_occlude(o, d, mt, cand, info, tile, tab)
    bp = cull.cull_occlude_reference(o, d, mt, cand, info, tile, tab)
    torch.cuda.synchronize()
    assert torch.equal(bk, bp)
    if case == "parked":
        assert not bool(bk.any())
    else:
        assert 0 < int(bk.sum()) < bk.numel()


def _mxu_staging(gpu_world6, o, d, k_cols=mxu.K_COLS):
    """K6's inputs for rays ``o, d``: the kernel's arguments and the plain
    version's (which also takes the staged columns)."""
    data = mxu.prepare_mxu_cast(gpu_world6["scene"], gpu_world6["geom"],
                                gpu_world6["cfg"], k_cols=k_cols)
    lay = cull.CullLayout.of(o.shape[0], 1 << 19, data.tile)
    o_p, d_p = lay.pad_rays(o, d, 0.0)
    info, staged, ids, rd6, rp8 = mxu.stage_mxu(o_p, d_p, data)
    lean = mxu.stage_mxu(o_p, d_p, data, columns=False)
    assert lean[1] is None
    for a, b in zip((info, ids, rd6, rp8), lean[:1] + lean[2:]):
        assert torch.equal(a, b)
    return (data,
            (info, data.columns, data.n_tris, ids, rd6, rp8, data.tile,
             data.max_tris),
            (info, data.columns, data.n_tris, staged, ids, rd6, rp8,
             data.tile))


def _mxu_rays(gpu_world6, rays):
    if rays in ("primary", "random"):
        return gpu_world6["rays"][rays]
    if rays == "sky":  # straight up from above the terrain: every list empty
        o, d = gpu_world6["rays"]["random"]
        o = o.clone()
        o[:, 1] += 50.0
        return o, torch.tensor([0.0, 1.0, 0.0], device=o.device).expand(
            o.shape).contiguous()
    o, d, _, _ = _cull_shadow_query(gpu_world6, "finite")
    return o, d


@pytest.mark.parametrize("k_cols", [mxu.K_COLS, 768])
@pytest.mark.parametrize("rays", ["primary", "random", "sky", "shadow"])
def test_mxu_kernel_matches_plain(gpu_world6, rays, k_cols):
    """K6 on listed tiles (primary), all-dense input (random rays), all-sky
    input and shadow rays (parked lanes: dense tiles among sky), with two
    list widths: t, id, u, v identical to the plain version."""
    o, d = _mxu_rays(gpu_world6, rays)
    data, args_k, args_p = _mxu_staging(gpu_world6, o, d, k_cols)
    info = args_k[0]
    before = mxu.mxu_cast.launches
    out_k = mxu.mxu_cast(*args_k)
    assert mxu.mxu_cast.launches == before + 1
    out_p = mxu.mxu_cast_reference(*args_p)
    torch.cuda.synchronize()
    for a, b in zip(out_k, out_p):
        assert torch.equal(a, b)
    if rays == "random":
        assert bool((info[:, 1] > 0).all())
    if rays == "sky":
        assert int(info.sum()) == 0 and not bool(
            torch.isfinite(out_k[0]).any())
    else:
        assert bool(torch.isfinite(out_k[0]).any())


def test_mxu_kernel_merges_chunks_to_the_first_minimum(gpu_world6):
    """A table whose second half repeats its first.  Listed tiles list every
    column twice (the copy later in the list, in other chunks), and a second
    launch sweeps the whole table densely: ties between chunks, which must
    fall to the first column in order whatever block finishes first."""
    o, d = gpu_world6["rays"]["primary"]
    data, args_k, _ = _mxu_staging(gpu_world6, o, d, 768)
    info, columns, n_tris, ids, rd6, rp8, tile, max_tris = args_k
    twice = torch.cat([columns[:n_tris], columns[:n_tris],
                       columns.new_zeros(2 * (columns.shape[0] - n_tris),
                                         mxu.COL)]).contiguous()
    half = ids.shape[1] // 2
    listed = (info[:, 1] == 0) & (info[:, 0] * max_tris <= half)
    assert bool(listed.any())
    ids2 = ids.clone()
    ids2[listed, half:] = torch.where(ids[listed, :half] >= 0,
                                      ids[listed, :half] + n_tris, -1.0)
    info2 = info.clone()
    info2[listed, 0] = ids.shape[1] // max_tris
    dense = torch.ones_like(info) * torch.tensor(
        [204, 1], dtype=torch.int32, device=info.device)
    for inf, idt in ((info2, ids2), (dense, ids)):
        out_k = mxu.mxu_cast(inf, twice, 2 * n_tris, idt, rd6, rp8, tile,
                             max_tris)
        out_p = mxu.mxu_cast_reference(inf, twice, 2 * n_tris,
                                       mxu.gather_columns(twice, idt), idt,
                                       rd6, rp8, tile)
        torch.cuda.synchronize()
        for a, b in zip(out_k, out_p):
            assert torch.equal(a, b)
        hit = torch.isfinite(out_k[0])
        assert bool(hit.any()) and bool((out_k[1][hit] < n_tris).all())


def test_mxu_kernel_block_stamps(gpu_world6):
    o, d = gpu_world6["rays"]["primary"]
    _, args_k, _ = _mxu_staging(gpu_world6, o, d)
    out = mxu.mxu_cast(*args_k, stamps=True)
    torch.cuda.synchronize()
    times = out[4]
    assert times.shape[0] > args_k[0].shape[0] and times.shape[1] == 2
    assert times.dtype == torch.int64
    assert bool((times[:, 0] > 0).all())
    assert bool((times[:, 1] >= times[:, 0]).all())
    for a, b in zip(out[:4], mxu.mxu_cast(*args_k)):
        assert torch.equal(a, b)


def test_cull_and_mxu_wrappers_reject_bad_inputs(gpu_world6):
    o, d = gpu_world6["rays"]["random"]
    _, args_k, _ = _mxu_staging(gpu_world6, o, d)
    info, columns, n_tris, ids, rd6, rp8, tile, max_tris = args_k
    with pytest.raises(TypeError):
        mxu.mxu_cast(info, columns, n_tris, ids.double(), rd6, rp8, tile,
                     max_tris)
    with pytest.raises(ValueError):
        mxu.mxu_cast(info, columns, n_tris, ids, rd6[:-1], rp8, tile,
                     max_tris)
    with pytest.raises(ValueError):
        mxu.mxu_cast(info, columns.cpu(), n_tris, ids, rd6, rp8, tile,
                     max_tris)
    with pytest.raises(ValueError):  # rows off the 16-byte grid
        shifted = torch.empty(rd6.numel() + 1, device=rd6.device)[1:]
        mxu.mxu_cast(info, columns, n_tris, ids,
                     shifted.view_as(rd6).copy_(rd6), rp8, tile, max_tris)
    with pytest.raises(ValueError):
        mxu.mxu_cast(info, columns, n_tris, ids, rd6, rp8, tile, 0)
    tab = gpu_world6["tables"]["box"]
    ctile = gpu_world6["tile"]
    o_p, d_p, cand, info5 = _lists(gpu_world6, o, d)
    mt = torch.ones(o_p.shape[0], device=o_p.device)
    with pytest.raises(TypeError):
        cull.cull_occlude(o_p, d_p, mt.double(), cand, info5, ctile, tab)
    with pytest.raises(ValueError):
        cull.cull_occlude(o_p, d_p, mt[:-1], cand, info5, ctile, tab)
    with pytest.raises(ValueError):
        cull.cull_occlude(o_p, d_p, mt.cpu(), cand, info5, ctile, tab)
    with pytest.raises(ValueError):
        cull.cull_occlude(o_p, d_p, mt, cand, info5, ctile + 128, tab)
    with pytest.raises(TypeError):
        cull.cull_occlude(o_p, d_p, mt, cand.long(), info5, ctile, tab)


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


# ---------------------------------------------------------------------------
# the geometry-gradient path: K1's and K4's exact_uv instantiations, K1's
# visit counts, the cull on lists of any length, the vertex gradients
# ---------------------------------------------------------------------------

def _exact_uv_rays(world, case, boxes):
    o, d = world["rays"]["primary" if case == "primary" else "random"]
    if case == "degenerate":
        o, d = _degenerate(o, d, boxes)
    elif case == "1080p":
        w = rtt.generate(world["path"])
        cfg = world["cfg"].replace(width=1920, height=1080)
        cam = rtt.to_device(scale_camera(w.camera, 1920, w.config.width),
                            o.device)
        o, d, _, _ = _frame_rays_blocked(cam, cfg)
    return o, d


@pytest.mark.parametrize("case", ["primary", "random", "degenerate",
                                  "1080p"])
def test_bvh_cast_exact_uv_kernel_matches_plain(gpu_world, case):
    """K1's exact_uv instantiation against ``bvh_cast_reference(exact_uv=
    True)`` over the box_exact_uv tables, every output identical."""
    s = gpu_world["scene"]
    geom = expand_geometry(s)
    data = ce.prepare_cast(s, geom, gpu_world["cfg"].replace(
        edge_aware_grads=True))
    o, d = _exact_uv_rays(dict(gpu_world, path=WORLD), case,
                          data.tables.inst_f32[:, :6])
    before = ce.bvh_cast.launches
    hk = ce.bvh_cast(o, d, data, exact_uv=True)
    assert ce.bvh_cast.launches == before + 1
    hp = ce.bvh_cast_reference(o, d, data, exact_uv=True)
    torch.cuda.synchronize()
    _assert_same_hits(hk, hp)
    assert int(hk.valid.sum()) > 0
    assert float((hk.uv[hk.valid] - 1.0 / 3.0).abs().max()) > 0.1


def test_bvh_visits_kernel_equals_its_walk(gpu_world):
    """K1's visits instantiation counts the node boxes its walk tests: its
    plain version's count (the replay's), which is the per-thread walk's
    plus two for each stale kept vote; its steps are no more than the
    per-thread walk's visits."""
    data = gpu_world["data"]["box"]
    for rays in ("primary", "random"):
        o, d = gpu_world["rays"][rays]
        before = ce.bvh_visit_counts.launches
        v = ce.bvh_visit_counts(o, d, data)
        assert ce.bvh_visit_counts.launches == before + 1
        plain = ce.bvh_visit_counts_reference(o, d, data)
        _, replay, stale = ce.k1_walk_replay(o, d, data)
        work = torch.zeros(o.shape[0], len(ce.WORK_COLUMNS),
                           dtype=torch.int64, device=o.device)
        ce.bvh_cast_reference(o, d, data, work=work)
        torch.cuda.synchronize()
        assert torch.equal(v, plain)
        assert torch.equal(replay.to(torch.int32), plain)
        assert torch.equal(replay, work[:, 0] + 2 * stale)
        assert bool(((replay - 1) // 2 <= work[:, 0]).all())


def test_bvh_visits_scale_logarithmically_on_the_card():
    """``tests/test_accel.py``'s envelope on the kernel's counts: 64x the
    instances (16,384 against 256 touching cubes) cost under 4x the
    visits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    from raytracer_tpu_torch.builder import make_grid_world

    dev = torch.device("cuda", 0)
    mean = {}
    for side in (16, 128):
        scene_np, _, cfg = make_grid_world(side)
        scene = rtt.to_device(scene_np, dev)
        data = ce.prepare_cast(scene, expand_geometry(scene),
                               cfg.replace(pallas_traversal="bvh"))
        xs = torch.linspace(0.5 * side - 6.0, 0.5 * side + 6.0, 32,
                            device=dev)
        gx, gz = torch.meshgrid(xs, xs, indexing="xy")
        o = torch.stack([gx.reshape(-1), torch.full_like(gx, 10.0)
                         .reshape(-1), gz.reshape(-1)], -1).contiguous()
        d = torch.tensor([0.0, -1.0, 0.0], device=dev).expand_as(o)
        d = d.contiguous()
        assert bool(ce.bvh_cast(o, d, data).valid.all())
        mean[side] = float(ce.bvh_visit_counts(o, d, data).float().mean())
    assert mean[16] < mean[128] < 4.0 * mean[16], mean


@pytest.mark.parametrize("case", ["primary", "random", "degenerate",
                                  "1080p"])
def test_cull_cast_exact_uv_kernel_matches_plain(gpu_world6, case):
    tab = ce.prepare_cast(gpu_world6["scene"], gpu_world6["geom"],
                          gpu_world6["cfg"].replace(
                              edge_aware_grads=True)).tables
    o, d = _exact_uv_rays(dict(gpu_world6, path=WORLD6), case,
                          tab.inst_f32[:, :6])
    cfg = gpu_world6["cfg"]
    if case == "1080p":
        cfg = cfg.replace(width=1920, height=1080)
    tile = cull.tile_rows_of(cfg) * cull.LANES
    lay = cull.CullLayout.of(o.shape[0], cfg.pallas_ray_chunk, tile)
    o_p, d_p = lay.pad_rays(o, d, 1.0e30)
    cand, info = cull.tile_candidates(o_p, d_p, tile, tab.inst_f32,
                                      cull.MAX_CAND)
    hk = cull.cull_cast(o_p, d_p, cand, info, tile, tab, exact_uv=True)
    hp = cull.cull_cast_reference(o_p, d_p, cand, info, tile, tab,
                                  exact_uv=True)
    torch.cuda.synchronize()
    _assert_same_hits(hk, hp)
    assert int(hk.valid.sum()) > 0


@pytest.fixture(scope="module")
def gpu_grid96():
    """96 x 96 touching cubes (9,216 instances): above every instance
    count K4 and K5 staged whole before lists came in pieces."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    from raytracer_tpu_torch.builder import make_grid_world

    dev = torch.device("cuda", 0)
    scene_np, cam, cfg = make_grid_world(96)
    scene = rtt.to_device(scene_np, dev)
    cam = rtt.to_device(scale_camera(cam, 160, 640), dev)
    cfg = cfg.replace(engine="cuda", width=160, height=120,
                      pallas_traversal="cull", tile_rows=8)
    data = ce.prepare_cast(scene, expand_geometry(scene), cfg)
    assert data.nodes is None
    return dict(scene=scene, cam=cam, cfg=cfg, tables=data.tables,
                tile=8 * cull.LANES)


def test_cull_kernels_on_9216_instances(gpu_grid96):
    g = gpu_grid96
    ro, rd, _, _ = _frame_rays_blocked(g["cam"], g["cfg"])
    lay = cull.CullLayout.of(ro.shape[0], g["cfg"].pallas_ray_chunk,
                             g["tile"])
    o_p, d_p = lay.pad_rays(ro, rd, 1.0e30)
    cand, info = cull.tile_candidates(o_p, d_p, g["tile"],
                                      g["tables"].inst_f32, cull.MAX_CAND)
    over = (info[:, 1] > 0).nonzero().flatten()[:2].tolist()
    listed = ((info[:, 1] == 0) & (info[:, 0] > 0)).nonzero().flatten()
    pick = over + listed[:1].tolist()
    assert len(over) == 2 and int(info[over[0], 0]) == 9216
    tile = g["tile"]
    sel = torch.cat([torch.arange(t * tile, (t + 1) * tile,
                                  device=ro.device) for t in pick])
    o, d = o_p[sel].contiguous(), d_p[sel].contiguous()
    c, i = cand[pick].contiguous(), info[pick].contiguous()
    hk = cull.cull_cast(o, d, c, i, tile, g["tables"])
    hp = cull.cull_cast_reference(o, d, c, i, tile, g["tables"])
    torch.cuda.synchronize()
    _assert_same_hits(hk, hp)
    assert int(hk.valid.sum()) > 0
    t = torch.where(hk.valid, hk.t, 1.0)
    o1, d1, dist, _, _ = shadow_rays(g["scene"], o + t[:, None] * d,
                                     hk.valid)
    c5, i5 = cull.tile_candidates(o1, d1, tile, g["tables"].inst_f32,
                                  cull.MAX_CAND)
    bk = cull.cull_occlude(o1, d1, dist, c5, i5, tile, g["tables"])
    bp = cull.cull_occlude_reference(o1, d1, dist, c5, i5, tile,
                                     g["tables"])
    torch.cuda.synchronize()
    assert torch.equal(bk, bp)


def test_cull_frame_on_9216_instances_equals_walk(gpu_grid96):
    g = gpu_grid96
    before = (cull.cull_cast.launches, cull.cull_occlude.launches)
    img = render_frame(g["scene"], g["cam"], g["cfg"])
    torch.cuda.synchronize()
    assert cull.cull_cast.launches == before[0] + 1
    assert cull.cull_occlude.launches == before[1] + 2
    walk = render_frame(g["scene"], g["cam"], g["cfg"].replace(
        pallas_traversal="bvh"))
    torch.testing.assert_close(img, walk, rtol=0.0, atol=1e-5)
    assert float((img[..., :3].amax(-1) > 0).float().mean()) > 0.3


@pytest.mark.parametrize("case", ["terrain8", "terrain6", "terrain6_mxu"])
def test_vertex_grads_cuda_match_torch_engine(gpu_world, gpu_world6, case):
    """The geometry-gradient step (``edge_aware_grads``, vertices
    trainable) through the exact_uv kernels and the reparam rule: grads
    equal to the ``"torch"`` engine's, verts at atol 1e-6 max|g| (per-vertex
    sums in another order), the forward frame the plain one."""
    w = gpu_world if case == "terrain8" else gpu_world6
    s, cam, cfg = w["scene"], w["cam"], w["cfg"].replace(
        edge_aware_grads=True)
    if case == "terrain6_mxu":
        cfg = cfg.replace(pallas_kernel="mxu")
    assert torch.equal(render_frame(s, cam, cfg), render_frame(
        s, cam, cfg.replace(edge_aware_grads=False)))
    target = torch.zeros(cfg.height, cfg.width, 4, device=cam.pos.device)
    grads = {}
    for engine in ("cuda", "torch"):
        params = diff.trainable_params(s, cam, include_vertices=True)
        loss = diff.make_loss_fn(s, cam, cfg.replace(engine=engine),
                                 target)(params)
        grads[engine] = diff.grad_of(loss, params)
    assert float(grads["cuda"]["verts"].abs().max()) > 0.0
    for (key, a), b in zip(tree.leaves_with_paths(grads["cuda"]),
                           tree.leaves(grads["torch"])):
        assert bool(torch.isfinite(a).all()), key
        atol = 1e-6 * float(b.abs().max()) if key == "['verts']" else 1e-6
        torch.testing.assert_close(a, b, rtol=1e-4, atol=atol, msg=key)


# ---------------------------------------------------------------------------
# the bounce rounds: the reflective and the mixed terrain, the synth worlds
# ---------------------------------------------------------------------------

BOUNCE_WORLDS = {"stress": "terrain8_stress.json", "mixed": "terrain8_mixed.json"}


@pytest.fixture(scope="module", params=sorted(BOUNCE_WORLDS))
def gpu_bounce(request):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    dev = torch.device("cuda", 0)
    w = rtt.generate(os.path.join(REPO, "raytracer_tpu_torch", "worlds",
                                  BOUNCE_WORLDS[request.param]))
    scene = rtt.to_device(w.scene, dev)
    cfg = w.config.replace(engine="cuda", width=160, height=120)
    cam = rtt.to_device(scale_camera(w.camera, 160, w.config.width), dev)
    return dict(name=request.param, scene=scene, cfg=cfg, cam=cam)


def test_bounce_frame_cuda_matches_torch_engine(gpu_bounce):
    from raytracer_tpu_torch.render.engine import render_frame_with_stats

    g = gpu_bounce
    img, stats = render_frame_with_stats(g["scene"], g["cam"], g["cfg"])
    ref = render_frame(g["scene"], g["cam"], g["cfg"].replace(engine="torch"))
    assert int(stats["dropped"]) == 0
    assert torch.isfinite(img).all()
    assert float((img - ref).abs().max()) <= 1e-5
    if g["name"] == "stress":  # the per-light round gives the fused frame
        assert torch.equal(img, render_frame(
            g["scene"], g["cam"], g["cfg"].replace(fused_shadows=False)))


def test_bounce_rounds_k1_matches_plain(gpu_bounce):
    """K1 on each later round's rays (refracted rays inside glass boxes
    among them in the mixed world) gives the plain version's hits."""
    from raytracer_tpu_torch.render import engine

    g = gpu_bounce
    scene, cfg = g["scene"], g["cfg"]
    geom = expand_geometry(scene)
    data = ce.prepare_cast(scene, geom, cfg)
    ro, rd, _, _ = _frame_rays_blocked(g["cam"], cfg)
    waves = []
    engine.radiance(scene, geom, engine.make_cast(scene, geom, cfg), cfg, ro,
                    rd, on_round=lambda r, st: waves.append(st))
    assert len(waves) == 3
    inside = 0
    for w in waves[1:]:
        o = torch.where(w.active[:, None], w.o, 1e30).contiguous()
        hk = ce.bvh_cast(o, w.d.contiguous(), data)
        hp = ce.bvh_cast_reference(o, w.d.contiguous(), data)
        for name in ("valid", "t", "wtri", "uv", "normal", "mat"):
            assert torch.equal(getattr(hk, name), getattr(hp, name)), name
        inside += int((w.active & w.in_obj).sum())
    assert (inside > 0) == (g["name"] == "mixed")


def test_bounce_grads_cuda_match_torch_engine(gpu_bounce):
    g = gpu_bounce
    target = torch.zeros(g["cfg"].height, g["cfg"].width, 4,
                         device=g["scene"].verts.device)
    grads = {}
    for engine in ("cuda", "torch"):
        params = diff.trainable_params(g["scene"], g["cam"])
        loss = diff.make_loss_fn(g["scene"], g["cam"], g["cfg"].replace(
            engine=engine, early_exit=False), target)(params)
        grads[engine] = diff.grad_of(loss, params)
    for (key, a), b in zip(tree.leaves_with_paths(grads["cuda"]),
                           tree.leaves(grads["torch"])):
        assert torch.isfinite(a).all(), key
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6, msg=key)
    assert float(grads["cuda"]["materials"].kr.abs().max()) > 0.0


@pytest.mark.parametrize("case", ["mixed_cull", "sphere_cull", "sphere_mxu",
                                  "big_walk"])
def test_synth_frames_cuda_match_torch_engine(case):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    from raytracer_tpu_torch import synth

    dev = torch.device("cuda", 0)
    make = {"mixed": lambda: synth.make_mixed_world(depth=3),
            "sphere": synth.make_sphere_world,
            "big": lambda: synth.make_big_world(4096)}[case.split("_")[0]]
    scene_np, cam_np, cfg = make()
    scene, cam = rtt.to_device(scene_np, dev), rtt.to_device(cam_np, dev)
    cfg = cfg.replace(engine="cuda",
                      pallas_kernel="mxu" if case == "sphere_mxu" else "scalar")
    img = render_frame(scene, cam, cfg)
    ref = render_frame(scene, cam, cfg.replace(engine="torch"))
    assert float((img - ref).abs().max()) <= 1e-5
    if case == "big_walk":  # forced onto the cull: the walk's frame
        forced = render_frame(scene, cam, cfg.replace(pallas_traversal="cull"))
        assert float((forced - img).abs().max()) <= 1e-5


# ---------------------------------------------------------------------------
# spp > 1: jittered samples, the kept tiles, the checkpointed step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["walk", "walk_static", "cull",
                                  "cull_static", "mxu"])
def test_spp_frame_cuda_matches_torch_engine(gpu_world, gpu_world6, case):
    """spp 4 at 160x120 through the kernels: the ``"torch"`` engine's frame,
    nothing dropped, each kernel launched once a sample (the probe of the
    kept tiles once more): terrain8 on the walk, terrain6 on the cull and
    the MXU cast, and with ``auto_tile_caps``' kept tiles (terrain6's,
    also forced onto the walk: terrain8's frame at this size keeps every
    tile)."""
    from raytracer_tpu_torch.render import engine

    g = gpu_world if case == "walk" else gpu_world6
    s, cam = g["scene"], g["cam"]
    cfg = g["cfg"].replace(spp=4, pallas_kernel="mxu" if case == "mxu"
                           else "scalar")
    if case == "walk_static":
        cfg = cfg.replace(pallas_traversal="bvh")
    if case.endswith("static"):
        cfg = cfg.replace(static_tile_cap=engine.auto_tile_caps(
            s, cam, cfg)["static_tile_cap"])
        assert 0.0 < cfg.static_tile_cap < 1.0
    cast = {"walk": ce.bvh_cast, "cull": cull.cull_cast,
            "mxu": mxu.mxu_cast}[case.split("_")[0]]
    n = cast.launches
    img, stats = engine.render_frame_with_stats(s, cam, cfg)
    torch.cuda.synchronize()
    per_sample = 3 if case == "mxu" else 1  # K6 casts the shadows too
    assert cast.launches - n == 4 * per_sample + case.endswith("static")
    assert int(stats["dropped"]) == 0
    ref = render_frame(s, cam, cfg.replace(engine="torch"))
    torch.testing.assert_close(img, ref, rtol=0.0, atol=1e-5)


@pytest.mark.parametrize("chunk", [None, 2])
def test_spp_grads_cuda_match_torch_engine(gpu_world, chunk):
    """``make_spp_grad_fn`` at spp 4 through the kernels: the ``"torch"``
    engine's loss and grads; the backward launches no any-hit query."""
    s, cam, cfg = gpu_world["scene"], gpu_world["cam"], gpu_world["cfg"]
    cfg = cfg.replace(early_exit=False)
    target = torch.zeros(cfg.height, cfg.width, 4, device=cam.pos.device)
    out = {}
    for engine in ("cuda", "torch"):
        params = diff.trainable_params(s, cam)
        out[engine] = diff.make_spp_grad_fn(
            s, cam, cfg.replace(engine=engine), 4, spp_chunk=chunk)(params,
                                                                    target)
    loss_c, g_c = out["cuda"]
    loss_t, g_t = out["torch"]
    assert float(loss_c) == pytest.approx(float(loss_t), rel=1e-6)
    assert float(g_c["cam_pos"].abs().max()) > 0.0
    for a, b in zip(tree.leaves(g_c), tree.leaves(g_t)):
        assert bool(torch.isfinite(a).all())
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)


def test_spp_backward_launches_no_any_hit_query(gpu_world):
    s, cam, cfg = gpu_world["scene"], gpu_world["cam"], gpu_world["cfg"]
    cfg = cfg.replace(early_exit=False, spp=4)
    params = diff.trainable_params(s, cam)
    loss = diff.make_loss_fn(s, cam, cfg, torch.zeros(
        cfg.height, cfg.width, 4, device=cam.pos.device))(params)
    torch.cuda.synchronize()
    n1, n2 = ce.bvh_cast.launches, ce.bvh_occlude2.launches
    diff.grad_of(loss, params)
    torch.cuda.synchronize()
    assert ce.bvh_occlude2.launches == n2
    assert ce.bvh_cast.launches == n1 + 4  # every sample's cast again


def test_orbit_frame_cuda_matches_torch_engine(gpu_world):
    """The first camera of ``--orbit`` (``camera_motion.orbit_frames``, on
    the card): the kernels' frame against the ``"torch"`` engine's, one K1
    and one K2 launch, the camera on the card."""
    from raytracer_tpu_torch import camera_motion as cm

    s, cam, cfg = gpu_world["scene"], gpu_world["cam"], gpu_world["cfg"]
    cam0 = next(cm.orbit_frames(cam, 1))
    assert cam0.rot.device == cam.rot.device
    assert not torch.equal(cam0.rot, cam.rot)
    n1, n2 = ce.bvh_cast.launches, ce.bvh_occlude2.launches
    img = render_frame(s, cam0, cfg)
    torch.cuda.synchronize()
    assert (ce.bvh_cast.launches - n1, ce.bvh_occlude2.launches - n2) == (1, 1)
    ref = render_frame(s, cam0, cfg.replace(engine="torch"))
    assert float((img - ref).abs().max()) <= 1e-5
