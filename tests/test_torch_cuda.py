"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: each test skips (with a reason) when
``torch.cuda.is_available()`` is false, decided inside the test, never at
import.  Run on a GPU machine with::

    python -m pytest tests/test_torch_cuda.py -q -m gpu

K1 and K4 must give the plain version's valid, triangle and material
exactly, t at rtol 1e-5 and normals/uv at atol 1e-5; K2's, K3's and K5's
masks must be identical (K3's also to K2's; K5's also on overflowed tiles,
parked lanes and degenerate rays); K6's t, id, u and v must equal its plain
version's (listed, dense and sky tiles, ties between a tile's chunks); a frame through the kernels must equal the ``"torch"``
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
