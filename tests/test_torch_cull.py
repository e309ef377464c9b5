"""The candidate-list cull of the PyTorch port against the JAX package.

On terrain6 (204 instances, so ``pallas_traversal="auto"`` takes the cull in
both packages), on the CPU, with the same numpy-made rays handed to both:

* ``tile_candidates``: ``cand`` and ``info`` identical to
  ``pallas_engine.tile_candidates``, per tile on one chunk and per ray
  through ``cast._chunked_over_rays`` on several, for primary rays and for
  shadow rays with parked (origin 1e30) lanes; the port's padded layout
  equal to ``_pad_rays``'s;
* K4's plain version (through the engine's cast) against
  ``cast_vjp._pallas_chunked_cast`` (Pallas in interpret mode), box and
  template tables: valid and material exact, t rtol 1e-5, normals atol 1e-5,
  triangle ids at box-face granularity (``tests/test_pallas.py:29-59``;
  exact, with uv, on template tables);
* K5's plain version against ``_pallas_chunked_occlude``: masks identical
  for max_t 0.5, 2.0, inf and per ray, and equal to ``valid & t <= max_t``;
* frames at atol 1e-5 against JAX ``render_frame`` (48x32, and 64x64 with
  ``tile_rows=8`` so that there are several tiles and an overflow), the cull
  frame equal to the port's own LBVH frame, and loss gradients against
  ``jax.grad`` leaf by leaf at rtol 1e-5 / atol 1e-6;
* the CLI's ``-d`` mapping and a CLI render through the cull.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import raytracer_tpu as jrt
from raytracer_tpu import diff as jdiff
from raytracer_tpu.builder import scale_camera as jscale_camera
from raytracer_tpu.render import cast as jcast
from raytracer_tpu.render import cast_vjp as jcast_vjp
from raytracer_tpu.render import geometry as jgeometry
from raytracer_tpu.render import pallas_engine as pe
from raytracer_tpu.render import render_frame as jrender_frame
from raytracer_tpu.scene import device_scene

from raytracer_tpu_torch import cli, convert, diff, tree
from raytracer_tpu_torch.render import cuda_engine as ce
from raytracer_tpu_torch.render import cull, geometry, shading
from raytracer_tpu_torch.render.engine import make_cast, render_frame

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = os.path.join(REPO, "raytracer_tpu_torch", "worlds", "terrain6.json")
RTOL_GRAD, ATOL_GRAD = 1e-5, 1e-6


@pytest.fixture(scope="module")
def world():
    jw = jrt.generate(WORLD)
    jscene = device_scene(jw.scene)
    jgeom = jgeometry.expand_geometry(jscene)
    scene = convert.scene_from_numpy(jw.scene)
    geom = geometry.expand_geometry(scene)
    return dict(jw=jw, jscene=jscene, jgeom=jgeom, scene=scene, geom=geom)


def _primary(world, w, h):
    cam = jax.tree_util.tree_map(
        jnp.asarray, jscale_camera(world["jw"].camera, w,
                                   world["jw"].config.width))
    ro, rd = jgeometry.camera_rays(cam, w, h)
    return (np.array(ro, np.float32).reshape(-1, 3),
            np.array(rd, np.float32).reshape(-1, 3))


def _shadow(world, ro, rd):
    """The directional light's shadow query from the primary hits of
    ``ro``/``rd``; lanes that missed park at 1e30, as ``shadow_rays``
    parks them."""
    jaux = pe.prepare_pallas_cast(world["jscene"], world["jgeom"],
                                  _jcfg(world))
    hit = jcast_vjp._pallas_chunked_cast(_jcfg(world), jnp.asarray(ro),
                                         jnp.asarray(rd), jaux)
    valid = np.asarray(hit.valid)
    t = np.where(valid, np.asarray(hit.t), 1.0)
    pos = ro + t[:, None] * rd
    ldir = -np.array([0.3, -1.0, 0.5], np.float32)
    ldir = np.broadcast_to(ldir / np.linalg.norm(ldir), pos.shape)
    park = np.where(valid[:, None], pos, np.float32(1e30))
    return ((park + np.float32(1e-5) * ldir).astype(np.float32),
            np.ascontiguousarray(ldir, np.float32))


def _random(n=1024, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
    o[:, 1] += 4.0
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _jcfg(world, **change):
    return world["jw"].config.replace(engine="pallas", **change)


# ---------------------------------------------------------------------------
# tile candidates and the ray layout
# ---------------------------------------------------------------------------

LAYOUTS = {
    # name: (frame w, h, tile_rows, ray chunk)
    "48x32": (48, 32, 48, 1 << 19),  # one padded tile
    "64x64_rows8": (64, 64, 8, 1 << 19),  # 4 tiles
    "64x64_chunked": (64, 64, 8, 1500),  # 3 chunks of 2 tiles
}


@pytest.mark.parametrize("rays", ["primary", "shadow"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_tile_candidates_match_jax(world, layout, rays):
    w, h, rows, chunk = LAYOUTS[layout]
    ro, rd = _primary(world, w, h)
    if rays == "shadow":
        ro, rd = _shadow(world, ro, rd)
    tile = rows * cull.LANES
    jtab = pe.build_tables(world["jscene"], world["jgeom"])
    tab = ce.build_tables(world["scene"], world["geom"])
    lay = cull.CullLayout.of(ro.shape[0], chunk, tile)
    ro_p, rd_p = lay.pad_rays(torch.from_numpy(ro), torch.from_numpy(rd),
                              1.0e30)
    cand, info = cull.tile_candidates(ro_p, rd_p, tile, tab.inst_f32,
                                      cull.MAX_CAND)
    assert cand.dtype == info.dtype == torch.int32
    assert cand.shape == (lay.n_tiles, cull.MAX_CAND)

    # per ray, through the JAX package's own chunking and padding
    def lists(ro_c, rd_c):
        comps, r, _, _ = pe._pad_rays(ro_c, rd_c, tile)
        jc, ji = pe.tile_candidates(comps, rows, jtab.inst_f32,
                                    cull.MAX_CAND)
        of = jnp.arange(r) // tile
        return jc[of], ji[of]

    jc_r, ji_r = jcast._chunked_over_rays(chunk, pad_origin=1.0e30)(lists)(
        jnp.asarray(ro), jnp.asarray(rd))
    of = lay.unpad(torch.arange(lay.n_padded) // tile)
    np.testing.assert_array_equal(cand[of].numpy(), np.asarray(jc_r))
    np.testing.assert_array_equal(info[of].numpy(), np.asarray(ji_r))
    if lay.n_chunks == 1:  # per tile, and the padded rays themselves
        comps, _, _, _ = pe._pad_rays(jnp.asarray(ro), jnp.asarray(rd), tile)
        jc, ji = pe.tile_candidates(comps, rows, jtab.inst_f32,
                                    cull.MAX_CAND)
        np.testing.assert_array_equal(cand.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(info.numpy(), np.asarray(ji))
        padded = np.stack([np.asarray(c).reshape(-1) for c in comps], -1)
        np.testing.assert_array_equal(
            torch.cat([ro_p, rd_p], -1).numpy(), padded)
    info = info.numpy()
    assert (info[:, 0] <= world["scene"].inst_pos.shape[0]).all()
    if layout == "64x64_rows8":  # several tiles, listed and overflowing
        assert (info[:, 1] == 0).any() and (info[:, 1] == 1).any()


def test_layout_pads_and_unpads():
    lay = cull.CullLayout.of(1000, 384, 256)
    assert (lay.chunk, lay.n_chunks, lay.chunk_p) == (384, 3, 512)
    x = torch.arange(1000, dtype=torch.float32)[:, None].expand(1000, 3)
    p = lay.pad(x, 7.0)
    assert p.shape == (1536, 3)
    assert torch.equal(lay.unpad(p), x)
    # chunk 3 holds rays 768..999 and 152 first-step pad rows, then 128
    assert torch.equal(p[1024:1024 + 232, 0], torch.arange(768.0, 1000.0))
    assert (p[1024 + 232:, 0] == 7.0).all() and (p[384:512] == 7.0).all()
    assert cull.CullLayout.of(0, 1 << 19, 6144).n_padded == 6144


@pytest.mark.parametrize("wh", [(640, 480), (1920, 1080), (64, 48),
                                (4000, 3000)])
def test_auto_tile_rows_matches_jax(wh):
    assert cull.auto_tile_rows(*wh) == pe.auto_tile_rows(*wh)


# ---------------------------------------------------------------------------
# K4 and K5 (plain versions) against the Pallas kernels
# ---------------------------------------------------------------------------

def _casts(world, tables, **change):
    """(JAX aux, port CastData, jcfg, port cfg) on the cull."""
    jcfg = _jcfg(world, pallas_traversal="cull", **change)
    jaux = pe.prepare_pallas_cast(world["jscene"], world["jgeom"], jcfg)
    cfg = convert.config_from_jax(jcfg)
    data = ce.prepare_cast(world["scene"], world["geom"], cfg)
    assert data.nodes is None and data.ordering is None
    if tables == "template":
        jaux = dict(jaux, tables=pe.build_tables(
            world["jscene"], world["jgeom"], exact_uv=True))
        data = ce.CastData(tables=ce.build_tables(
            world["scene"], world["geom"], exact_uv=True))
    return jaux, data, jcfg, cfg


RAYS = {
    "primary_48x32": lambda world: _primary(world, 48, 32),
    "primary_64x64_rows8": lambda world: _primary(world, 64, 64),
    "random": lambda world: _random(),
}


@pytest.mark.parametrize("tables", ["box", "template"])
@pytest.mark.parametrize("rays", sorted(RAYS))
def test_cull_cast_matches_pallas(world, tables, rays):
    change = {"tile_rows": 8} if rays.endswith("rows8") else {}
    jaux, data, jcfg, cfg = _casts(world, tables, **change)
    o, d = RAYS[rays](world)
    jh = jcast_vjp._pallas_chunked_cast(jcfg, jnp.asarray(o), jnp.asarray(d),
                                        jaux)
    th = cull.make_cull_cast(data, cfg.replace(engine="torch"))(
        torch.from_numpy(o), torch.from_numpy(d))

    jv = np.asarray(jh.valid)
    tv = th.valid.numpy()
    assert 0 < jv.sum() < jv.size
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_allclose(th.t.detach().numpy()[tv], np.asarray(jh.t)[tv],
                               rtol=1e-5, atol=0)
    np.testing.assert_allclose(th.normal.numpy()[tv],
                               np.asarray(jh.normal)[tv], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(th.mat.numpy()[tv], np.asarray(jh.mat)[tv])
    tw, jwt = th.wtri.numpy()[tv], np.asarray(jh.wtri)[tv]
    inst = np.asarray(world["jgeom"].inst)
    np.testing.assert_array_equal(inst[tw], inst[jwt])
    face = np.asarray(pe._detect_box_meshes(world["jscene"])[3])[
        np.asarray(world["jscene"].wtri_tri)]
    np.testing.assert_array_equal(face[tw], face[jwt])
    if tables == "template":
        np.testing.assert_array_equal(tw, jwt)
        np.testing.assert_allclose(th.uv.detach().numpy()[tv],
                                   np.asarray(jh.uv)[tv], rtol=0, atol=1e-5)
    miss = ~tv
    assert np.isinf(th.t.detach().numpy()[miss]).all()
    assert (th.wtri.numpy()[miss] == 0).all()


def _max_ts(n, kind):
    if kind == "per_ray":
        return np.random.default_rng(5).uniform(0.1, 10.0, n).astype(
            np.float32)
    return np.full(n, {"0.5": 0.5, "2.0": 2.0, "inf": np.inf}[kind],
                   np.float32)


@pytest.mark.parametrize("tables", ["box", "template"])
@pytest.mark.parametrize("max_t", ["0.5", "2.0", "inf", "per_ray"])
def test_cull_occlude_matches_pallas(world, tables, max_t):
    jaux, data, jcfg, cfg = _casts(world, tables, tile_rows=8)
    po, pd = _primary(world, 64, 64)
    so, sd = _shadow(world, po, pd)
    ro_, rd_ = _random(512, seed=7)
    o = np.concatenate([po, so, ro_])
    d = np.concatenate([pd, sd, rd_])
    mt = _max_ts(o.shape[0], max_t)
    j = np.asarray(jcast_vjp._pallas_chunked_occlude(
        jcfg, jnp.asarray(o), jnp.asarray(d), jnp.asarray(mt), jaux))
    cast = cull.make_cull_cast(data, cfg.replace(engine="torch"))
    blk = cast.occlude(torch.from_numpy(o), torch.from_numpy(d),
                       torch.from_numpy(mt))
    assert blk.dtype == torch.bool and 0 < int(blk.sum()) < blk.numel()
    np.testing.assert_array_equal(blk.numpy(), j)
    # any hit within max_t == the closest hit within max_t
    hit = cast(torch.from_numpy(o), torch.from_numpy(d))
    t = torch.where(hit.valid, hit.t, float("inf"))
    assert torch.equal(blk, hit.valid & (t <= torch.from_numpy(mt)))


def test_wrappers_check_lists(world):
    _, data, _, _ = _casts(world, "box")
    o, d = (torch.from_numpy(x) for x in _random(1024))
    cand, info = cull.tile_candidates(o, d, 512, data.tables.inst_f32, 64)
    with pytest.raises(ValueError, match="tiles"):
        cull.cull_cast(o[:1000].contiguous(), d[:1000].contiguous(), cand,
                       info, 512, data.tables)
    with pytest.raises(TypeError):
        cull.cull_cast(o, d, cand.long(), info, 512, data.tables)
    with pytest.raises(ValueError):
        cull.cull_occlude(o, d, torch.ones(1023), cand, info, 512,
                          data.tables)
    with pytest.raises(ValueError, match="LBVH"):  # the walk's data check
        ce._check_data(data, o.device)
    before = (cull.cull_cast.launches, cull.cull_occlude.launches)
    cull.cull_cast(o, d, cand, info, 512, data.tables)
    cull.cull_occlude(o, d, torch.ones(1024), cand, info, 512, data.tables)
    assert (cull.cull_cast.launches, cull.cull_occlude.launches) == before


def test_march_shadow_without_occlude_equals_occlude(world):
    """``march_shadow`` on a cast without ``occlude`` (a closest hit within
    max_t) gives the any-hit query's light, and the fused round needs an
    ``occlude2``."""
    _, data, _, cfg = _casts(world, "box")
    cast = cull.make_cull_cast(data, cfg.replace(engine="torch"))

    def bare(ro, rd):
        return cast(ro, rd)

    po, pd = (torch.from_numpy(x) for x in _primary(world, 48, 32))
    hit = cast(po, pd)
    pos = po + torch.where(hit.valid, hit.t, 1.0)[:, None] * pd
    lcol = torch.tensor([1.0, 0.9, 0.8, 1.0])
    lpos = torch.tensor([0.0, 20.0, 0.0])
    dist = torch.linalg.norm(lpos - pos, dim=-1)
    ldir = (lpos - pos) / dist[:, None]
    a = shading.march_shadow(cast, pos, ldir, dist, lcol, hit.valid)
    b = shading.march_shadow(bare, pos, ldir, dist, lcol, hit.valid)
    assert torch.equal(a, b) and bool((a == 0).any())
    scene = world["scene"]
    assert shading._use_fused(scene, cfg, cast)
    assert not shading._use_fused(scene, cfg, bare)


# ---------------------------------------------------------------------------
# K5's kernel design, replayed in torch: the union-box filter, groups of
# four entries, the warp's early exit (csrc/cull_kernels.cu)
# ---------------------------------------------------------------------------

def _slab_gate(box, o, inv, par, max_t):
    """The slab gate of K5 against ``box`` (one ``[6]`` or per ray ``[R,
    6]``) with the plain version's slab arithmetic: ``(passes, fails for
    certain)``.  The second takes every comparison in its negated form, as
    the kernel's filter does, so a NaN (0 * inf, a NaN max_t) is no certain
    failure."""
    tns, tfs, inside = ce._slab_terms(box, o, inv, par)
    tmin, tmax = ce._max3(tns), ce._min3(tfs)
    thr = ce.rm.THRESHOLD
    return ((tmin <= tmax) & (tmax >= thr) & (tmin <= max_t) & inside,
            (tmin > tmax) | (tmax < thr) | (tmin > max_t) | ~inside)


def _union(boxes):
    return torch.cat([boxes[:, :3].amin(0), boxes[:, 3:6].amax(0)])


def _filter_rays(kind, rng, boxes, n=2048):
    """Seeded rays that press on the filter: ``(o, d, max_t)`` f32."""
    f = np.float32
    lo, hi = boxes[:, :3].min(0), boxes[:, 3:6].max(0)
    o = rng.uniform(lo - 4.0, hi + 4.0, (n, 3)).astype(f)
    d = rng.standard_normal((n, 3)).astype(f)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    mt = rng.uniform(0.0, 12.0, n).astype(f)
    pick = rng.integers(0, boxes.shape[0], n)
    if kind == "parked":
        o[::2] = f(1e30)
    elif kind == "axis_parallel":
        d[rng.random((n, 3)) < 0.4] = 0.0
        d[np.all(d == 0.0, -1), 1] = 1.0
        # origins on the boxes' own planes: containment at its edge
        edge = rng.random((n, 3)) < 0.3
        o = np.where(edge, boxes[pick, :3], o).astype(f)
    elif kind == "inside":
        w = rng.random((n, 3)).astype(f)
        o = (boxes[pick, :3] * w + boxes[pick, 3:6] * (1 - w)).astype(f)
    elif kind == "tiny_d":
        # 1 / d overflows; origins on box and union planes make 0 * inf
        d[rng.random((n, 3)) < 0.5] = f(1e-42)
        d[rng.random((n, 3)) < 0.2] = f(-1e-42)
        planes = np.concatenate([boxes[:, :3], boxes[:, 3:6], lo[None],
                                 hi[None]])
        on = rng.random((n, 3)) < 0.5
        o = np.where(on, planes[rng.integers(0, planes.shape[0], n)],
                     o).astype(f)
        mt[::3] = np.inf
    elif kind == "max_t":
        mt[0::4] = np.inf
        mt[1::4] = 0.0
        mt[2::8] = np.nan
    else:
        assert kind == "random"
    return o, d, mt


@pytest.mark.parametrize("kind", ["random", "parked", "axis_parallel",
                                  "inside", "tiny_d", "max_t"])
@settings(max_examples=25, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2 ** 31 - 1))
def test_union_box_filter_is_exact(kind, seed):
    """A ray that fails the slab gate for certain on the union of a list's
    valid boxes fails it on each of them: the lanes K5 leaves early could
    not have been blocked."""
    rng = np.random.default_rng(seed)
    nb = int(rng.integers(1, 12))
    lo = rng.uniform(-5.0, 5.0, (nb, 3))
    boxes = np.concatenate([lo, lo + rng.uniform(0.0, 2.0, (nb, 3))],
                           -1).astype(np.float32)
    o, d, mt = (torch.from_numpy(x) for x in _filter_rays(kind, rng, boxes))
    boxes = torch.from_numpy(boxes)
    oc = [o[:, k] for k in range(3)]
    par, inv = ce._ray_recips(d)
    _, dead = _slab_gate(_union(boxes), oc, inv, par, mt)
    some = torch.zeros_like(dead)
    for b in boxes:
        passes, _ = _slab_gate(b, oc, inv, par, mt)
        assert not bool((passes & dead).any()), (kind, seed)
        some |= passes
    if kind in ("random", "parked", "max_t"):  # the filter does filter
        assert bool(dead.any())
    if kind == "inside":  # and rays do pass the gate
        assert bool(some.any()) and not bool(dead.all())
    if kind == "parked":
        assert bool(dead[::2].all())


def _k5_replay(o, d, mt, cand, info, tile, tables, threads=256, group=4):
    """K5 as its kernel runs it: per block of ``threads`` rays of a tile the
    list staged once, lanes dead on the union of its valid boxes, entries in
    groups of ``group``, a warp passing over a group whose union box none of
    its open lanes can enter, and leaving once all its lanes are blocked or
    dead.  Each entry's own test is the plain version's on a one-entry
    list.  Returns ``(mask, warps that left early, dead lanes, groups
    passed over)``."""
    R = o.shape[0]
    n_inst = tables.inst_f32.shape[0]
    blk = torch.zeros(R, dtype=torch.bool)
    one = torch.tensor([[1, 0]], dtype=torch.int32)
    early = n_dead = skipped = 0
    for t in range(R // tile):
        loop_n, over = int(info[t, 0]), bool(info[t, 1] > 0)
        inst = [k if over else int(cand[t, min(k, cand.shape[1] - 1)])
                for k in range(loop_n)]
        rows = slice(t * tile, (t + 1) * tile)
        ot, dt, mtt = o[rows], d[rows], mt[rows]
        valid = [bool(tables.inst_i32[i, ce._II_VALID] > 0) for i in inst]
        boxes = tables.inst_f32[[i for i, v in zip(inst, valid) if v], :6]
        par, inv = ce._ray_recips(dt)
        oc = [ot[:, k] for k in range(3)]

        def fails(entries):
            """Per ray: fails the gate for certain on the union of the valid
            boxes among ``entries`` (none valid: the inverted box)."""
            b = tables.inst_f32[[inst[k] for k in entries if valid[k]], :6]
            u = _union(b) if b.shape[0] else torch.tensor(
                [ce.F32_BIG] * 3 + [ce.F32_NEG_BIG] * 3)
            return _slab_gate(u, oc, inv, par, mtt)[1]

        dead = fails(range(loop_n))
        group_fails = [fails(range(k0, min(k0 + group, loop_n)))
                       for k0 in range(0, loop_n, group)]
        n_dead += int(dead.sum())
        hits = [cull.cull_occlude_reference(
            ot, dt, mtt, torch.tensor([[i]], dtype=torch.int32),
            one.expand(1, 2), tile, tables) for i in inst]
        b = torch.zeros(tile, dtype=torch.bool)
        for w0 in range(0, tile, 32):
            lanes = slice(w0, w0 + 32)
            for k0 in range(0, loop_n, group):
                if bool((b[lanes] | dead[lanes]).all()):
                    early += 1
                    break
                if bool((b[lanes] | dead[lanes]
                         | group_fails[k0 // group][lanes]).all()):
                    skipped += 1
                    continue
                for k in range(k0, min(k0 + group, loop_n)):
                    b[lanes] |= hits[k][lanes] & ~dead[lanes]
        blk[rows] = b
    assert threads % 32 == 0 and tile % 32 == 0 and n_inst > 0
    return blk, early, n_dead, skipped


@pytest.mark.parametrize("tables", ["box", "template"])
@pytest.mark.parametrize("rays", ["shadow", "random"])
def test_k5_replay_in_groups_with_early_exit_equals_plain(world, tables,
                                                          rays):
    _, data, _, cfg = _casts(world, tables, tile_rows=8)
    tile = 8 * cull.LANES
    if rays == "shadow":  # parked lanes, overflowed tiles
        o, d = _shadow(world, *_primary(world, 64, 64))
        mt = _max_ts(o.shape[0], "inf")
    else:
        o, d = _random(2048, seed=9)
        mt = _max_ts(2048, "per_ray")
    lay = cull.CullLayout.of(o.shape[0], 1 << 19, tile)
    o_p, d_p = lay.pad_rays(torch.from_numpy(o), torch.from_numpy(d), 1.0e30)
    mt_p = lay.pad(torch.from_numpy(mt), 0.0)
    cand, info = cull.tile_candidates(o_p, d_p, tile, data.tables.inst_f32,
                                      cull.MAX_CAND)
    want = cull.cull_occlude_reference(o_p, d_p, mt_p, cand, info, tile,
                                       data.tables)
    got, early, n_dead, skipped = _k5_replay(o_p, d_p, mt_p, cand, info,
                                             tile, data.tables)
    assert torch.equal(got, want)
    assert 0 < int(want.sum()) < want.numel()
    assert early > 0 and n_dead > 0 and skipped > 0
    if rays == "shadow":
        assert bool((info[:, 1] > 0).any())


# ---------------------------------------------------------------------------
# the plain versions' work counts (the bounds of chip_smoke.py)
# ---------------------------------------------------------------------------

def _skip_next(v):
    """``bvh_walk.cuh``'s ``skip_next`` per ray: climb while a right child,
    then step to the sibling; 0 ends the walk."""
    for _ in range(int(v.max()).bit_length()):
        v = torch.where((v > 1) & (v % 2 == 1), v // 2, v)
    return torch.where(v == 1, 0, v + 1)


def _walk_in_lockstep(data, queries, closest):
    """The LBVH kernels' stackless walk written out per ray as the CUDA
    code runs it, every ray one node per step: ``(work [R, 4], best t)``
    of K1 (``closest``, one query) or ``(work, blocked masks)`` of K3/K2
    (one or two queries, the walk ending once all are blocked)."""
    n, tab = data.n_leaves, data.tables
    total = 2 * n - 1
    R = queries[0][0].shape[0]
    n_tmpl = tab.tmpl.shape[0]
    max_tris = int(tab.inst_i32[:, ce._II_TRI_COUNT].max())
    qs = [dict(o=[ro[:, k] for k in range(3)], d=[rd[:, k] for k in range(3)],
               mt=mt, rec=ce._ray_recips(rd),
               blk=torch.zeros(R, dtype=torch.bool)) for ro, rd, mt in queries]
    bt = torch.full((R,), float("inf"))
    v = torch.ones(R, dtype=torch.long)
    work = torch.zeros(R, 4, dtype=torch.long)
    while True:
        live = v > 0
        if not closest:
            live = live & ~torch.stack([q["blk"] for q in qs]).all(0)
        if not bool(live.any()):
            return work, (bt if closest else [q["blk"] for q in qs])
        flat = (total - v).clamp(0, total - 1)
        node = data.nodes[flat]
        is_leaf = v >= n
        inst = torch.where(is_leaf, data.ordering[flat.clamp(max=n - 1)], -1)
        f = tab.inst_f32[inst.clamp(min=0).long()]
        ii = tab.inst_i32[inst.clamp(min=0).long()]
        box = ii[:, ce._II_IS_BOX] > 0
        count = ii[:, ce._II_TRI_COUNT]
        work[:, 0] += live * len(qs)
        go = torch.zeros(R, dtype=torch.bool)
        for q in qs:
            par, inv = q["rec"]
            tns, tfs, inside = ce._slab_terms(node, q["o"], inv, par)
            tmin, tmax = ce._max3(tns), ce._min3(tfs)
            ok = (live & (tmin <= tmax) & (tmax >= 1e-5) & inside
                  & (node[:, 6] > 0.0))
            vote = ok & ((tmin < bt) if closest
                         else ~q["blk"] & (tmin <= q["mt"]))
            go = go | vote
            enter = vote & is_leaf & (inst >= 0)
            work[:, 1] += enter & box
            work[:, 2] += enter & ~box
            tgate = enter & ~box
            _, lo, ld = ce._to_local(f, q["o"], q["d"])
            if closest:
                hit, t_hit, _, _ = ce._box_face_hit(tns, tfs, inside, q["d"],
                                                    f, ii)
                bt = torch.where(enter & box & hit & (t_hit < bt), t_hit, bt)
                work[:, 3] += tgate * count
                for j in range(max_tris):
                    row = tab.tmpl[(ii[:, ce._II_TMPL_START] + j).clamp(
                        max=n_tmpl - 1).long()]
                    tok, tt, _, _, _ = ce._template_tri(row, lo, ld)
                    bt = torch.where(tgate & (j < count) & tok & (tt < bt),
                                     tt, bt)
                continue
            t_hit = torch.where(tmin >= 1e-5, tmin, tmax)
            new = (enter & box & (tmin <= tmax) & inside & (t_hit >= 1e-5)
                   & (t_hit <= q["mt"]))
            for j in range(max_tris):  # stops at the first blocking one
                step = tgate & (j < count) & ~new
                work[:, 3] += step
                row = tab.tmpl[(ii[:, ce._II_TMPL_START] + j).clamp(
                    max=n_tmpl - 1).long()]
                tok, tt, _, _, _ = ce._template_tri(row, lo, ld)
                new = new | (step & tok & (tt <= q["mt"]))
            q["blk"] = q["blk"] | new
        v = torch.where(live, torch.where(go & ~is_leaf, 2 * v,
                                          _skip_next(v)), v)


@pytest.mark.parametrize("tables", ["box", "template"])
@pytest.mark.parametrize("query", ["cast", "occlude", "occlude2"])
def test_walk_work_counts_follow_the_kernels_walk(world, tables, query):
    """The slab, box-face, instance and triangle counts the walk's plain
    versions report are those of the kernels' per-ray walk: internal nodes
    included, the prune and the early exits applied."""
    cfg = convert.config_from_jax(_jcfg(world, pallas_traversal="bvh"))
    data = ce.prepare_cast(world["scene"], world["geom"], cfg)
    if tables == "template":
        data = ce.CastData(tables=ce.build_tables(
            world["scene"], world["geom"], exact_uv=True), nodes=data.nodes,
            ordering=data.ordering)
    po, pd = _primary(world, 48, 32)
    so, sd = _shadow(world, po, pd)
    ro_, rd_ = _random(po.shape[0], seed=3)
    mt = _max_ts(po.shape[0], "per_ray")
    t = torch.from_numpy
    work = torch.zeros(po.shape[0], 4, dtype=torch.long)
    if query == "cast":
        hit = ce.bvh_cast_reference(t(po), t(pd), data, work=work)
        expect, bt = _walk_in_lockstep(data, [(t(po), t(pd), None)], True)
        assert torch.equal(bt, hit.t)
    elif query == "occlude":
        blk = ce.bvh_occlude_reference(t(so), t(sd), t(mt), data, work=work)
        expect, masks = _walk_in_lockstep(data, [(t(so), t(sd), t(mt))],
                                          False)
        assert torch.equal(masks[0], blk) and 0 < int(blk.sum())
    else:
        inf = torch.full((po.shape[0],), float("inf"))
        pair = ce.bvh_occlude2_reference(t(so), t(sd), t(mt), t(ro_),
                                         t(rd_), inf, data, work=work)
        expect, masks = _walk_in_lockstep(
            data, [(t(so), t(sd), t(mt)), (t(ro_), t(rd_), inf)], False)
        assert all(torch.equal(a, b) for a, b in zip(masks, pair))
    assert torch.equal(work, expect)
    assert int(work[:, 0].min()) >= 1  # every walk tests the root
    kind = 1 if tables == "box" else 2
    assert int(work[:, kind].sum()) > 0 and int(work[:, 3 - kind].sum()) == 0


@pytest.mark.parametrize("tables", ["box", "template"])
def test_cull_work_counts(world, tables):
    """K4 tests every slot of its tile's list (every instance on
    overflow); K5 stops at a ray's first block; the counts leave the
    results as they were."""
    _, data, _, cfg = _casts(world, tables, tile_rows=8)
    tile = 8 * cull.LANES
    po, pd = _primary(world, 64, 64)
    so, sd = _shadow(world, po, pd)
    tri = int(data.tables.inst_i32[:, ce._II_TRI_COUNT].max())
    for name, (o, d) in (("cast", (po, pd)), ("occlude", (so, sd))):
        lay = cull.CullLayout.of(o.shape[0], cfg.pallas_ray_chunk, tile)
        o_p, d_p = lay.pad_rays(torch.from_numpy(o), torch.from_numpy(d),
                                1.0e30)
        cand, info = cull.tile_candidates(o_p, d_p, tile,
                                          data.tables.inst_f32, cull.MAX_CAND)
        loop = info[torch.arange(o_p.shape[0]) // tile, 0].long()
        work = torch.zeros(o_p.shape[0], 4, dtype=torch.long)
        if name == "cast":
            hit = cull.cull_cast_reference(o_p, d_p, cand, info, tile,
                                           data.tables, work=work)
            plain = cull.cull_cast_reference(o_p, d_p, cand, info, tile,
                                             data.tables)
            assert torch.equal(hit.t, plain.t)
            assert torch.equal(work[:, 0], loop)
            assert torch.equal(work[:, 3], tri * work[:, 2])
            assert bool((work[hit.valid, 1:3].sum(-1) >= 1).all())
        else:
            mt = lay.pad(torch.from_numpy(_max_ts(o.shape[0], "per_ray")),
                         0.0)
            blk = cull.cull_occlude_reference(o_p, d_p, mt, cand, info, tile,
                                              data.tables, work=work)
            assert torch.equal(blk, cull.cull_occlude_reference(
                o_p, d_p, mt, cand, info, tile, data.tables))
            assert 0 < int(blk.sum()) < blk.numel()
            assert torch.equal(work[~blk, 0], loop[~blk])
            assert bool((work[blk, 0] <= loop[blk]).all())
            assert bool((work[:, 3] <= tri * work[:, 2]).all())
            assert bool((work[blk, 1:3].sum(-1) >= 1).all())
        entered = work[:, 1:3].sum(-1)
        assert bool((entered <= work[:, 0]).all()) and int(entered.sum()) > 0
        kind = 1 if tables == "box" else 2
        assert int(work[:, 3 - kind].sum()) == 0


# ---------------------------------------------------------------------------
# frames and gradients
# ---------------------------------------------------------------------------

FRAMES = {"48x32": (48, 32, {}), "64x64_rows8": (64, 64, {"tile_rows": 8}),
          "48x32_per_light": (48, 32, {"fused_shadows": False})}


@pytest.fixture(scope="module", params=sorted(FRAMES))
def frames(world, request):
    w, h, change = FRAMES[request.param]
    jw = world["jw"]
    jcam_np = jscale_camera(jw.camera, w, jw.config.width)
    jcfg = jw.config.replace(width=w, height=h, engine="pallas", **change)
    jimg = np.asarray(jax.jit(jrender_frame, static_argnames=("cfg",))(
        world["jscene"], jax.tree_util.tree_map(jnp.asarray, jcam_np), jcfg))
    cam = convert.camera_from_numpy(jcam_np)
    cfg = convert.config_from_jax(jcfg)
    assert cfg.pallas_traversal == "auto" and not ce._use_walk(
        cfg, world["scene"].inst_pos.shape[0])
    return dict(name=request.param, jimg=jimg, cam=cam, cfg=cfg)


def test_cull_frame_matches_jax_pallas(world, frames):
    img = render_frame(world["scene"], frames["cam"],
                       frames["cfg"].replace(engine="torch"))
    np.testing.assert_allclose(img.numpy(), frames["jimg"], rtol=0,
                               atol=1e-5)
    hits = frames["jimg"][..., :3].max(-1) > 0
    assert 0.03 < hits.mean() < 0.5
    # the "cuda" engine on CPU tensors: the wrappers take the plain versions
    assert torch.equal(img, render_frame(world["scene"], frames["cam"],
                                         frames["cfg"]))


def test_cull_frame_equals_lbvh_frame(world, frames):
    """The counterpart of ``test_pallas.py::test_bvh_render_matches_cull_big_
    world`` on terrain6: the walk must reproduce the cull's frame."""
    cfg = frames["cfg"].replace(engine="torch")
    img = render_frame(world["scene"], frames["cam"], cfg)
    walk = render_frame(world["scene"], frames["cam"],
                        cfg.replace(pallas_traversal="bvh"))
    np.testing.assert_allclose(walk.numpy(), img.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_cull_casts_launch_no_walk_kernel(world):
    cfg = world["jw"].config.replace(engine="cuda", width=16, height=16)
    cast = make_cast(world["scene"], world["geom"], cfg)
    assert hasattr(cast, "occlude") and hasattr(cast, "occlude2")
    walk = (ce.bvh_cast, ce.bvh_occlude, ce.bvh_occlude2)
    before = [k.launches for k in walk]
    render_frame(world["scene"], convert.camera_from_numpy(
        jscale_camera(world["jw"].camera, 16, 640)), cfg)
    assert [k.launches for k in walk] == before


@pytest.fixture(scope="module", params=["fused", "per_light"])
def grads(world, request):
    change = {} if request.param == "fused" else {"fused_shadows": False}
    w, h = 48, 32
    jw = world["jw"]
    jcam_np = jscale_camera(jw.camera, w, jw.config.width)
    jcam = jax.tree_util.tree_map(jnp.asarray, jcam_np)
    jcfg = jw.config.replace(width=w, height=h, engine="pallas", **change)
    target = np.random.default_rng(11).uniform(
        0.0, 0.6, (h, w, 4)).astype(np.float32)
    jparams = jdiff.trainable_params(world["jscene"], jcam)
    jloss, jg = jax.jit(jax.value_and_grad(jdiff.make_loss_fn(
        world["jscene"], jcam, jcfg, jnp.asarray(target))))(jparams)
    cam = convert.camera_from_numpy(jcam_np)
    cfg = convert.config_from_jax(jcfg)
    out = {}
    for engine in ("torch", "cuda"):
        params = convert.params_from_numpy(jparams)
        loss = diff.make_loss_fn(world["scene"], cam,
                                 cfg.replace(engine=engine),
                                 torch.from_numpy(target))(params)
        out[engine] = (float(loss.detach()), diff.grad_of(loss, params))
    flat, _ = jax.tree_util.tree_flatten_with_path(jg)
    jl = [("/".join(str(p) for p in path), np.asarray(v))
          for path, v in flat]
    return dict(case=request.param, jloss=float(jloss), jl=jl, port=out)


def test_cull_loss_grads_match_jax_pallas(grads):
    loss, g = grads["port"]["torch"]
    assert loss == pytest.approx(grads["jloss"], rel=1e-6)
    tl = tree.leaves_with_paths(convert.params_to_numpy(g))
    assert [k for k, _ in tl] == [k for k, _ in grads["jl"]]
    for (key, gt), (_, gj) in zip(tl, grads["jl"]):
        assert np.isfinite(gt).all(), key
        np.testing.assert_allclose(gt, gj, rtol=RTOL_GRAD, atol=ATOL_GRAD,
                                   err_msg=f"{grads['case']} {key}")
    by_key = dict(tl)
    for key in ("['cam_pos']", "['cam_rot']", "['materials']/.kd"):
        assert np.abs(by_key[key]).max() > 10 * ATOL_GRAD, key
    lc, gc = grads["port"]["cuda"]
    assert lc == loss
    for a, b in zip(tree.leaves(g), tree.leaves(gc)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dim", [1, 8, 32, 33, 64, 100, 128])
def test_cli_dim_maps_like_jax(dim):
    # raytracer_tpu/cli.py: max(8, (d * d // 128 + 7) // 8 * 8)
    want = max(8, (dim * dim // 128 + 7) // 8 * 8)
    assert cli.tile_rows_for_dim(dim) == want
    assert cli.tile_rows_for_dim(dim) % 8 == 0
    assert cli.build_parser().parse_args(
        ["-c", WORLD, "-d", str(dim)]).dim == dim


def test_cli_renders_terrain6_through_the_cull(tmp_path):
    from raytracer_tpu_torch.pngio import read_png

    frames = []
    for extra in ([], ["-d", "32"]):
        out = str(tmp_path / f"t6{len(extra)}.png")
        before = cull.cull_cast.launches
        assert cli.main(["-c", WORLD, "--device", "cpu", "--width", "64",
                         "--height", "48", "-o", out] + extra) == 0
        assert cull.cull_cast.launches == before  # CPU: plain versions
        frames.append(read_png(out))
    assert frames[0].shape == (48, 64, 4) and frames[0][..., :3].max() > 0
    np.testing.assert_array_equal(frames[0], frames[1])
