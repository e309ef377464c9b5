"""K1's visit counts and the cull's lists of any length, on the CPU.

* ``visit_counts`` (the JAX package's ``cast.visit_counts``; K1's
  ``visits_out``, whose plain version replays K1's walk,
  ``cuda_engine.k1_walk_replay``): on grid worlds of 256 and 16,384
  touching cubes built with the port's ``SceneBuilder``, the count grows
  by less than 4x for 64x the instances (``tests/test_accel.py:60-121``'s
  O(log N) envelope), every ray hits, and the hits at 256 instances equal
  the JAX package's walk (t to rtol 1e-5); the JAX kernel's per-tile count
  (the union of the tile's walks) is no smaller than any ray's own
  per-thread walk (``_WalkVisits``).
* K1's walk against the per-thread walk whose visits the plain versions
  count as work (``_WalkVisits``): two more for each stale kept vote,
  exactly; K1's dependent steps are no more than the per-thread count.
* Lists of any length (K4/K5 stage them in pieces): the overflow list's
  piece boxes, and K4's and K5's walks replayed piece by piece with the
  pieces still to come taken from those boxes, equal to the plain
  versions on terrain6 with pieces of 64 entries (overflowed tiles of four
  pieces); the wrappers' staging takes any instance count.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.render import geometry as jgeometry
from raytracer_tpu.render import pallas_engine as pe
from raytracer_tpu import scene as jscene_mod
from raytracer_tpu.scene import RenderConfig as JRenderConfig
from raytracer_tpu.scene import device_scene

import raytracer_tpu_torch as rtt
from raytracer_tpu_torch.builder import make_grid_world, scale_camera
from raytracer_tpu_torch.render import cuda_engine as ce
from raytracer_tpu_torch.render import cull
from raytracer_tpu_torch.render.engine import _frame_rays_blocked, make_cast
from raytracer_tpu_torch.render.geometry import expand_geometry

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = os.path.join(REPO, "raytracer_tpu_torch", "worlds")
SIDES = (16, 128)  # 256 and 16,384 instances
INVERTED = [ce.F32_BIG] * 3 + [ce.F32_NEG_BIG] * 3


def _down_rays(side):
    """``tests/test_accel.py``'s ray tile: 32 x 32 rays straight down onto
    the middle of the grid."""
    n, span, mid = 1024, 6.0, 0.5 * side
    xs = np.linspace(mid - span, mid + span, 32, dtype=np.float32)
    gx, gz = np.meshgrid(xs, xs)
    ro = np.stack([gx.ravel(), np.full(n, 10.0, np.float32), gz.ravel()], -1)
    rd = np.broadcast_to(np.array([0, -1, 0], np.float32), (n, 3)).copy()
    return ro, rd


@pytest.fixture(scope="module")
def grids():
    out = {}
    for side in SIDES:
        scene_np, _, cfg = make_grid_world(side)
        scene = rtt.to_device(scene_np, "cpu")
        cfg = cfg.replace(pallas_traversal="bvh", engine="cuda")
        cast = make_cast(scene, expand_geometry(scene), cfg)
        ro, rd = (torch.from_numpy(x) for x in _down_rays(side))
        out[side] = dict(scene_np=scene_np, scene=scene, cfg=cfg, cast=cast,
                         ro=ro, rd=rd, hit=cast(ro, rd),
                         visits=cast.visit_counts(ro, rd))
    return out


def test_visit_counts_scale_logarithmically(grids):
    mean = {}
    for side, g in grids.items():
        v = g["visits"]
        assert v.dtype == torch.int32 and v.shape == (1024,)
        assert bool(g["hit"].valid.all())  # the grid fills the view
        mean[side] = float(v.float().mean())
    # 64x the instances: the implicit heap is 6 levels deeper
    assert mean[128] < 4.0 * mean[16], mean
    assert mean[128] > mean[16], mean


def _jax_scene(scene_np):
    """The JAX package's Scene with the port's (numpy) scene's leaves."""
    kw = {}
    for f in dataclasses.fields(scene_np):
        v = getattr(scene_np, f.name)
        if f.name in ("materials", "lights"):
            cls = getattr(jscene_mod, f.name.capitalize())
            v = cls(**{g.name: getattr(v, g.name)
                       for g in dataclasses.fields(v)})
        kw[f.name] = v
    return device_scene(jscene_mod.Scene(**kw))


def test_walk_at_256_instances_matches_jax(grids):
    g = grids[16]
    jscene = _jax_scene(g["scene_np"])
    jgeom = jgeometry.expand_geometry(jscene)
    jcast = pe.make_pallas_cast(jscene, jgeom, JRenderConfig(
        pallas_traversal="bvh", max_tris_per_mesh=12))
    ro, rd = (jnp.asarray(x.numpy()) for x in (g["ro"], g["rd"]))
    jh = jcast(ro, rd)
    np.testing.assert_array_equal(g["hit"].valid.numpy(),
                                  np.asarray(jh.valid))
    np.testing.assert_allclose(g["hit"].t.numpy(), np.asarray(jh.t),
                               rtol=1e-5, atol=0)
    # one padded tile: its walk is the union of the rays' walks
    tile_visits = np.asarray(jcast.visit_counts(ro, rd))
    assert tile_visits.shape == (1,)
    data = ce.prepare_cast(g["scene"], expand_geometry(g["scene"]), g["cfg"])
    assert int(tile_visits[0]) >= int(_walk_visits(g["ro"], g["rd"],
                                                   data).max())


def _walk_visits(ro, rd, data):
    """The per-thread walk's node tests (``_WalkVisits``, the ``slab``
    work column of the plain version)."""
    work = torch.zeros(ro.shape[0], len(ce.WORK_COLUMNS), dtype=torch.long)
    ce.bvh_cast_reference(ro, rd, data, work=work)
    return work[:, 0]


def test_visit_counts_of_both_engines_are_the_plain_walks(grids):
    """Both engines and the plain version give K1's walk's count
    (``k1_walk_replay``) on the CPU."""
    g = grids[16]
    cast_t = make_cast(g["scene"], expand_geometry(g["scene"]),
                       g["cfg"].replace(engine="torch"))
    assert torch.equal(cast_t.visit_counts(g["ro"], g["rd"]), g["visits"])
    data = ce.prepare_cast(g["scene"], expand_geometry(g["scene"]), g["cfg"])
    assert torch.equal(ce.bvh_visit_counts_reference(g["ro"], g["rd"], data),
                       g["visits"])
    _, replay, _ = ce.k1_walk_replay(g["ro"], g["rd"], data)
    assert torch.equal(replay.to(torch.int32), g["visits"])
    before = ce.bvh_visit_counts.launches
    ce.bvh_visit_counts(g["ro"], g["rd"], data)  # CPU: no launch
    assert ce.bvh_visit_counts.launches == before


@pytest.mark.parametrize("world", ["grid16", "terrain8"])
def test_k1_walk_visits_are_plain_visits_plus_stale_votes(grids, world):
    if world == "grid16":
        g = grids[16]
        data = ce.prepare_cast(g["scene"], expand_geometry(g["scene"]),
                               g["cfg"])
        ro, rd = g["ro"], g["rd"]
    else:
        w = rtt.generate(os.path.join(WORLDS, "terrain8.json"))
        scene = rtt.to_device(w.scene, "cpu")
        cfg = w.config.replace(width=64, height=48, engine="cuda")
        data = ce.prepare_cast(scene, expand_geometry(scene), cfg)
        cam = rtt.to_device(scale_camera(w.camera, 64, w.config.width),
                            "cpu")
        ro, rd, _, _ = _frame_rays_blocked(cam, cfg)
    work = torch.zeros(ro.shape[0], len(ce.WORK_COLUMNS), dtype=torch.long)
    want = ce.bvh_cast_reference(ro, rd, data, work=work)
    plain = work[:, 0]  # the per-thread walk's (``_WalkVisits``)
    hit, visits, stale = ce.k1_walk_replay(ro, rd, data)
    for name in ("valid", "t", "wtri", "uv", "normal", "mat"):
        assert torch.equal(getattr(hit, name), getattr(want, name)), name
    assert torch.equal(visits.to(torch.int32),
                       ce.bvh_visit_counts_reference(ro, rd, data))
    assert torch.equal(visits, plain + 2 * stale)
    assert bool(((visits - 1) // 2 <= plain).all())  # steps
    if world == "terrain8":
        assert int(stale.sum()) > 0


# ---------------------------------------------------------------------------
# K4 and K5 on lists of any length: pieces
# ---------------------------------------------------------------------------

def _union(boxes):
    if boxes.shape[0] == 0:
        return torch.tensor(INVERTED)
    return torch.cat([boxes[:, :3].amin(0), boxes[:, 3:6].amax(0)])


def _widen(a, b):
    return torch.cat([torch.minimum(a[:3], b[:3]), torch.maximum(a[3:], b[3:])])


def test_overflow_piece_boxes():
    w = rtt.generate(os.path.join(WORLDS, "terrain6.json"))
    scene = rtt.to_device(w.scene, "cpu")
    tables = ce.build_tables(scene, expand_geometry(scene))
    n = tables.inst_f32.shape[0]
    for piece in (64, 100, 512):
        boxes = cull.overflow_piece_boxes(tables, piece)
        assert boxes.shape == (-(-n // piece), 6)
        for p in range(boxes.shape[0]):
            want = _union(tables.inst_f32[p * piece:(p + 1) * piece, :6])
            assert torch.equal(boxes[p], want), p
    invalid = ce.SceneTables(inst_f32=tables.inst_f32,
                             inst_i32=tables.inst_i32.clone(),
                             tmpl=tables.tmpl)
    invalid.inst_i32[:64, ce._II_VALID] = 0
    assert torch.equal(cull.overflow_piece_boxes(invalid, 64)[0],
                       torch.tensor(INVERTED))


def test_staging_takes_any_instance_count():
    scene_np, _, _ = make_grid_world(96)
    scene = rtt.to_device(scene_np, "cpu")
    tables = ce.build_tables(scene, expand_geometry(scene))
    cand = torch.zeros(4, 64, dtype=torch.int32)
    n_inst, scratch = cull._staging("cull_cast", cand, tables)
    assert n_inst == 9216 and scratch.shape == (18, 8)
    small = ce.build_tables(*(lambda s: (s, expand_geometry(s)))(
        rtt.to_device(make_grid_world(16)[0], "cpu")))
    assert cull._staging("cull_occlude", cand, small) == (256, None)
    with pytest.raises(ValueError, match="one piece"):
        cull._staging("cull_cast", torch.zeros(4, 513, dtype=torch.int32),
                      tables)


def _gate_fails(box, o, inv, par, best_t=None, max_t=None):
    """K4's (``best_t``) or K5's (``max_t``) gate failing for certain."""
    tns, tfs, inside = ce._slab_terms(box, o, inv, par)
    tmin, tmax = ce._max3(tns), ce._min3(tfs)
    far = tmin >= best_t if max_t is None else tmin > max_t
    return (tmin > tmax) | (tmax < ce.rm.THRESHOLD) | far | ~inside


def _tile_lists(info, cand, t):
    loop_n, over = int(info[t, 0]), bool(info[t, 1] > 0)
    return loop_n, over, [k if over else int(cand[t, min(k, cand.shape[1] - 1)])
                          for k in range(loop_n)]


def _k4_pieces(o, d, cand, info, tile, tables, piece, group=4, span=4):
    """K4 as its kernel runs a list of any length: per tile, pieces of
    ``piece`` entries one after the other; in a piece, the spans' suffix
    unions widened by the union of the pieces still to come (the overflow
    list's piece boxes); a warp leaves on the suffix, passes over a span or
    a group every lane fails, and at a piece's end leaves if every lane
    fails on the pieces to come; the block stops staging once every warp
    has left.  Returns ``(Hit, pieces staged, warps that left)``."""
    R = o.shape[0]
    inst_f, inst_i = tables.inst_f32, tables.inst_i32
    max_tris = int(inst_i[:, ce._II_TRI_COUNT].max())
    any_tmpl = bool((inst_i[:, ce._II_IS_BOX] == 0).any())
    pboxes = cull.overflow_piece_boxes(tables, piece)
    best = cull._Best(R, o.device)
    staged = left_n = 0
    for t in range(R // tile):
        loop_n, over, inst = _tile_lists(info, cand, t)
        valid = [bool(inst_i[i, ce._II_VALID] > 0) for i in inst]

        def union(first, end):
            return _union(inst_f[[inst[k] for k in range(first, min(end, loop_n))
                                  if valid[k]], :6])

        rows = slice(t * tile, (t + 1) * tile)
        oc = [o[rows][:, k] for k in range(3)]
        dc = [d[rows][:, k] for k in range(3)]
        par, inv = ce._ray_recips(d[rows])
        sub = cull._Best(tile, o.device)
        gone = torch.zeros(tile // 32, dtype=torch.bool)
        n_pieces = -(-loop_n // piece)
        assert n_pieces <= 1 or over  # a listed list is one piece
        for q in range(n_pieces):
            if bool(gone.all()):
                break
            staged += 1
            first, end = q * piece, min(loop_n, (q + 1) * piece)
            later = torch.tensor(INVERTED)
            for p in range(q + 1, n_pieces):
                later = _widen(later, pboxes[p])
            for k0 in range(first, end, group * span):
                done = _gate_fails(_widen(union(k0, end), later), oc, inv,
                                   par, best_t=sub.t)
                leave = done.view(-1, 32).all(-1) & ~gone
                left_n += int(leave.sum())
                gone |= leave
                done_w = done.view(-1, 32)
                pass_span = ((_gate_fails(union(k0, k0 + group * span), oc,
                                          inv, par, best_t=sub.t)
                              .view(-1, 32) | done_w).all(-1) & ~gone)
                for g0 in range(k0, min(k0 + group * span, end), group):
                    pass_group = ((_gate_fails(union(g0, g0 + group), oc,
                                               inv, par, best_t=sub.t)
                                   .view(-1, 32) | done_w).all(-1)
                                  & ~gone & ~pass_span)
                    walk = (~gone & ~pass_span & ~pass_group
                            ).repeat_interleave(32)
                    for k in range(g0, min(g0 + group, end)):
                        f = inst_f[inst[k]].expand(tile, -1)
                        ii = inst_i[inst[k]].expand(tile, -1)
                        tns, tfs, inside = ce._slab_terms(f, oc, inv, par)
                        tmin, tmax = ce._max3(tns), ce._min3(tfs)
                        gate = (walk & (tmin <= tmax)
                                & (tmax >= ce.rm.THRESHOLD) & (tmin < sub.t)
                                & inside & valid[k])
                        cull._closest_update(sub, f, ii, gate, tns, tfs,
                                             inside, oc, dc, tables.tmpl,
                                             max_tris, any_tmpl)
            if q + 1 < n_pieces:
                gone |= _gate_fails(later, oc, inv, par,
                                    best_t=sub.t).view(-1, 32).all(-1)
        for name in ("t", "tri", "u", "v", "mat"):
            getattr(best, name)[rows] = getattr(sub, name)
        for c in range(3):
            best.n[c][rows] = sub.n[c]
    return best.hit(), staged, left_n


def _k5_pieces(o, d, mt, cand, info, tile, tables, piece, group=4):
    """K5 as its kernel runs a list of any length: lanes dead on the union
    of the whole list (the piece boxes' where there are several pieces),
    pieces one after the other, groups a warp passes over, warps leaving
    once blocked or dead, and the block once every warp has left.
    Returns ``(mask, pieces staged)``."""
    R = o.shape[0]
    inst_f, inst_i = tables.inst_f32, tables.inst_i32
    pboxes = cull.overflow_piece_boxes(tables, piece)
    one = torch.tensor([[1, 0]], dtype=torch.int32)
    blk = torch.zeros(R, dtype=torch.bool)
    staged = 0
    for t in range(R // tile):
        loop_n, over, inst = _tile_lists(info, cand, t)
        rows = slice(t * tile, (t + 1) * tile)
        ot, dt, mtt = o[rows], d[rows], mt[rows]
        oc = [ot[:, k] for k in range(3)]
        par, inv = ce._ray_recips(dt)
        valid = [bool(inst_i[i, ce._II_VALID] > 0) for i in inst]
        n_pieces = -(-loop_n // piece)
        if n_pieces > 1:
            whole = torch.tensor(INVERTED)
            for p in range(n_pieces):
                whole = _widen(whole, pboxes[p])
        else:
            whole = _union(inst_f[[i for i, v in zip(inst, valid) if v], :6])
        dead = _gate_fails(whole, oc, inv, par, max_t=mtt)
        hits = [cull.cull_occlude_reference(
            ot, dt, mtt, torch.tensor([[i]], dtype=torch.int32),
            one.expand(1, 2), tile, tables) for i in inst]
        b = torch.zeros(tile, dtype=torch.bool)
        gone = torch.zeros(tile // 32, dtype=torch.bool)
        for q in range(n_pieces):
            if bool(gone.all()):
                break
            staged += 1
            for w0 in range(0, tile, 32):
                lanes = slice(w0, w0 + 32)
                if bool(gone[w0 // 32]):
                    continue
                for g0 in range(q * piece, min(loop_n, (q + 1) * piece),
                                group):
                    if bool((b[lanes] | dead[lanes]).all()):
                        gone[w0 // 32] = True
                        break
                    gb = _union(inst_f[[inst[k] for k in range(
                        g0, min(g0 + group, loop_n)) if valid[k]], :6])
                    skip = (b[lanes] | dead[lanes] | _gate_fails(
                        gb, [x[lanes] for x in oc],
                        [x[lanes] for x in inv], [x[lanes] for x in par],
                        max_t=mtt[lanes]))
                    if bool(skip.all()):
                        continue
                    for k in range(g0, min(g0 + group, loop_n)):
                        b[lanes] |= hits[k][lanes] & ~dead[lanes]
                gone[w0 // 32] |= bool((b[lanes] | dead[lanes]).all())
        blk[rows] = b
    return blk, staged


@pytest.fixture(scope="module")
def terrain6():
    w = rtt.generate(os.path.join(WORLDS, "terrain6.json"))
    scene = rtt.to_device(w.scene, "cpu")
    data = ce.prepare_cast(scene, expand_geometry(scene),
                           w.config.replace(engine="cuda"))
    cam = rtt.to_device(scale_camera(w.camera, 64, w.config.width), "cpu")
    cfg = w.config.replace(width=64, height=64, engine="cuda", tile_rows=8)
    ro, rd, _, _ = _frame_rays_blocked(cam, cfg)
    return dict(scene=scene, tables=data.tables, ro=ro, rd=rd)


@pytest.mark.parametrize("rays", ["primary", "shadow"])
def test_k4_in_pieces_equals_plain(terrain6, rays):
    tab, tile, piece = terrain6["tables"], 8 * cull.LANES, 64
    o, d = terrain6["ro"], terrain6["rd"]
    if rays == "shadow":  # parked lanes: overflowed tiles
        hit = ce.bvh_cast_reference(o, d, ce.prepare_cast(
            terrain6["scene"], expand_geometry(terrain6["scene"]),
            rtt.generate(os.path.join(WORLDS, "terrain6.json")).config
            .replace(pallas_traversal="bvh")))
        from raytracer_tpu_torch.render.shading import shadow_rays
        pos = o + torch.where(hit.valid, hit.t, 1.0)[:, None] * d
        q = shadow_rays(terrain6["scene"], pos, hit.valid)
        o, d = q[3], q[4].contiguous()
    lay = cull.CullLayout.of(o.shape[0], 1 << 19, tile)
    o_p, d_p = lay.pad_rays(o, d, 1.0e30)
    cand, info = cull.tile_candidates(o_p, d_p, tile, tab.inst_f32,
                                      cull.MAX_CAND)
    over = info[:, 1] > 0
    assert bool(over.any()) and int(info[over, 0].max()) > 3 * piece
    want = cull.cull_cast_reference(o_p, d_p, cand, info, tile, tab)
    got, staged, left_n = _k4_pieces(o_p, d_p, cand, info, tile, tab, piece)
    for name in ("valid", "t", "wtri", "uv", "normal", "mat"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert left_n > 0 and staged > info.shape[0]


def test_k5_in_pieces_equals_plain(terrain6):
    tab, tile, piece = terrain6["tables"], 8 * cull.LANES, 64
    from raytracer_tpu_torch.render.shading import shadow_rays
    hit = ce.bvh_cast_reference(terrain6["ro"], terrain6["rd"], ce.prepare_cast(
        terrain6["scene"], expand_geometry(terrain6["scene"]),
        rtt.generate(os.path.join(WORLDS, "terrain6.json")).config
        .replace(pallas_traversal="bvh")))
    pos = terrain6["ro"] + torch.where(hit.valid, hit.t, 1.0)[:, None] \
        * terrain6["rd"]
    o, d, dist, _, _ = shadow_rays(terrain6["scene"], pos, hit.valid)
    lay = cull.CullLayout.of(o.shape[0], 1 << 19, tile)
    o_p, d_p = lay.pad_rays(o, d, 1.0e30)
    mt = lay.pad(dist, 0.0)
    cand, info = cull.tile_candidates(o_p, d_p, tile, tab.inst_f32,
                                      cull.MAX_CAND)
    assert bool((info[:, 1] > 0).any())
    want = cull.cull_occlude_reference(o_p, d_p, mt, cand, info, tile, tab)
    got, staged = _k5_pieces(o_p, d_p, mt, cand, info, tile, tab, piece)
    assert torch.equal(got, want)
    assert 0 < int(want.sum()) < want.numel()
