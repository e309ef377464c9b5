"""The MXU cast (K6) of the PyTorch port against the JAX package.

On terrain6, on the CPU, with the same numpy-made rays handed to both:

* ``build_mxu_tables`` against ``pallas_mxu.build_mxu_tables``;
* K6's plain version, through the engine's cast, against the JAX engine's
  MXU cast (``_chunked_over_rays`` around ``make_mxu_cast``, Pallas in
  interpret mode): coherent (primary) and incoherent (random and parked
  shadow) rays.  The budgets of ``tests/test_pallas.py:85-122`` hold: hit
  mask disagreement below 0.1% (coherent) / 0.5% (incoherent), t within
  rtol 1e-4, triangle ids equal on more than 99.9% of the common hits.  The
  two packages sum each 8-term product in their own order (XLA's dot at
  HIGHEST against the port's left-to-right sum), so only a column whose
  barycentric sign sits within a rounding of ``-BARY_TOL`` can flip; at
  these sizes none does, and the test asserts the tighter budgets it
  measures: masks identical, ids identical, t within rtol 1e-5;
* the plain version's first-minimum pick against a per-ray scan of the
  columns in order (strict <), the kernel's own loop, on duplicated
  columns and on overflow tiles (the dense sweep);
* frames at atol 1e-5 against JAX ``render_frame`` with
  ``pallas_kernel="mxu"`` (primary cast plus a closest-hit cast per light,
  the shading's fallback for a cast without ``occlude``), and loss
  gradients against ``jax.grad``.  The cast's ray cotangents are zero in
  both packages (``detach_visibility`` with a zero normal), but the camera
  gradients are not: shading still reads the ray directly (the hit point
  ``o + t d`` with ``t`` held, the view direction), and those terms match.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracer_tpu as jrt
from raytracer_tpu import diff as jdiff
from raytracer_tpu.builder import scale_camera as jscale_camera
from raytracer_tpu.render import cast as jcast
from raytracer_tpu.render import geometry as jgeometry
from raytracer_tpu.render import pallas_mxu
from raytracer_tpu.render import render_frame as jrender_frame
from raytracer_tpu.scene import device_scene

from raytracer_tpu_torch import convert, diff, tree
from raytracer_tpu_torch.render import cull, geometry, mxu
from raytracer_tpu_torch.render.engine import make_cast, render_frame

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = os.path.join(REPO, "raytracer_tpu_torch", "worlds", "terrain6.json")


@pytest.fixture(scope="module")
def world():
    jw = jrt.generate(WORLD)
    jscene = device_scene(jw.scene)
    jgeom = jgeometry.expand_geometry(jscene)
    jcfg = jw.config.replace(engine="pallas", pallas_kernel="mxu")
    scene = convert.scene_from_numpy(jw.scene, device="cpu")
    geom = geometry.expand_geometry(scene)
    cfg = convert.config_from_jax(jcfg)
    jinner = pallas_mxu.make_mxu_cast(jscene, jgeom, jcfg)
    jcast_fn = jcast._chunked_over_rays(jcfg.pallas_ray_chunk)(jinner)
    return dict(jw=jw, jscene=jscene, jgeom=jgeom, jcfg=jcfg, scene=scene,
                geom=geom, cfg=cfg, jcast=jcast_fn,
                data=mxu.prepare_mxu_cast(scene, geom, cfg))


def test_mxu_tables_match_jax(world):
    data = world["data"]
    wp = data.wp
    assert wp % mxu.K_COLS == 0 and wp >= data.n_tris == 2448
    jt = pallas_mxu.build_mxu_tables(world["jscene"], world["jgeom"],
                                     wp - data.n_tris)
    cols = data.columns.numpy()
    assert cols.shape == (wp, mxu.COL)
    for k, name in enumerate(("edge_a", "edge_b", "edge_c", "plane_num",
                              "plane_den")):
        np.testing.assert_allclose(cols[:, k * mxu.ROW:(k + 1) * mxu.ROW],
                                   np.asarray(getattr(jt, name)), rtol=1e-6,
                                   atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(data.tables.inst_start.numpy(),
                                  np.asarray(jt.inst_start))
    np.testing.assert_array_equal(data.tables.inst_count.numpy(),
                                  np.asarray(jt.inst_count))
    assert (cols[data.n_tris:] == 0).all()


def _primary(world, w, h):
    jw = world["jw"]
    cam = jax.tree_util.tree_map(
        jnp.asarray, jscale_camera(jw.camera, w, jw.config.width))
    ro, rd = jgeometry.camera_rays(cam, w, h)
    return (np.array(ro, np.float32).reshape(-1, 3),
            np.array(rd, np.float32).reshape(-1, 3))


def _random(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
    o[:, 1] += 4.0
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _shadow(world, o, d):
    """Shadow rays toward the point light from the MXU cast's primary hits;
    missed lanes park at 1e30 (their tiles overflow: the dense sweep)."""
    h = world["jcast"](jnp.asarray(o), jnp.asarray(d))
    valid = np.asarray(h.valid)
    pos = o + np.where(valid, np.asarray(h.t), 1.0)[:, None] * d
    disp = np.array([0.0, 20.0, 0.0], np.float32) - pos
    ldir = (disp / np.linalg.norm(disp, axis=-1, keepdims=True)).astype(
        np.float32)
    park = np.where(valid[:, None], pos, np.float32(1e30))
    return (park + np.float32(1e-5) * ldir).astype(np.float32), ldir


RAYS = {
    "coherent": lambda w: _primary(w, 64, 48),
    "incoherent": lambda w: _random(2048, 1),
    "shadow": lambda w: _shadow(w, *_primary(w, 64, 48)),
}


@pytest.mark.parametrize("rays", sorted(RAYS))
def test_mxu_cast_matches_jax(world, rays):
    o, d = RAYS[rays](world)
    jh = world["jcast"](jnp.asarray(o), jnp.asarray(d))
    cast = make_cast(world["scene"], world["geom"],
                     world["cfg"].replace(engine="torch"))
    assert cast.occlude2 is None and cast.march is None
    th = cast(torch.from_numpy(o), torch.from_numpy(d))
    assert th.normal is None and th.mat is None
    jv = np.asarray(jh.valid)
    tv = th.valid.numpy()
    assert 0 < jv.sum() < jv.size
    # budgets of test_pallas.py:85-122, and the tighter ones measured here
    assert (jv != tv).mean() < (0.001 if rays == "coherent" else 0.005)
    np.testing.assert_array_equal(tv, jv)
    both = jv & tv
    tt = th.t.detach().numpy()
    np.testing.assert_allclose(tt[both], np.asarray(jh.t)[both], rtol=1e-5,
                               atol=0)
    tw, jwt = th.wtri.numpy(), np.asarray(jh.wtri)
    assert (tw[both] == jwt[both]).mean() > 0.999
    np.testing.assert_array_equal(tw, jwt)
    np.testing.assert_allclose(th.uv.detach().numpy()[both],
                               np.asarray(jh.uv)[both], rtol=0, atol=1e-5)
    assert np.isinf(tt[~tv]).all() and (tw[~tv] == 0).all()


def test_mxu_overflow_tiles_take_the_dense_sweep(world):
    o, d = _shadow(world, *_primary(world, 64, 48))
    lay = cull.CullLayout.of(o.shape[0], 1 << 19, world["data"].tile)
    ro_p, rd_p = lay.pad_rays(torch.from_numpy(o), torch.from_numpy(d), 0.0)
    info, staged, ids, rd6, rp8 = mxu.stage_mxu(ro_p, rd_p, world["data"])
    assert staged.shape == (info.shape[0], mxu.K_COLS, mxu.COL)
    assert (info[:, 1] == 1).any(), "no tile overflows"
    assert (info[:, 0] <= world["scene"].inst_pos.shape[0]).all()
    # rd6 = [d, o x d, 0, 0], rp8 = [o, d, 1, 0]
    np.testing.assert_array_equal(rp8[:, 6].numpy(), 1.0)
    assert torch.equal(rd6[:, :3], rd_p) and torch.equal(rp8[:, :3], ro_p)


def _scan(a, p, cols, ids):
    """The kernel's loop for one ray: columns in order, strict <."""
    best = (np.inf, 0.0, 0.0, 0.0)
    f = np.float32
    for c in range(cols.shape[0]):
        w = []
        for first, x in ((0, a), (8, a), (16, a), (24, p), (32, p)):
            acc = f(x[0] * cols[c, first])
            for j in range(1, 8):
                acc = f(acc + f(x[j] * cols[c, first + j]))
            w.append(acc)
        wa, wb, wc, num, den = w
        s = f(f(wa + wb) + wc)
        s_ok = abs(s) > f(1e-30)
        inv = f(f(1.0) / (s if s_ok else f(1.0)))
        ba, bb, bc = f(wa * inv), f(wb * inv), f(wc * inv)
        tol = f(-1e-5)
        den_ok = abs(den) >= f(1e-5)
        with np.errstate(all="ignore"):
            tt = f(num / (den if den_ok else f(1.0)))
        ok = (ba >= tol and bb >= tol and bc >= tol and den_ok and s_ok
              and tt >= f(1e-5) and ids[c] >= 0)
        if ok and tt < best[0]:
            best = (tt, ids[c], bb, bc)
    return best


def test_mxu_reference_is_the_first_minimum_scan(world):
    """The vectorized plain version equals the kernel's per-ray loop over
    the columns, on staged tiles whose columns repeat (ties: the first
    column wins) and on an overflow tile (the dense sweep)."""
    # wide staging (224 slots): at 64x48 the default 32 overflow wherever
    # the terrain is in view
    data = mxu.prepare_mxu_cast(world["scene"], world["geom"], world["cfg"],
                                k_cols=2688)
    o, d = _primary(world, 64, 48)
    tile = data.tile
    lay = cull.CullLayout.of(o.shape[0], 1 << 19, tile)
    ro_p, rd_p = lay.pad_rays(torch.from_numpy(o), torch.from_numpy(d), 0.0)
    info, staged, ids, rd6, rp8 = mxu.stage_mxu(ro_p, rd_p, data)
    staged = staged.clone()
    ids = ids.clone()
    info = info.clone()
    k = staged.shape[1]
    n_live = (ids >= 0).sum(-1)
    t0 = mxu.mxu_cast_reference(info, data.columns, data.n_tris, staged, ids,
                                rd6, rp8, tile)[0]
    hits = torch.isfinite(t0.reshape(-1, tile)).any(-1)
    # a listed tile with hits: its live columns again, under other ids, in
    # the second half; and another tile with hits forced onto the dense sweep
    ts = int(torch.nonzero((info[:, 1] == 0) & hits & (n_live <= k // 2))[0])
    td = int(torch.nonzero(hits)[-1])
    assert ts != td
    n = int(n_live[ts])
    staged[ts, k // 2:k // 2 + n] = staged[ts, :n]
    ids[ts, k // 2:k // 2 + n] = ids[ts, :n] + 10000.0
    info[td] = torch.tensor([204, 1], dtype=torch.int32)
    t, idf, u, v = mxu.mxu_cast_reference(info, data.columns, data.n_tris,
                                          staged, ids, rd6, rp8, tile)
    dense_ids = np.where(np.arange(data.wp) < data.n_tris,
                         np.arange(data.wp), -1).astype(np.float32)
    rng = np.random.default_rng(3)
    for tile_id in (ts, td):
        if tile_id == ts:
            cols, cid = staged[ts].numpy(), ids[ts].numpy()
        else:
            cols, cid = data.columns.numpy(), dense_ids
        for r in rng.choice(tile, 12, replace=False):
            g = tile_id * tile + r
            want = _scan(rd6[g].numpy(), rp8[g].numpy(), cols, cid)
            got = (float(t[g]), float(idf[g]), float(u[g]), float(v[g]))
            assert got == pytest.approx(want, rel=0, abs=0), (tile_id, r)
        assert torch.isfinite(t[tile_id * tile:(tile_id + 1) * tile]).any()
    # the first of equal columns won
    assert (idf[ts * tile:(ts + 1) * tile] < 10000).all()


def test_mxu_wrapper_checks_inputs(world):
    data = world["data"]
    o, d = _random(1024, 2)
    lay = cull.CullLayout.of(1024, 1 << 19, data.tile)
    ro_p, rd_p = lay.pad_rays(torch.from_numpy(o), torch.from_numpy(d), 0.0)
    info, staged, ids, rd6, rp8 = mxu.stage_mxu(ro_p, rd_p, data)
    args = (info, data.columns, data.n_tris, ids, rd6, rp8)
    with pytest.raises(ValueError):
        mxu.mxu_cast(*args[:4], rd6[:-1], rp8, data.tile, data.max_tris)
    with pytest.raises(TypeError):
        mxu.mxu_cast(info.long(), *args[1:], data.tile, data.max_tris)
    with pytest.raises(ValueError):
        mxu.mxu_cast(*args, 1024, data.max_tris)
    with pytest.raises(ValueError):
        mxu.mxu_cast(*args, data.tile, 0)
    with pytest.raises(ValueError):  # the block stamps exist on the card
        mxu.mxu_cast(*args, data.tile, data.max_tris, stamps=True)
    before = mxu.mxu_cast.launches
    out = mxu.mxu_cast(*args, data.tile, data.max_tris)
    assert mxu.mxu_cast.launches == before  # CPU: the plain version
    assert all(x.shape == (1024,) for x in out)
    want = mxu.mxu_cast_reference(info, data.columns, data.n_tris, staged,
                                  ids, rd6, rp8, data.tile)
    assert all(torch.equal(a, b) for a, b in zip(out, want))


# ---------------------------------------------------------------------------
# K6's kernel design, replayed in torch: live columns only, a tile's
# positions cut into chunks, the chunks merged by a 64-bit key
# (csrc/mxu_kernel.cu)
# ---------------------------------------------------------------------------

def _staged_rays(world, rays, data):
    o, d = RAYS[rays](world)
    lay = cull.CullLayout.of(o.shape[0], 1 << 19, data.tile)
    return lay.pad_rays(torch.from_numpy(o), torch.from_numpy(d), 0.0)


@pytest.mark.parametrize("rays", sorted(RAYS))
def test_stage_mxu_without_columns(world, rays):
    """The staging the kernel path takes: the same info, ids and ray rows,
    no ``[T, K, 40]`` gather; and the live columns are the ids >= 0 within
    a tile's first ``info[t, 0] * max_tris`` positions, nothing beyond."""
    data = world["data"]
    ro_p, rd_p = _staged_rays(world, rays, data)
    info, staged, ids, rd6, rp8 = mxu.stage_mxu(ro_p, rd_p, data)
    lean = mxu.stage_mxu(ro_p, rd_p, data, columns=False)
    assert lean[1] is None
    for a, b in zip((info, ids, rd6, rp8), lean[:1] + lean[2:]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    pos = torch.arange(data.k_cols)[None, :]
    listed = pos < info[:, :1] * data.max_tris
    live = ids >= 0
    assert bool(live.any()) and not bool((live & ~listed).any())
    # a box instance fills its slot: the live columns lead the list
    n_live = live.sum(-1)
    assert torch.equal(live, pos < n_live[:, None])
    assert torch.equal(staged[live], data.columns[ids[live].long()])
    assert torch.equal(staged, mxu.gather_columns(data.columns, ids))
    # the wrapper, on CPU tensors, stages the columns itself
    out = mxu.mxu_cast(info, data.columns, data.n_tris, ids, rd6, rp8,
                       data.tile, data.max_tris)
    want = mxu.mxu_cast_reference(info, data.columns, data.n_tris, staged,
                                  ids, rd6, rp8, data.tile)
    assert all(torch.equal(a, b) for a, b in zip(out, want))


_KEY_MISS = torch.iinfo(torch.int64).max
SPLIT, MIN_CHUNK = 40, 64  # kMxuSplit, kMxuCols


def _split_merge_replay(info, columns, n_tris, ids, rd6, rp8, tile, max_tris,
                        rng):
    """K6 as its kernel runs it: a tile's positions (the list's first
    ``info[t, 0] * max_tris``, or the ``n_tris`` of the dense sweep) cut
    into up to 40 chunks of at least 64; per chunk the first minimum over
    its live columns, gathered from the table by id; the chunks merged in
    a shuffled order by the smaller ``(bits of t) << 32 | position``; u and
    v recomputed from the winning column.  The column arithmetic is the
    plain version's (``mxu._score``)."""
    T, k = ids.shape
    a = rd6.reshape(T, tile, mxu.ROW)
    p = rp8.reshape(T, tile, mxu.ROW)
    out = [torch.full((T, tile), float("inf")), torch.zeros(T, tile),
           torch.zeros(T, tile), torch.zeros(T, tile)]
    n_chunks = []
    for t in range(T):
        dense = bool(info[t, 1] > 0)
        limit = n_tris if dense else min(int(info[t, 0]) * max_tris, k)
        per = max(MIN_CHUNK, -(-limit // SPLIT))
        chunks = -(-limit // per)
        n_chunks.append(chunks)
        keys = torch.full((tile,), _KEY_MISS)
        for y in rng.permutation(chunks):
            pos = torch.arange(y * per, min(limit, (y + 1) * per))
            rows = pos if dense else ids[t, pos].long()
            pos, rows = pos[rows >= 0], rows[rows >= 0]  # live only
            if pos.numel() == 0:
                continue
            tt, bpos, _, _ = mxu._score(a[t:t + 1], p[t:t + 1],
                                        columns[rows][None],
                                        pos[None].float())
            key = (tt[0].view(torch.int32).long() << 32) | bpos[0].long()
            keys = torch.minimum(keys, torch.where(torch.isfinite(tt[0]),
                                                   key, _KEY_MISS))
        hit = keys != _KEY_MISS
        pos = keys & 0xffffffff
        rows = pos if dense else ids[t, pos.clamp(max=k - 1)].long()
        rows = torch.where(hit, rows, 0)
        # one ray against its own winning column
        tt, _, u, v = mxu._score(a[t][:, None], p[t][:, None],
                                 columns[rows][:, None],
                                 torch.zeros(tile, 1))
        t_key = (keys >> 32).to(torch.int32).view(torch.float32)
        assert torch.equal(tt[:, 0][hit], t_key[hit])
        out[0][t] = torch.where(hit, t_key, float("inf"))
        out[1][t] = torch.where(hit, rows.float(), 0.0)
        out[2][t] = torch.where(hit, u[:, 0], 0.0)
        out[3][t] = torch.where(hit, v[:, 0], 0.0)
    return tuple(x.reshape(-1) for x in out), n_chunks


@pytest.mark.parametrize("case", ["listed_twice", "dense_twice", "sky",
                                  "shadow"])
def test_mxu_split_and_merge_replay_equals_plain(world, case):
    """The kernel's split of a tile over blocks and its order-free merge
    give the plain version's first minimum: on lists that hold every column
    twice (ties between chunks), on the dense sweep of a table that repeats
    itself, on tiles with no live column, and on shadow rays."""
    data = mxu.prepare_mxu_cast(world["scene"], world["geom"], world["cfg"],
                                k_cols=768)
    tile, max_tris, n_tris = data.tile, data.max_tris, data.n_tris
    twice = torch.cat([data.columns[:n_tris], data.columns[:n_tris],
                       data.columns.new_zeros(2 * (data.wp - n_tris),
                                              mxu.COL)])
    if case == "sky":
        o = torch.from_numpy(_random(1024, 4)[0]) + torch.tensor(
            [0.0, 50.0, 0.0])
        ro_p, rd_p = o, torch.tensor([0.0, 1.0, 0.0]).expand(1024, 3)
    else:
        ro_p, rd_p = _staged_rays(
            world, "shadow" if case == "shadow" else "coherent", data)
    info, _, ids, rd6, rp8 = mxu.stage_mxu(ro_p.contiguous(),
                                           rd_p.contiguous(), data,
                                           columns=False)
    info, ids = info.clone(), ids.clone()
    if case == "listed_twice":
        half = data.k_cols // 2
        listed = (info[:, 1] == 0) & (info[:, 0] * max_tris <= half)
        assert bool(listed.any())
        ids[listed, half:] = torch.where(ids[listed, :half] >= 0,
                                         ids[listed, :half] + n_tris, -1.0)
        info[listed, 0] = data.k_cols // max_tris
    elif case == "dense_twice":
        info[:] = torch.tensor([204, 1], dtype=torch.int32)
    elif case == "sky":
        assert int(info.sum()) == 0
    got, n_chunks = _split_merge_replay(info, twice, 2 * n_tris, ids, rd6,
                                        rp8, tile, max_tris,
                                        np.random.default_rng(5))
    want = mxu.mxu_cast_reference(info, twice, 2 * n_tris,
                                  mxu.gather_columns(twice, ids), ids, rd6,
                                  rp8, tile)
    for name, x, y in zip("t id u v".split(), got, want):
        assert torch.equal(x, y), name
    hit = torch.isfinite(want[0])
    if case == "sky":
        assert max(n_chunks) == 0 and not bool(hit.any())
    else:
        assert max(n_chunks) > 1 and bool(hit.any())
        # of two equal columns the first in order won
        assert bool((want[1][hit] < n_tris).all())
    if case == "dense_twice":  # 4,896 triangles: 40 chunks of 123
        assert set(n_chunks) == {SPLIT}


# ---------------------------------------------------------------------------
# frames and gradients
# ---------------------------------------------------------------------------

def _jax_frame(world, w, h, **change):
    jw = world["jw"]
    jcam_np = jscale_camera(jw.camera, w, jw.config.width)
    jcfg = world["jcfg"].replace(width=w, height=h, **change)
    jimg = np.asarray(jax.jit(jrender_frame, static_argnames=("cfg",))(
        world["jscene"], jax.tree_util.tree_map(jnp.asarray, jcam_np),
        jcfg))
    return (jimg, convert.camera_from_numpy(jcam_np, device="cpu"),
            convert.config_from_jax(jcfg))


@pytest.mark.parametrize("wh", [(48, 32), (64, 64)])
def test_mxu_frame_matches_jax_pallas(world, wh):
    jimg, cam, cfg = _jax_frame(world, *wh)
    assert cfg.pallas_kernel == "mxu"
    img = render_frame(world["scene"], cam, cfg.replace(engine="torch"))
    np.testing.assert_allclose(img.numpy(), jimg, rtol=0, atol=1e-5)
    hits = jimg[..., :3].max(-1) > 0
    assert 0.03 < hits.mean() < 0.5
    assert torch.equal(img, render_frame(world["scene"], cam, cfg))
    # the same frame as the scalar kernels' (cull) frame
    scalar = render_frame(world["scene"], cam, cfg.replace(
        engine="torch", pallas_kernel="scalar"))
    np.testing.assert_allclose(img.numpy(), scalar.numpy(), rtol=0,
                               atol=1e-5)


def test_mxu_loss_grads_match_jax_pallas(world):
    w, h = 48, 32
    jw = world["jw"]
    jcam_np = jscale_camera(jw.camera, w, jw.config.width)
    jcam = jax.tree_util.tree_map(jnp.asarray, jcam_np)
    jcfg = world["jcfg"].replace(width=w, height=h)
    target = np.random.default_rng(11).uniform(
        0.0, 0.6, (h, w, 4)).astype(np.float32)
    jparams = jdiff.trainable_params(world["jscene"], jcam)
    jloss, jg = jax.jit(jax.value_and_grad(jdiff.make_loss_fn(
        world["jscene"], jcam, jcfg, jnp.asarray(target))))(jparams)
    cam = convert.camera_from_numpy(jcam_np, device="cpu")
    cfg = convert.config_from_jax(jcfg)
    params = convert.params_from_numpy(jparams, device="cpu")
    loss = diff.make_loss_fn(world["scene"], cam, cfg.replace(engine="torch"),
                             torch.from_numpy(target))(params)
    g = diff.grad_of(loss, params)
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-6)
    flat, _ = jax.tree_util.tree_flatten_with_path(jg)
    jl = [("/".join(str(p) for p in path), np.asarray(v)) for path, v in flat]
    tl = tree.leaves_with_paths(convert.params_to_numpy(g))
    assert [k for k, _ in tl] == [k for k, _ in jl]
    for (key, gt), (_, gj) in zip(tl, jl):
        assert np.isfinite(gt).all(), key
        np.testing.assert_allclose(gt, gj, rtol=1e-5, atol=1e-6, err_msg=key)
    by_key = dict(tl)
    for key in ("['materials']/.kd", "['cam_pos']", "['cam_rot']"):
        assert np.abs(by_key[key]).max() > 1e-5, key
