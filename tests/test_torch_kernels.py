"""Plain versions of K1, K2 and K3 in the PyTorch port against the JAX
package's Pallas kernels (interpret mode on the CPU).

K1 (``bvh_cast``) against ``make_pallas_cast(...)``, K2 (``bvh_occlude2``)
against its ``.occlude2`` and K3 (``bvh_occlude``) against its ``.occlude``,
on terrain8 with box tables and
with template tables (``build_tables(exact_uv=True)``: every instance takes
the triangle loop while the kernel runs with ``exact_uv=False``).  Rays: a
128x96 primary frame and 1,024 seeded random rays, handed to both packages
as the same numpy arrays.

Contract (``tests/test_pallas.py::_compare``): valid exact; t at rtol 1e-5;
normal at atol 1e-5; material exact; instance and box face exact (with
template tables the triangle id and uv too).  Occlusion masks are exact.
The per-ray walk may differ from the tile walk on a boundary ray where the
slab test and the triangle test disagree by a rounding; the budget for that
is 1e-4 of the rays, which at these sizes means none.

K1's kernel walk is replayed in torch and held to the plain version in
every output, also on degenerate rays."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracer_tpu as jrt
from raytracer_tpu.builder import scale_camera as jscale_camera
from raytracer_tpu.render import geometry as jgeometry
from raytracer_tpu.render import pallas_engine as pe
from raytracer_tpu.scene import device_scene

from raytracer_tpu_torch import convert
from raytracer_tpu_torch.render import cuda_engine as ce
from raytracer_tpu_torch.render import geometry

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = os.path.join(REPO, "raytracer_tpu_torch", "worlds", "terrain8.json")
BOUNDARY_BUDGET = 1e-4


@pytest.fixture(scope="module")
def setup():
    jw = jrt.generate(WORLD)
    jscene = device_scene(jw.scene)
    jgeom = jgeometry.expand_geometry(jscene)
    cfg = jw.config.replace(engine="pallas")
    scene = convert.scene_from_numpy(jw.scene, device="cpu")
    geom = geometry.expand_geometry(scene)
    data = ce.prepare_cast(scene, geom, convert.config_from_jax(cfg))
    jaux = pe.prepare_pallas_cast(jscene, jgeom, cfg)
    jaux_t = dict(jaux, tables=pe.build_tables(jscene, jgeom, exact_uv=True))
    data_t = ce.CastData(tables=ce.build_tables(scene, geom, exact_uv=True),
                         nodes=data.nodes, ordering=data.ordering)
    casts = {
        "box": (pe.make_pallas_cast(jscene, jgeom, cfg, aux=jaux), data),
        "template": (pe.make_pallas_cast(jscene, jgeom, cfg, aux=jaux_t),
                     data_t),
    }

    cam = jax.tree_util.tree_map(
        jnp.asarray, jscale_camera(jw.camera, 128, jw.config.width))
    ro, rd = jgeometry.camera_rays(cam, 128, 96)
    rng = np.random.default_rng(0)
    o = rng.uniform(-6, 6, (1024, 3)).astype(np.float32)
    o[:, 1] += 4.0
    d = rng.standard_normal((1024, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = {"primary": (np.array(ro).reshape(-1, 3),
                        np.array(rd).reshape(-1, 3)),
            "random": (o, d)}
    return dict(jscene=jscene, jgeom=jgeom, casts=casts, rays=rays,
                face_of=np.asarray(pe._detect_box_meshes(jscene)[3]),
                wtri_tri=np.asarray(jscene.wtri_tri),
                inst=np.asarray(jgeom.inst))


def _mismatch_ok(mask, what):
    frac = float(np.mean(mask))
    assert frac <= BOUNDARY_BUDGET, f"{what}: {frac:.2e} of rays differ"
    return ~mask


@pytest.mark.parametrize("tables", ["box", "template"])
@pytest.mark.parametrize("rays", ["primary", "random"])
def test_bvh_cast_matches_pallas(setup, tables, rays):
    jcast, data = setup["casts"][tables]
    o, d = setup["rays"][rays]
    jh = jcast(jnp.asarray(o), jnp.asarray(d))
    th = ce.bvh_cast(torch.from_numpy(o), torch.from_numpy(d), data)

    jv = np.asarray(jh.valid)
    tv = th.valid.numpy()
    assert jv.sum() > 0
    keep = _mismatch_ok(jv != tv, "valid")
    both = jv & tv & keep
    np.testing.assert_allclose(th.t.numpy()[both], np.asarray(jh.t)[both],
                               rtol=1e-5, atol=0)
    np.testing.assert_allclose(th.normal.numpy()[both],
                               np.asarray(jh.normal)[both], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(th.mat.numpy()[both],
                                  np.asarray(jh.mat)[both])
    tw, jwt = th.wtri.numpy()[both], np.asarray(jh.wtri)[both]
    inst = setup["inst"]
    np.testing.assert_array_equal(inst[tw], inst[jwt])
    face = setup["face_of"][setup["wtri_tri"]]
    np.testing.assert_array_equal(face[tw], face[jwt])
    if tables == "template":  # the true triangle and its barycentrics
        np.testing.assert_array_equal(tw, jwt)
        np.testing.assert_allclose(th.uv.numpy()[both],
                                   np.asarray(jh.uv)[both], rtol=0,
                                   atol=1e-5)
    # miss lanes: t = +inf, tri = 0, mat = 0, normal (0, 0, 1)
    miss = ~tv
    assert np.isinf(th.t.numpy()[miss]).all()
    assert (th.wtri.numpy()[miss] == 0).all()
    assert (th.mat.numpy()[miss] == 0).all()
    np.testing.assert_array_equal(th.normal.numpy()[miss],
                                  np.tile([0.0, 0.0, 1.0], (miss.sum(), 1)))


def test_wrappers_check_inputs(setup):
    data = setup["casts"]["box"][1]
    o, d = (torch.from_numpy(x) for x in setup["rays"]["random"])
    exact = ce.bvh_cast(o, d, data, exact_uv=True)  # ported: no raise
    want = ce.bvh_cast_reference(o, d, data, exact_uv=True)
    assert torch.equal(exact.uv, want.uv) and torch.equal(exact.wtri,
                                                          want.wtri)
    with pytest.raises(TypeError):
        ce.bvh_cast(o.double(), d.double(), data)
    with pytest.raises(ValueError):
        ce.bvh_cast(o[:, :2].contiguous(), d[:, :2].contiguous(), data)
    with pytest.raises(ValueError):
        ce.bvh_cast(o.t().contiguous().t(), d, data)
    mt = torch.ones(o.shape[0])
    with pytest.raises(ValueError):
        ce.bvh_occlude2(o, d, mt[:-1], o, d, mt, data)
    with pytest.raises(ValueError):
        ce.bvh_occlude(o, d, mt[:-1], data)
    with pytest.raises(TypeError):
        ce.bvh_occlude(o, d, mt.double(), data)
    # the CUDA path is not taken for CPU tensors: no counter moves
    kernels = (ce.bvh_cast, ce.bvh_occlude2, ce.bvh_occlude)
    before = [k.launches for k in kernels]
    ce.bvh_cast(o, d, data)
    ce.bvh_occlude2(o, d, mt, o, d, mt, data)
    ce.bvh_occlude(o, d, mt, data)
    assert [k.launches for k in kernels] == before


def _shadow_queries(setup):
    """Both shadow queries of the primary frame, each followed by the random
    rays: to the point light (finite max_t; the random rays 4.0) and along
    the directional light (+inf)."""
    o, d = setup["rays"]["primary"]
    jh = setup["casts"]["box"][0](jnp.asarray(o), jnp.asarray(d))
    valid = np.asarray(jh.valid)
    t = np.where(valid, np.asarray(jh.t), 1.0)
    hit = o + t[:, None] * d
    lpos = np.array([0.0, 20.0, 0.0], np.float32)
    disp = lpos - hit
    dist = np.linalg.norm(disp, axis=-1).astype(np.float32)
    d1 = (disp / dist[:, None]).astype(np.float32)
    d2 = np.broadcast_to(-np.array([0.3, -1.0, 0.5], np.float32)
                         / np.float32(np.linalg.norm([0.3, -1.0, 0.5])),
                         hit.shape).astype(np.float32)
    park = np.where(valid[:, None], hit, np.float32(1e30)).astype(np.float32)
    o1 = (park + np.float32(1e-5) * d1).astype(np.float32)
    o2 = (park + np.float32(1e-5) * d2).astype(np.float32)
    ro, rd = setup["rays"]["random"]
    mt_r = np.full(ro.shape[0], 4.0, np.float32)
    # query 1: shadow rays to the point light, then the random rays
    q1 = (np.concatenate([o1, ro]), np.concatenate([d1, rd]),
          np.concatenate([dist, mt_r]))
    q2 = (np.concatenate([o2, ro]), np.concatenate([d2, rd[::-1]]),
          np.concatenate([np.full(dist.shape, np.inf, np.float32),
                          np.full(mt_r.shape, np.inf, np.float32)]))
    return q1, q2


def _torch(q):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in q]


@pytest.mark.parametrize("tables", ["box", "template"])
def test_bvh_occlude2_matches_pallas(setup, tables):
    jcast, data = setup["casts"][tables]
    q1, q2 = _shadow_queries(setup)
    jb1, jb2 = jcast.occlude2(*[jnp.asarray(x) for x in q1],
                              *[jnp.asarray(x) for x in q2])
    tb1, tb2 = ce.bvh_occlude2(*_torch(q1), *_torch(q2), data)
    for j, t_, name in ((jb1, tb1, "query 1"), (jb2, tb2, "query 2")):
        j = np.asarray(j)
        assert 0 < j.sum() < j.size
        _mismatch_ok(j != t_.numpy(), name)


@pytest.mark.parametrize("tables", ["box", "template"])
@pytest.mark.parametrize("max_t", ["finite", "inf"])
def test_bvh_occlude_matches_pallas(setup, tables, max_t):
    """K3 against ``.occlude`` (``_bvh_occlude_kernel``) on one query:
    the point-light query (finite max_t) or the directional one (+inf);
    K3's mask also equals that query of K2 exactly."""
    jcast, data = setup["casts"][tables]
    q1, q2 = _shadow_queries(setup)
    q = q1 if max_t == "finite" else q2
    j = np.asarray(jcast.occlude(*[jnp.asarray(x) for x in q]))
    t_ = ce.bvh_occlude(*_torch(q), data)
    assert t_.dtype == torch.bool and t_.shape == (q[0].shape[0],)
    assert 0 < j.sum() < j.size
    _mismatch_ok(j != t_.numpy(), f"K3 {max_t}")
    pair = ce.bvh_occlude2(*_torch(q1), *_torch(q2), data)
    assert torch.equal(t_, pair[0] if max_t == "finite" else pair[1])


# ---------------------------------------------------------------------------
# K1's kernel walk, replayed in torch (csrc/bvh_kernels.cu)
# ---------------------------------------------------------------------------

def _degenerate_rays(kind, data, n=2048, seed=0):
    """Rays the slab arithmetic treats specially, aimed at the tree:
    ``tiny_d`` (1 / d overflows; origins on node planes make 0 * inf) and
    ``axis_parallel`` (exact zero direction components, origins on node
    planes: containment at its edge)."""
    f = np.float32
    rng = np.random.default_rng(seed)
    boxes = data.nodes[:, :6].numpy()
    boxes = boxes[data.nodes[:, 6].numpy() > 0]
    lo, hi = boxes[:, :3].min(0), boxes[:, 3:].max(0)
    o = rng.uniform(lo - 2.0, hi + 2.0, (n, 3)).astype(f)
    target = rng.uniform(lo, hi, (n, 3)).astype(f)
    d = target - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    planes = np.concatenate([boxes[:, :3], boxes[:, 3:]])
    on = rng.random((n, 3)) < 0.5
    o = np.where(on, planes[rng.integers(0, planes.shape[0], n)], o)
    if kind == "tiny_d":
        d[rng.random((n, 3)) < 0.4] = f(1e-42)
        d[rng.random((n, 3)) < 0.2] = f(-1e-42)
    else:
        assert kind == "axis_parallel"
        d[rng.random((n, 3)) < 0.4] = 0.0
        d[np.all(d == 0.0, -1), 1] = -1.0
    return o.astype(f), d.astype(f)


def _pair_walk(data, ro, rd):
    """K1's walk as its kernel runs it (``cuda_engine.k1_walk_replay``: both
    children a step, the right child's vote kept, pops to the deepest kept
    right child).  Returns ``(Hit, steps per ray, kept right children whose
    own vote would fail when entered)``."""
    hit, visits, stale = ce.k1_walk_replay(ro, rd, data)
    return hit, (visits - 1) // 2, int(stale.sum())


@pytest.mark.parametrize("tables", ["box", "template"])
@pytest.mark.parametrize("rays", ["primary", "random", "tiny_d",
                                  "axis_parallel"])
def test_k1_pair_walk_equals_plain(setup, tables, rays):
    """K1's walk (both children a step, right votes kept) gives the plain
    version's all-leaves loop in t, triangle, uv, normal and material, on
    degenerate rays too; it takes no more steps than the per-thread walk
    visits nodes, and the kept votes do go stale."""
    data = setup["casts"][tables][1]
    if rays in ("primary", "random"):
        o, d = setup["rays"][rays]
    else:
        o, d = _degenerate_rays(rays, data)
    o, d = torch.from_numpy(np.ascontiguousarray(o)), torch.from_numpy(
        np.ascontiguousarray(d))
    work = torch.zeros(o.shape[0], len(ce.WORK_COLUMNS), dtype=torch.long)
    want = ce.bvh_cast_reference(o, d, data, work=work)
    got, steps, stale = _pair_walk(data, o, d)
    for name in ("valid", "t", "wtri", "uv", "normal", "mat"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert 0 < int(want.valid.sum())
    assert bool((steps <= work[:, 0]).all())
    assert int(steps.sum()) < int(work[:, 0].sum())
    if rays == "primary":
        assert stale > 0


# ---------------------------------------------------------------------------
# K2's and K3's kernel walk, replayed in torch (csrc/bvh_kernels.cu)
# ---------------------------------------------------------------------------

def _occlude_queries(setup, rays, data):
    """Two queries ``(o, d, max_t)`` as torch tensors: the primary frame's
    shadow queries (``_shadow_queries``), the seeded random rays, or
    degenerate rays (``_degenerate_rays``); the latter two at seeded
    random finite max_t (query 1) and at +inf (query 2)."""
    if rays == "shadow":
        return [_torch(q) for q in _shadow_queries(setup)]
    if rays == "random":
        o, d = setup["rays"]["random"]
    else:
        o, d = _degenerate_rays(rays, data)
    mt = np.random.default_rng(9).uniform(0.5, 12.0, o.shape[0])
    return [_torch((o, d, mt.astype(np.float32))),
            _torch((o, d, np.full(o.shape[0], np.inf, np.float32)))]


@pytest.mark.parametrize("kernel", ["K2", "K3"])
@pytest.mark.parametrize("tables", ["box", "template"])
@pytest.mark.parametrize("rays", ["shadow", "random", "tiny_d",
                                  "axis_parallel"])
def test_occlude_pair_walk_equals_plain(setup, kernel, tables, rays):
    """K2's and K3's walk (``cuda_engine.occlude_walk_replay``: both
    children a step, the left entered first, the right's vote kept, a
    block ends the walk) gives the plain version's masks, on degenerate
    rays too (with the tiny directions at max_t = +inf, box hits at t =
    +inf in leaves whose ancestors' slabs are NaN: no walk reaches them),
    and takes no more steps than the per-thread walk that the plain
    versions count (``_WalkVisits``) visits nodes: K3 per query and ray,
    K2 (one walk a query) for both queries against their count's sum."""
    data = setup["casts"][tables][1]
    q1, q2 = _occlude_queries(setup, rays, data)
    R = q1[0].shape[0]
    walks = [ce.occlude_walk_replay(*q, data) for q in (q1, q2)]
    steps = [(visits - 1) // 2 for _, visits, _ in walks]
    if kernel == "K2":
        work = torch.zeros(R, len(ce.WORK_COLUMNS), dtype=torch.long)
        want = ce.bvh_occlude2_reference(*q1, *q2, data, work=work)
        assert bool((steps[0] + steps[1] <= work[:, 0]).all())
        assert int((steps[0] + steps[1]).sum()) < int(work[:, 0].sum())
    else:
        want = []
        for q, s in zip((q1, q2), steps):
            work = torch.zeros(R, len(ce.WORK_COLUMNS), dtype=torch.long)
            want.append(ce.bvh_occlude_reference(*q, data, work=work))
            assert bool((s <= work[:, 0]).all())
            assert int(s.sum()) < int(work[:, 0].sum())
    for (got, _, _), w in zip(walks, want):
        assert torch.equal(got, w)
        assert 0 < int(w.sum()) < R


def _one_leaf():
    """A world of one cube (``builder.make_grid_world(1)``) on the walk: its
    LBVH is one leaf, the root; box tables and template tables."""
    from raytracer_tpu_torch.builder import make_grid_world
    from raytracer_tpu_torch.scene import to_device

    world, _, cfg = make_grid_world(1)
    scene = to_device(world, "cpu")
    geom = geometry.expand_geometry(scene)
    data = ce.prepare_cast(scene, geom, cfg.replace(pallas_traversal="bvh"))
    assert data.n_leaves == 1
    data_t = ce.CastData(tables=ce.build_tables(scene, geom, exact_uv=True),
                         nodes=data.nodes, ordering=data.ordering)
    return {"box": data, "template": data_t}


@pytest.mark.parametrize("tables", ["box", "template"])
def test_walks_on_one_leaf(tables):
    """With one leaf the walks test the root alone and, where it passes,
    its instance (the kernels' ``n_leaves == 1`` branch): K1's replay
    gives the plain version's hits, K2's and K3's their masks, on seeded
    rays through and around the cube at finite max_t and at +inf."""
    data = _one_leaf()[tables]
    rng = np.random.default_rng(4)
    n = 512
    o = rng.uniform(-3.0, 4.0, (n, 3)).astype(np.float32)
    target = rng.uniform(-0.6, 0.6, (n, 3)).astype(np.float32)
    d = target - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    want = ce.bvh_cast_reference(o, d, data)
    got, visits, _ = ce.k1_walk_replay(o, d, data)
    for name in ("valid", "t", "wtri", "uv", "normal", "mat"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert bool((visits == 1).all()) and 0 < int(want.valid.sum()) < n
    mt = torch.from_numpy(rng.uniform(0.5, 8.0, n).astype(np.float32))
    for max_t in (mt, torch.full((n,), float("inf"))):
        blk, visits, _ = ce.occlude_walk_replay(o, d, max_t, data)
        assert torch.equal(blk, ce.bvh_occlude_reference(o, d, max_t, data))
        assert bool((visits == 1).all()) and 0 < int(blk.sum()) < n
