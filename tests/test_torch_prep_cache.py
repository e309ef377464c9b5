"""Scene prep kept across the frames and steps of one geometry
(``engine.prepared``), on the CPU with the ``"torch"`` engine.

* an orbit of 3 cameras (terrain8 on the LBVH walk, terrain6 on the cull,
  terrain8_stress through the bounce rounds) builds once and hits twice;
  the kept tables are ``torch.equal`` to a fresh ``expand_geometry`` +
  ``prepare_cast``, and every frame to the frame of a fresh build;
* two training steps (``diff.train_step``; ``make_spp_grad_fn`` in two
  chunks) give equal losses and gradients with the entry dropped before
  every step and kept;
* every geometry leaf of the key rebuilds on an in-place edit and on a new
  tensor, and no other leaf does; each keyed ``cfg`` field rebuilds, other
  fields hit; an in-place vertex or instance edit and a new ``verts``
  tensor give the frame of a fresh build;
* geometry that requires grad (the ``_scaled`` pattern of
  ``test_torch_geomgrad.py``, ``include_vertices``, the kept ``verts``
  itself set to require grad) builds every call, stores nothing, and
  gives the gradients of a fresh build;
* under ``torch.profiler``, a hit runs no aten op inside ``rt.prep``.

The ``gpu`` case renders an orbit on the card (``engine="cuda"``) and
finds no launch inside ``rt.prep`` on a hit.  Run it on a GPU machine
with ``python -m pytest tests/test_torch_prep_cache.py -q -m gpu``.
"""

import dataclasses
import os

import pytest
import torch

import raytracer_tpu_torch as rtt
from raytracer_tpu_torch import diff, tree
from raytracer_tpu_torch.builder import scale_camera
from raytracer_tpu_torch.camera_motion import orbit_frames
from raytracer_tpu_torch.render import cuda_engine as ce
from raytracer_tpu_torch.render import engine
from raytracer_tpu_torch.render.engine import (prepare_cast, prepared,
                                               render_frame)
from raytracer_tpu_torch.render.geometry import expand_geometry
from raytracer_tpu_torch.scene import Scene

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = os.path.join(REPO, "raytracer_tpu_torch", "worlds")
W, H = 32, 24


def _world(name, device="cpu", width=W, height=H, engine_name="torch"):
    w = rtt.generate(os.path.join(WORLDS, f"{name}.json"))
    scene = rtt.to_device(w.scene, device)
    cam = rtt.to_device(scale_camera(w.camera, width, w.config.width),
                        device)
    return scene, cam, w.config.replace(width=width, height=height,
                                        engine=engine_name)


@pytest.fixture(scope="module")
def worlds():
    return {name: _world(name)
            for name in ("terrain8", "terrain6", "terrain8_stress")}


def _reset():
    """An empty cache and zero counters."""
    engine.clear_prepared()
    prepared.hits = prepared.builds = 0


def _counts():
    return prepared.builds, prepared.hits


def _fresh(scene, cfg):
    geom = expand_geometry(scene)
    return geom, prepare_cast(scene, geom, cfg)


def _flat(obj, name=""):
    """``(name, leaf)`` of every field of nested dataclasses and tuples."""
    if dataclasses.is_dataclass(obj):
        return [x for f in dataclasses.fields(obj)
                for x in _flat(getattr(obj, f.name), f"{name}.{f.name}")]
    if isinstance(obj, tuple):
        return [x for i, o in enumerate(obj) for x in _flat(o, f"{name}[{i}]")]
    return [(name, obj)]


def _assert_same(got, want):
    got, want = _flat(got), _flat(want)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, a), (_, b) in zip(got, want):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), name
        else:
            assert a == b, name


def _private(scene, *fields):
    """``scene`` with its own copies of ``fields``, to edit in place."""
    return dataclasses.replace(
        scene, **{f: getattr(scene, f).clone() for f in fields})


@pytest.mark.parametrize("name,walk", [("terrain8", True),
                                       ("terrain6", False),
                                       ("terrain8_stress", True)])
def test_an_orbit_builds_once_and_equals_fresh_builds(worlds, name, walk):
    scene, cam, cfg = worlds[name]
    assert ce._use_walk(cfg, scene.inst_pos.shape[0]) == walk
    cams = list(orbit_frames(cam, 3, 5.0))
    _reset()
    kept = [render_frame(scene, c, cfg) for c in cams]
    assert _counts() == (1, 2)
    first = prepared(scene, cfg)
    assert prepared(scene, cfg)[0] is first[0]
    _assert_same(first, _fresh(scene, cfg))
    for c, img in zip(cams, kept):
        engine.clear_prepared()
        assert torch.equal(img, render_frame(scene, c, cfg))
    assert not torch.equal(kept[0], kept[2])  # the cameras moved
    assert _counts() == (4, 4)


@pytest.mark.parametrize("spp_chunk", [None, 2])
def test_steps_equal_with_the_entry_dropped_or_kept(worlds, spp_chunk):
    """``spp_chunk=None``: ``diff.train_step`` (one prep a step); 2: the
    spp-4 gradient in two chunks (two passes of two chunks, four a
    step)."""
    scene, cam, cfg = worlds["terrain8"]
    target = torch.full((H, W, 4), 0.25)
    calls = 1 if spp_chunk is None else 4

    def run(drop):
        _reset()
        params = diff.trainable_params(scene, cam)
        out = []
        for _ in range(2):
            if drop:
                engine.clear_prepared()
            if spp_chunk is None:
                loss, grads, params = diff.train_step(scene, cam, cfg, target,
                                                      params, lr=1e-2)
            else:
                loss, grads = diff.make_spp_grad_fn(
                    scene, cam, cfg, 4, spp_chunk=spp_chunk)(params, target)
                params = diff.sgd_step(params, grads, 1e-2)
            out.append([loss] + tree.leaves(grads))
        return out, _counts()

    kept, kept_counts = run(False)
    dropped, dropped_counts = run(True)
    assert kept_counts == (1, 2 * calls - 1)
    assert dropped_counts == (2, 2 * calls - 2)
    for a, b in zip(kept, dropped):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(kept[0][0], kept[1][0])  # the step moved


_TENSOR_LEAVES = [f.name for f in dataclasses.fields(Scene)
                  if f.name not in ("materials", "lights")]


@pytest.mark.parametrize("how", ["in_place", "new_tensor"])
@pytest.mark.parametrize("leaf", _TENSOR_LEAVES)
def test_the_key_is_every_geometry_leaf_and_no_other(worlds, leaf, how):
    """An in-place write (values unchanged) or an equal new tensor: a
    build for a leaf that prep reads, a hit for any other."""
    scene, _, cfg = worlds["terrain8"]
    scene = _private(scene, leaf)
    _reset()
    before = prepared(scene, cfg)
    x = getattr(scene, leaf)
    if how == "in_place":
        with torch.no_grad():
            x.copy_(x.clone())
    else:
        scene = dataclasses.replace(scene, **{leaf: x.clone()})
    after = prepared(scene, cfg)
    keyed = leaf in engine._PREP_LEAVES
    assert _counts() == ((2, 0) if keyed else (1, 1))
    assert (after[0] is before[0]) == (not keyed)
    _assert_same(after, _fresh(scene, cfg))


@pytest.mark.parametrize("base,change,keyed", [
    ({}, {"pallas_kernel": "mxu"}, True),
    ({}, {"pallas_traversal": "cull"}, True),
    ({}, {"edge_aware_grads": True}, True),
    ({}, {"texture_mapping": True}, True),
    ({"pallas_kernel": "mxu"}, {"max_tris_per_mesh": 32}, True),
    ({}, {"engine": "cuda", "spp": 4, "width": 48, "recurse_depth": 1}, False),
    ({}, {"wavefront_tile_cap": 0.5, "static_tile_cap": 0.5}, False),
], ids=["pallas_kernel", "pallas_traversal", "edge_aware_grads",
        "texture_mapping", "max_tris_per_mesh", "frame_fields", "caps"])
def test_each_keyed_cfg_field_rebuilds(worlds, base, change, keyed):
    scene, _, cfg = worlds["terrain8"]
    cfg = cfg.replace(**base)
    _reset()
    before = prepared(scene, cfg)
    cfg2 = cfg.replace(**change)
    after = prepared(scene, cfg2)
    assert _counts() == ((2, 0) if keyed else (1, 1))
    assert (after[0] is before[0]) == (not keyed)
    _assert_same(after, _fresh(scene, cfg2))


def _mul_verts(scene):
    with torch.no_grad():
        scene.verts.mul_(1.05)
    return scene


def _shift_instances(scene):
    with torch.no_grad():
        scene.inst_pos.add_(0.25)
    return scene


def _new_verts(scene):
    return dataclasses.replace(scene, verts=scene.verts * 1.05)


@pytest.mark.parametrize("edit", [_mul_verts, _shift_instances, _new_verts],
                         ids=["verts.mul_", "inst_pos.add_", "new_verts"])
def test_a_geometry_edit_renders_the_fresh_frame(worlds, edit):
    scene, cam, cfg = worlds["terrain8"]
    scene = _private(scene, "verts", "inst_pos")
    _reset()
    before = render_frame(scene, cam, cfg)
    scene = edit(scene)
    after = render_frame(scene, cam, cfg)
    assert _counts() == (2, 0)
    assert not torch.equal(before, after)
    _assert_same(prepared(scene, cfg), _fresh(scene, cfg))
    engine.clear_prepared()
    assert torch.equal(after, render_frame(scene, cam, cfg))


def _scaled(scene, s):
    return dataclasses.replace(scene, verts=scene.verts * (1.0 + s))


@pytest.mark.parametrize("how", ["scaled", "include_vertices",
                                 "kept_verts_require_grad"])
def test_trainable_vertices_build_every_call_and_store_nothing(worlds, how):
    scene, cam, cfg = worlds["terrain8"]
    cfg = cfg.replace(edge_aware_grads=True)
    target = torch.zeros(H, W, 4)
    kept_verts = scene.verts.clone()
    own = dataclasses.replace(scene, verts=kept_verts)

    def grads():
        if how == "scaled":
            s = torch.zeros((), requires_grad=True)
            img = render_frame(_scaled(scene, s), cam, cfg)
            return list(torch.autograd.grad(img[..., :3].mean(), s))
        if how == "include_vertices":
            params = diff.trainable_params(scene, cam, include_vertices=True)
            loss = diff.make_loss_fn(scene, cam, cfg, target)(params)
            return [loss.detach()] + tree.leaves(diff.grad_of(loss, params))
        img = render_frame(own, cam, cfg)
        return list(torch.autograd.grad(img[..., :3].mean(), kept_verts))

    _reset()
    render_frame(own, cam, cfg)  # an entry on the very verts tensor
    entry = engine._prep_entry
    assert entry is not None
    kept_verts.requires_grad_(how == "kept_verts_require_grad")
    first, second = grads(), grads()
    assert _counts() == (3, 0)
    assert engine._prep_entry is entry
    engine.clear_prepared()
    third = grads()
    assert engine._prep_entry is None
    for a, b, c in zip(first, second, third):
        assert torch.equal(a, b) and torch.equal(a, c)
    # the vertex gradient reached the geometry, through a build
    assert float(first[-1].abs().sum()) > 0.0


def _prep_ops(events):
    """The aten ops that start inside the ``rt.prep`` span, on its
    thread."""
    (prep,) = [e for e in events if e[0] == "rt.prep"]
    return [e for e in events if e[0].startswith("aten::")
            and e[3] == prep[3] and prep[1] <= e[1] < prep[2]]


def _traced_events(fn, activities):
    with torch.profiler.profile(activities=activities) as prof:
        out = fn()
    return out, [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
                  e.start_thread_id())
                 for e in prof.profiler.kineto_results.events()]


@pytest.mark.parametrize("hit", [True, False], ids=["hit", "miss"])
def test_a_hit_runs_no_op_inside_prep(worlds, hit):
    scene, cam, cfg = worlds["terrain8"]
    _reset()
    if hit:
        prepared(scene, cfg)
    img, events = _traced_events(
        lambda: render_frame(scene, cam, cfg),
        [torch.profiler.ProfilerActivity.CPU])
    assert (len(_prep_ops(events)) == 0) == hit
    assert _counts() == ((1, 1) if hit else (1, 0))
    engine.clear_prepared()
    assert torch.equal(img, render_frame(scene, cam, cfg))


@pytest.mark.gpu
def test_an_orbit_on_the_card_launches_nothing_in_prep():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    scene, cam, cfg = _world("terrain8", torch.device("cuda", 0), 640, 480,
                             "cuda")
    cams = list(orbit_frames(cam, 3, 2.01))
    _reset()
    kept = [render_frame(scene, c, cfg) for c in cams]
    assert _counts() == (1, 2)
    _assert_same(prepared(scene, cfg), _fresh(scene, cfg))
    _, events = _traced_events(
        lambda: render_frame(scene, cams[0], cfg),
        [torch.profiler.ProfilerActivity.CPU,
         torch.profiler.ProfilerActivity.CUDA])
    (prep,) = [e for e in events if e[0] == "rt.prep"]
    launches = [e for e in events
                if e[0].startswith(("cudaLaunch", "cuLaunch",
                                    "cudaMemsetAsync", "cudaMemcpyAsync"))
                and prep[1] <= e[1] < prep[2]]
    assert launches == [] and _prep_ops(events) == []
    for c, img in zip(cams, kept):
        engine.clear_prepared()
        assert torch.equal(img, render_frame(scene, c, cfg))
