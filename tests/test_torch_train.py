"""The port's differentiable step against the JAX package, on the CPU.

* Tie subgradients: ``phong_term``, ``distance_attenuation`` and the frame
  clamp on inputs exactly at ``L.N == 0``, ``reflect_dot == 0``,
  ``quad == 1`` and ``acc == 1``, against ``jax.grad``.  ``jnp.maximum``/
  ``jnp.minimum`` pass half the gradient at a tie; ``torch.clamp`` would
  pass all of it.  (At ``reflect_dot == 0`` ``safe_pow`` masks the gradient
  in both packages, so that case guards the value path only.)
* ``BvhCastDetached``'s backward against ``_detached_bwd`` on seeded inputs.
* The grads of ``diff.make_loss_fn`` against ``jax.grad`` of the JAX
  ``make_loss_fn`` with ``engine="pallas"`` (Pallas in interpret mode), leaf
  by leaf, on terrain8 fused, terrain8 per light (``fused_shadows=False``,
  K3's path) and ``terrain8_lights3`` (2 point + 1 directional light), at
  48x32 against a seeded random target.  Tolerance rtol 1e-5 / atol 1e-6,
  the JAX package's own (``tests/test_pallas.py:304-307``).
* The ``"cuda"`` engine on CPU tensors (wrappers on their plain versions)
  gives the ``"torch"`` engine's grads; one ``train_step`` lowers the loss;
  checkpoints round-trip without pickle; the CLI trains and resumes.
"""

import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracer_tpu as jrt
from raytracer_tpu import diff as jdiff
from raytracer_tpu.builder import scale_camera as jscale_camera
from raytracer_tpu.render import cast_vjp as jcast_vjp
from raytracer_tpu.render import shading as jshading
from raytracer_tpu.scene import Materials as JMaterials
from raytracer_tpu.scene import device_scene

import raytracer_tpu_torch as rtt
from raytracer_tpu_torch import checkpoint, cli, convert, diff, tracing, tree
from raytracer_tpu_torch.builder import scale_camera
from raytracer_tpu_torch.render import cast_vjp, shading
from raytracer_tpu_torch.render.cast import Hit
from raytracer_tpu_torch.render.engine import clamp_frame, render_frame

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = os.path.join(REPO, "raytracer_tpu_torch", "worlds")
TERRAIN8 = os.path.join(WORLDS, "terrain8.json")
LIGHTS3 = os.path.join(WORLDS, "terrain8_lights3.json")
W, H = 48, 32
RTOL, ATOL = 1e-5, 1e-6


# ---------------------------------------------------------------------------
# tie subgradients
# ---------------------------------------------------------------------------

def _rmats(lib, k=3):
    """Per-ray material rows for ``k`` rays, as numpy-made leaves."""
    rng = np.random.default_rng(7)
    rows = {f: rng.uniform(0.1, 0.9, (k, 4)).astype(np.float32)
            for f in ("ke", "ka", "kd", "ks", "kt", "kr")}
    rows["alpha"] = np.array([8.0, 1.0, 0.0], np.float32)[:k]
    rows["eta"] = np.ones(k, np.float32)
    if lib == "jax":
        return JMaterials(**{f: jnp.asarray(v) for f, v in rows.items()})
    return rtt.Materials(**{f: torch.from_numpy(v) for f, v in rows.items()})


# unit directions and normals chosen so that L.N == 0 (ray 0) and
# -reflect(-L, N).V == 0 (ray 1) exactly; ray 2 is off every tie
_L = np.array([[1, 0, 0], [0, 1, 0], [0.6, 0.8, 0]], np.float32)
_N = np.array([[0, 1, 0], [0, 1, 0], [0, 1, 0]], np.float32)
_V = np.array([[0, 0, 1], [1, 0, 0], [0.8, -0.6, 0]], np.float32)
_INC = np.ones((3, 4), np.float32)


def _jax_grads(fn, *args):
    return [np.asarray(g) for g in
            jax.grad(fn, argnums=tuple(range(len(args))))(
                *[jnp.asarray(a) for a in args])]


def _torch_grads(fn, *args):
    ts = [torch.from_numpy(np.array(a)).requires_grad_(True) for a in args]
    return [g.numpy() for g in torch.autograd.grad(fn(*ts), ts)]


def test_phong_term_tie_grads_match_jax():
    rd = np.array([[1, 0, 0], [1, 0, 0], [1, 0, 0]], np.float32)
    # L.N == 0 on ray 0, and the reflect dot is exactly 0 on ray 1
    assert _L[0] @ _N[0] == 0.0
    jm, tm = _rmats("jax"), _rmats("torch")

    def jf(inc, v, lt, n):
        return jnp.sum(jshading.phong_term(jm, inc, v, lt, n))

    def tf(inc, v, lt, n):
        return torch.sum(shading.phong_term(tm, inc, v, lt, n))

    for view in (_V, rd):
        args = (_INC, view, _L, _N)
        jv = jf(*[jnp.asarray(a) for a in args])
        tv = tf(*[torch.from_numpy(a) for a in args])
        np.testing.assert_allclose(float(tv), float(jv), rtol=1e-6)
        for g_t, g_j in zip(_torch_grads(tf, *args), _jax_grads(jf, *args)):
            np.testing.assert_allclose(g_t, g_j, rtol=1e-6, atol=1e-7)
    # the L.N tie is one that tells the subgradients apart: half of kd
    g_l = _torch_grads(tf, _INC, rd, _L, _N)[2]
    assert g_l[0, 1] == pytest.approx(0.5 * float(tm.kd[0].sum()), rel=1e-6)


def test_distance_attenuation_tie_grads_match_jax():
    # quad = c + l d + q d^2 == 1 exactly at d == 0 (c == 1)
    atten = np.array([1.0, 0.02, 0.002], np.float32)
    dist = np.array([0.0, 0.0, 3.0], np.float32)

    def jf(d, a):
        return jnp.sum(jshading.distance_attenuation(
            types.SimpleNamespace(dist_atten=a), d))

    def tf(d, a):
        return torch.sum(shading.distance_attenuation(
            types.SimpleNamespace(dist_atten=a), d))

    assert float(tf(torch.from_numpy(dist), torch.from_numpy(atten))) == \
        pytest.approx(float(jf(jnp.asarray(dist), jnp.asarray(atten))),
                      rel=1e-6)
    for g_t, g_j in zip(_torch_grads(tf, dist, atten),
                        _jax_grads(jf, dist, atten)):
        np.testing.assert_allclose(g_t, g_j, rtol=1e-6, atol=1e-7)
    g_d = _torch_grads(tf, dist, atten)[0]
    assert g_d[0] == pytest.approx(-0.5 * 0.02, rel=1e-6)


def test_frame_clamp_tie_grads_match_jax():
    acc = np.array([[0.5, 1.0, 1.5, 1.0]], np.float32)
    gj = _jax_grads(lambda a: jnp.sum(jnp.minimum(a, 1.0) ** 2), acc)[0]
    gt = _torch_grads(lambda a: torch.sum(clamp_frame(a) ** 2), acc)[0]
    np.testing.assert_array_equal(gt, gj)
    assert gt[0, 1] == 1.0  # 2 * acc * 0.5 at the tie


# ---------------------------------------------------------------------------
# the cast's VJP rule
# ---------------------------------------------------------------------------

def test_bvh_cast_detached_backward_matches_jax():
    rng = np.random.default_rng(3)
    R = 512
    rd = rng.standard_normal((R, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    n = rng.standard_normal((R, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    # grazing lanes: n perpendicular to rd, |n.rd| < 1e-5
    perp = np.cross(rd[:64], np.array([0.0, 0.0, 1.0], np.float32))
    n[:64] = perp / np.linalg.norm(perp, axis=-1, keepdims=True)
    valid = rng.uniform(size=R) < 0.8
    t = rng.uniform(0.5, 30.0, R).astype(np.float32)
    g_t = rng.standard_normal(R).astype(np.float32)
    ro = rng.standard_normal((R, 3)).astype(np.float32)

    res = (jnp.asarray(rd), jnp.asarray(valid),
           jnp.asarray(np.where(valid, t, 0.0).astype(np.float32)),
           jnp.asarray(n), None)
    jgo, jgd, _ = jcast_vjp._detached_bwd(
        None, res, types.SimpleNamespace(t=jnp.asarray(g_t)))

    def query(o, d, _data):
        tt = torch.from_numpy(np.where(valid, t, np.inf).astype(np.float32))
        return Hit(valid=torch.from_numpy(valid), t=tt,
                   wtri=torch.zeros(R, dtype=torch.int32),
                   uv=torch.zeros(R, 2), normal=torch.from_numpy(n),
                   mat=torch.zeros(R, dtype=torch.int32))

    o_t = torch.from_numpy(ro).requires_grad_(True)
    d_t = torch.from_numpy(rd).requires_grad_(True)
    hit = cast_vjp.cast_detached(query, o_t, d_t, None)
    assert not hit.valid.requires_grad and not hit.mat.requires_grad
    go, gd = torch.autograd.grad(hit.t, (o_t, d_t),
                                 grad_outputs=torch.from_numpy(g_t))
    assert np.abs(np.asarray(jgo)[:64]).max() == 0.0  # grazing lanes: 0
    np.testing.assert_allclose(go.numpy(), np.asarray(jgo), rtol=1e-6,
                               atol=0)
    np.testing.assert_allclose(gd.numpy(), np.asarray(jgd), rtol=1e-6,
                               atol=0)


# ---------------------------------------------------------------------------
# the loss gradient against jax.grad through the Pallas engine
# ---------------------------------------------------------------------------

CASES = {
    "terrain8_fused": (TERRAIN8, {}),
    "terrain8_per_light": (TERRAIN8, {"fused_shadows": False}),
    "terrain8_lights3": (LIGHTS3, {}),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def grads(request):
    path, change = CASES[request.param]
    jw = jrt.generate(path)
    jcam_np = jscale_camera(jw.camera, W, jw.config.width)
    jcam = jax.tree_util.tree_map(jnp.asarray, jcam_np)
    jscene = device_scene(jw.scene)
    jcfg = jw.config.replace(width=W, height=H, engine="pallas", **change)
    target = np.random.default_rng(11).uniform(
        0.0, 0.6, (H, W, 4)).astype(np.float32)
    jparams = jdiff.trainable_params(jscene, jcam)
    jloss, jg = jax.jit(jax.value_and_grad(jdiff.make_loss_fn(
        jscene, jcam, jcfg, jnp.asarray(target))))(jparams)

    scene = convert.scene_from_numpy(jw.scene, device="cpu")
    cam = convert.camera_from_numpy(jcam_np, device="cpu")
    cfg = convert.config_from_jax(jcfg)
    out = {}
    for engine in ("torch", "cuda"):
        params = convert.params_from_numpy(jparams, device="cpu")
        loss = diff.make_loss_fn(scene, cam, cfg.replace(engine=engine),
                                 torch.from_numpy(target))(params)
        out[engine] = (float(loss.detach()), diff.grad_of(loss, params))
    return dict(case=request.param, jloss=float(jloss), jgrads=jg,
                port=out)


def _jax_leaves(jg):
    flat, _ = jax.tree_util.tree_flatten_with_path(jg)
    return [("/".join(str(p) for p in path), np.asarray(v))
            for path, v in flat]


def test_loss_grads_match_jax_pallas(grads):
    loss, g = grads["port"]["torch"]
    assert loss == pytest.approx(grads["jloss"], rel=1e-6)
    jl = _jax_leaves(grads["jgrads"])
    tl = tree.leaves_with_paths(convert.params_to_numpy(g))
    assert [k for k, _ in tl] == [k for k, _ in jl]
    for (key, gt), (_, gj) in zip(tl, jl):
        assert np.isfinite(gt).all(), key
        np.testing.assert_allclose(gt, gj, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{grads['case']} {key}")
    # the comparison tests something: camera and light grads are non-zero
    by_key = dict(tl)
    for key in ("['cam_pos']", "['cam_rot']", "['lights']/.point_col",
                "['materials']/.kd"):
        assert np.abs(by_key[key]).max() > 10 * ATOL, key


def test_cuda_engine_on_cpu_grads_equal_torch_engine(grads):
    lt, gt = grads["port"]["torch"]
    lc, gc = grads["port"]["cuda"]
    assert lt == lc
    for a, b in zip(tree.leaves(gt), tree.leaves(gc)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# training, parameters, checkpoints, CLI
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small():
    w = rtt.generate(TERRAIN8)
    scene = rtt.to_device(w.scene, "cpu")
    cam = rtt.to_device(scale_camera(w.camera, 32, w.config.width), "cpu")
    cfg = w.config.replace(width=32, height=24, engine="cuda")
    return scene, cam, cfg


def test_train_step_lowers_loss(small):
    import dataclasses

    scene, cam, cfg = small
    bright = dataclasses.replace(scene.materials,
                                 kd=scene.materials.kd * 1.3)
    with torch.no_grad():
        target = render_frame(dataclasses.replace(scene, materials=bright),
                              cam, cfg)
    params = diff.trainable_params(scene, cam, include_camera=False)
    loss0, g, params1 = diff.train_step(scene, cam, cfg, target, params,
                                        lr=0.05)
    with torch.no_grad():
        loss1 = diff.make_loss_fn(scene, cam, cfg, target)(params1)
    assert float(loss1) < float(loss0)
    assert all(p.requires_grad and p.is_leaf for p in tree.leaves(params1))
    assert float(g["materials"].kd.abs().sum()) > 0.0


def test_params_roundtrip_through_numpy(small):
    scene, cam, _ = small
    params = diff.trainable_params(scene, cam)
    back = convert.params_from_numpy(convert.params_to_numpy(params),
                                     device="cpu")
    for (ka, a), (kb, b) in zip(tree.leaves_with_paths(params),
                                tree.leaves_with_paths(back)):
        assert ka == kb and torch.equal(a, b) and b.requires_grad


def test_checkpoint_roundtrip_needs_no_pickle(small, tmp_path):
    scene, cam, _ = small
    params = diff.trainable_params(scene, cam)
    path = str(tmp_path / "ck.npz")
    checkpoint.save(path, params, step=7)
    with np.load(path, allow_pickle=False) as data:
        assert data["__keys__"].dtype.kind == "U"
        assert data["__keys__"][0] == "['cam_pos']"
    loaded, step = checkpoint.load(path, params)
    assert step == 7
    for a, b in zip(tree.leaves(params), tree.leaves(loaded)):
        assert torch.equal(a, b) and b.requires_grad
    with pytest.raises(ValueError, match="structure"):
        checkpoint.load(path, {"materials": params["materials"]})
    bad = dict(params, cam_pos=torch.zeros(4, requires_grad=True))
    with pytest.raises(ValueError, match="shape"):
        checkpoint.load(path, bad)


def _train_steps(err: str):
    recs = [json.loads(line) for line in err.splitlines()
            if line.startswith("{")]
    return [r["step"] for r in recs if r["event"] == "train_step"]


def test_cli_trains_and_resumes(tmp_path, capsys):
    ck = str(tmp_path / "ck.npz")
    base = ["-c", TERRAIN8, "--width", "24", "--height", "16", "--device",
            "cpu", "--checkpoint", ck]
    assert cli.main(base + ["--train", "2", "--checkpoint-every", "1"]) == 0
    assert _train_steps(capsys.readouterr().err) == [0, 1]
    with np.load(ck) as data:
        assert int(data["__step__"]) == 2
    assert cli.main(base + ["--train-until", "3"]) == 0
    err = capsys.readouterr().err
    assert _train_steps(err) == [2]
    assert '"checkpoint_restored"' in err
    assert cli.main(base + ["--train-until", "3"]) == 0
    cap = capsys.readouterr()
    assert _train_steps(cap.err) == [] and "nothing to do" in cap.out


@pytest.mark.parametrize("what", ["elastic", "profile_dir", "spp_grad",
                                  "profile_trace"])
def test_unported_training_surface_raises(small, tmp_path, capsys, what):
    """The training surface that once raised is ported, each part checked
    by its result: ``--elastic`` trains to its target in a supervised
    worker, ``--profile-dir`` writes a trace of the loop,
    ``profile_trace`` a trace of its block; and one whole step at spp 2
    gives ``make_loss_fn``'s loss and gradients at ``spp=2`` bit for bit
    (the same samples summed in the same order)."""
    if what == "spp_grad":
        scene, cam, cfg = small
        params = diff.trainable_params(scene, cam)
        target = torch.zeros(cfg.height, cfg.width, 4)
        loss, grads = diff.make_spp_grad_fn(scene, cam, cfg, 2)(params,
                                                                target)
        ref = diff.make_loss_fn(scene, cam, cfg.replace(spp=2),
                                target)(params)
        assert float(loss) == float(ref.detach()) > 0.0
        for a, b in zip(tree.leaves(grads),
                        tree.leaves(diff.grad_of(ref, params))):
            assert torch.equal(a, b)
        assert float(grads["cam_pos"].abs().max()) > 0.0
        return
    logdir = str(tmp_path / "trace")
    ck = str(tmp_path / "ck.npz")
    base = ["-c", TERRAIN8, "--width", "24", "--height", "16", "--device",
            "cpu", "--checkpoint", ck]
    if what == "elastic":
        assert cli.main(base + ["--train-until", "1", "--elastic", "2"]) == 0
        assert '"elastic_done"' in capsys.readouterr().err
        with np.load(ck) as data:
            assert int(data["__step__"]) == 1
        return
    if what == "profile_dir":
        assert cli.main(base + ["--train", "1", "--profile-dir",
                                logdir]) == 0
    else:
        with tracing.profile_trace(logdir) as got:
            assert got == logdir
            torch.ones(4).sum()
    (trace,) = os.listdir(logdir)
    with open(os.path.join(logdir, trace)) as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    assert "aten::sum" in names
    assert '"profile_trace_written"' in capsys.readouterr().err
