"""The port's synthetic worlds and bounce math against the JAX package, on
the CPU.

* ``raytracer_tpu_torch.synth``'s three builders give scenes, cameras and
  configs bit for bit the JAX package's.
* ``raymath.refract`` (with total internal reflection), ``safe_sqrt``,
  ``trans_attenuation`` and ``shadow_attenuation`` equal the JAX functions
  on seeded inputs, and so do their gradients, which stay finite on TIR
  lanes and at zero bases.
* ``process_round`` keeps every gradient finite through dead slots, misses
  and TIR lanes.
* The mixed world (a mirror and a glass cube: the compacted 2x stream)
  renders the JAX package's ``engine="pallas"`` frame (Pallas in interpret
  mode) at depths 0 to 3, atol 1e-5; depth changes the frame, and
  ``early_exit`` on and off give the same frame bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu import raymath as jrm
from raytracer_tpu import synth as jsynth
from raytracer_tpu.builder import scale_camera as jscale_camera
from raytracer_tpu.render import engine as jengine
from raytracer_tpu.render import render_frame as jrender_frame
from raytracer_tpu.render import shading as jshading
from raytracer_tpu.scene import device_scene

from raytracer_tpu_torch import convert, raymath as rm, synth
from raytracer_tpu_torch.render import engine, shading
from raytracer_tpu_torch.render.cast import hit_shading_attrs
from raytracer_tpu_torch.render.geometry import expand_geometry

torch.set_num_threads(2)

W, H = 64, 48
RTOL, ATOL = 1e-5, 1e-6


def _leaves(obj, prefix=""):
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            yield from _leaves(v, prefix + f.name + ".")
        else:
            yield prefix + f.name, np.asarray(v)


BUILDERS = {
    "mixed": ("make_mixed_world", (3,)),
    "big": ("make_big_world", (300,)),
    "sphere": ("make_sphere_world", ()),
}


@pytest.mark.parametrize("which", sorted(BUILDERS))
def test_synth_scenes_bit_equal_to_jax(which):
    name, args = BUILDERS[which]
    jout = getattr(jsynth, name)(*args)
    tout = getattr(synth, name)(*args)
    for jobj, tobj in zip(jout[:2], tout[:2]):
        jl, tl = dict(_leaves(jobj)), dict(_leaves(tobj))
        assert jl.keys() == tl.keys()
        for key, jv in jl.items():
            tv = tl[key]
            assert (tv.dtype, tv.shape) == (jv.dtype, jv.shape), key
            assert tv.tobytes() == jv.tobytes(), key
    jcfg = dataclasses.asdict(jout[2])
    tcfg = dataclasses.asdict(tout[2])
    assert jcfg.pop("engine") == "jnp" and tcfg.pop("engine") == "torch"
    assert jcfg == tcfg


# ---------------------------------------------------------------------------
# bounce math
# ---------------------------------------------------------------------------

def _refract_inputs(n=512):
    rng = np.random.default_rng(5)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d *= rng.uniform(0.5, 2.0, (n, 1)).astype(np.float32)  # not unit
    nrm = rng.standard_normal((n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    n1 = rng.choice(np.array([1.0, 0.9, 1.5], np.float32), n)
    n2 = rng.choice(np.array([1.0, 0.9, 1.5], np.float32), n)
    w = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    return d, nrm, n1, n2, w


def test_refract_matches_jax_with_tir():
    d, nrm, n1, n2, w = _refract_inputs()
    jd, jtir = jrm.refract(jnp.asarray(d), jnp.asarray(nrm), jnp.asarray(n1),
                           jnp.asarray(n2))
    td, ttir = rm.refract(torch.from_numpy(d), torch.from_numpy(nrm),
                          torch.from_numpy(n1), torch.from_numpy(n2))
    tir = np.asarray(jtir)
    assert 20 < tir.sum() < len(tir) - 20  # both branches taken
    assert np.array_equal(ttir.numpy(), tir)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6,
                               atol=1e-6)

    def jf(d, nrm, n1, n2):
        return jnp.sum(jrm.refract(d, nrm, n1, n2)[0] * w)

    def tf(d, nrm, n1, n2):
        return torch.sum(rm.refract(d, nrm, n1, n2)[0] * torch.from_numpy(w))

    jg = jax.grad(jf, argnums=(0, 1, 2, 3))(*map(jnp.asarray,
                                                (d, nrm, n1, n2)))
    ts = [torch.from_numpy(x.copy()).requires_grad_(True)
          for x in (d, nrm, n1, n2)]
    tg = torch.autograd.grad(tf(*ts), ts)
    for name, a, b in zip(("d", "n", "n1", "n2"), tg, jg):
        # a TIR lane's refracted root is 0 with a zero gradient: finite
        assert torch.isfinite(a).all(), name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=1e-5, err_msg=name)


def test_safe_sqrt_gradient_is_zero_at_and_below_zero():
    x = torch.tensor([-1.0, 0.0, 4.0], requires_grad=True)
    y = rm.safe_sqrt(x)
    (g,) = torch.autograd.grad(y.sum(), x)
    assert y.tolist() == [0.0, 0.0, 2.0]
    assert g.tolist() == [0.0, 0.0, 0.25]


def _atten_inputs(n=256):
    rng = np.random.default_rng(9)
    kt = rng.uniform(0.0, 1.0, (n, 4)).astype(np.float32)
    kt[::7] = 0.0  # opaque channels: the pow's base or exponent at 0
    time = rng.uniform(-0.5, 6.0, n).astype(np.float32)
    time[::5] = 0.0
    w = rng.uniform(-1.0, 1.0, (n, 4)).astype(np.float32)
    return kt, time, w


@pytest.mark.parametrize("which", ["trans", "shadow"])
def test_attenuation_matches_jax(which):
    """``trans_attenuation`` (``time^Kt``: the time is the base) and
    ``shadow_attenuation`` (``Kt^dist``), values and gradients."""
    kt, time, w = _atten_inputs()
    if which == "trans":
        jfn, tfn = jengine.trans_attenuation, engine.trans_attenuation
    else:
        jfn, tfn = jshading.shadow_attenuation, shading.shadow_attenuation
    jv = np.asarray(jfn(jnp.asarray(kt), jnp.asarray(time)))
    tv = tfn(torch.from_numpy(kt), torch.from_numpy(time)).numpy()
    np.testing.assert_allclose(tv, jv, rtol=1e-6, atol=1e-7)
    jg = jax.grad(lambda a, b: jnp.sum(jfn(a, b) * w), argnums=(0, 1))(
        jnp.asarray(kt), jnp.asarray(time))
    ts = [torch.from_numpy(x.copy()).requires_grad_(True) for x in (kt, time)]
    tg = torch.autograd.grad(torch.sum(tfn(*ts) * torch.from_numpy(w)), ts)
    for a, b in zip(tg, jg):
        assert torch.isfinite(a).all()
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL)


# ---------------------------------------------------------------------------
# the mixed world's frames
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mixed():
    jscene_np, jcam_np, jcfg = jsynth.make_mixed_world(depth=3)
    jcam_np = jscale_camera(jcam_np, W, jcfg.width)
    jcfg = jcfg.replace(width=W, height=H, engine="pallas")
    return dict(jscene=device_scene(jscene_np),
                jcam=jax.tree_util.tree_map(jnp.asarray, jcam_np),
                jcfg=jcfg,
                scene=convert.scene_from_numpy(jscene_np, device="cpu"),
                cam=convert.camera_from_numpy(jcam_np, device="cpu"),
                cfg=convert.config_from_jax(jcfg).replace(engine="torch"))


def test_process_round_gradients_stay_finite_through_dead_slots(mixed):
    """A round's contributions and children, differentiated with respect to
    the materials and the rays, stay finite where slots are dead (parked),
    rays miss (t = inf before sanitizing) and refraction is totally
    internal (the root's argument below 0)."""
    scene, cfg = mixed["scene"], mixed["cfg"]
    geom = expand_geometry(scene)
    cast_fn = engine.make_cast(scene, geom, cfg)
    ro, rd, _, _ = engine._frame_rays_blocked(mixed["cam"], cfg)
    n = ro.shape[0]
    kt = scene.materials.kt.clone().requires_grad_(True)
    kr = scene.materials.kr.clone().requires_grad_(True)
    eta = scene.materials.eta.clone().requires_grad_(True)
    mats = dataclasses.replace(scene.materials, kt=kt, kr=kr, eta=eta)
    scene_g = dataclasses.replace(scene, materials=mats)
    # every 8th ray grazes the glass cube's top face (y = 0.5 about
    # (0.8, 0.5)): entering at n1/n2 = 1/0.9, it reflects totally
    idx = torch.arange(n)
    graze = (idx % 8 == 1)[:, None]
    ro = torch.where(graze, torch.tensor([-1.2, 0.6, 0.5]), ro)
    rd = torch.where(graze, rm.normalize(torch.tensor([1.0, -0.05, 0.0])), rd)
    o = ro.clone().requires_grad_(True)
    d = rd.clone().requires_grad_(True)
    st = engine.Wave(o=o, d=d, atten=torch.ones(n, 4),
                     in_obj=idx % 3 == 0, active=idx % 4 != 0, pixel=idx)
    contrib, children = engine.process_round(scene_g, geom, cast_fn, cfg, st,
                                             True)
    with torch.no_grad():
        hit = cast_fn(torch.where(st.active[:, None], ro, 1e30), rd)
        normal, mat, _ = hit_shading_attrs(geom, hit)
        eta_r = scene.materials.eta[mat.long()]
        _, tir = rm.refract(rd, normal, torch.where(st.in_obj, eta_r, 1.0),
                            torch.where(st.in_obj, 1.0, eta_r))
        glass = (scene.materials.kt[mat.long()] > 0.0).any(-1)
    live = st.active & hit.valid
    assert (st.active & ~hit.valid).any() and (~st.active).any()
    # grazing rays into the glass (n1 = 1, n2 = 0.9) reflect totally
    assert (live & glass & tir).any() and (live & glass & ~tir).any()
    loss = (contrib.sum() + (children.atten * children.d[:, :1]).sum()
            + children.o.sum())
    grads = torch.autograd.grad(loss, [kt, kr, eta, o, d])
    for name, g in zip(("kt", "kr", "eta", "o", "d"), grads):
        assert torch.isfinite(g).all(), name
    assert float(grads[0].abs().sum()) > 0 and float(grads[1].abs().sum()) > 0


@pytest.mark.parametrize("depth", [0, 1, 2, 3])
def test_mixed_frame_matches_jax_pallas(mixed, depth):
    jcfg = mixed["jcfg"].replace(recurse_depth=depth)
    jimg = np.asarray(jax.jit(jrender_frame, static_argnames=("cfg",))(
        mixed["jscene"], mixed["jcam"], jcfg))
    cfg = mixed["cfg"].replace(recurse_depth=depth)
    img, stats = engine.render_frame_with_stats(mixed["scene"], mixed["cam"],
                                                cfg)
    np.testing.assert_allclose(img.numpy(), jimg, rtol=0, atol=1e-5)
    assert int(stats["dropped"]) == 0
    if depth == 3:
        # the bounces add light where the mirror and the glass are
        img0 = engine.render_frame(mixed["scene"], mixed["cam"],
                                   cfg.replace(recurse_depth=0))
        changed = (img - img0).abs().amax(-1) > 1e-3
        assert int(changed.sum()) > 40
        # early_exit on and off: the same frame, bit for bit
        assert cfg.early_exit
        assert torch.equal(img, engine.render_frame(
            mixed["scene"], mixed["cam"], cfg.replace(early_exit=False)))
