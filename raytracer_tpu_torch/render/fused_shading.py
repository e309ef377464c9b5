"""A wavefront round's shading as two CUDA kernels around its shadow
queries (``csrc/shade_kernels.cu``).

``process_round``'s torch path (``shading.illuminate`` and the glue around
it: hit points, the attenuation inside a medium, Phong of every light, the
weighted contribution) dispatches a few hundred whole-queue torch ops a
round.  On the card, where nothing differentiates through the round, the
same values come from:

* :func:`shade_rays`, before the queries: the hit points, the shaded-lane
  flag ``h_valid``, each light's unit direction (and a point light's
  distance), the any-hit queries' origins (parked at 1e30 where a lane is
  not shaded, then THRESHOLD along the query; the march offsets and parks
  its own) and ``atten_eff``, ``atten * Kt^t`` inside a medium;
* the shadow queries, as the torch path sends them: K2's fused pair, one
  any-hit query a light (K3, K5), or each light's transmissive march
  (``shading.march_transmissive``, one launch a light);
* :func:`shade_phong`, after them: ``Ke + Ka * ambience`` plus each
  light's arriving light times Phong, weighted by ``atten_eff``, 0 where a
  lane is not shaded.

The torch path is the plain version: the CPU tests, training, the
``"torch"`` engine and every case that :func:`eligible` turns away take it
unchanged.  Each operation of the kernels rounds as its torch op does
(``-fmad=false``); ``powf`` may differ from torch's ``pow`` in the last
place.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import torch

from ..scene import RenderConfig, Scene
from . import shading
from .cast import Cast, Hit
from .cuda_engine import _check
from .geometry import WorldGeometry

MAX_LIGHTS = 8  # point + directional lights (the kernels' Shadow table)
# materials whose rows fit the 48 KB of shared memory (80 B a material)
MAX_MATERIALS = 512


def _on_card(x: torch.Tensor) -> bool:
    return x.is_cuda


def eligible(scene: Scene, geom: WorldGeometry, cast_fn: Cast,
             cfg: RenderConfig, st, hit: Hit) -> bool:
    """Whether the round ``st`` (an ``engine.Wave``) with its closest hits
    ``hit`` shades on the kernels: the ``"cuda"`` engine, with every tensor
    the round reads on the card and none that requires grad (the rays and
    their attenuation, the materials, the lights, the world triangles),
    no texture and no edge-aware band, a hit that carries its normal and
    material (the scalar kernels' do; the MXU cast's does not), no mask
    tape recording or replaying (``shading.mask_tape_contexts``), a cast
    with a fused march where a material transmits, at most
    :data:`MAX_LIGHTS` lights and :data:`MAX_MATERIALS` materials."""
    mats, lights = scene.materials, scene.lights
    if (cfg.engine != "cuda" or cfg.texture_mapping or cfg.edge_aware_grads
            or hit.normal is None or hit.mat is None
            or shading.tape_active()
            or (cfg.any_refractive and cast_fn.march is None)
            or lights.point_pos.shape[0] + lights.dir_dir.shape[0]
            > MAX_LIGHTS
            or mats.ke.shape[0] > MAX_MATERIALS):
        return False
    read = (st.o, st.d, st.atten, st.active, hit.t, hit.normal, hit.mat,
            mats.ke, mats.ka, mats.kd, mats.ks, mats.kt, mats.alpha,
            lights.point_pos, lights.point_col, lights.dir_dir,
            lights.dir_col, scene.ambience, scene.dist_atten)
    return all(_on_card(x) for x in read) and not shading._requires_grad(
        *read, geom.a, geom.b, geom.c, geom.na, geom.nb, geom.nc)


# ---------------------------------------------------------------------------
# the kernels' wrappers (CUDA tensors only: the plain version is the torch
# path of engine.process_round)
# ---------------------------------------------------------------------------

class _ShadeScene(ctypes.Structure):
    """``rt::ShadeScene`` (``csrc/shade_kernels.cu``), field for field."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "ke", "ka", "kd", "ks", "kt", "alpha", "point_pos", "point_col",
        "dir_dir", "dir_col", "ambience", "dist_atten")] + [
        ("n_mats", ctypes.c_int), ("n_point", ctypes.c_int),
        ("n_dir", ctypes.c_int)]


def _checked(name, x, shape, device, dtype=torch.float32):
    """``x`` contiguous and 16-byte aligned, for float4 rows (a view at an
    odd offset is copied); raises on a wrong dtype, shape or device."""
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    _check(name, x, dtype, shape, device)
    return x


def scene_arg(scene: Scene, device):
    """``(_ShadeScene, kept tensors)``, the scene's shading constants as
    both kernels take them: built once a round, and held until its
    launches have been enqueued (a copy freed before it could lend its
    memory to the outputs)."""
    mats, lights = scene.materials, scene.lights
    k = mats.ke.shape[0]
    n_p, n_d = lights.point_pos.shape[0], lights.dir_dir.shape[0]
    if n_p + n_d > MAX_LIGHTS or not 1 <= k <= MAX_MATERIALS:
        raise ValueError(f"the shading kernels take 1-{MAX_MATERIALS} "
                         f"materials and at most {MAX_LIGHTS} lights, got "
                         f"{k} and {n_p + n_d}")
    kept = dict(
        ke=_checked("ke", mats.ke, (k, 4), device),
        ka=_checked("ka", mats.ka, (k, 4), device),
        kd=_checked("kd", mats.kd, (k, 4), device),
        ks=_checked("ks", mats.ks, (k, 4), device),
        kt=_checked("kt", mats.kt, (k, 4), device),
        alpha=_checked("alpha", mats.alpha, (k,), device),
        point_pos=_checked("point_pos", lights.point_pos, (n_p, 3), device),
        point_col=_checked("point_col", lights.point_col, (n_p, 4), device),
        dir_dir=_checked("dir_dir", lights.dir_dir, (n_d, 3), device),
        dir_col=_checked("dir_col", lights.dir_col, (n_d, 4), device),
        ambience=_checked("ambience", scene.ambience, (4,), device),
        dist_atten=_checked("dist_atten", scene.dist_atten, (3,), device))
    arg = _ShadeScene(**{n: x.data_ptr() for n, x in kept.items()},
                      n_mats=k, n_point=n_p, n_dir=n_d)
    return arg, kept


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else ctypes.c_void_p(x.data_ptr())


def _launch(name: str, device: torch.device, *args) -> None:
    """Call the library's entry point ``name`` on ``device``'s current
    stream; raises where the launch fails."""
    from . import kernels

    err = getattr(kernels.library(), name)(*args, device.index,
                                           kernels.stream_handle(device))
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


@dataclass
class RayShade:
    """What :func:`shade_rays` gives a round: ``hit_pos [R, 3]``,
    ``h_valid [R]``, ``atten_eff [R, 4]``, ``ldir [Q, R, 3]`` (the point
    lights' unit directions, then with queries the directional ones'),
    ``ldist [L, R]``, ``qorig [Q, R, 3]`` (the any-hit queries' origins,
    or None) and ``dunit [M, 3]`` (the directional lights' unit
    directions)."""

    hit_pos: torch.Tensor
    h_valid: torch.Tensor
    atten_eff: torch.Tensor
    ldir: torch.Tensor
    ldist: torch.Tensor
    qorig: Optional[torch.Tensor]
    dunit: torch.Tensor


def shade_rays(sc, o, d, atten, in_obj, active, valid, t, mat, *,
               queries: bool, refractive: bool) -> RayShade:
    """The kernel before the shadow queries (``shade_rays_kernel``), with
    the scene's constants ``sc`` (:func:`scene_arg`): rays
    ``o``, ``d`` ``[R, 3]``, their ``atten [R, 4]``, ``in_obj`` and
    ``active`` ``[R]``, and their closest hits' ``valid``, ``t`` and
    ``mat`` ``[R]``.  ``queries`` writes every light's per-lane direction
    and query origin (K2, K3), else the point lights' directions alone
    (the march); ``refractive`` writes ``atten_eff``, which is else
    ``atten`` itself.  CUDA tensors only."""
    R = o.shape[0]
    dev = o.device
    if not _on_card(o):
        raise ValueError("shade_rays launches on CUDA tensors only (the "
                         "plain version is process_round's torch path)")
    o = _checked("o", o, (R, 3), dev)
    d = _checked("d", d, (R, 3), dev)
    atten = _checked("atten", atten, (R, 4), dev)
    in_obj = _checked("in_obj", in_obj, (R,), dev, torch.bool)
    active = _checked("active", active, (R,), dev, torch.bool)
    valid = _checked("valid", valid, (R,), dev, torch.bool)
    t = _checked("t", t, (R,), dev)
    mat = _checked("mat", mat, (R,), dev, torch.int32)
    sc, _ = sc
    n_p = sc.n_point
    q = n_p + sc.n_dir if queries else n_p
    hit_pos = torch.empty(R, 3, dtype=torch.float32, device=dev)
    h_valid = torch.empty(R, dtype=torch.bool, device=dev)
    atten_eff = (torch.empty(R, 4, dtype=torch.float32, device=dev)
                 if refractive else atten)
    ldir = torch.empty(q, R, 3, dtype=torch.float32, device=dev)
    ldist = torch.empty(n_p, R, dtype=torch.float32, device=dev)
    qorig = (torch.empty(q, R, 3, dtype=torch.float32, device=dev)
             if queries else None)
    dunit = torch.empty(sc.n_dir, 3, dtype=torch.float32, device=dev)
    if R > 0:
        _launch("rt_shade_rays", dev, ctypes.addressof(sc), _ptr(o), _ptr(d),
                _ptr(atten), _ptr(in_obj), _ptr(active), _ptr(valid), _ptr(t),
                _ptr(mat), int(queries), R, _ptr(hit_pos), _ptr(h_valid),
                _ptr(atten_eff) if refractive else None, _ptr(ldir),
                _ptr(ldist), _ptr(qorig), _ptr(dunit))
        shade_rays.launches += 1
    return RayShade(hit_pos, h_valid, atten_eff, ldir, ldist, qorig, dunit)


shade_rays.launches = 0


def shade_phong(sc, d, normal, mat, h_valid, hit_pos, atten_eff, shadow, *,
                march: bool) -> torch.Tensor:
    """The kernel after the shadow queries (``shade_phong_kernel``), with
    the scene's constants ``sc`` (:func:`scene_arg`): the round's
    contribution ``[R, 4]`` from the rays' ``d`` and the hits'
    ``normal`` and ``hit_pos`` ``[R, 3]``, ``mat`` and ``h_valid`` ``[R]``,
    ``atten_eff [R, 4]`` and ``shadow``, one entry a light, point lights
    first: bool ``[R]`` masks (a blocker found), or with ``march`` the
    marches' light ``[R, 4]``.  CUDA tensors only."""
    R = d.shape[0]
    dev = d.device
    if not _on_card(d):
        raise ValueError("shade_phong launches on CUDA tensors only (the "
                         "plain version is process_round's torch path)")
    d = _checked("d", d, (R, 3), dev)
    normal = _checked("normal", normal, (R, 3), dev)
    mat = _checked("mat", mat, (R,), dev, torch.int32)
    h_valid = _checked("h_valid", h_valid, (R,), dev, torch.bool)
    hit_pos = _checked("hit_pos", hit_pos, (R, 3), dev)
    atten_eff = _checked("atten_eff", atten_eff, (R, 4), dev)
    sc, _ = sc
    if len(shadow) != sc.n_point + sc.n_dir:
        raise ValueError(f"shadow: one entry a light ({sc.n_point} + "
                         f"{sc.n_dir}), got {len(shadow)}")
    shadow = [_checked(f"shadow[{i}]", s, (R, 4), dev) if march
              else _checked(f"shadow[{i}]", s, (R,), dev, torch.bool)
              for i, s in enumerate(shadow)]
    table = (ctypes.c_void_p * MAX_LIGHTS)(*[s.data_ptr() for s in shadow])
    contrib = torch.empty(R, 4, dtype=torch.float32, device=dev)
    if R > 0:
        _launch("rt_shade_phong", dev, ctypes.addressof(sc), _ptr(d),
                _ptr(normal), _ptr(mat), _ptr(h_valid), _ptr(hit_pos),
                _ptr(atten_eff), ctypes.addressof(table), int(march), R,
                _ptr(contrib))
        shade_phong.launches += 1
    return contrib


shade_phong.launches = 0


def mode(scene: Scene, cfg: RenderConfig, cast_fn: Cast) -> str:
    """How the round's shadow queries run, as the torch path sends them:
    ``"pair"`` (K2's fused pair), ``"each"`` (one any-hit query a light)
    or ``"march"`` (each light's transmissive march)."""
    if shading._use_fused(scene, cfg, cast_fn):
        return "pair"
    return "march" if cfg.any_refractive else "each"


def shadow_queries(scene: Scene, geom: WorldGeometry, cast_fn: Cast,
                   cfg: RenderConfig, rs: RayShade, how: str):
    """The round's shadow queries from :func:`shade_rays`' ``rs``, one
    entry a light, point lights first, as :func:`shade_phong` takes them:
    ``how`` (:func:`mode`) ``"pair"`` or ``"each"`` gives a bool ``[R]``
    blocker mask a light, ``"march"`` each march's light ``[R, 4]``."""
    lights = scene.lights
    n_p, n_d = lights.point_pos.shape[0], lights.dir_dir.shape[0]
    inf = float("inf")
    with torch.no_grad():
        if how == "pair":
            return list(cast_fn.occlude2(rs.qorig[0], rs.ldir[0], rs.ldist[0],
                                         rs.qorig[1], rs.ldir[1], inf))
        if how == "each":
            return [cast_fn.occlude(rs.qorig[i], rs.ldir[i],
                                    rs.ldist[i] if i < n_p else inf)
                    for i in range(n_p + n_d)]
        return [shading.march_transmissive(
            scene, geom, cast_fn, cfg, rs.hit_pos, rs.ldir[i], rs.ldist[i],
            lights.point_col[i], rs.h_valid) for i in range(n_p)] + [
                shading.march_transmissive(
                    scene, geom, cast_fn, cfg, rs.hit_pos, rs.dunit[j], inf,
                    lights.dir_col[j], rs.h_valid) for j in range(n_d)]


def shade_round(scene: Scene, geom: WorldGeometry, cast_fn: Cast,
                cfg: RenderConfig, st, hit: Hit):
    """One round's shading on the kernels, where :func:`eligible` says so.
    Returns ``(contrib [R, 4], h_valid [R], hit_pos [R, 3], atten_eff
    [R, 4])``: the contribution, and what the round's spawn reads."""
    how = mode(scene, cfg, cast_fn)
    sc = scene_arg(scene, st.o.device)
    rs = shade_rays(sc, st.o, st.d, st.atten, st.in_obj, st.active,
                    hit.valid, hit.t, hit.mat, queries=how != "march",
                    refractive=cfg.any_refractive)
    shadow = shadow_queries(scene, geom, cast_fn, cfg, rs, how)
    contrib = shade_phong(sc, st.d, hit.normal, hit.mat, rs.h_valid,
                          rs.hit_pos, rs.atten_eff, shadow,
                          march=how == "march")
    return contrib, rs.h_valid, rs.hit_pos, rs.atten_eff
