"""Phong shading, shadowed point and directional lights, and the
transmissive shadow march.

Counterpart of ``raytracer_tpu/render/shading.py``: ``illuminate = Ke +
Ka*ambience + sum over lights of phong(...)``.  In a world without a
refractive material each light's shadow is one any-hit query: with exactly
1 point + 1 directional light, ``fused_shadows`` on and a cast that has
``occlude2``, one call answers both queries (K2's fused walk, or two K5
queries on the cull); otherwise each light sends its own ``occlude`` query
(K3, K5, or the MXU cast's closest hit).
With a refractive material the shadow ray marches (``_march_shadow``,
reference light.cu:30-61): each step takes the closest hit (K1, K4 or K6);
an opaque blocker before the light kills it, a transmissive one passes it
on, attenuated by ``Kt^segment`` where the ray leaves the blocker
(``n.d > 0``), for at most ``shadow_steps`` steps.  On the LBVH walk with
no input that requires grad the whole march is one kernel launch
(``Cast.march``); else a loop of torch ops (:func:`march_steps`).  With
``texture_mapping`` the nearest atlas texel (``sample_atlas``) replaces
``Kd`` on textured triangles.

Where the JAX package takes ``jnp.maximum``/``jnp.minimum`` against a
constant, this module takes ``torch.maximum``/``torch.minimum`` against a
tensor, never ``torch.clamp``: the values are equal, but at a tie clamp
passes the whole gradient where JAX passes half.

Every opaque shadow mask goes through :func:`shadow_masks`, the port's
counterpart of the JAX package's ``checkpoint_name(..., "shadow_occl")``:
inside a per-sample checkpoint (``engine.sum_samples``) the forward
records the masks on a :class:`MaskTape`, bit-packed, and the backward's
recompute replays them, so that it runs no any-hit query.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Optional, Tuple

import torch

from .. import raymath as rm
from ..scene import Materials, RenderConfig, Scene
from ..tracing import span
from .cast import Cast, Hit, hit_shading_attrs
from .geometry import WorldGeometry


class MaskTape:
    """The shadow masks of one sample, in query order, 8 to a byte (1 bit a
    ray and query: the per-sample checkpoint keeps these across the whole
    forward, so they grow with spp)."""

    def __init__(self):
        self.packed: list = []
        self.pos = 0

    def record(self, masks: Tuple[torch.Tensor, ...]) -> None:
        self.packed.append(tuple(_pack_bits(m) for m in masks))

    def replay(self) -> Tuple[torch.Tensor, ...]:
        masks = tuple(_unpack_bits(*p) for p in self.packed[self.pos])
        self.pos += 1
        return masks


def _bit_weights(device) -> torch.Tensor:
    return torch.arange(8, dtype=torch.uint8, device=device)


def _pack_bits(m: torch.Tensor):
    flat = m.reshape(-1).to(torch.uint8)
    flat = torch.nn.functional.pad(flat, (0, -flat.shape[0] % 8))
    bits = (flat.view(-1, 8) << _bit_weights(m.device)).sum(
        -1, dtype=torch.uint8)
    return bits, m.shape


def _unpack_bits(bits: torch.Tensor, shape) -> torch.Tensor:
    n = shape.numel()
    flat = (bits[:, None] >> _bit_weights(bits.device)) & 1
    return flat.reshape(-1)[:n].to(torch.bool).reshape(shape)


# (mode, tape) while a per-sample checkpoint records or replays, else None
_TAPE: Optional[Tuple[str, MaskTape]] = None


@contextlib.contextmanager
def _tape_mode(mode: str, tape: MaskTape):
    global _TAPE
    saved, _TAPE = _TAPE, (mode, tape)
    tape.pos = 0
    try:
        yield
    finally:
        _TAPE = saved


def mask_tape_contexts():
    """``(forward, recompute)`` context managers over one fresh
    :class:`MaskTape`: the ``context_fn`` of a per-sample
    ``torch.utils.checkpoint``."""
    tape = MaskTape()
    return _tape_mode("record", tape), _tape_mode("replay", tape)


def shadow_masks(query: Callable[[], Tuple[torch.Tensor, ...]]
                 ) -> Tuple[torch.Tensor, ...]:
    """The bool masks of ``query()`` (the any-hit queries of a shading
    round), run under ``no_grad`` so that it adds nothing to the graph; a
    checkpoint's recompute takes them from the tape instead of running it
    (the JAX package saves them by name, ``"shadow_occl"``)."""
    if _TAPE is not None and _TAPE[0] == "replay":
        return _TAPE[1].replay()
    with torch.no_grad():
        masks = query()
    if _TAPE is not None:
        _TAPE[1].record(masks)
    return masks


def tape_active() -> bool:
    """Whether a per-sample checkpoint's :class:`MaskTape` records or
    replays."""
    return _TAPE is not None


def _relu(x):
    """``max(x, 0)`` with JAX's 0.5 subgradient at ``x == 0``."""
    return torch.maximum(x, x.new_zeros(()))


class _MaterialRows(torch.autograd.Function):
    """``table[idx]`` for a material table ``[K, C]`` and per-ray indices
    ``[R]``, whose backward sums each material's rows of the cotangent in
    two passes that do not grow with K: an ``index_add_`` of each block of
    ``max(64, K)`` consecutive rays into that block's own K partial rows,
    then a sum of the partials over the blocks, all in FP32.  (The autograd
    of a gather is torch's sort-based accumulate, which adds each run of
    equal indices serially: ~1M rays a material in a 1080p frame; one
    ``index_add_`` into K rows would put as many atomic adds on each row.)
    The JAX package takes a one-hot matmul for the same reason, its
    transpose being a matmul; additions need no TF32 guard."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.n_rows = table.shape[0]
        return table[idx]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        k, (r, c) = ctx.n_rows, g.shape
        block = max(64, k)  # adds on a partial row; partials <= R rows
        n_blocks = -(-r // block)
        slot = idx + k * (torch.arange(r, device=idx.device) // block)
        parts = g.new_zeros(n_blocks * k, c).index_add_(0, slot, g)
        return parts.view(n_blocks, k, c).sum(0), None


def gather_material_rows(mats: Materials, mat_idx: torch.Tensor) -> Materials:
    """Per-ray material rows: the eight fields packed into one ``[K, 26]``
    table as the JAX package packs them, and one exact row gather (the
    values the JAX package's one-hot matmul at HIGHEST precision selects),
    under :class:`_MaterialRows`'s blocked-sum backward.  Returns a
    ``Materials`` whose leaves are per-ray rows ([R,4] / [R])."""
    table = torch.cat([mats.ke, mats.ka, mats.kd, mats.ks, mats.kt, mats.kr,
                       mats.alpha[:, None], mats.eta[:, None]], dim=1)
    rows = _MaterialRows.apply(table, mat_idx.long())
    return dataclasses.replace(
        mats, ke=rows[:, 0:4], ka=rows[:, 4:8], kd=rows[:, 8:12],
        ks=rows[:, 12:16], kt=rows[:, 16:20], kr=rows[:, 20:24],
        alpha=rows[:, 24], eta=rows[:, 25])


def distance_attenuation(scene: Scene, dist):
    """``1 / max(1, c + l*d + q*d^2)``, and exactly 1 where the quadratic is
    below 1 (reference light.cu:11-17)."""
    c = scene.dist_atten[0]
    lin = scene.dist_atten[1]
    q = scene.dist_atten[2]
    quad = c + lin * dist + q * dist * dist
    return torch.where(quad < 1.0, 1.0,
                       1.0 / torch.maximum(quad, quad.new_ones(())))


def sample_atlas(scene: Scene, hit: Hit):
    """The nearest atlas texel of each hit and whether its triangle is
    untextured (``shading.sample_atlas``): the triangle's atlas rect
    ``(x, y, w, h)`` and the hit's barycentric ``uv`` give the texel
    ``rect.xy + uv * rect.wh``, truncated toward zero and clamped to the
    atlas.  Returns ``(texel [..., 4], degenerate [...])``."""
    tri = scene.wtri_tri[hit.wtri.long()].long()
    rect = scene.tri_coord_rect[tri]  # [..., 4]
    h, w = scene.atlas.shape[0], scene.atlas.shape[1]
    px = torch.clamp((rect[..., 0] + hit.uv[..., 0] * rect[..., 2]).to(
        torch.int32), 0, w - 1)
    py = torch.clamp((rect[..., 1] + hit.uv[..., 1] * rect[..., 3]).to(
        torch.int32), 0, h - 1)
    return scene.atlas[py.long(), px.long()], scene.tri_coord_degenerate[tri]


def phong_term(rmats: Materials, incoming, ray_dir, dir_to_light, normal,
               kd_override=None):
    """One light's Phong contribution (reference phong.cu:14-33):
    ``(max(L.N, 0) Kd + max(-reflect(-L, N).V, 0)^alpha Ks) * incoming``,
    with ``0^0 = 1`` for ``alpha = 0``; ``kd_override`` (the sampled
    texture) takes the place of ``Kd``."""
    kd = rmats.kd if kd_override is None else kd_override
    norm_dot = _relu(rm.dot(dir_to_light, normal))
    diffuse = norm_dot[..., None] * kd
    reflected = rm.reflect(-dir_to_light, normal)
    reflect_dot = rm.dot(-reflected, ray_dir)
    spec = rm.safe_pow(_relu(reflect_dot), rmats.alpha)[..., None] * rmats.ks
    return (diffuse + spec) * incoming


def shadow_attenuation(kt, dist):
    """``Kt^dist`` per channel (reference light.cu:19-26); gradient-safe at
    ``kt == 0``."""
    return rm.safe_pow(kt, dist[..., None])


def _use_fused(scene: Scene, cfg: RenderConfig, cast_fn: Cast) -> bool:
    """The JAX package's condition for the fused two-light round: it needs
    a cast with an ``occlude2`` query."""
    return (cfg.fused_shadows and not cfg.any_refractive
            and scene.lights.point_pos.shape[0] == 1
            and scene.lights.dir_dir.shape[0] == 1
            and cast_fn.occlude2 is not None)


def shadow_rays(scene: Scene, hit_pos, active):
    """The fused round's two shadow queries at ``hit_pos`` [R,3]:
    ``(o1, dir1, dist, o2, dir2)``.  Query 1 runs to the point light (max_t
    ``dist``), query 2 along the normalized directional light (max_t +inf).
    Both origins step THRESHOLD along the ray; inactive lanes park at 1e30,
    far outside the scene, so their walks end at once."""
    o_park = torch.where(active[..., None], hit_pos, 1e30)
    disp = scene.lights.point_pos[0] - hit_pos
    dist = rm.norm(disp)
    dir1 = rm.normalize(disp)
    dir2 = rm.normalize(-scene.lights.dir_dir[0]).expand(hit_pos.shape)
    return (o_park + rm.THRESHOLD * dir1, dir1, dist,
            o_park + rm.THRESHOLD * dir2, dir2)


def march_shadow(cast_fn: Cast, origin, dir_unit, max_t, light_col, active):
    """The light arriving at ``origin`` [R,3] from ``light_col`` along
    ``dir_unit``: the opaque fast path of ``_march_shadow``, one any-hit
    query (``Cast.occlude``) -- a blocker within ``max_t`` kills the light.
    Inactive lanes park at 1e30 like the fused round's."""
    dir_unit = dir_unit.expand(origin.shape)

    def query():
        o = (torch.where(active[..., None], origin, 1e30)
             + rm.THRESHOLD * dir_unit)
        return (active & cast_fn.occlude(o, dir_unit, max_t),)

    (blocked,) = shadow_masks(query)
    lit = light_col.expand(origin.shape[:-1] + (4,))
    return torch.where(blocked[..., None], 0.0, lit)


def march_steps(cast_fn: Cast, geom: WorldGeometry, mats: Materials,
                origin, dir_unit, max_t, light_col, active, steps: int,
                early_exit: bool):
    """The transmissive shadow march as a loop of whole-queue torch ops
    (``_march_shadow``'s loop): the light arriving at ``origin`` [R,3] from
    ``light_col`` along ``dir_unit`` within ``max_t`` ([R] or a float).
    Each step casts the closest hit: a hit beyond the light leaves it, an
    opaque one kills it, and a refractive one lets it on from the hit
    point, times ``Kt^t`` where the ray leaves the blocker (``n.d > 0``).
    ``steps`` steps, or with ``early_exit`` until no ray walks on (one host
    read a step, an ``rt.sync`` span).  ``kt`` comes from the packed
    material rows (:func:`gather_material_rows`, the blocked-sum
    backward): on the card a gather of the ``[K, 4]`` table alone takes
    torch's path for 16-byte rows, several times slower.  Differentiable;
    the plain version of the LBVH walk's fused march
    (``cuda_engine.bvh_march``)."""
    dir_unit = dir_unit.expand(origin.shape)
    origin = torch.where(active[..., None], origin, 1e30)
    rv = light_col.expand(origin.shape[:-1] + (4,))
    cur_o = origin + rm.THRESHOLD * dir_unit  # light.cu:32
    remaining = torch.as_tensor(max_t, dtype=torch.float32,
                                device=origin.device).expand(
                                    origin.shape[:-1])
    alive = active
    for _ in range(steps):
        if early_exit:
            with span("rt.sync"):
                live = bool(alive.any())
            if not live:
                break
        hit = cast_fn(cur_o, dir_unit)
        h_norm, h_mat, _ = hit_shading_attrs(geom, hit)
        step_hit = alive & hit.valid
        t_fin = torch.where(hit.valid, hit.t, 1.0)  # masked lanes finite
        beyond = step_hit & (t_fin > remaining)
        kt = gather_material_rows(mats, h_mat).kt
        refractive = (kt > 0.0).any(-1)
        opaque = step_hit & ~beyond & ~refractive
        continuing = step_hit & ~beyond & refractive
        rv = torch.where(opaque[..., None], 0.0, rv)
        exiting = continuing & (rm.dot(h_norm, dir_unit) > 0.0)
        # the path length masked first: no miss reaches the pow's gradient
        t_m = torch.where(continuing, t_fin, 1.0)
        rv = torch.where(exiting[..., None],
                         rv * shadow_attenuation(kt, t_m), rv)
        cur_o = torch.where(continuing[..., None],
                            cur_o + t_m[..., None] * dir_unit, cur_o)
        remaining = torch.where(continuing, remaining - t_m, remaining)
        alive = continuing
    return rv


def _requires_grad(*xs) -> bool:
    return torch.is_grad_enabled() and any(
        isinstance(x, torch.Tensor) and x.requires_grad for x in xs)


def march_transmissive(scene: Scene, geom: WorldGeometry, cast_fn: Cast,
                       cfg: RenderConfig, origin, dir_unit, max_t, light_col,
                       active):
    """The transmissive shadow march of one light, in one ``rt.march``
    span: the cast's own ``march`` (the LBVH walk's on the card: one kernel
    launch) where the cast has one and no input of the march requires grad
    (the rays, ``max_t``, the light, ``kt`` or the world triangles the
    reparam rule differentiates), else
    :func:`march_steps` over ``cast_fn``, whose casts (``rt.cast``) and
    early exits (``rt.sync``) nest in the span and whose graph the backward
    takes.  The kernel's path opens an empty ``rt.march_fused`` span first:
    it marks the path, and the launch's host time stays in ``rt.march``'s
    own."""
    with span("rt.march"):
        if cast_fn.march is not None and not _requires_grad(
                origin, dir_unit, max_t, light_col, scene.materials.kt,
                geom.a, geom.b, geom.c, geom.na, geom.nb, geom.nc):
            with span("rt.march_fused"):
                pass
            return cast_fn.march(origin, dir_unit, max_t, light_col, active,
                                 scene.materials.kt, cfg.shadow_steps)
        return march_steps(cast_fn, geom, scene.materials, origin, dir_unit,
                           max_t, light_col, active, cfg.shadow_steps,
                           cfg.early_exit)


def _shadowed(scene: Scene, geom: WorldGeometry, cast_fn: Cast,
              cfg: RenderConfig, origin, dir_unit, max_t, light_col, active):
    """``_march_shadow``: one any-hit query where no material transmits,
    else the march."""
    if not cfg.any_refractive:
        return march_shadow(cast_fn, origin, dir_unit, max_t, light_col,
                            active)
    return march_transmissive(scene, geom, cast_fn, cfg, origin, dir_unit,
                              max_t, light_col, active)


def illuminate(scene: Scene, geom: WorldGeometry, cast_fn: Cast,
               cfg: RenderConfig, ray_o, ray_d, hit: Hit, normal,
               rmats: Materials, active):
    """Local shading at a hit point (reference phong.cu:40-67): the fused
    two-light round when it applies, else one shadow query or march per
    light.  With ``texture_mapping`` a textured triangle's atlas texel
    replaces ``Kd`` in every light's term (the texel takes no gradient;
    ``Kd`` keeps its gradient on untextured triangles only)."""
    hit_pos = ray_o + hit.t[..., None] * ray_d
    col = rmats.ke + rmats.ka * scene.ambience
    lights = scene.lights
    kd = None
    if cfg.texture_mapping:
        tex, degenerate = sample_atlas(scene, hit)
        kd = torch.where(degenerate[..., None], rmats.kd, tex)

    if _use_fused(scene, cfg, cast_fn):
        o1, dir1, dist, o2, dir2 = shadow_rays(scene, hit_pos, active)
        b1, b2 = shadow_masks(lambda: tuple(
            active & b for b in cast_fn.occlude2(o1, dir1, dist, o2, dir2,
                                                 float("inf"))))
        dir_to_light2 = -lights.dir_dir[0]  # raw: Phong takes it unnormalized
        datten = distance_attenuation(scene, dist)
        zero = hit_pos.new_zeros(())
        incoming1 = datten[..., None] * torch.where(b1[..., None], zero,
                                                    lights.point_col[0])
        col = col + phong_term(rmats, incoming1, ray_d, dir1, normal,
                               kd)
        incoming2 = torch.where(b2[..., None], zero, lights.dir_col[0])
        col = col + phong_term(rmats, incoming2, ray_d, dir_to_light2,
                               normal, kd)
        return col

    for i in range(lights.point_pos.shape[0]):
        disp = lights.point_pos[i] - hit_pos
        dist = rm.norm(disp)
        dir_to_light = rm.normalize(disp)
        incoming = distance_attenuation(scene, dist)[..., None] * _shadowed(
            scene, geom, cast_fn, cfg, hit_pos, dir_to_light, dist,
            lights.point_col[i], active)
        col = col + phong_term(rmats, incoming, ray_d, dir_to_light, normal,
                               kd)
    for i in range(lights.dir_dir.shape[0]):
        dir_to_light = -lights.dir_dir[i]  # raw (reference light.cu:74-77)
        incoming = _shadowed(scene, geom, cast_fn, cfg, hit_pos,
                             rm.normalize(dir_to_light), float("inf"),
                             lights.dir_col[i], active)
        col = col + phong_term(rmats, incoming, ray_d, dir_to_light, normal,
                               kd)
    return col
