"""Frame assembly: camera rays in 32x32 blocks, the bounce wavefront, clamp.

Counterpart of ``raytracer_tpu/render/engine.py``: ``render_frame`` ->
``_frame_rays_blocked`` (pad to a multiple of 32, pad pixels keep origin 0
and dir (0,0,1), reorder into 32x32 screen blocks so neighbouring rays
share a frustum) -> ``render_rays_stats`` -> ``radiance`` -> unblock and
crop.

``radiance`` replaces the reference's per-pixel recursion
(``propagate_ray``, ``src/rayenv/scene.cu:75-187``) with a wavefront: a
queue of ray states (:class:`Wave`) advanced one bounce round at a time by
:func:`process_round` (cast, shade, spawn the reflect and refract
children).  Two queue disciplines, chosen from the scene's materials:

* the pixel-aligned stream (materials spawn one child type): each child
  keeps its parent's slot, so a round adds its contributions with a plain
  add; dead slots keep their place, their origins parked at 1e30;
* the compacted 2x stream (reflective AND refractive materials): the two
  child streams concatenate, a stable argsort moves the active children to
  the front, ``C = int(R * queue_factor)`` slots are kept (the rest are
  counted in ``dropped``), and contributions go back to their pixels by an
  ``index_add_``.

``wavefront_tile_cap`` runs the rounds on the 1024-ray tiles that hold a
primary hit; ``child_tile_cap`` keeps whole tiles of children instead of
single slots.  Each surface's own material gates its reflect and refract
children (DEVIATIONS.md: one flag per child type).  Frames are
differentiable: the casts carry their own VJP rules (``cast_vjp.py``);
``edge_aware_grads`` adds the silhouette band's boundary term to the
backward and leaves the forward frame bit for bit as it is.

At ``spp > 1`` a frame is the mean of ``spp`` sample frames, each through
jittered sub-pixel rays (``spp_jitter_grid``: R2 offsets plus a per-pixel
toroidal shift), summed by ``sum_samples`` over cast tables built once a
geometry (``prepared``: scene prep, kept across the frames and steps of
one geometry).  Each sample runs under a
``torch.utils.checkpoint`` whose backward recomputes it, so reverse-mode
memory does not grow with spp beyond its shadow masks (1 bit a ray and
query), which the recompute replays (``shading.shadow_masks``) instead of
running the any-hit queries again.  ``static_tile_cap`` renders each sample
on the 1024-ray tiles kept by one probe of the pixel-centre frame
(``_static_tile_lanes``).
"""

from __future__ import annotations

import dataclasses
import weakref
from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.utils.checkpoint

from .. import raymath as rm
from ..scene import Camera, RenderConfig, Scene
from ..tracing import span
from . import cuda_engine, fused_shading
from .cast import Cast, Hit, hit_shading_attrs
from .cast_vjp import pack_reparam_geo
from .cuda_engine import _use_walk, make_cuda_cast
from .cull import make_cull_cast
from .geometry import WorldGeometry, camera_rays, expand_geometry
from .mxu import make_mxu_cast, prepare_mxu_cast
from .shading import gather_material_rows, illuminate, mask_tape_contexts

BLOCK = 32  # screen-space tile edge: one 32x32 block of rays
# Rays per engine tile (BLOCK * BLOCK): the granularity of the tile caps
TILE_LANES = 1024


def trans_attenuation(kt, time):
    """``time^Kt`` per channel (reference ``src/rayenv/scene.cu:14-22``):
    the base is the segment's *time*, not Kt, as the reference has it.
    Gradient-safe at 0."""
    return rm.safe_pow(torch.maximum(time, time.new_zeros(()))[..., None],
                       kt)


@torch.no_grad()
def band_table(geom: WorldGeometry) -> torch.Tensor:
    """The edge-aware hinge's per-triangle table ``[W, 4]``: the altitudes
    onto the edges opposite a, b and c, and the inradius (``engine.
    _radiance_dense``'s ``band_tbl``).  Out of the graph by design: at a
    silhouette the barycentric weight goes to 0, so the boundary term flows
    through the cast's uv-VJP alone."""
    eab = geom.b - geom.a
    ebc = geom.c - geom.b
    eca = geom.a - geom.c
    area2 = rm.norm(rm.cross(eab, -eca))  # twice the area
    tiny = area2.new_tensor(1e-12)
    safe = torch.maximum(area2, tiny)
    h_a = safe / torch.maximum(rm.norm(ebc), tiny)
    h_b = safe / torch.maximum(rm.norm(eca), tiny)
    h_c = safe / torch.maximum(rm.norm(eab), tiny)
    r_in = safe / torch.maximum(rm.norm(eab) + rm.norm(ebc) + rm.norm(eca),
                                tiny)
    return torch.stack([h_a, h_b, h_c, r_in], dim=-1)


def edge_aware_visibility(cfg: RenderConfig, band_tbl, hit: Hit, normal,
                          ray_d, h_valid, pixel_angle=None):
    """The hit mask with the edge-aware gradient (``_radiance_dense``'s
    ``edge_aware_grads`` block): 1 on hits, 0 elsewhere, as a value; its
    gradient is that of the one-sided hinge ``clip(e / band, 0, 1)`` on the
    world distance ``e`` from the hit point to the nearest edge of its
    triangle (barycentric times altitude).  ``band`` is ``edge_px`` screen
    pixels of footprint ``t * pixel_angle / max(|n.d|, 0.05)``, at most 0.8
    inradii (``cfg.edge_eps`` of the smallest altitude without
    ``pixel_angle``), and takes no gradient."""
    u = hit.uv[..., 0]
    v = hit.uv[..., 1]
    b0 = 1.0 - u - v
    rows = band_tbl[hit.wtri.long()]
    h_a, h_b, h_c, r_in = rows.unbind(-1)
    e_world = torch.minimum(torch.minimum(b0 * h_a, u * h_b), v * h_c)
    if pixel_angle is None:
        band = cfg.edge_eps * torch.minimum(torch.minimum(h_a, h_b), h_c)
    else:
        nd = torch.abs(rm.dot(normal.detach(), ray_d))
        foot = hit.t * pixel_angle / torch.maximum(nd, nd.new_tensor(0.05))
        band = torch.minimum(cfg.edge_px * foot, 0.8 * r_in)
    band = torch.maximum(band, band.new_tensor(1e-12)).detach()
    ratio = e_world / band
    soft = torch.minimum(torch.maximum(ratio, ratio.new_zeros(())),
                         ratio.new_ones(()))
    return torch.where(h_valid, 1.0 + (soft - soft.detach()), 0.0)


@dataclass
class Wave:
    """One round's ray queue (the SoA analog of the reference's
    ``RayFrame``): origins and directions ``[C, 3]``, the attenuation
    carried from the primary ray ``[C, 4]``, whether the ray travels inside
    a medium, whether the slot is live, and the pixel (the block-major ray
    index of the primary) it adds to."""

    o: torch.Tensor
    d: torch.Tensor
    atten: torch.Tensor
    in_obj: torch.Tensor
    active: torch.Tensor
    pixel: torch.Tensor

    def map(self, fn) -> "Wave":
        return Wave(**{f.name: fn(getattr(self, f.name))
                       for f in dataclasses.fields(self)})

    def with_parked_dirs(self) -> "Wave":
        """Dead slots take the direction (0, 0, 1)."""
        d = torch.where(self.active[:, None], self.d,
                        self.d.new_tensor([0.0, 0.0, 1.0]))
        return dataclasses.replace(self, d=d)


def primary_wave(ray_o, ray_d) -> Wave:
    R = ray_o.shape[0]
    dev = ray_o.device
    return Wave(o=ray_o, d=ray_d,
                atten=torch.ones(R, 4, dtype=torch.float32, device=dev),
                in_obj=torch.zeros(R, dtype=torch.bool, device=dev),
                active=torch.ones(R, dtype=torch.bool, device=dev),
                pixel=torch.arange(R, device=dev))


def process_round(scene: Scene, geom: WorldGeometry, cast_fn: Cast,
                  cfg: RenderConfig, st: Wave, spawn: bool, band_tbl=None,
                  pixel_angle=None):
    """Cast and shade one wavefront round (``_radiance_dense``'s
    ``process_round``).  Returns ``(contrib [C, 4], children)``: the
    radiance each slot adds to its pixel, and the reflect and refract
    children as one :class:`Wave` (``2C`` slots when both child types
    exist), or None when ``spawn`` is False (the last round, whose
    children would all be dead).  Where ``fused_shading.eligible`` says
    so, the round shades on two kernels around its shadow queries and
    opens an empty ``rt.shade_fused`` span first; else on the torch ops
    below, the plain version."""
    # dead slots park far outside the scene, so their walks end at once
    o_cast = torch.where(st.active[:, None], st.o, 1e30)
    hit = cast_fn(o_cast, st.d)
    with span("rt.shade"):
        fused = fused_shading.eligible(scene, geom, cast_fn, cfg, st, hit)
        if fused:
            with span("rt.shade_fused"):
                pass
            contrib, h_valid, hit_pt, atten_eff = fused_shading.shade_round(
                scene, geom, cast_fn, cfg, st, hit)
            normal, mat_idx = hit.normal, hit.mat
        else:
            # sanitize miss times (inf) so positions of masked lanes stay
            # finite
            hit = Hit(valid=hit.valid, t=torch.where(hit.valid, hit.t, 1.0),
                      wtri=hit.wtri, uv=hit.uv, normal=hit.normal,
                      mat=hit.mat)
            h_valid = st.active & hit.valid
            normal, mat_idx, _ = hit_shading_attrs(geom, hit)
            rmats = gather_material_rows(scene.materials, mat_idx)

            # inside a medium every hit attenuates by the hit material's Kt
            # over the segment (scene.cu:112-115); t masked to 1 outside, so
            # that no miss reaches the pow's gradient.  No refractive
            # material: no ray is ever inside one.
            atten_eff = st.atten
            if cfg.any_refractive:
                in_medium = st.in_obj & h_valid
                t_m = torch.where(in_medium, hit.t, 1.0)
                atten_eff = torch.where(
                    in_medium[:, None],
                    st.atten * trans_attenuation(rmats.kt, t_m), st.atten)

            lum = illuminate(scene, geom, cast_fn, cfg, st.o, st.d, hit,
                             normal, rmats, h_valid)
            # visibility is exactly 1 on hits without the edge-aware band
            weight = atten_eff
            if cfg.edge_aware_grads:
                vis = edge_aware_visibility(cfg, band_tbl, hit, normal, st.d,
                                            h_valid, pixel_angle)
                weight = vis[:, None] * atten_eff
            contrib = torch.where(h_valid[:, None], weight * lum, 0.0)
    if not spawn:
        return contrib, None

    with span("rt.queue"):
        # the kernels' round gave the hit points but gathered no material
        # row (a spawn kernel, ROADMAP item 30, would take both in)
        if fused:
            rmats = gather_material_rows(scene.materials, mat_idx)
        else:
            hit_pt = st.o + hit.t[:, None] * st.d
        parts = []
        if cfg.any_reflective:
            reflective = (rmats.kr > 0.0).any(-1)
            parts.append(Wave(
                o=hit_pt, d=rm.normalize(rm.reflect(st.d, normal)),
                atten=atten_eff * rmats.kr, in_obj=st.in_obj,
                active=h_valid & reflective, pixel=st.pixel))
        if cfg.any_refractive:
            refractive = (rmats.kt > 0.0).any(-1)
            eta = rmats.eta
            n1 = torch.where(st.in_obj, eta, 1.0)
            n2 = torch.where(st.in_obj, 1.0, eta)
            refr_d, tir = rm.refract(st.d, normal, n1, n2)
            parts.append(Wave(
                o=hit_pt, d=rm.normalize(refr_d), atten=atten_eff,
                in_obj=~st.in_obj, active=h_valid & refractive & ~tir,
                pixel=st.pixel))
        if len(parts) == 1:
            return contrib, parts[0]
        return contrib, Wave(**{
            f.name: torch.cat([getattr(p, f.name) for p in parts])
            for f in dataclasses.fields(Wave)})


def compact(children: Wave, cap: int):
    """The active children first, in their order (a stable argsort of the
    dead flag, as uint8 so every device sorts alike), the first ``cap``
    slots kept.  Returns ``(wave, n_dropped)``."""
    order = torch.argsort((~children.active).to(torch.uint8), stable=True)
    keep = order[:cap]
    st = children.map(lambda x: x[keep]).with_parked_dirs()
    dropped = children.active.sum() - st.active.sum()
    return st, dropped.to(torch.int32)


def compact_tiles(children: Wave, n_tiles: int):
    """The first ``n_tiles`` whole 1024-slot tiles that hold an active
    child, in tile order.  Returns ``(wave, n_dropped)``."""
    tile_any = children.active.reshape(-1, TILE_LANES).any(-1)
    keep_t = torch.sort(torch.argsort((~tile_any).to(torch.uint8),
                                      stable=True)[:n_tiles]).values

    def take(x):
        xt = x.reshape((-1, TILE_LANES) + x.shape[1:])
        return xt[keep_t].reshape((-1,) + x.shape[1:])

    st = children.map(take).with_parked_dirs()
    dropped = children.active.sum() - st.active.sum()
    return st, dropped.to(torch.int32)


def tile_scatter_add(acc, pixel, contrib):
    """Add kept tiles' contributions by whole tiles: each kept tile's 1024
    pixels are one tile of the frame, in order (children keep their
    parents' slots), and a mixed stream can keep the same tile twice,
    whose contributions ``index_add`` sums."""
    tid = pixel.reshape(-1, TILE_LANES)[:, 0] // TILE_LANES
    return acc.reshape(-1, TILE_LANES, 4).index_add(
        0, tid, contrib.reshape(-1, TILE_LANES, 4)).reshape(acc.shape)


RoundHook = Callable[[int, Wave], None]


def _radiance_dense(scene: Scene, geom: WorldGeometry, cast_fn: Cast,
                    cfg: RenderConfig, ray_o, ray_d, pixel_angle=None,
                    on_round: Optional[RoundHook] = None):
    """Every round of the wavefront over the flat primary rays ``[R, 3]``.
    Returns ``(acc [R, 4], dropped)``; ``dropped`` counts the children that
    found no slot in the queue.  ``pixel_angle``: the angular size of a
    pixel, which sizes the edge-aware band in screen pixels.  ``on_round``
    (if given) sees each round's queue before its cast."""
    R = ray_o.shape[0]
    band_tbl = band_table(geom) if cfg.edge_aware_grads else None
    can_spawn = ((cfg.any_reflective or cfg.any_refractive)
                 and cfg.recurse_depth > 0)

    def run(r, st, spawn):
        if on_round is not None:
            on_round(r, st)
        return process_round(scene, geom, cast_fn, cfg, st, spawn, band_tbl,
                             pixel_angle)

    acc, children = run(0, primary_wave(ray_o, ray_d), can_spawn)
    dropped = torch.zeros((), dtype=torch.int32, device=ray_o.device)
    if not can_spawn:
        return acc, dropped

    # the child queue: whole tiles (child_tile_cap), aligned slots (one
    # child type), or single slots (both types, C = R * queue_factor)
    tiles = cfg.child_tile_cap > 0.0 and R % TILE_LANES == 0
    aligned = (cfg.any_reflective != cfg.any_refractive) and not tiles
    if tiles:
        t0 = R // TILE_LANES
        n_parts = int(bool(cfg.any_reflective)) + int(bool(cfg.any_refractive))
        n_tiles = min(max(1, int(-(-t0 * cfg.child_tile_cap // 1))),
                      n_parts * t0)
    C = int(R * cfg.queue_factor)

    def advance(children):
        if aligned:
            return children.with_parked_dirs(), None
        if tiles:
            return compact_tiles(children, n_tiles)
        return compact(children, C)

    with span("rt.queue"):
        st, dn = advance(children)
        if dn is not None:
            dropped = dropped + dn
    for r in range(1, cfg.recurse_depth + 1):
        # early_exit: one host read a round, the JAX package's while_loop
        if cfg.early_exit:
            with span("rt.sync"):
                live = bool(st.active.any())
            if not live:
                break
        spawn = r < cfg.recurse_depth  # the last round spawns none
        contrib, children = run(r, st, spawn)
        with span("rt.queue"):
            if aligned:
                acc = acc + contrib
            elif tiles:
                acc = tile_scatter_add(acc, st.pixel, contrib)
            else:
                acc = acc.index_add(0, st.pixel, contrib)
            if spawn:
                st, dn = advance(children)
                if dn is not None:
                    dropped = dropped + dn
    return acc, dropped


def _radiance_tile_compacted(scene, geom, cast_fn, cfg, ray_o, ray_d,
                             n_tiles, pixel_angle, on_round=None):
    """The wavefront on the first ``n_tiles`` 1024-ray tiles that hold a
    primary hit (found by a detached pre-cast); hits in the other tiles are
    counted in ``dropped``, and their pixels stay 0."""
    R = ray_o.shape[0]
    T = R // TILE_LANES
    with torch.no_grad():
        pre = cast_fn(ray_o.detach(), ray_d.detach())
    tile_hits = pre.valid.reshape(T, TILE_LANES).sum(-1)
    keep_t = torch.sort(torch.argsort((tile_hits == 0).to(torch.uint8),
                                      stable=True)[:n_tiles]).values
    dropped_hits = tile_hits.sum() - tile_hits[keep_t].sum()

    def take(x):
        return x.reshape(T, TILE_LANES, 3)[keep_t].reshape(-1, 3)

    acc_c, dropped = _radiance_dense(scene, geom, cast_fn, cfg, take(ray_o),
                                     take(ray_d), pixel_angle, on_round)
    acc = acc_c.new_zeros(T, TILE_LANES, 4).index_copy(
        0, keep_t, acc_c.reshape(-1, TILE_LANES, 4)).reshape(R, 4)
    return acc, dropped + dropped_hits.to(torch.int32)


def radiance(scene: Scene, geom: WorldGeometry, cast_fn: Cast,
             cfg: RenderConfig, ray_o, ray_d, pixel_angle=None,
             on_round: Optional[RoundHook] = None):
    """Accumulated RGBA radiance ``[R, 4]`` of flat primary rays ``[R, 3]``
    and the count of dropped children (and, under ``wavefront_tile_cap``,
    of primary hits in tiles beyond the cap).  ``wavefront_tile_cap`` > 0
    runs the rounds on ``ceil(T * cap)`` tiles when that is fewer than all
    ``T``."""
    cap = cfg.wavefront_tile_cap
    if cap > 0.0 and ray_o.shape[0] % TILE_LANES == 0:
        T = ray_o.shape[0] // TILE_LANES
        n_tiles = max(1, int(-(-T * cap // 1)))  # ceil(T * cap)
        if n_tiles < T:
            return _radiance_tile_compacted(scene, geom, cast_fn, cfg, ray_o,
                                            ray_d, n_tiles, pixel_angle,
                                            on_round)
    return _radiance_dense(scene, geom, cast_fn, cfg, ray_o, ray_d,
                           pixel_angle, on_round)


def render_rays_stats(scene: Scene, geom: WorldGeometry, cast_fn: Cast,
                      cfg: RenderConfig, ray_o, ray_d, pixel_angle=None):
    """Radiance of a ray batch, clamped to <= 1 like the canvas write.
    Returns ``(img, dropped)``: a nonzero ``dropped`` means a queue or tile
    cap deleted radiance."""
    acc, dropped = radiance(scene, geom, cast_fn, cfg, ray_o.reshape(-1, 3),
                            ray_d.reshape(-1, 3), pixel_angle)
    return clamp_frame(acc).reshape(ray_o.shape[:-1] + (4,)), dropped


def render_rays(scene: Scene, geom: WorldGeometry, cast_fn: Cast,
                cfg: RenderConfig, ray_o, ray_d, pixel_angle=None):
    """:func:`render_rays_stats` without the drop count (the JAX
    package's ``render_rays``): the row blocks of the sharded renders
    (``dist.py``) go through it."""
    img, _ = render_rays_stats(scene, geom, cast_fn, cfg, ray_o, ray_d,
                               pixel_angle)
    return img


def clamp_frame(acc):
    """``min(acc, 1)``, the canvas write's clamp.  ``torch.minimum``, not
    ``clamp``: at ``acc == 1`` it passes half the gradient, as
    ``jnp.minimum`` does (``clamp`` passes all of it)."""
    return torch.minimum(acc, acc.new_ones(()))


def prepare_cast(scene: Scene, geom: WorldGeometry, cfg: RenderConfig):
    """The cast's tables (``raytracer_tpu/render/engine.py``
    ``prepare_cast``), built once a frame under ``no_grad`` and shared by
    its spp samples: ``mxu.prepare_mxu_cast`` for ``pallas_kernel="mxu"``,
    else ``cuda_engine.prepare_cast`` (the walk's LBVH or the cull's
    tables)."""
    if cfg.pallas_kernel == "mxu":
        return prepare_mxu_cast(scene, geom, cfg)
    if cfg.pallas_kernel != "scalar":
        raise ValueError(f"unknown pallas_kernel {cfg.pallas_kernel!r} "
                         "(expected 'scalar' or 'mxu')")
    return cuda_engine.prepare_cast(scene, geom, cfg)


# What scene prep reads: every Scene leaf that expand_geometry and the table
# builds touch, and the cfg fields that choose the tables.  Materials,
# lights, ambience and the camera are not among them.
_PREP_LEAVES = ("verts", "norms", "tri_v", "tri_mat", "tri_coord_degenerate",
                "mesh_pos", "mesh_rot", "mesh_tri_start", "mesh_tri_count",
                "inst_pos", "inst_rot", "inst_mesh", "wtri_inst", "wtri_tri")
_PREP_CFG = ("pallas_kernel", "pallas_traversal", "edge_aware_grads",
             "texture_mapping", "max_tris_per_mesh")


@dataclass
class _PrepEntry:
    refs: list  # weak references to the _PREP_LEAVES tensors
    versions: list  # their _version at the build
    opts: tuple  # the _PREP_CFG values
    geom: WorldGeometry
    aux: object


_prep_entry: Optional[_PrepEntry] = None


def prepared(scene: Scene, cfg: RenderConfig):
    """Scene prep, ``(geom, aux)``: :func:`expand_geometry` and
    :func:`prepare_cast`, in one ``rt.prep`` span, kept across calls on one
    geometry.  A call whose geometry leaves are the same tensors at the
    same ``_version`` (so no in-place edit since) and whose table options
    are equal gets the kept pair back and launches nothing; any other call
    builds anew and keeps that build in place of the last (one entry).
    When a geometry leaf requires grad, the build runs every call and is
    not kept: the reparam rule's graph and ``expand_geometry``'s must run
    through ``geom``.  Nothing writes into a kept ``geom`` or ``aux``.  An
    edit that bypasses the version counter (through ``.data`` or a numpy
    view) is not seen: rebuild the leaf, or :func:`clear_prepared`.
    ``prepared.hits`` and ``prepared.builds`` count the calls of each
    kind."""
    global _prep_entry
    with span("rt.prep"):
        leaves = [getattr(scene, k) for k in _PREP_LEAVES]
        keep = not any(x.requires_grad for x in leaves)
        if keep:
            versions = [x._version for x in leaves]
            opts = tuple(getattr(cfg, k) for k in _PREP_CFG)
            e = _prep_entry
            if (e is not None and e.opts == opts and e.versions == versions
                    and all(r() is x for r, x in zip(e.refs, leaves))):
                prepared.hits += 1
                return e.geom, e.aux
            # dropped before the build, so that two builds are never held
            _prep_entry = None
        prepared.builds += 1
        geom = expand_geometry(scene)
        aux = prepare_cast(scene, geom, cfg)
        if keep:
            _prep_entry = _PrepEntry([weakref.ref(x) for x in leaves],
                                     versions, opts, geom, aux)
        return geom, aux


prepared.hits = 0  # calls answered by the kept entry
prepared.builds = 0  # calls that built (misses and grad-carrying geometry)


def clear_prepared() -> None:
    """Drop :func:`prepared`'s kept entry (its counters stay)."""
    global _prep_entry
    _prep_entry = None


def make_cast(scene: Scene, geom: WorldGeometry, cfg: RenderConfig,
              aux=None) -> Cast:
    """The engine's :class:`Cast` (``raytracer_tpu/render/engine.py``
    ``make_cast``) over the tables ``aux`` of :func:`prepare_cast` (built
    here when None), and the one place that picks each query's kernel:
    the MXU cast (K6) for ``pallas_kernel="mxu"``, else the LBVH walk
    (K1-K3, the march) or, by ``pallas_traversal``, the cull (K4/K5),
    each through the ``"cuda"`` kernels or the ``"torch"`` plain versions
    (``cfg.engine``).  Under ``edge_aware_grads`` the closest hit takes the
    reparam rule over the packed rows of ``geom``.  Each query but
    ``march`` (in the caller's ``rt.march``) runs in an ``rt.cast`` span."""
    if cfg.engine not in ("cuda", "torch"):
        raise ValueError(f"unknown engine {cfg.engine!r} "
                         "(expected 'torch' or 'cuda')")
    if aux is None:
        aux = prepare_cast(scene, geom, cfg)
    geo = pack_reparam_geo(geom) if cfg.edge_aware_grads else None
    if cfg.pallas_kernel == "mxu":
        make = make_mxu_cast
    elif _use_walk(cfg, scene.inst_pos.shape[0]):
        make = make_cuda_cast
    else:
        make = make_cull_cast
    cast = make(aux, cfg, geo, plain=cfg.engine == "torch")
    return dataclasses.replace(
        cast, closest=_in_cast_span(cast.closest),
        occlude=_in_cast_span(cast.occlude),
        occlude2=_in_cast_span(cast.occlude2),
        visit_counts=_in_cast_span(cast.visit_counts))


def _in_cast_span(fn):
    if fn is None:
        return None

    def run(*args):
        with span("rt.cast"):
            return fn(*args)

    return run


def _to_blocks(x, hp, wp):
    """[Hp, Wp, ...] -> block-major [Hp*Wp, ...]."""
    lead = x.shape[2:]
    x = x.reshape(hp // BLOCK, BLOCK, wp // BLOCK, BLOCK, *lead)
    return x.transpose(1, 2).reshape(hp * wp, *lead)


def _from_blocks(x, hp, wp):
    lead = x.shape[1:]
    x = x.reshape(hp // BLOCK, wp // BLOCK, BLOCK, BLOCK, *lead)
    return x.transpose(1, 2).reshape(hp, wp, *lead)


def _frame_rays_blocked(camera: Camera, cfg: RenderConfig, jitter=None):
    """Full-frame camera rays in block-major [R, 3] layout (padded);
    ``jitter`` as ``camera_rays``'."""
    ray_o, ray_d = camera_rays(camera, cfg.width, cfg.height, jitter=jitter)
    hp = (cfg.height + BLOCK - 1) // BLOCK * BLOCK
    wp = (cfg.width + BLOCK - 1) // BLOCK * BLOCK
    pad = (0, 0, 0, wp - cfg.width, 0, hp - cfg.height)
    ray_o = torch.nn.functional.pad(ray_o, pad)
    ray_d = torch.nn.functional.pad(ray_d, pad)
    if hp != cfg.height or wp != cfg.width:
        dev = ray_d.device
        yy = torch.arange(hp, device=dev)[:, None]
        xx = torch.arange(wp, device=dev)[None, :]
        pad_mask = (yy >= cfg.height) | (xx >= cfg.width)
        ray_d = torch.where(pad_mask[..., None],
                            torch.tensor([0.0, 0.0, 1.0], device=dev), ray_d)
    return _to_blocks(ray_o, hp, wp), _to_blocks(ray_d, hp, wp), hp, wp


def spp_jitter_grid(spp: int, width: int, height: int, device=None):
    """The sub-pixel sample pattern of an spp frame (``engine.
    spp_jitter_grid``): ``(offs [spp, 2], shift [H, W, 2])``, the R2
    low-discrepancy offsets of the samples and a per-pixel toroidal shift
    that decorrelates them across pixels.  Sample ``s`` jitters by ``(offs[s]
    + shift) % 1``.  FP32 in the JAX package's order of operations (its
    Python-float constants round to FP32 before each product, as torch's
    scalars do)."""
    g = 1.32471795724474602596  # the plastic constant
    a1, a2 = 1.0 / g, 1.0 / (g * g)
    s = torch.arange(spp, dtype=torch.float32, device=device)
    offs = torch.stack([(0.5 + a1 * s) % 1.0, (0.5 + a2 * s) % 1.0], -1)
    xx = torch.arange(width, dtype=torch.float32, device=device)[None, :]
    yy = torch.arange(height, dtype=torch.float32, device=device)[:, None]
    shift = torch.stack(
        [((a1 * xx + a2 * yy) % 1.0).expand(height, width),
         ((a2 * xx + a1 * yy) % 1.0).expand(height, width)], -1)
    return offs, shift


def _render_one_stats(scene: Scene, geom: WorldGeometry, cast_fn: Cast,
                      camera: Camera, cfg: RenderConfig, jitter, lane=None):
    """One sample frame ``[H, W, 4]`` and its drop count.  ``jitter``
    ``[H, W, 2]`` or None (the pixel corners); ``lane`` (the kept tiles of
    :func:`_static_tile_lanes`, sorted) renders only those 1024-ray tiles
    of the block-major rays and scatters them back into a zero frame (the
    other tiles hold no hit), the gradient flowing to the kept tiles."""
    ro_b, rd_b, hp, wp = _frame_rays_blocked(camera, cfg, jitter)
    # the angular size of a pixel at the image centre (camera.cu:33-42)
    pixel_angle = None
    if cfg.edge_aware_grads:
        pixel_angle = (1.0 / (camera.unit_to_pixels
                              * camera.global_near)).detach()
    if lane is None:
        img_b, dropped = render_rays_stats(scene, geom, cast_fn, cfg, ro_b,
                                           rd_b, pixel_angle)
    else:
        T = ro_b.shape[0] // TILE_LANES

        def take(x):
            return x.reshape(T, TILE_LANES, 3)[lane].reshape(-1, 3)

        img_c, dropped = render_rays_stats(scene, geom, cast_fn, cfg,
                                           take(ro_b), take(rd_b),
                                           pixel_angle)
        img_b = img_c.new_zeros(T, TILE_LANES, 4).index_copy(
            0, lane, img_c.reshape(-1, TILE_LANES, 4)).reshape(-1, 4)
    img = _from_blocks(img_b, hp, wp)
    return img[: cfg.height, : cfg.width], dropped


def _sample_frame(scene, geom, aux, camera, cfg: RenderConfig, off, shift,
                  lane=None):
    """One jittered sample frame over the frame's tables ``aux``.  Under a
    kept-tile ``lane`` the wavefront and child caps are off: they would
    apply their full-frame share to the already compacted queue."""
    if lane is not None:
        cfg = cfg.replace(wavefront_tile_cap=0.0, child_tile_cap=0.0)
    cast_fn = make_cast(scene, geom, cfg, aux=aux)
    return _render_one_stats(scene, geom, cast_fn, camera, cfg,
                             (off + shift) % 1.0, lane=lane)


def sum_samples(sample, offs, remat: bool = True):
    """The SUM over the offsets ``offs [k, 2]`` of ``sample(off) -> (img,
    dropped)``, frames and drop counts.  ``remat=True`` runs each sample
    under ``torch.utils.checkpoint`` (non-reentrant): reverse mode
    recomputes a sample instead of keeping its intermediates, and the
    recompute replays the sample's shadow masks from its tape
    (``shading.mask_tape_contexts``) instead of querying again.  Without
    grad mode (a frame to view, the first pass of a chunked step) nothing
    is recomputed: no checkpoint.  The sweep of :func:`_scan_samples` and
    of the sharded row blocks (``dist.py``)."""
    acc = drops = 0
    for off in offs:
        if remat and torch.is_grad_enabled():
            img, d = torch.utils.checkpoint.checkpoint(
                sample, off, use_reentrant=False, preserve_rng_state=False,
                context_fn=mask_tape_contexts)
        else:
            img, d = sample(off)
        acc = acc + img
        drops = drops + d
    return acc, drops


def _scan_samples(scene, geom, aux, camera, cfg: RenderConfig, offs, shift,
                  remat: bool = True, lane=None):
    """The SUM of the sample frames at the offsets ``offs [k, 2]`` and the
    summed drop count (:func:`sum_samples` of :func:`_sample_frame`)."""

    def sample(off):
        return _sample_frame(scene, geom, aux, camera, cfg, off, shift,
                             lane=lane)

    return sum_samples(sample, offs, remat)


def _spp_lane(scene, geom, aux, camera, cfg: RenderConfig):
    """The spp sweep's kept tiles and probe drops, ``(None, 0)`` without
    ``static_tile_cap``."""
    if cfg.static_tile_cap <= 0.0:
        return None, torch.zeros((), dtype=torch.int32,
                                 device=camera.pos.device)
    return _static_tile_lanes(make_cast(scene, geom, cfg, aux=aux), camera,
                              cfg)


def render_frame_with_stats(scene: Scene, camera: Camera, cfg: RenderConfig):
    """Like ``render_frame``, also returning ``{"dropped": i32}``: the
    children and primary hits that a queue or tile cap deleted, over every
    sample, the kept-tile probe's once a sample (0 unless a cap is too
    small; raise it, or take ``auto_tile_caps``).  The frame is one
    ``rt.frame`` span, its scene prep (world geometry, the cast's tables)
    one ``rt.prep`` span in it."""
    with span("rt.frame"):
        geom, aux = prepared(scene, cfg)
        if cfg.spp > 1:
            # the mean of spp jittered samples; spp = 1 renders the pixel
            # corners, as the reference does
            offs, shift = spp_jitter_grid(cfg.spp, cfg.width, cfg.height,
                                          camera.pos.device)
            lane, probe_drops = _spp_lane(scene, geom, aux, camera, cfg)
            acc, drops = _scan_samples(scene, geom, aux, camera, cfg, offs,
                                       shift, lane=lane)
            return acc / cfg.spp, {"dropped": drops + cfg.spp * probe_drops}
        img, dropped = _render_one_stats(
            scene, geom, make_cast(scene, geom, cfg, aux=aux), camera, cfg,
            None)
        return img, {"dropped": dropped}


def render_frame(scene: Scene, camera: Camera, cfg: RenderConfig):
    """Render one RGBA float frame [H, W, 4] (each sample clamped to <= 1)
    on the scene's device."""
    img, _ = render_frame_with_stats(scene, camera, cfg)
    return img


def render_frame_sum(scene: Scene, camera: Camera, cfg: RenderConfig, offs,
                     remat: bool = True, with_stats: bool = False):
    """The SUM of the sample frames at the offsets ``offs [k, 2]``
    (``engine.render_frame_sum``), the building block of
    ``diff.make_spp_grad_fn``'s chunks: over chunks of
    ``spp_jitter_grid(n, ...)``'s offsets these sums add up to ``n`` times
    ``render_frame`` at ``spp=n``, since the shift does not depend on spp.
    ``remat=False`` keeps every sample's intermediates (no checkpoint).
    ``with_stats`` also returns ``{"dropped": i32}``, the probe's drops
    counted once a sample."""
    geom, aux = prepared(scene, cfg)
    _, shift = spp_jitter_grid(2, cfg.width, cfg.height, camera.pos.device)
    lane, probe_drops = _spp_lane(scene, geom, aux, camera, cfg)
    acc, drops = _scan_samples(scene, geom, aux, camera, cfg, offs, shift,
                               remat=remat, lane=lane)
    if with_stats:
        return acc, {"dropped": drops + offs.shape[0] * probe_drops}
    return acc


@torch.no_grad()
def _probe_tile_occupancy(cast_fn: Cast, camera: Camera, cfg: RenderConfig,
                          scene: Optional[Scene] = None,
                          geom: Optional[WorldGeometry] = None):
    """Per-tile occupancy of the pixel-centre frame: ``(occ [T], dil [T],
    hits [T], spawn [T] or None)``, the tiles with a hit, their 3x3
    screen-space dilation, the hits per tile and, given ``scene``, the
    tiles with a hit on a reflective or refractive material (the only hits
    that feed the child queues)."""
    ro_b, rd_b, hp, wp = _frame_rays_blocked(
        camera, cfg, torch.full((cfg.height, cfg.width, 2), 0.5,
                                device=camera.pos.device))
    pre = cast_fn(ro_b, rd_b)
    th, tw = hp // BLOCK, wp // BLOCK
    valid = pre.valid.reshape(th * tw, TILE_LANES)
    occ = valid.any(-1)
    hits = valid.sum(-1)
    p = torch.nn.functional.pad(occ.reshape(th, tw), (1, 1, 1, 1))
    dil = torch.zeros_like(occ.reshape(th, tw))
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            dil = dil | p[1 + dy: 1 + dy + th, 1 + dx: 1 + dx + tw]
    spawn = None
    if scene is not None:
        mat = pre.mat
        if mat is None and geom is not None:
            mat = geom.mat[pre.wtri.long()]
        if mat is not None:
            mats = scene.materials
            spawnable = (mats.kr > 0.0).any(-1) | (mats.kt > 0.0).any(-1)
            lane = pre.valid & spawnable[mat.long()]
            spawn = lane.reshape(th * tw, TILE_LANES).any(-1)
    return occ, dil.reshape(-1), hits, spawn


@torch.no_grad()
def auto_tile_caps(scene: Scene, camera: Camera, cfg: RenderConfig,
                   margin: float = 2.0) -> dict:
    """Tile caps from one probe of the pixel-centre frame, as a dict of
    config overrides (the JAX package's ``auto_tile_caps``; a host-level
    helper to call once at setup):

    * ``wavefront_tile_cap``: the share of tiles with a hit times
      ``margin``, 0 (off) at 40% or more;
    * ``child_tile_cap``: the share of tiles with a reflective or
      refractive hit times ``margin``, 0 when the wavefront cap is on (its
      queue already holds only kept tiles) or at 85% or more;
    * ``static_tile_cap``: the dilated share times 1.1, the kept tiles of
      the spp sweep (:func:`_static_tile_lanes`).

    A cap is at least one tile.  Drops that remain are counted by
    ``render_frame_with_stats``."""
    cfg1 = cfg.replace(spp=1, static_tile_cap=0.0, wavefront_tile_cap=0.0,
                       child_tile_cap=0.0)
    geom, aux = prepared(scene, cfg1)
    cast_fn = make_cast(scene, geom, cfg1, aux=aux)
    occ, dil, _, spawn = _probe_tile_occupancy(cast_fn, camera, cfg1,
                                               scene=scene, geom=geom)
    n_occ = int(occ.sum())
    n_dil = int(dil.sum())
    n_spawn = n_occ if spawn is None else int(spawn.sum())
    T = occ.shape[0]

    def cap(frac, off_at=0.85):
        return 0.0 if frac >= off_at else max(frac, 1.0 / T)

    wf = cap(float(n_occ) / T * margin, off_at=0.4)
    child = 0.0 if wf > 0.0 else cap(float(n_spawn) / T * margin)
    return {"wavefront_tile_cap": wf, "child_tile_cap": child,
            "static_tile_cap": cap(float(n_dil) / T * 1.1)}


def auto_static_tile_cap(scene: Scene, camera: Camera,
                         cfg: RenderConfig) -> float:
    """``auto_tile_caps``' ``static_tile_cap`` alone (the JAX package's
    ``margin`` argument, which it ignores, is left out)."""
    return auto_tile_caps(scene, camera, cfg)["static_tile_cap"]


@torch.no_grad()
def _static_tile_lanes(cast_fn: Cast, camera: Camera, cfg: RenderConfig):
    """The kept tiles of the spp sweep from one probe of the pixel-centre
    frame: ``Ct = ceil(T * static_tile_cap)`` tiles (at least 1, at most
    ``T``), tiles with a probe hit first, then their one-ring dilation
    (sub-pixel jitter moves a silhouette far less than a 32-pixel tile),
    by a stable argsort of ``-(2 occ + dil)``.  Returns ``(keep_t [Ct]
    sorted, dropped)``: the probe's hits outside the kept tiles."""
    occ, dil, hits, _ = _probe_tile_occupancy(cast_fn, camera, cfg)
    T = occ.shape[0]
    Ct = min(max(1, int(-(-T * cfg.static_tile_cap // 1))), T)
    prio = occ.to(torch.int32) * 2 + dil.to(torch.int32)
    keep_t = torch.sort(torch.argsort(-prio, stable=True)[:Ct]).values
    kept = torch.zeros(T, dtype=torch.bool, device=occ.device)
    kept[keep_t] = True
    dropped = hits.sum() - torch.where(kept, hits, 0).sum()
    return keep_t, dropped.to(torch.int32)


def frame_to_u8(img: torch.Tensor) -> torch.Tensor:
    """Float RGBA -> RGBA8 by truncation, ``(u8)(255 * c)`` (reference
    rayenv/color.h:38-46)."""
    return (torch.clamp(img, 0.0, 1.0) * 255.0).to(torch.uint8)
