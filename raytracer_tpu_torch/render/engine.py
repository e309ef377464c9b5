"""Frame assembly: camera rays in 32x32 blocks, one shading round, clamp.

Counterpart of ``raytracer_tpu/render/engine.py`` for opaque worlds:
``render_frame`` -> ``_frame_rays_blocked`` (pad to a multiple of 32, pad
pixels keep origin 0 and dir (0,0,1), reorder into 32x32 screen blocks so
neighbouring rays share a frustum) -> ``render_rays_stats`` -> round 0 of
``_radiance_dense`` -> unblock and crop.  Worlds with a reflective or
refractive material spawn bounce rounds, which are not ported.  Frames are
differentiable: the casts carry their own VJP rules (``cast_vjp.py``);
``edge_aware_grads`` adds the silhouette band's boundary term to the
backward (the reparam cast rule and the visibility hinge) and leaves the
forward frame bit for bit as it is.
"""

from __future__ import annotations

import torch

from .. import raymath as rm
from ..scene import Camera, RenderConfig, Scene
from .cast import CastFn, Hit, hit_shading_attrs
from .cast_vjp import pack_reparam_geo
from .cuda_engine import _use_walk, make_cuda_cast, prepare_cast
from .cull import make_cull_cast
from .geometry import WorldGeometry, camera_rays, expand_geometry
from .mxu import make_mxu_cast, prepare_mxu_cast
from .shading import check_lights, gather_material_rows, illuminate

BLOCK = 32  # screen-space tile edge: one 32x32 block of rays


def check_config(scene: Scene, cfg: RenderConfig) -> None:
    """Raise NotImplementedError, naming the ROADMAP item, for any setting
    the port does not cover yet (never a silent switch of path)."""
    if cfg.any_reflective or cfg.any_refractive:
        raise NotImplementedError(
            "worlds with reflective or refractive materials spawn bounce "
            "rounds, which are not ported (ROADMAP.md Queue 1 items 4-5: "
            "bounce streams, refraction); the loader sets any_reflective/"
            "any_refractive from the materials")
    if cfg.spp > 1:
        raise NotImplementedError(
            "spp > 1 is not ported (ROADMAP.md Queue 1 item 6: spp)")
    if (cfg.wavefront_tile_cap > 0.0 or cfg.child_tile_cap > 0.0
            or cfg.static_tile_cap > 0.0):
        raise NotImplementedError(
            "tile caps are not ported (ROADMAP.md Queue 1 item 4: bounce "
            "streams and tile-compacted queues)")
    if cfg.texture_mapping:
        raise NotImplementedError(
            "texture_mapping is not ported (ROADMAP.md Queue 1 item 9: the "
            "ops surface and atlas sampling)")
    check_lights(scene, cfg)


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


def _radiance_dense(scene: Scene, geom: WorldGeometry, cast_fn: CastFn,
                    cfg: RenderConfig, ray_o, ray_d, pixel_angle=None):
    """Round 0 of the wavefront (primary rays); with no material able to
    spawn children this is the whole of ``_radiance_dense``.  Returns
    ``(acc [R,4], dropped)``.  ``pixel_angle``: the angular size of a
    pixel, which sizes the edge-aware band in screen pixels."""
    check_config(scene, cfg)
    R = ray_o.shape[0]
    active = torch.ones(R, dtype=torch.bool, device=ray_o.device)
    hit = cast_fn(ray_o, ray_d)
    # sanitize miss times (inf) so positions of masked lanes stay finite
    hit = Hit(valid=hit.valid, t=torch.where(hit.valid, hit.t, 1.0),
              wtri=hit.wtri, uv=hit.uv, normal=hit.normal, mat=hit.mat)
    h_valid = active & hit.valid
    normal, mat_idx, _ = hit_shading_attrs(geom, hit)
    rmats = gather_material_rows(scene.materials, mat_idx)
    lum = illuminate(scene, cast_fn, cfg, ray_o, ray_d, hit, normal, rmats,
                     h_valid)
    # the primary round's attenuation and visibility are exactly 1 on hits
    if cfg.edge_aware_grads:
        vis = edge_aware_visibility(cfg, band_table(geom), hit, normal,
                                    ray_d, h_valid, pixel_angle)
        lum = vis[:, None] * lum
    contrib = torch.where(h_valid[:, None], lum, 0.0)
    return contrib, torch.zeros((), dtype=torch.int32, device=ray_o.device)


def render_rays_stats(scene: Scene, geom: WorldGeometry, cast_fn: CastFn,
                      cfg: RenderConfig, ray_o, ray_d, pixel_angle=None):
    """Radiance of a flat ray batch, clamped to <= 1 like the canvas write.
    Returns ``(img, dropped)``; nothing is dropped without tile caps."""
    acc, dropped = _radiance_dense(scene, geom, cast_fn, cfg,
                                   ray_o.reshape(-1, 3), ray_d.reshape(-1, 3),
                                   pixel_angle)
    return clamp_frame(acc).reshape(ray_o.shape[:-1] + (4,)), dropped


def clamp_frame(acc):
    """``min(acc, 1)``, the canvas write's clamp.  ``torch.minimum``, not
    ``clamp``: at ``acc == 1`` it passes half the gradient, as
    ``jnp.minimum`` does (``clamp`` passes all of it)."""
    return torch.minimum(acc, acc.new_ones(()))


def make_cast(scene: Scene, geom: WorldGeometry, cfg: RenderConfig) -> CastFn:
    """The engine's cast (``raytracer_tpu/render/engine.py`` ``make_cast``
    and ``prepare_cast``) for ``cfg.engine`` (``"cuda"`` kernels or the
    ``"torch"`` plain versions): ``pallas_kernel="mxu"`` takes the MXU cast
    (K6; no shadow queries), ``"scalar"`` the LBVH walk (K1-K3) or, by
    ``pallas_traversal``, the candidate-list cull (K4/K5).  Under
    ``edge_aware_grads`` the closest-hit cast takes the reparam rule over
    the packed rows of ``geom`` (its graph reaches ``scene.verts``); the
    kernels' tables stay out of every graph."""
    geo = pack_reparam_geo(geom) if cfg.edge_aware_grads else None
    if cfg.pallas_kernel == "mxu":
        return make_mxu_cast(prepare_mxu_cast(scene, geom, cfg), cfg, geo)
    if cfg.pallas_kernel != "scalar":
        raise ValueError(f"unknown pallas_kernel {cfg.pallas_kernel!r} "
                         "(expected 'scalar' or 'mxu')")
    data = prepare_cast(scene, geom, cfg)
    if _use_walk(cfg, scene.inst_pos.shape[0]):
        return make_cuda_cast(data, cfg, geo)
    return make_cull_cast(data, cfg, geo)


def _to_blocks(x, hp, wp):
    """[Hp, Wp, ...] -> block-major [Hp*Wp, ...]."""
    lead = x.shape[2:]
    x = x.reshape(hp // BLOCK, BLOCK, wp // BLOCK, BLOCK, *lead)
    return x.transpose(1, 2).reshape(hp * wp, *lead)


def _from_blocks(x, hp, wp):
    lead = x.shape[1:]
    x = x.reshape(hp // BLOCK, wp // BLOCK, BLOCK, BLOCK, *lead)
    return x.transpose(1, 2).reshape(hp, wp, *lead)


def _frame_rays_blocked(camera: Camera, cfg: RenderConfig):
    """Full-frame camera rays in block-major [R, 3] layout (padded)."""
    ray_o, ray_d = camera_rays(camera, cfg.width, cfg.height)
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


def render_frame_with_stats(scene: Scene, camera: Camera, cfg: RenderConfig):
    """Like ``render_frame``, also returning ``{"dropped": i32}``."""
    geom = expand_geometry(scene)
    cast_fn = make_cast(scene, geom, cfg)
    ro_b, rd_b, hp, wp = _frame_rays_blocked(camera, cfg)
    # the angular size of a pixel at the image centre (_render_one_stats)
    pixel_angle = None
    if cfg.edge_aware_grads:
        pixel_angle = (1.0 / (camera.unit_to_pixels
                              * camera.global_near)).detach()
    img_b, dropped = render_rays_stats(scene, geom, cast_fn, cfg, ro_b, rd_b,
                                       pixel_angle)
    img = _from_blocks(img_b, hp, wp)
    return img[: cfg.height, : cfg.width], {"dropped": dropped}


def render_frame(scene: Scene, camera: Camera, cfg: RenderConfig):
    """Render one RGBA float frame [H, W, 4] (clamped to <= 1) on the
    scene's device."""
    img, _ = render_frame_with_stats(scene, camera, cfg)
    return img


def frame_to_u8(img: torch.Tensor) -> torch.Tensor:
    """Float RGBA -> RGBA8 by truncation, ``(u8)(255 * c)`` (reference
    rayenv/color.h:38-46)."""
    return (torch.clamp(img, 0.0, 1.0) * 255.0).to(torch.uint8)
