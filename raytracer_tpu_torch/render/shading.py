"""Phong shading with the fused two-light shadow query.

Counterpart of ``raytracer_tpu/render/shading.py`` for opaque worlds with one
point and one directional light: ``illuminate = Ke + Ka*ambience + sum over
lights of phong(...)``, each light's shadow decided by one any-hit query, both
queries answered by one fused walk (K2).  The transmissive shadow march and
the per-light path are not ported.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import raymath as rm
from ..scene import Materials, RenderConfig, Scene
from .cast import CastFn, Hit


def gather_material_rows(mats: Materials, mat_idx: torch.Tensor) -> Materials:
    """Per-ray material rows by exact index gather (the JAX package's one-hot
    matmul at HIGHEST precision selects the same f32 values)."""
    idx = mat_idx.long()
    return dataclasses.replace(
        mats, ke=mats.ke[idx], ka=mats.ka[idx], kd=mats.kd[idx],
        ks=mats.ks[idx], kt=mats.kt[idx], kr=mats.kr[idx],
        alpha=mats.alpha[idx], eta=mats.eta[idx])


def distance_attenuation(scene: Scene, dist):
    """``1 / max(1, c + l*d + q*d^2)``, and exactly 1 where the quadratic is
    below 1 (reference light.cu:11-17)."""
    c = scene.dist_atten[0]
    lin = scene.dist_atten[1]
    q = scene.dist_atten[2]
    quad = c + lin * dist + q * dist * dist
    return torch.where(quad < 1.0, 1.0, 1.0 / torch.clamp(quad, min=1.0))


def phong_term(rmats: Materials, incoming, ray_dir, dir_to_light, normal):
    """One light's Phong contribution (reference phong.cu:14-33):
    ``(max(L.N, 0) Kd + max(-reflect(-L, N).V, 0)^alpha Ks) * incoming``,
    with ``0^0 = 1`` for ``alpha = 0``."""
    norm_dot = torch.clamp(rm.dot(dir_to_light, normal), min=0.0)
    diffuse = norm_dot[..., None] * rmats.kd
    reflected = rm.reflect(-dir_to_light, normal)
    reflect_dot = rm.dot(-reflected, ray_dir)
    spec = rm.safe_pow(torch.clamp(reflect_dot, min=0.0),
                       rmats.alpha)[..., None] * rmats.ks
    return (diffuse + spec) * incoming


def check_lights(scene: Scene, cfg: RenderConfig) -> None:
    """The slice shades opaque worlds with exactly 1 point + 1 directional
    light through the fused query; anything else raises."""
    n_point = scene.lights.point_pos.shape[0]
    n_dir = scene.lights.dir_dir.shape[0]
    if n_point != 1 or n_dir != 1 or not cfg.fused_shadows:
        raise NotImplementedError(
            f"{n_point} point + {n_dir} directional lights with "
            f"fused_shadows={cfg.fused_shadows}: only the fused 1 + 1 path "
            "is ported (ROADMAP.md Queue 1 item 2: the per-light shadow "
            "path with K3)")


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


def illuminate(scene: Scene, cast_fn: CastFn, cfg: RenderConfig, ray_o,
               ray_d, hit: Hit, normal, rmats: Materials, active):
    """Local shading at a hit point: the fused branch of the JAX package's
    ``illuminate`` (one dual-query walk answers both shadow rays)."""
    check_lights(scene, cfg)
    hit_pos = ray_o + hit.t[..., None] * ray_d
    col = rmats.ke + rmats.ka * scene.ambience

    o1, dir1, dist, o2, dir2 = shadow_rays(scene, hit_pos, active)
    b1, b2 = cast_fn.occlude2(o1, dir1, dist, o2, dir2, float("inf"))
    b1 = active & b1
    b2 = active & b2
    lcol1 = scene.lights.point_col[0]
    dir_to_light2 = -scene.lights.dir_dir[0]  # raw: Phong takes it unnormalized
    datten = distance_attenuation(scene, dist)
    zero = torch.zeros((), dtype=torch.float32, device=hit_pos.device)
    incoming1 = datten[..., None] * torch.where(b1[..., None], zero, lcol1)
    col = col + phong_term(rmats, incoming1, ray_d, dir1, normal)
    lcol2 = scene.lights.dir_col[0]
    incoming2 = torch.where(b2[..., None], zero, lcol2)
    col = col + phong_term(rmats, incoming2, ray_d, dir_to_light2, normal)
    return col
