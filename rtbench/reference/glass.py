"""The plain reference of a cube world with glass and mirrors: frames, in
torch.

What a frame of such a world means, written as directly as it can be.
Every ray is tested against every box (``cubes.closest_hit``: no tree, no
queue, no kernel).  A ray's radiance is a recursion to the world's
depth: the closest hit is shaded with Phong terms, each light's term
under a shadow ray that marches towards it, and the surface spawns a
reflected child weighted by ``Kr`` where its material reflects, and a
refracted child where its material transmits.  A frame is clamped at 1;
at ``spp > 1`` it is the mean of the clamped jittered sample frames, as
in ``cubes``.

The semantics are the upstream renderer's (``wtzhang23/gpu-ray-tracer``:
``Kt``, ``Kr`` and ``eta`` of ``material.h:104-112``; the refract frame of
``propagate_ray``, ``scene.cu:149-183``; ``trans_atten``,
``scene.cu:14-22``; the shadow march of ``light.cu:30-61``), with the
departures that DEVIATIONS.md lists for the system:

* "Quirks preserved" 2: ``refract`` is the upstream's non-physical form,
  ``cosi = d.n`` with its raw sign in ``ratio d + (ratio cosi -
  sqrt(1 - sint2)) n``; under total internal reflection the refracted
  child is dropped;
* "Quirks preserved" 3: a hit reached inside a medium attenuates by
  ``time^Kt`` (the path length raised to the hit material's ``Kt``),
  where the shadow march attenuates by ``Kt^time``;
* "Bugs fixed" 1: each surface's own material gates its reflected and
  refracted children (the upstream reads a stale hit record);
* "Bugs fixed" 2: the march is bounded at :data:`SHADOW_STEPS` steps
  (the upstream loop is unbounded); a ray still marching after the last
  step reaches the light with what it carries.

A refracted child flips whether its ray travels inside a medium, and
``eta`` is the hit material's: ``n1 / n2`` is ``1 / eta`` entering and
``eta`` leaving (the upstream's single-medium assumption, SURVEY.md).

This module imports torch and ``rtbench`` only: nothing of the program.
It runs in float32 with TF32 off, or, as the precision control, in
bfloat16.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..world import World
from .cubes import (THRESHOLD, Params, Scene, View, _attenuation, _phong,
                    camera_rays, closest_hit, dot, norm, normalize, reflect,
                    relu, safe_pow, spp_jitter, strict_fp32, to_u8,
                    world_params)

__all__ = ["SHADOW_STEPS", "Scene", "View", "make_scene", "world_params",
           "refract", "march", "render_pixels", "render_frame", "to_u8",
           "spp_jitter", "live_rays", "strict_fp32"]

SHADOW_STEPS = 4  # DEVIATIONS.md "Bugs fixed" 2; the loader's default


def make_scene(world: World, device, dtype=torch.float32) -> Scene:
    """``cubes.Scene`` of any world, glass included (the recursion runs to
    the world's depth whatever its materials)."""
    def t(x):
        return torch.as_tensor(np.asarray(x), device=device).to(dtype)

    return Scene(lo=t(world.box_lo), hi=t(world.box_hi),
                 mat=torch.as_tensor(world.box_mat, device=device),
                 ambience=t(world.ambience), dist_atten=t(world.dist_atten),
                 depth=world.depth, reflective=world.any_reflective)


def _hit_normal(d, axis, side):
    """The outward normal of the hit face: ``+-e_axis``."""
    return torch.nn.functional.one_hot(axis, 3).to(d.dtype) * \
        torch.where(side, 1.0, -1.0).to(d.dtype)[:, None]


def refract(d, n, ratio):
    """The upstream's refraction of ``d`` [R, 3] at the normal ``n`` with
    ``ratio = n1 / n2`` [R]: ``(dir, tir)``, ``dir`` at ``d``'s length.
    ``cosi = d.n`` keeps its raw sign (DEVIATIONS.md "Quirks preserved"
    2); ``tir`` where ``ratio^2 (1 - cosi^2) > 1``, and ``dir`` is then the
    mirror direction."""
    length = norm(d)[:, None]
    dn, nn = normalize(d), normalize(n)
    r = ratio[:, None]
    cosi = dot(dn, nn)[:, None]
    sint2 = r * r * (1.0 - cosi * cosi)
    tir = sint2[:, 0] > 1.0
    rest = 1.0 - sint2
    root = torch.where(rest > 0, torch.sqrt(torch.where(rest > 0, rest, 1.0)),
                       0.0)
    out = torch.where(tir[:, None], normalize(dn - 2.0 * cosi * nn),
                      r * dn + (r * cosi - root) * nn)
    return length * out, tir


def march(scene: Scene, P: Params, o, d, max_t, light_col):
    """The light that reaches the points ``o`` [R, 3] from ``light_col``
    along the unit ``d`` within ``max_t`` ([R] or a float): from ``o``
    stepped 1e-5 along ``d``, each step takes the closest hit; a hit
    beyond what remains of ``max_t`` leaves the light as it is, an opaque
    hit blacks it out, and a glass hit lets the ray on from the hit point,
    times ``Kt^t`` where the ray leaves the glass (``n.d > 0``), for at
    most :data:`SHADOW_STEPS` steps."""
    R = o.shape[0]
    rv = light_col.expand(R, 4).clone()
    cur = o + THRESHOLD * d
    remaining = torch.as_tensor(max_t, dtype=o.dtype,
                                device=o.device).expand(R).clone()
    lanes = torch.arange(R, device=o.device)
    for _ in range(SHADOW_STEPS):
        if lanes.numel() == 0:
            break
        dl = d[lanes]
        valid, t, box, axis, side = closest_hit(scene, cur[lanes], dl)
        # a miss and a hit beyond the light both leave the lane lit
        near = valid & (t <= remaining[lanes])
        lanes, t, dl = lanes[near], t[near], dl[near]
        box, axis, side = box[near], axis[near], side[near]
        kt = P["materials.kt"][scene.mat[box]]
        glass = (kt > 0.0).any(-1)
        rv[lanes[~glass]] = 0.0
        lanes, t, dl, kt = lanes[glass], t[glass], dl[glass], kt[glass]
        leaving = dot(_hit_normal(dl, axis[glass], side[glass]), dl) > 0.0
        through = safe_pow(kt, t[:, None])
        rv[lanes] = torch.where(leaving[:, None], rv[lanes] * through,
                                rv[lanes])
        cur[lanes] = cur[lanes] + t[:, None] * dl
        remaining[lanes] = remaining[lanes] - t
    return rv


def shade(scene: Scene, P: Params, o, d, t, normal, mat):
    """Emission, ambient, and each light's Phong term under its march, at
    the hits ``o + t d``."""
    hit = o + t[:, None] * d
    col = P["materials.ke"][mat] + P["materials.ka"][mat] * scene.ambience
    for i in range(P["lights.point_pos"].shape[0]):
        disp = P["lights.point_pos"][i] - hit
        dist = norm(disp)
        to_light = normalize(disp)
        lit = march(scene, P, hit, to_light, dist, P["lights.point_col"][i])
        incoming = _attenuation(scene, dist)[:, None] * lit
        col = col + _phong(P, mat, incoming, d, to_light, normal)
    for i in range(P["lights.dir_dir"].shape[0]):
        to_light = -P["lights.dir_dir"][i]
        unit = normalize(to_light).expand(hit.shape)
        incoming = march(scene, P, hit, unit, float("inf"),
                         P["lights.dir_col"][i])
        col = col + _phong(P, mat, incoming, d, to_light, normal)
    return col


def _children(scene: Scene, P: Params, o, d, atten, inside):
    """One generation of rays ``[R]``: the closest hit of each, and what
    it spawns.  Returns ``(hit lanes, t, normal, mat, weight, kids)``:
    ``weight`` the attenuation at the hit (``time^Kt`` applied inside a
    medium), ``kids`` the reflected then the refracted children as
    ``(which hit lanes spawn, o, d, atten, inside)``."""
    valid, t, box, axis, side = closest_hit(scene, o, d)
    lanes = valid.nonzero()[:, 0]
    o, d, atten, inside = o[lanes], d[lanes], atten[lanes], inside[lanes]
    t, normal = t[lanes], _hit_normal(d, axis[lanes], side[lanes])
    mat = scene.mat[box[lanes]]
    kt = P["materials.kt"][mat]
    # DEVIATIONS.md "Quirks preserved" 3: time^Kt inside a medium
    weight = torch.where(inside[:, None],
                         atten * safe_pow(relu(t)[:, None], kt), atten)
    hit = o + t[:, None] * d
    kr = P["materials.kr"][mat]
    refl = (kr > 0.0).any(-1)
    eta = P["materials.eta"][mat]
    one = torch.ones_like(eta)
    ratio = torch.where(inside, eta, one) / torch.where(inside, one, eta)
    refr_d, tir = refract(d, normal, ratio)
    refr = (kt > 0.0).any(-1) & ~tir
    kids = [(refl, hit[refl], normalize(reflect(d, normal))[refl],
             (weight * kr)[refl], inside[refl]),
            (refr, hit[refr], normalize(refr_d)[refr], weight[refr],
             ~inside[refr])]
    return lanes, t, normal, mat, weight, kids


def _radiance(scene: Scene, P: Params, o, d, atten, inside, pix, acc,
              left: int):
    """``acc`` with the radiance of the rays ``o``, ``d`` [R, 3] added at
    their pixels ``pix``, recursing ``left`` more levels."""
    lanes, t, normal, mat, weight, kids = _children(scene, P, o, d, atten,
                                                    inside)
    if lanes.numel() == 0:
        return acc
    o, d, pix = o[lanes], d[lanes], pix[lanes]
    acc = acc.index_add(0, pix, weight * shade(scene, P, o, d, t, normal,
                                               mat))
    if left == 0:
        return acc
    for spawn, ko, kd, ka, kin in kids:
        if ko.shape[0]:
            acc = _radiance(scene, P, ko, kd, ka, kin, pix[spawn], acc,
                            left - 1)
    return acc


@torch.no_grad()
def radiance(scene: Scene, P: Params, o, d):
    """Clamped RGBA ``[R, 4]`` of primary rays ``[R, 3]``."""
    R = o.shape[0]
    acc = _radiance(scene, P, o, d, o.new_ones(R, 4),
                    torch.zeros(R, dtype=torch.bool, device=o.device),
                    torch.arange(R, device=o.device), o.new_zeros(R, 4),
                    scene.depth)
    return torch.minimum(acc, acc.new_ones(()))


def render_pixels(scene: Scene, P: Params, view: View, px, spp: int = 1):
    """The frame's RGBA at the pixels ``px``: one corner ray each at spp 1,
    else the mean of the clamped jittered samples."""
    if spp == 1:
        return radiance(scene, P, *camera_rays(P, view, px))
    offs, shift = spp_jitter(spp, view.width, view.height, px.device,
                             P["cam_pos"].dtype)
    shift = shift.reshape(-1, 2)[px]
    acc = 0
    for s in range(spp):
        acc = acc + radiance(scene, P, *camera_rays(
            P, view, px, (offs[s] + shift) % 1.0))
    return acc / spp


def render_frame(scene: Scene, P: Params, view: View, spp: int = 1):
    px = torch.arange(view.width * view.height, device=scene.lo.device)
    return render_pixels(scene, P, view, px, spp).reshape(
        view.height, view.width, 4)


@torch.no_grad()
def live_rays(scene: Scene, P: Params, view: View, px, jitter=None
              ) -> List[int]:
    """The rays of each round that have something to cast: all primary
    rays, then each round's reflected and refracted children (the march's
    steps are not among them)."""
    o, d = camera_rays(P, view, px, jitter)
    R = o.shape[0]
    atten = o.new_ones(R, 4)
    inside = torch.zeros(R, dtype=torch.bool, device=o.device)
    counts = []
    for rnd in range(scene.depth + 1):
        counts.append(int(o.shape[0]))
        if rnd == scene.depth:
            break
        *_, kids = _children(scene, P, o, d, atten, inside)
        o, d, atten, inside = (torch.cat([k[i] for k in kids])
                               for i in range(1, 5))
        if o.shape[0] == 0:
            break
    return counts
