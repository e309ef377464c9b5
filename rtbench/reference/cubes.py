"""The plain reference of a cube world: frames and SGD steps, in torch.

What a frame of the system means, written as directly as it can be: every
ray is tested against every box of the world (the cube meshes are
axis-aligned boxes; a ray that starts inside one leaves through its far
face), the closest hit is shaded with Phong terms under one any-hit shadow
query per light, and mirrors spawn a reflected ray, up to the world's
depth.  A frame is clamped at 1; at ``spp > 1`` it is the mean of the
clamped sample frames through jittered sub-pixel rays (R2 offsets plus a
per-pixel toroidal shift).  No tree, no kernel, no tile: the only
departure from a loop over rays is that the box tests run in blocks of
rays.

The gradient of a frame is exact autodiff of the shading with the hit
identity and the shadow masks held fixed (they are piecewise constant);
the hit distance moves with the ray as the distance to the hit face's
plane, ``t = (plane - o) / d`` on the face's axis, zero where ``|d|`` on
that axis is under 1e-5.

This module imports torch and ``rtbench.world`` only: nothing of the
program.  It runs in float32 with TF32 off, or, as the precision control,
in bfloat16.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from ..world import PARAM_NAMES, World

THRESHOLD = 1e-5
BIG = 3.0e38
PAIRS_PER_BLOCK = 1 << 24  # ray-box pairs of one block of the box tests

Params = Dict[str, torch.Tensor]


def strict_fp32() -> None:
    """No TF32 anywhere (the reference's precision is float32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------- vector math

def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def norm(v):
    s = v[..., 0] * v[..., 0]
    for k in range(1, v.shape[-1]):
        s = s + v[..., k] * v[..., k]
    pos = s > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, s, 1.0)), 0.0)


def normalize(v):
    ln = norm(v)[..., None]
    ok = ln > THRESHOLD
    return torch.where(ok, v / torch.where(ok, ln, 1.0), 0.0)


def relu(x):
    """``max(x, 0)``, half the gradient at a tie."""
    return torch.maximum(x, x.new_zeros(()))


def safe_pow(base, exponent):
    """``base ** exponent`` for base >= 0, with ``0 ** 0 = 1``."""
    pos = base > 0
    val = torch.pow(torch.where(pos, base, 1.0), exponent)
    return torch.where(pos, val, torch.where(exponent == 0.0, 1.0, 0.0).to(
        val.dtype))


def reflect(d, n):
    """The mirror of ``d`` about ``n``, at ``d``'s length."""
    dn, nn = normalize(d), normalize(n)
    r = dn - 2.0 * dot(dn, nn)[..., None] * nn
    return norm(d)[..., None] * normalize(r)


def quat_to_mat(q):
    """Rotation matrix of ``q = [x, y, z, w]``, normalized on the fly."""
    x, y, z, w = (q / norm(q)).unbind(-1)
    xx, yy, zz = 2 * x * x, 2 * y * y, 2 * z * z
    wx, wy, wz = 2 * w * x, 2 * w * y, 2 * w * z
    xy, xz, yz = 2 * x * y, 2 * x * z, 2 * y * z
    return torch.stack([
        torch.stack([1 - (yy + zz), xy - wz, xz + wy]),
        torch.stack([xy + wz, 1 - (xx + zz), yz - wx]),
        torch.stack([xz - wy, yz + wx, 1 - (xx + yy)])])


# --------------------------------------------------------------------- scene

@dataclass
class Scene:
    """The boxes of a world on a device, in the reference's precision."""

    lo: torch.Tensor  # [N, 3]
    hi: torch.Tensor  # [N, 3]
    mat: torch.Tensor  # [N] int64
    ambience: torch.Tensor  # [4]
    dist_atten: torch.Tensor  # [3]
    depth: int
    reflective: bool


def make_scene(world: World, device, dtype=torch.float32) -> Scene:
    if world.any_refractive:
        raise NotImplementedError("the cube reference has no refraction")

    def t(x):
        return torch.as_tensor(np.asarray(x), device=device).to(dtype)

    return Scene(lo=t(world.box_lo), hi=t(world.box_hi),
                 mat=torch.as_tensor(world.box_mat, device=device),
                 ambience=t(world.ambience), dist_atten=t(world.dist_atten),
                 depth=world.depth, reflective=world.any_reflective)


def world_params(world: World, device, dtype=torch.float32) -> Params:
    """The trainable values of a world and its camera, by name."""
    return {k: torch.as_tensor(np.asarray(v), device=device).to(dtype)
            for k, v in world.values().items()}


@dataclass
class View:
    """The fixed part of a camera and the canvas."""

    near: float
    unit_to_pixels: float
    width: int
    height: int


# ---------------------------------------------------------------- box tests

def _slabs(scene: Scene, o, d, lo=None, hi=None):
    """Slab entry/exit times of rays ``[B, 3]`` against every box (or one
    box a ray when ``lo``/``hi`` are ``[B, 3]``).  A ray with an exactly zero
    direction component is parallel to that axis: unconstrained there, but
    its origin has to lie in the slab."""
    every = lo is None
    if every:
        lo, hi = scene.lo[None], scene.hi[None]  # [1, N, 3]
        o, d = o[:, None], d[:, None]  # [B, 1, 3]
    par = d == 0.0
    inv = 1.0 / torch.where(par, 1.0, d)
    tmin = tmax = inside = tns = tfs = None
    tns, tfs = [], []
    for k in range(3):
        t1 = (lo[..., k] - o[..., k]) * inv[..., k]
        t2 = (hi[..., k] - o[..., k]) * inv[..., k]
        p = par[..., k]
        tn = torch.where(p, -BIG, torch.minimum(t1, t2))
        tf = torch.where(p, BIG, torch.maximum(t1, t2))
        ins = ~p | ((o[..., k] >= lo[..., k]) & (o[..., k] <= hi[..., k]))
        tmin = tn if k == 0 else torch.maximum(tmin, tn)
        tmax = tf if k == 0 else torch.minimum(tmax, tf)
        inside = ins if k == 0 else inside & ins
        if not every:
            tns.append(tn)
            tfs.append(tf)
    return tmin, tmax, inside, tns, tfs


def _blocks(scene: Scene, n_rays: int):
    step = max(256, PAIRS_PER_BLOCK // max(1, scene.lo.shape[0]))
    return range(0, n_rays, step), step


@torch.no_grad()
def closest_hit(scene: Scene, o, d):
    """The closest box hit of rays ``[R, 3]``: ``(valid, t, box, axis,
    side_hi)``.  A box is hit at its entry when that is at least 1e-5
    along the ray, else at its exit (the ray starts inside); the face is
    the slab that sets that time (x before y before z at a tie), on its
    high side when the ray leaves through it going up, or enters it going
    down."""
    R = o.shape[0]
    t = torch.empty(R, dtype=o.dtype, device=o.device)
    box = torch.empty(R, dtype=torch.int64, device=o.device)
    starts, step = _blocks(scene, R)
    for s in starts:
        tmin, tmax, inside, _, _ = _slabs(scene, o[s:s + step], d[s:s + step])
        t_hit = torch.where(tmin >= THRESHOLD, tmin, tmax)
        ok = (tmin <= tmax) & inside & (t_hit >= THRESHOLD)
        t[s:s + step], box[s:s + step] = torch.where(
            ok, t_hit, float("inf")).min(dim=1)
    valid = torch.isfinite(t)
    box = torch.where(valid, box, 0)
    tmin, tmax, _, tns, tfs = _slabs(scene, o, d, scene.lo[box],
                                     scene.hi[box])
    entry = tmin >= THRESHOLD
    t_hit = torch.where(entry, tmin, tmax)
    on_x = torch.where(entry, tns[0], tfs[0]) == t_hit
    on_y = ~on_x & (torch.where(entry, tns[1], tfs[1]) == t_hit)
    axis = torch.where(on_x, 0, torch.where(on_y, 1, 2))
    d_axis = d.gather(1, axis[:, None])[:, 0]
    return valid, t, box, axis, (d_axis >= 0.0) ^ entry


@torch.no_grad()
def occluded(scene: Scene, o, d, max_t):
    """Any-hit queries: blocked iff some box is hit at a time in
    ``[1e-5, max_t]`` (``max_t`` a tensor ``[R]`` or a float)."""
    R = o.shape[0]
    out = torch.empty(R, dtype=torch.bool, device=o.device)
    mt = torch.as_tensor(max_t, dtype=o.dtype, device=o.device).expand(R)
    starts, step = _blocks(scene, R)
    for s in starts:
        m = mt[s:s + step, None]
        tmin, tmax, inside, _, _ = _slabs(scene, o[s:s + step], d[s:s + step])
        t_hit = torch.where(tmin >= THRESHOLD, tmin, tmax)
        out[s:s + step] = ((tmin <= tmax) & (tmax >= THRESHOLD) & (tmin <= m)
                           & inside & (t_hit >= THRESHOLD)
                           & (t_hit <= m)).any(dim=1)
    return out


# ------------------------------------------------------------------- shading

def _phong(P: Params, mat, incoming, ray_d, to_light, normal):
    kd = P["materials.kd"][mat]
    ks = P["materials.ks"][mat]
    alpha = P["materials.alpha"][mat]
    diffuse = relu(dot(to_light, normal))[:, None] * kd
    reflect_dot = dot(-reflect(-to_light, normal), ray_d)
    spec = safe_pow(relu(reflect_dot), alpha)[:, None] * ks
    return (diffuse + spec) * incoming


def _attenuation(scene: Scene, dist):
    c, lin, q = scene.dist_atten.unbind(0)
    quad = c + lin * dist + q * dist * dist
    return torch.where(quad < 1.0, 1.0,
                       1.0 / torch.maximum(quad, quad.new_ones(())))


def shade(scene: Scene, P: Params, o, d, t, normal, mat):
    """Emission, ambient, and each light's Phong term under its shadow
    query, at the hits ``o + t d``."""
    hit = o + t[:, None] * d
    col = P["materials.ke"][mat] + P["materials.ka"][mat] * scene.ambience
    for i in range(P["lights.point_pos"].shape[0]):
        disp = P["lights.point_pos"][i] - hit
        dist = norm(disp)
        to_light = normalize(disp)
        blocked = occluded(scene, (hit + THRESHOLD * to_light).detach(),
                           to_light.detach(), dist.detach())
        lit = torch.where(blocked[:, None], 0.0, P["lights.point_col"][i])
        incoming = _attenuation(scene, dist)[:, None] * lit
        col = col + _phong(P, mat, incoming, d, to_light, normal)
    for i in range(P["lights.dir_dir"].shape[0]):
        to_light = -P["lights.dir_dir"][i]
        unit = normalize(to_light).expand(hit.shape)
        blocked = occluded(scene, (hit + THRESHOLD * unit).detach(),
                           unit.detach(), float("inf"))
        incoming = torch.where(blocked[:, None], 0.0, P["lights.dir_col"][i])
        col = col + _phong(P, mat, incoming, d, to_light, normal)
    return col


def radiance(scene: Scene, P: Params, o, d):
    """Clamped RGBA ``[R, 4]`` of primary rays: the hit's shading, plus, up
    to the world's depth, its mirror's, weighted by the product of ``Kr``
    along the path."""
    R = o.shape[0]
    acc = o.new_zeros(R, 4)
    pix = torch.arange(R, device=o.device)
    atten = o.new_ones(R, 4)
    for rnd in range(scene.depth + 1 if scene.reflective else 1):
        valid, t_val, box, axis, side = closest_hit(scene, o.detach(),
                                                    d.detach())
        keep = valid.nonzero()[:, 0]
        o, d, atten, pix = o[keep], d[keep], atten[keep], pix[keep]
        t_val, box, axis, side = t_val[keep], box[keep], axis[keep], side[keep]
        # value: the slab time; gradient: the face plane's
        plane = torch.where(side[:, None], scene.hi[box], scene.lo[box]).gather(
            1, axis[:, None])[:, 0]
        o_ax = o.gather(1, axis[:, None])[:, 0]
        d_ax = d.gather(1, axis[:, None])[:, 0]
        ok = torch.abs(d_ax) >= 1e-5
        t_pl = (plane - o_ax) / torch.where(ok, d_ax, 1.0)
        t = t_val + torch.where(ok, t_pl - t_pl.detach(), 0.0)
        normal = torch.nn.functional.one_hot(axis, 3).to(o.dtype) * \
            torch.where(side, 1.0, -1.0).to(o.dtype)[:, None]
        mat = scene.mat[box]
        acc = acc.index_add(0, pix, atten * shade(scene, P, o, d, t, normal,
                                                  mat))
        if rnd == scene.depth:
            break
        kr = P["materials.kr"][mat]
        spawn = (kr > 0.0).any(-1).nonzero()[:, 0]
        if spawn.numel() == 0:
            break
        o = (o + t[:, None] * d)[spawn]
        d = normalize(reflect(d, normal))[spawn]
        atten = (atten * kr)[spawn]
        pix = pix[spawn]
    return torch.minimum(acc, acc.new_ones(()))


# --------------------------------------------------------------------- rays

def spp_jitter(spp: int, width: int, height: int, device, dtype):
    """The sub-pixel offsets of an spp frame: ``(offs [spp, 2], shift [H,
    W, 2])``; sample ``s`` moves each ray by ``(offs[s] + shift) % 1``."""
    g = 1.32471795724474602596  # the plastic constant
    a1, a2 = 1.0 / g, 1.0 / (g * g)
    s = torch.arange(spp, dtype=dtype, device=device)
    offs = torch.stack([(0.5 + a1 * s) % 1.0, (0.5 + a2 * s) % 1.0], -1)
    xx = torch.arange(width, dtype=dtype, device=device)[None, :]
    yy = torch.arange(height, dtype=dtype, device=device)[:, None]
    shift = torch.stack([((a1 * xx + a2 * yy) % 1.0).expand(height, width),
                         ((a2 * xx + a1 * yy) % 1.0).expand(height, width)],
                        -1)
    return offs, shift


def camera_rays(P: Params, view: View, px, jitter=None):
    """Rays through the pixels ``px`` (flat ``y * W + x``) at their corner,
    or moved by ``jitter [len(px), 2]``."""
    dt = P["cam_pos"].dtype
    m = quat_to_mat(P["cam_rot"])
    r, u, f = normalize(m[:, 0]), normalize(m[:, 1]), normalize(m[:, 2])
    xs = (px % view.width).to(dt)
    ys = torch.div(px, view.width, rounding_mode="floor").to(dt)
    u2p = torch.as_tensor(view.unit_to_pixels, dtype=dt, device=px.device)
    near = torch.as_tensor(view.near, dtype=dt, device=px.device)
    if jitter is None:
        gx = (xs - 0.5 * view.width) / u2p
        gy = (0.5 * view.height - ys) / u2p
    else:
        gx = (xs + jitter[:, 0] - 0.5 * view.width) / u2p
        gy = (0.5 * view.height - (ys + jitter[:, 1])) / u2p
    d = normalize(near * f + gx[:, None] * r + gy[:, None] * u)
    return P["cam_pos"].expand(d.shape), d


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


def to_u8(img):
    """RGBA8 by truncation, as a viewer shows it."""
    return (torch.clamp(img, 0.0, 1.0) * 255.0).to(torch.uint8)


# ------------------------------------------------------------------ training

def train(scene: Scene, view: View, spp: int, target, p0: Params, lr: float,
          steps: int, rows: Optional[int] = None, grad_scale: float = 1.0):
    """``steps`` SGD steps on the mean squared error to ``target`` from
    ``p0``.  Returns ``(losses [steps], params [steps + 1])`` as float64
    numpy values (params by name).  ``rows`` and ``grad_scale`` plant the
    check's faults in the reference's place: the loss over the first
    ``rows`` rows only (half of the batch left out), the gradient scaled
    (an answer altered where it is produced)."""
    cur = {k: v.detach().clone() for k, v in p0.items()}
    losses: List[float] = []
    history = [{k: v.double().cpu().numpy() for k, v in cur.items()}]
    for _ in range(steps):
        P = {k: v.detach().requires_grad_(True) for k, v in cur.items()}
        img = render_frame(scene, P, view, spp)
        loss = torch.mean((img[:rows] - target[:rows]) ** 2)
        grads = torch.autograd.grad(loss, [P[k] for k in PARAM_NAMES],
                                    allow_unused=True)
        losses.append(float(loss.detach()))
        with torch.no_grad():
            cur = {k: (P[k] - lr * grad_scale * g if g is not None
                       else P[k]).detach()
                   for k, g in zip(PARAM_NAMES, grads)}
        history.append({k: v.double().cpu().numpy() for k, v in cur.items()})
        del img, loss, grads, P
    return np.asarray(losses), history


def kd_scaled(P: Params, factor: float) -> Params:
    out = dict(P)
    out["materials.kd"] = P["materials.kd"] * factor
    return out


def live_rays(scene: Scene, P: Params, view: View, px, jitter=None
              ) -> List[int]:
    """The rays of each round that have something to cast: all primary
    rays, then each round's mirror children."""
    with torch.no_grad():
        o, d = camera_rays(P, view, px, jitter)
        counts = []
        for rnd in range(scene.depth + 1 if scene.reflective else 1):
            counts.append(int(o.shape[0]))
            valid, t, box, axis, side = closest_hit(scene, o, d)
            if rnd == scene.depth:
                break
            spawn = (valid & (P["materials.kr"][scene.mat[box]] > 0.0)
                     .any(-1)).nonzero()[:, 0]
            normal = torch.nn.functional.one_hot(axis, 3).to(o.dtype) * \
                torch.where(side, 1.0, -1.0).to(o.dtype)[:, None]
            o = (o + t[:, None] * d)[spawn]
            d = normalize(reflect(d, normal))[spawn]
            if o.shape[0] == 0:
                break
    return counts

