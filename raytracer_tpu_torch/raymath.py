"""Batched ray-tracing math on torch tensors.

Counterpart of ``raytracer_tpu/raymath.py``, name for name.  Conventions
are the JAX package's: ``THRESHOLD = 1e-5`` is the universal epsilon,
``normalize`` returns the zero vector below it, quaternions are ``[x, y,
z, w]``.

Everything stays exact float32: dot products and rotations are written out
per component (no matmul, so no TF32 and no reduction-order surprises), in
the JAX package's left-to-right order.
"""

from __future__ import annotations

import numpy as np
import torch

THRESHOLD = 1e-5


def dot(a, b, keepdims=False):
    d = a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]
    return d[..., None] if keepdims else d


def norm(v):
    """Euclidean length over the last axis (zero where the length is zero)."""
    s = v[..., 0] * v[..., 0]
    for k in range(1, v.shape[-1]):
        s = s + v[..., k] * v[..., k]
    pos = s > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, s, 1.0)), 0.0)


def safe_sqrt(x):
    """sqrt clamped at 0, with a zero gradient there (not +inf)."""
    pos = x > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


def safe_pow(base, exponent):
    """``base ** exponent`` for base >= 0 with C ``powf``'s values at 0:
    pow(0, 0) == 1, pow(0, e > 0) == 0."""
    pos = base > 0
    val = torch.pow(torch.where(pos, base, 1.0), exponent)
    zero_case = torch.where(exponent == 0.0, 1.0, 0.0)
    return torch.where(pos, val, zero_case)


def normalize(v, eps=THRESHOLD):
    """Zero vector if length <= eps (reference linear.h:160-167)."""
    ln = norm(v)[..., None]
    ok = ln > eps
    return torch.where(ok, v / torch.where(ok, ln, 1.0), 0.0)


def cross(a, b):
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def reflect(d, n):
    """Mirror reflection: normalize inputs, reflect, re-normalize, rescale by
    |d| (reference linear.h:213-223)."""
    d_len = norm(d)[..., None]
    dn = normalize(d)
    nn = normalize(n)
    r = dn - 2.0 * dot(dn, nn, keepdims=True) * nn
    return d_len * normalize(r)


def refract(d, n, n1, n2):
    """Snell refraction (reference linear.h:225-242).  Returns ``(dir,
    tir)``: ``tir`` flags total internal reflection, where ``dir`` is the
    reflection of the normalized ray instead; ``dir`` is scaled by |d|.
    ``n1``/``n2`` are per-ray tensors ``[...]`` or scalars.  Under TIR the
    refracted branch's root is ``safe_sqrt``'s 0, so its gradient stays
    finite."""
    d_len = norm(d)[..., None]
    dn = normalize(d)
    nn = normalize(n)
    ratio = torch.as_tensor(n1 / n2, dtype=dn.dtype, device=dn.device)
    ratio = ratio.expand(dn.shape[:-1])[..., None]
    cosi = dot(dn, nn, keepdims=True)
    sint2 = ratio * ratio * (1.0 - cosi * cosi)
    tir = (sint2 > 1.0)[..., 0]
    refracted = ratio * dn + (ratio * cosi - safe_sqrt(1.0 - sint2)) * nn
    reflected = dn - 2.0 * cosi * nn
    out = torch.where(tir[..., None], normalize(reflected), refracted)
    return d_len * out, tir


IDENTITY_QUAT = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=torch.float32)
"""The identity rotation, on the CPU: callers move it with ``.to(device)``."""


def quat_mul(a, b):
    ax, ay, az, aw = a.unbind(-1)
    bx, by, bz, bw = b.unbind(-1)
    return torch.stack(
        [
            ax * bw + aw * bx + ay * bz - az * by,
            ay * bw + aw * by + az * bx - ax * bz,
            az * bw + aw * bz + ax * by - ay * bx,
            aw * bw - ax * bx - ay * by - az * bz,
        ],
        dim=-1,
    )


def quat_conj(q):
    return q * torch.tensor([-1.0, -1.0, -1.0, 1.0], dtype=q.dtype,
                            device=q.device)


def quat_normalize(q, eps=THRESHOLD):
    """Unit quaternion, or zero where ``|q| <= eps`` (as :func:`normalize`)."""
    return normalize(q, eps)


def quat_to_mat(q):
    """Rotation matrix [..., 3, 3] of a (normalized-on-the-fly) quaternion."""
    qn = q / norm(q)[..., None]
    x, y, z, w = qn.unbind(-1)
    xx, yy, zz = 2 * x * x, 2 * y * y, 2 * z * z
    wx, wy, wz = 2 * w * x, 2 * w * y, 2 * w * z
    xy, xz, yz = 2 * x * y, 2 * x * z, 2 * y * z
    row0 = torch.stack([1 - (yy + zz), xy - wz, xz + wy], dim=-1)
    row1 = torch.stack([xy + wz, 1 - (xx + zz), yz - wx], dim=-1)
    row2 = torch.stack([xz - wy, yz + wx, 1 - (xx + yy)], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def quat_rotate(q, v):
    """Rotate ``v`` by ``q``: the rotation matrix applied elementwise
    (exact f32; the JAX package's einsum at HIGHEST precision)."""
    m = quat_to_mat(q)
    m, v = torch.broadcast_tensors(m, v[..., None, :])
    return (m[..., 0] * v[..., 0] + m[..., 1] * v[..., 1]
            + m[..., 2] * v[..., 2])


def quat_rotate_inv(q, v):
    return quat_rotate(quat_conj(q), v)


def quat_from_axis_angle(axis, theta):
    """Rotation by ``theta`` (a Python float or a 0-d tensor) about the unit
    ``axis``: ``[axis * sin(theta / 2), cos(theta / 2)]``, computed in
    float32 on ``axis``'s device (a tensor ``theta``'s when ``axis`` is
    not a tensor)."""
    if not isinstance(axis, torch.Tensor):
        axis = torch.tensor(axis, dtype=torch.float32, device=(
            theta.device if isinstance(theta, torch.Tensor) else None))
    axis = axis.to(torch.float32)
    half = 0.5 * torch.as_tensor(theta, dtype=torch.float32,
                                 device=axis.device)
    return torch.cat([axis * torch.sin(half), torch.cos(half)[None]], dim=-1)


# entity frames (reference: src/rayprimitives/entity.cu:5-23)

def point_to_local(q, p, v):
    return quat_rotate(q, v - p)


def point_from_local(q, p, v):
    return quat_rotate_inv(q, v) + p


def vec_to_local(q, v):
    return quat_rotate(q, v)


def vec_from_local(q, v):
    return quat_rotate_inv(q, v)


# intersection tests

def ray_plane(ro, rd, po, pn):
    """Ray/plane (geometry.h:254-261); ``pn`` must be unit.  Returns ``(ok,
    t)``."""
    denom = dot(rd, pn)
    ok = torch.abs(denom) >= THRESHOLD
    t = dot(po - ro, pn) / torch.where(ok, denom, 1.0)
    return ok, t


def ray_triangle_areas(ro, rd, a, b, c):
    """The reference's triangle test (geometry.h:275-290): hit the plane,
    then accept iff the three sub-triangle areas sum to ~1 (tol 1e-5).
    Returns ``(hit, t, uv)``, ``uv = (bary_b, bary_c)``; inputs broadcast,
    ``rd`` unit."""
    pn_raw = cross(b - a, c - a)
    tri_area = norm(pn_raw)
    pn = normalize(pn_raw)
    ok, t = ray_plane(ro, rd, a, pn)
    p = ro + t[..., None] * rd
    inv_area = 1.0 / torch.where(tri_area > 0, tri_area, 1.0)
    bary0 = norm(cross(c - p, b - p)) * inv_area
    bary1 = norm(cross(c - p, a - p)) * inv_area
    bary2 = norm(cross(a - p, b - p)) * inv_area
    inside = torch.abs(bary0 + bary1 + bary2 - 1.0) <= THRESHOLD
    hit = ok & inside & (tri_area > 0)
    return hit, t, torch.stack([bary1, bary2], dim=-1)


def ray_triangle_mt(ro, rd, a, b, c, tol=THRESHOLD):
    """Moller-Trumbore triangle test, accepting ``u, v, 1-u-v >= -tol``.
    Returns ``(hit, t, uv)``."""
    e1 = b - a
    e2 = c - a
    pvec = cross(rd, e2)
    det = dot(e1, pvec)
    ok = torch.abs(det) >= 1e-12
    inv_det = 1.0 / torch.where(ok, det, 1.0)
    tvec = ro - a
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = dot(rd, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    hit = ok & (u >= -tol) & (v >= -tol) & (u + v <= 1.0 + tol)
    return hit, t, torch.stack([u, v], dim=-1)


def ray_aabb(ro, rd, bmin, bmax, nondegenerate=True):
    """Kay/Kajiya slab test (reference src/rayopt/bounding_box.cu:63-104).
    Axes with ``rd == 0`` are skipped, as the reference's ``continue``
    does.  Returns ``(hit, t_entry)``: ``t_entry`` is ``t_min`` if it is
    >= 0, else ``t_max``; a hit also needs ``t_max >= THRESHOLD``."""
    par = rd == 0.0
    inv = 1.0 / torch.where(par, 1.0, rd)
    t1 = (bmin - ro) * inv
    t2 = (bmax - ro) * inv
    tn = torch.where(par, -torch.inf, torch.minimum(t1, t2))
    tf = torch.where(par, torch.inf, torch.maximum(t1, t2))
    tmin = torch.amax(tn, dim=-1)
    tmax = torch.amin(tf, dim=-1)
    hit = (tmin <= tmax) & (tmax >= THRESHOLD) & nondegenerate
    return hit, torch.where(tmin >= 0, tmin, tmax)


def z_order_f32bits_np(center):
    """The reference's Morton code (src/rayopt/z_order.cu:5-36) in numpy:
    the raw IEEE-754 bits of the *negated* center interleaved x/y/z from
    bit 31 down, 64 output bits.  Kept as the parity artifact; the LBVH
    uses :func:`z_order_quantized`."""
    inv = -np.asarray(center, dtype=np.float32)
    bits = inv.view(np.uint32).astype(np.uint64)
    srcs = [bits[..., 0], bits[..., 1], bits[..., 2]]
    code = np.zeros(srcs[0].shape, dtype=np.uint64)
    offs = [31, 31, 31]
    for i in range(64):
        sel = i % 3
        code = (code << np.uint64(1)) | (
            (srcs[sel] >> np.uint64(offs[sel])) & np.uint64(1))
        offs[sel] -= 1
    return code


def z_order_quantized(center, scene_min, scene_max, bits=10):
    """Morton code over fixed-point quantized centers (3 x ``bits``
    interleaved).  Torch has no full uint32 arithmetic, so the code is built
    in int64 with the JAX package's uint32 masks; values stay below 2^30."""
    assert bits <= 10
    extent = torch.clamp(scene_max - scene_min, min=1e-30)
    # a tensor numerator: ``c / tensor`` in torch is ``reciprocal * c``,
    # which rounds differently from the true division
    scale = torch.full_like(extent, 2.0**bits - 1.0) / extent
    q = torch.clamp((center - scene_min) * scale, 0, 2.0**bits - 1)
    q = q.to(torch.int64)
    x, y, z = q.unbind(-1)

    def spread(v):
        v = v & 0x3FF
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        return v

    return (spread(x) << 2) | (spread(y) << 1) | spread(z)
