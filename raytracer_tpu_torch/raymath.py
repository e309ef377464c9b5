"""Batched ray-tracing math on torch tensors.

Counterpart of ``raytracer_tpu/raymath.py``, reduced to what the port's
render path uses.  Conventions are the JAX package's: ``THRESHOLD =
1e-5`` is the universal epsilon, ``normalize`` returns the zero vector below
it, quaternions are ``[x, y, z, w]``.

Everything stays exact float32: dot products and rotations are written out
per component (no matmul, so no TF32 and no reduction-order surprises), in
the JAX package's left-to-right order.
"""

from __future__ import annotations

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
