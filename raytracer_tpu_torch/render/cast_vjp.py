"""Autodiff rules of the casts and shadow queries.

Counterpart of ``raytracer_tpu/render/cast_vjp.py`` (``detach_visibility``,
``pallas_cast_detached``, ``pallas_occlude_detached``,
``pallas_occlude2_detached``) for every cast of the port: the LBVH walk, the
candidate-list cull and the MXU cast.  Autograd never looks inside a query:
the kernels run through ctypes into fresh tensors, and differentiating the
plain versions through their slab ``where``s would give the ``"torch"``
engine another gradient than the ``"cuda"`` engine (and non-finite terms
from the ``1/d`` of parallel axes).  Instead:

* the closest-hit cast follows the detached-visibility rule with the
  analytic t-VJP (:class:`BvhCastDetached`, ``pallas_cast_detached``): the
  hit triangle is piecewise constant, and ``t`` moves with the ray as the
  distance to a fixed plane, ``t = n.(p - o) / n.d``;
* under ``edge_aware_grads`` (the vertex-gradient configuration) the
  closest-hit cast follows the reparam rule instead (:class:`ReparamCast`,
  ``pallas_cast_reparam`` / ``reparam_cast``): the hit triangle stays
  frozen, and t, uv and the shading normal get their exact local
  derivatives in the rays and the hit triangle's geometry, pulled back
  through the closed-form plane hit (:func:`recon_plane_hit`) into the
  packed ``[W, 18]`` rows of :func:`pack_reparam_geo`;
* the occlusion queries are autodiff constants (``pallas_occlude_detached``,
  ``pallas_occlude2_detached``): their masks are bool and carry no gradient.
"""

from __future__ import annotations

import torch

from .. import raymath as rm
from .cast import Hit


class BvhCastDetached(torch.autograd.Function):
    """``(ro, rd) -> Hit`` through ``query(ro, rd, data)`` (a cast kernel or
    its plain version) with the JAX package's ``_detached_bwd``: for ``nd =
    n.rd`` and ``ok = valid & |nd| >= 1e-5``, ``scale = g_t / nd`` on ok
    lanes (0 elsewhere), ``d ro = -scale n`` and ``d rd = -(scale t) n``.
    The cotangents of ``uv`` and ``normal`` are ignored, as the JAX rule
    does.  A hit without a normal (the MXU cast) saves ``n = 0``, so its
    ray cotangents are 0, as ``detach_visibility`` gives; it then returns
    zeros for ``normal`` and ``mat``, which :func:`cast_detached` drops."""

    @staticmethod
    def forward(ctx, ro, rd, query, data):
        with torch.no_grad():
            hit = query(ro.contiguous(), rd.contiguous(), data)
        n = hit.normal if hit.normal is not None else torch.zeros_like(ro)
        mat = (hit.mat if hit.mat is not None
               else torch.zeros_like(hit.wtri))
        ctx.save_for_backward(rd, hit.valid,
                              torch.where(hit.valid, hit.t, 0.0), n)
        ctx.mark_non_differentiable(hit.valid, hit.wtri, mat)
        return hit.valid, hit.t, hit.wtri, hit.uv, n, mat

    @staticmethod
    def backward(ctx, _g_valid, g_t, _g_wtri, _g_uv, _g_normal, _g_mat):
        rd, valid, t, n = ctx.saved_tensors
        nd = n[:, 0] * rd[:, 0] + n[:, 1] * rd[:, 1] + n[:, 2] * rd[:, 2]
        ok = valid & (torch.abs(nd) >= 1e-5)
        inv = torch.where(ok, 1.0 / torch.where(ok, nd, 1.0), 0.0)
        scale = torch.where(ok, g_t, 0.0) * inv
        go = -scale[:, None] * n
        gd = -(scale * t)[:, None] * n
        return go, gd, None, None


def cast_detached(query, ro, rd, data, *, with_attrs: bool = True) -> Hit:
    """Closest hit of rays ``[R, 3]`` under :class:`BvhCastDetached`.
    ``with_attrs=False`` for a query that gives no normal and material:
    the Hit then has none, and shading takes them from the geometry."""
    valid, t, wtri, uv, normal, mat = BvhCastDetached.apply(ro, rd, query,
                                                            data)
    if not with_attrs:
        normal = mat = None
    return Hit(valid=valid, t=t, wtri=wtri, uv=uv, normal=normal, mat=mat)


def pack_reparam_geo(geom) -> torch.Tensor:
    """``[W, 18]`` packed ``(a, b, c, na, nb, nc)`` rows of the world
    triangles for :class:`ReparamCast` (``cast_vjp.pack_reparam_geo``): a
    plain differentiable concat, so row cotangents flow back to the
    geometry and through it to ``scene.verts``."""
    return torch.cat([geom.a, geom.b, geom.c, geom.na, geom.nb, geom.nc], 1)


def recon_plane_hit(ro, rd, va, vb, vc, na, nb, nc):
    """Closed-form ``(t, uv, normal)`` of the plane hit, all inputs ``[R,
    3]`` (``cast_vjp._recon_plane_hit``): ``t = n.(a - o) / n.d`` with ``n
    = (b - a) x (c - a)``, the signed barycentrics of ``p = o + t d``, and
    the normalized vertex-normal blend at them."""
    n = rm.cross(vb - va, vc - va)
    nd = rm.dot(n, rd)
    denom = torch.where(torch.abs(nd) > 0, nd, 1.0)
    t = rm.dot(n, va - ro) / denom
    p = ro + t[..., None] * rd
    nn2 = torch.maximum(rm.dot(n, n), nd.new_tensor(1e-30))
    u = rm.dot(rm.cross(p - va, vc - va), n) / nn2
    v = rm.dot(rm.cross(vb - va, p - va), n) / nn2
    sn = (1.0 - u - v)[..., None] * na + u[..., None] * nb \
        + v[..., None] * nc
    return t, torch.stack([u, v], dim=-1), rm.normalize(sn)


# benign stand-ins for the lanes where the reconstruction is singular (a
# miss, a grazing plane, a degenerate triangle): a unit-triangle hit
_BENIGN = ((0.0, 0.0, -1.0), (0.0, 0.0, 1.0), (-1.0, -1.0, 0.0),
           (3.0, -1.0, 0.0), (-1.0, 3.0, 0.0), (0.0, 0.0, 1.0),
           (0.0, 0.0, 1.0), (0.0, 0.0, 1.0))


class ReparamCast(torch.autograd.Function):
    """``(ro, rd, geo) -> Hit`` through ``query(ro, rd, data)`` with the
    JAX package's reparam rule (``_reparam_fwd`` / ``_reparam_bwd``): the
    hit identity stays frozen; the backward re-derives ``(t, uv, normal)``
    at the hit in closed form from the saved rows ``geo[wtri]`` and pulls
    the cotangents back with autograd of :func:`recon_plane_hit` on lanes
    where it is regular (``valid``, ``|n.d| >= THRESHOLD``, ``|n|^2 >
    1e-20``; the others take benign stand-ins and zero cotangents).  The
    row cotangents reach ``geo`` by ONE ``index_add_`` into ``[W, 18]``,
    not by autograd of a gather.  A hit without a normal (the MXU cast)
    returns a zero normal, which :func:`closest_hit` drops: its cotangent
    is then zero, as the JAX rule gets for a missing one."""

    @staticmethod
    def forward(ctx, ro, rd, geo, query, data):
        with torch.no_grad():
            hit = query(ro.contiguous(), rd.contiguous(), data)
            rows = geo[hit.wtri.long()]
        n = hit.normal if hit.normal is not None else torch.zeros_like(ro)
        mat = (hit.mat if hit.mat is not None
               else torch.zeros_like(hit.wtri))
        ctx.save_for_backward(ro, rd, hit.valid, hit.wtri, rows)
        ctx.n_rows = geo.shape[0]
        ctx.mark_non_differentiable(hit.valid, hit.wtri, mat)
        return hit.valid, hit.t, hit.wtri, hit.uv, n, mat

    @staticmethod
    def backward(ctx, _g_valid, g_t, _g_wtri, g_uv, g_n, _g_mat):
        ro, rd, valid, w, rows = ctx.saved_tensors
        va, vb, vc = rows[:, 0:3], rows[:, 3:6], rows[:, 6:9]
        n = rm.cross(vb - va, vc - va)
        nd = rm.dot(n, rd)
        nn2 = rm.dot(n, n)
        ok = valid & (torch.abs(nd) >= rm.THRESHOLD) & (nn2 > 1e-20)
        okv = ok[:, None]
        parts = [ro, rd] + [rows[:, 3 * k:3 * k + 3] for k in range(6)]
        ins = [torch.where(okv, x, x.new_tensor(b)).detach()
               .requires_grad_(True) for x, b in zip(parts, _BENIGN)]
        cots = (torch.where(ok, g_t, 0.0), torch.where(okv, g_uv, 0.0),
                torch.where(okv, g_n, 0.0))
        with torch.enable_grad():
            outs = recon_plane_hit(*ins)
            grads = torch.autograd.grad(outs, ins, cots, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(ins, grads)]
        d_rows = torch.where(okv, torch.cat(grads[2:], 1), 0.0)
        d_geo = rows.new_zeros(ctx.n_rows, rows.shape[1]).index_add_(
            0, w.long(), d_rows)
        return grads[0], grads[1], d_geo, None, None


def closest_hit(query, ro, rd, data, geo=None, *,
                with_attrs: bool = True) -> Hit:
    """The engine's closest-hit rule: :class:`ReparamCast` when it has the
    packed rows ``geo`` [W, 18] (``edge_aware_grads``), else
    :func:`cast_detached`; ``with_attrs`` as :func:`cast_detached`."""
    if geo is None:
        return cast_detached(query, ro, rd, data, with_attrs=with_attrs)
    valid, t, wtri, uv, normal, mat = ReparamCast.apply(ro, rd, geo, query,
                                                        data)
    if not with_attrs:
        normal = mat = None
    return Hit(valid=valid, t=t, wtri=wtri, uv=uv, normal=normal, mat=mat)


def _max_t(x, like):
    x = torch.as_tensor(x, dtype=torch.float32, device=like.device)
    return x.expand(like.shape[0]).contiguous()


@torch.no_grad()
def occlude_detached(query, ro, rd, max_t, data):
    """Any-hit query (K3, K5 or a plain version) as an autodiff constant:
    bool ``[R]``; ``max_t`` is a scalar or ``[R]``."""
    return query(ro.contiguous(), rd.contiguous(), _max_t(max_t, ro), data)


@torch.no_grad()
def occlude2_detached(query, o1, d1, mt1, o2, d2, mt2, data):
    """Two shadow queries (K2's fused walk, two K5 queries, or a plain
    version) as an autodiff constant: two bool ``[R]``."""
    return query(o1.contiguous(), d1.contiguous(), _max_t(mt1, o1),
                 o2.contiguous(), d2.contiguous(), _max_t(mt2, o1), data)
