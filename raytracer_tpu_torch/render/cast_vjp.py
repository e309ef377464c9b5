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
* the occlusion queries are autodiff constants (``pallas_occlude_detached``,
  ``pallas_occlude2_detached``): their masks are bool and carry no gradient.
"""

from __future__ import annotations

import torch

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
