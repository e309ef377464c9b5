"""Hit records, the :class:`Cast` of every query and a hit's shading
attributes.

Counterpart of ``raytracer_tpu/render/cast.py`` (``Hit``,
``hit_shading_attrs``).  The casts themselves live in ``cuda_engine.py``
(the LBVH walk), ``cull.py`` and ``mxu.py``; ``engine.make_cast`` picks.
The walk takes a whole frame in one launch; the cull and the MXU cast chunk
the rays as ``_chunked_over_rays`` does (``cull.CullLayout``), since their
tiles, and so their results' order of visits, depend on which rays share a
tile.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from .. import raymath as rm
from .geometry import WorldGeometry


@dataclass
class Hit:
    """SoA hit record (the reference's ``Isect``).  ``normal``/``mat`` are
    filled by casts that already know them (the scalar kernels do, the MXU
    cast does not)."""

    valid: torch.Tensor  # [...] bool
    t: torch.Tensor  # [...] f32 (inf when invalid)
    wtri: torch.Tensor  # [...] i32 world-triangle index (0 when invalid)
    uv: torch.Tensor  # [...,2] f32 barycentric (bary_b, bary_c)
    normal: Optional[torch.Tensor] = None  # [...,3] unit shading normal
    mat: Optional[torch.Tensor] = None  # [...] i32 material id


@dataclass(frozen=True)
class Cast:
    """The queries of one cast over rays ``[R, 3]``, built by
    ``engine.make_cast``; ``cast(ro, rd)`` is ``cast.closest(ro, rd)``.  An
    optional query is None where no kernel answers it."""

    closest: Callable[..., Hit]  # (ro, rd) -> Hit
    # (ro, rd, max_t) -> bool [R]: a blocker within max_t (an any-hit
    # kernel, or occlude_by_closest)
    occlude: Callable[..., torch.Tensor]
    # (o1, d1, mt1, o2, d2, mt2) -> both masks of the fused two-light round
    # (K2, or two K5 queries)
    occlude2: Optional[Callable[..., tuple]] = None
    # (origin, dir_unit, max_t, light_col, active, kt, steps) -> [R, 4]: the
    # transmissive shadow march in one launch (the LBVH walk on the card)
    march: Optional[Callable[..., torch.Tensor]] = None
    # (ro, rd) -> int32 [R]: the node boxes each ray's walk tests (the walk)
    visit_counts: Optional[Callable[..., torch.Tensor]] = None

    def __call__(self, ro: torch.Tensor, rd: torch.Tensor) -> Hit:
        return self.closest(ro, rd)


def occlude_by_closest(closest):
    """The any-hit query of a cast without one: its closest hit within
    ``max_t`` (the closest hit being minimal)."""

    def occlude(ro, rd, max_t):
        hit = closest(ro, rd)
        return hit.valid & (torch.where(hit.valid, hit.t, 1.0) <= max_t)

    return occlude


def hit_shading_attrs(geom: WorldGeometry, hit: Hit):
    """``(normal [...,3], mat [...] i32, inst [...] i32)`` of a hit: the
    cast's own normal/material when it gave them, else the barycentric blend
    of the world vertex normals, re-normalized."""
    w = hit.wtri.long()
    if hit.normal is not None and hit.mat is not None:
        return hit.normal, hit.mat, geom.inst[w]
    u = hit.uv[..., 0:1]
    v = hit.uv[..., 1:2]
    b0 = 1.0 - u - v
    n = b0 * geom.na[w] + u * geom.nb[w] + v * geom.nc[w]
    return rm.normalize(n), geom.mat[w], geom.inst[w]
