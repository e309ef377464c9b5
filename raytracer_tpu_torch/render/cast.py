"""Hit records and the shading attributes of a hit.

Counterpart of ``raytracer_tpu/render/cast.py`` (``Hit``,
``hit_shading_attrs``).  The casts themselves live in ``cuda_engine.py``
(the LBVH walk), ``cull.py`` and ``mxu.py``.  The walk takes a whole frame
in one launch; the cull and the MXU cast chunk the rays as
``_chunked_over_rays`` does (``cull.CullLayout``), since their tiles, and so
their results' order of visits, depend on which rays share a tile.
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


# Signature all casts share: (origins [R,3], dirs [R,3]) -> Hit over [R]
CastFn = Callable[[torch.Tensor, torch.Tensor], Hit]


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
