"""Render path: geometry, casts, shading, the bounce wavefront and frame
assembly (counterpart of ``raytracer_tpu/render``)."""

from .cast import Hit, hit_shading_attrs
from .engine import (auto_tile_caps, frame_to_u8, make_cast, radiance,
                     render_frame, render_frame_sum, render_frame_with_stats,
                     render_rays, render_rays_stats, spp_jitter_grid)
from .geometry import WorldGeometry, camera_rays, expand_geometry
from .shading import illuminate

__all__ = [
    "Hit",
    "WorldGeometry",
    "auto_tile_caps",
    "camera_rays",
    "expand_geometry",
    "frame_to_u8",
    "hit_shading_attrs",
    "illuminate",
    "make_cast",
    "radiance",
    "render_frame",
    "render_frame_sum",
    "render_frame_with_stats",
    "render_rays",
    "render_rays_stats",
    "spp_jitter_grid",
]
