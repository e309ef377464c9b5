"""Scene data model: plain dataclasses of flat SoA arrays.

PyTorch counterpart of ``raytracer_tpu/scene.py``.  The fields, their shapes
and their conventions are the JAX package's (quaternions ``[x, y, z, w]``,
instance quaternions map global to local, the camera's maps local to global);
what differs is the container: no pytree registration, and leaves are numpy
arrays as the builder emits them or torch tensors after :func:`to_device`.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch


@dataclass
class Materials:
    """Deduplicated Phong material table: ``[K, 4]`` RGBA rows (``[K]`` for
    the scalars); triangles index into it."""

    ke: Any  # [K,4] emission
    ka: Any  # [K,4] ambient
    kd: Any  # [K,4] diffuse
    ks: Any  # [K,4] specular
    kt: Any  # [K,4] transmission
    kr: Any  # [K,4] reflection
    alpha: Any  # [K] shininess exponent
    eta: Any  # [K] refraction index


@dataclass
class Lights:
    """Point + directional lights; either may be empty (shape [0, ...])."""

    point_pos: Any  # [Lp,3]
    point_col: Any  # [Lp,4]
    dir_dir: Any  # [Ld,3] direction the light SHINES (rays go toward -dir)
    dir_col: Any  # [Ld,4]


@dataclass
class Camera:
    """Pinhole camera; pixel (x, y) maps to a ray through
    ``near*f + gx*r + gy*u`` with (r, u, f) the columns of the orientation's
    rotation matrix (local -> global, unlike instances)."""

    pos: Any  # [3]
    rot: Any  # [4] quaternion [x,y,z,w]
    global_near: Any  # scalar
    unit_to_pixels: Any  # scalar


@dataclass
class Scene:
    """The full flattened scene.  Every leaf is an array; shapes are static."""

    verts: Any  # [V,3] mesh-local positions
    norms: Any  # [V,3] mesh-local unit vertex normals
    tri_v: Any  # [T,3] i32 vertex indices
    tri_mat: Any  # [T] i32 material table index
    tri_coord_rect: Any  # [T,4] f32 texture atlas rect
    tri_coord_degenerate: Any  # [T] bool; True => untextured, use Kd
    mesh_pos: Any  # [M,3]
    mesh_rot: Any  # [M,4]
    mesh_tri_start: Any  # [M] i32
    mesh_tri_count: Any  # [M] i32
    mesh_aabb_min: Any  # [M,3] mesh-local AABB over verts
    mesh_aabb_max: Any  # [M,3]
    materials: Materials
    inst_pos: Any  # [N,3]
    inst_rot: Any  # [N,4]
    inst_mesh: Any  # [N] i32
    wtri_inst: Any  # [W] i32 instance index per world triangle
    wtri_tri: Any  # [W] i32 triangle-table index per world triangle
    lights: Lights
    ambience: Any  # [4]
    dist_atten: Any  # [3] constant/linear/quadratic terms
    atlas: Any  # [Ha,Wa,4]


@dataclass(frozen=True)
class RenderConfig:
    """Static render settings: the JAX package's fields and defaults
    (``raytracer_tpu/scene.py`` RenderConfig documents each).  Only the
    values of ``engine`` differ: ``"torch"`` is the plain-PyTorch oracle and
    ``"cuda"`` the hand-written kernel path (on CPU tensors its wrappers run
    the plain versions)."""

    width: int = 640
    height: int = 480
    recurse_depth: int = 2
    shadow_steps: int = 4
    engine: str = "torch"  # "torch" oracle | "cuda" kernel path
    pallas_kernel: str = "scalar"  # kept name: "scalar" (K1-K5) | "mxu" (K6)
    pallas_traversal: str = "auto"  # "cull" | "bvh" | "auto" (> 256 inst.)
    use_bvh: bool = True
    tile_rows: int = 0
    ray_chunk: int = 16384
    pallas_ray_chunk: int = 1 << 19
    queue_factor: float = 1.0
    max_candidates: int = 64
    max_tris_per_mesh: int = 16
    spp: int = 1
    texture_mapping: bool = False
    early_exit: bool = True
    any_reflective: bool = True
    any_refractive: bool = True
    edge_aware_grads: bool = False
    edge_eps: float = 0.05
    edge_px: float = 1.5
    fused_shadows: bool = True
    wavefront_tile_cap: float = 0.0
    child_tile_cap: float = 0.0
    static_tile_cap: float = 0.0

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


def scene_render_flags(scene: Scene) -> dict:
    """Static scene facts for RenderConfig (what the cube-world loader sets):
    ``RenderConfig(**scene_render_flags(scene), ...)``."""
    counts = _np(scene.mesh_tri_count)
    return dict(
        any_reflective=bool(np.any(_np(scene.materials.kr) > 0.0)),
        any_refractive=bool(np.any(_np(scene.materials.kt) > 0.0)),
        max_tris_per_mesh=int(counts.max()) if counts.size else 1,
    )


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _leaf_to_device(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def to_device(obj, device):
    """Copy every array leaf of a Scene / Camera / Materials / Lights to
    ``device`` as torch tensors (dtypes kept: f32, i32, bool)."""
    kw = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            kw[f.name] = to_device(v, device)
        else:
            kw[f.name] = _leaf_to_device(v, device)
    return type(obj)(**kw)


def scene_summary(scene: Scene) -> str:
    """One line of the scene's sizes (the JAX package's ``scene_summary``)."""
    v = scene.verts.shape[0]
    t = scene.tri_v.shape[0]
    n = scene.inst_pos.shape[0]
    w = scene.wtri_tri.shape[0]
    lp = scene.lights.point_pos.shape[0]
    ld = scene.lights.dir_dir.shape[0]
    return (
        f"Scene(verts={v}, tris={t}, meshes={scene.mesh_pos.shape[0]}, "
        f"instances={n}, world_tris={w}, lights={lp}+{ld})"
    )


def tree_f32(x) -> np.ndarray:
    """A leaf (numpy array or tensor on any device) as a float32 numpy
    array."""
    return _np(x).astype(np.float32, copy=False)
