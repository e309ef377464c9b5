"""Per-frame geometry expansion and primary camera rays.

Counterpart of ``raytracer_tpu/render/geometry.py``: instances -> world-space
triangle soup + per-instance AABBs (8 transformed corners), and the pinhole
camera's rays through integer pixel corners (reference camera.cu:33-42).

The mesh boxes come from the vertices each frame (:func:`mesh_boxes`), not
from ``Scene.mesh_aabb_min/max``: the stored fields are the loader's and do
not follow an edit of ``verts`` (a vertex step, a scaled scene), and a box
that no longer bounds its geometry makes which hits a traversal finds depend
on how it votes.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import raymath as rm
from ..scene import Camera, Scene


@dataclass
class WorldGeometry:
    """World-space triangle soup, grouped contiguously by instance."""

    a: torch.Tensor  # [W,3] triangle vertex 0
    b: torch.Tensor  # [W,3]
    c: torch.Tensor  # [W,3]
    na: torch.Tensor  # [W,3] world-space unit vertex normals
    nb: torch.Tensor  # [W,3]
    nc: torch.Tensor  # [W,3]
    mat: torch.Tensor  # [W] i32 material index
    inst: torch.Tensor  # [W] i32 owning instance
    aabb_min: torch.Tensor  # [N,3] per-instance world AABB
    aabb_max: torch.Tensor  # [N,3]


def mesh_of_triangles(scene: Scene):
    """``(mesh [T] i64, owned [T] bool)``: the first mesh whose triangle
    range ``[mesh_tri_start, + mesh_tri_count)`` holds each triangle row
    (``jnp.argmax``'s first maximum), and whether any does."""
    rows = torch.arange(scene.tri_v.shape[0], device=scene.tri_v.device)
    starts = scene.mesh_tri_start
    in_mesh = ((rows[None, :] >= starts[:, None])
               & (rows[None, :] < (starts + scene.mesh_tri_count)[:, None]))
    return torch.argmax(in_mesh.to(torch.int32), dim=0), in_mesh.any(dim=0)


@torch.no_grad()
def mesh_boxes(scene: Scene):
    """Each mesh's local AABB ``(min [M,3], max [M,3])`` over the vertices
    its triangles reference, as ``SceneBuilder`` computes
    ``mesh_aabb_min/max`` (a mesh without triangles keeps zeros), from the
    current ``verts``.  Boxes are culling data: no gradient flows through
    them (the casts' VJPs reach ``verts`` through the triangles)."""
    M = scene.mesh_tri_start.shape[0]
    mesh, owned = mesh_of_triangles(scene)
    # one entry per vertex reference; unowned triangles go to a spare row
    seg = torch.where(owned, mesh, M).repeat_interleave(3)[:, None].expand(
        -1, 3)
    vals = scene.verts[scene.tri_v.long().reshape(-1)]
    zeros = scene.verts.new_zeros(M + 1, 3)
    lo = zeros.scatter_reduce(0, seg, vals, "amin", include_self=False)
    hi = zeros.scatter_reduce(0, seg, vals, "amax", include_self=False)
    return lo[:M], hi[:M]


def expand_geometry(scene: Scene) -> WorldGeometry:
    """World position of a mesh-local vertex v is
    ``inst.from_local(mesh.from_local(v))`` with ``from_local(v) =
    rot(q^-1, v) + p``."""
    wtri_inst = scene.wtri_inst.long()
    tri = scene.tri_v[scene.wtri_tri.long()].long()  # [W,3]
    mesh = scene.inst_mesh[wtri_inst].long()  # [W]
    m_pos = scene.mesh_pos[mesh]
    m_rot = scene.mesh_rot[mesh]
    i_pos = scene.inst_pos[wtri_inst]
    i_rot = scene.inst_rot[wtri_inst]

    def to_world_point(v):
        v1 = rm.quat_rotate_inv(m_rot, v) + m_pos
        return rm.quat_rotate_inv(i_rot, v1) + i_pos

    def to_world_vec(v):
        return rm.quat_rotate_inv(i_rot, rm.quat_rotate_inv(m_rot, v))

    va, vb, vc = (scene.verts[tri[:, k]] for k in range(3))
    na, nb, nc = (scene.norms[tri[:, k]] for k in range(3))

    # Per-instance world AABBs: fit all 8 transformed mesh-box corners.
    imesh = scene.inst_mesh.long()
    mesh_min, mesh_max = mesh_boxes(scene)
    bmin = mesh_min[imesh]  # [N,3]
    bmax = mesh_max[imesh]
    corners = []
    for sx in (0, 1):
        for sy in (0, 1):
            for sz in (0, 1):
                sel = torch.tensor([sx, sy, sz], dtype=bmin.dtype,
                                   device=bmin.device)
                corners.append(bmin * (1 - sel) + bmax * sel)
    corners = torch.stack(corners, dim=1)  # [N,8,3]
    mq = scene.mesh_rot[imesh][:, None, :]
    mp = scene.mesh_pos[imesh][:, None, :]
    iq = scene.inst_rot[:, None, :]
    ip = scene.inst_pos[:, None, :]
    wc = rm.quat_rotate_inv(iq, rm.quat_rotate_inv(mq, corners) + mp) + ip

    return WorldGeometry(
        a=to_world_point(va),
        b=to_world_point(vb),
        c=to_world_point(vc),
        na=to_world_vec(na),
        nb=to_world_vec(nb),
        nc=to_world_vec(nc),
        mat=scene.tri_mat[scene.wtri_tri.long()],
        inst=scene.wtri_inst,
        aabb_min=wc.amin(dim=1),
        aabb_max=wc.amax(dim=1),
    )


def camera_rays(cam: Camera, width: int, height: int, jitter=None):
    """Primary rays through every pixel corner (x right, y down).  Returns
    ``(origins [H,W,3], dirs [H,W,3])`` with unit dirs.  ``jitter`` (an
    optional ``[H,W,2]`` in [0, 1)) moves each ray inside its pixel, in the
    JAX package's operation order (the spp samples' jitter,
    ``engine.spp_jitter_grid``; ``auto_tile_caps`` probes the pixel
    centres with it)."""
    dev = cam.pos.device
    m = rm.quat_to_mat(cam.rot)
    r = rm.normalize(m[:, 0])
    u = rm.normalize(m[:, 1])
    f = rm.normalize(m[:, 2])
    xs = torch.arange(width, dtype=torch.float32, device=dev)
    ys = torch.arange(height, dtype=torch.float32, device=dev)
    if jitter is not None:
        gx = (xs[None, :] + jitter[..., 0] - 0.5 * width) / cam.unit_to_pixels
        gy = (0.5 * height - (ys[:, None] + jitter[..., 1])) / cam.unit_to_pixels
    else:
        gx = ((xs - 0.5 * width) / cam.unit_to_pixels).expand(height, width)
        gy = ((0.5 * height - ys) / cam.unit_to_pixels)[:, None].expand(
            height, width)
    d = cam.global_near * f + gx[..., None] * r + gy[..., None] * u
    d = rm.normalize(d)
    o = cam.pos.expand(d.shape)
    return o, d
