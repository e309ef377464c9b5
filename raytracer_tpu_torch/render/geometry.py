"""Per-frame geometry expansion and primary camera rays.

Counterpart of ``raytracer_tpu/render/geometry.py``: instances -> world-space
triangle soup + per-instance AABBs (8 transformed corners), and the pinhole
camera's rays through integer pixel corners (reference camera.cu:33-42).
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
    bmin = scene.mesh_aabb_min[imesh]  # [N,3]
    bmax = scene.mesh_aabb_max[imesh]
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


def camera_rays(cam: Camera, width: int, height: int):
    """Primary rays through every pixel corner (x right, y down).  Returns
    ``(origins [H,W,3], dirs [H,W,3])`` with unit dirs.  Sub-pixel jitter
    (spp > 1) is not ported."""
    dev = cam.pos.device
    m = rm.quat_to_mat(cam.rot)
    r = rm.normalize(m[:, 0])
    u = rm.normalize(m[:, 1])
    f = rm.normalize(m[:, 2])
    xs = torch.arange(width, dtype=torch.float32, device=dev)
    ys = torch.arange(height, dtype=torch.float32, device=dev)
    gx = ((xs - 0.5 * width) / cam.unit_to_pixels).expand(height, width)
    gy = ((0.5 * height - ys) / cam.unit_to_pixels)[:, None].expand(
        height, width)
    d = cam.global_near * f + gx[..., None] * r + gy[..., None] * u
    d = rm.normalize(d)
    o = cam.pos.expand(d.shape)
    return o, d
