"""LBVH cast and shadow queries: tables, plain versions, kernels.

Counterpart of ``raytracer_tpu/render/pallas_engine.py``.  Its LBVH-walk
kernels each have here a hand-written CUDA kernel (``csrc/bvh_kernels.cu``),
a plain batched PyTorch version beside it, and a wrapper that dispatches by
device; the candidate-list cull (K4/K5, the JAX package's traversal at <= 256
instances) lives in ``cull.py`` and shares this module's tables and helpers:

* K1 ``_bvh_cast_kernel`` -> :func:`bvh_cast` / :func:`bvh_cast_reference`:
  closest hit through the stackless implicit-heap LBVH walk; leaves run the
  box fast path (identity-rotation box meshes) or the template triangle loop.
  ``exact_uv=True`` (``cfg.edge_aware_grads``) resolves on the box fast path
  the true triangle of the hit face and its barycentrics; its
  ``visits_out`` is :func:`bvh_visit_counts`, whose plain version
  replays the kernel's own walk (:func:`k1_walk_replay`).
* K2 ``_bvh_occlude2_kernel`` -> :func:`bvh_occlude2` /
  :func:`bvh_occlude2_reference`: both shadow queries of a two-light round
  in one launch (the kernel: one walk a query; :func:`occlude_walk_replay`).
* K3 ``_bvh_occlude_kernel`` -> :func:`bvh_occlude` /
  :func:`bvh_occlude_reference`: one any-hit query (the per-light shadow).
* no Pallas kernel -> :func:`bvh_march` / ``shading.march_steps``: the
  transmissive shadow march of a light, every step's K1 walk and the
  attenuation in one thread a lane (the JAX package's ``_march_shadow``
  loop fused with K1).

The tables keep the JAX package's layouts (``_IF_*``, ``_II_*``, ``_TF_*``)
column for column.  The CUDA kernels walk the tree per thread (one ray each)
instead of per 8x128 tile; votes are conservative and leaf updates use strict
``<`` in the same preorder, so hits equal the tile walk's.  Because every
ancestor box contains its children exactly, the per-thread walk also equals a
flat loop over the leaves in walk order (``ordering[n-1], ..., ordering[0]``)
gated by each ray's own leaf-box test -- which is what the plain versions do;
the any-hit ones also gate a leaf by its ancestors' votes, which differ only
for a box hit at t = +inf (``_occlude_reference``).

Every comparison, select and division is written in the kernels' order so
that the CUDA code (built with ``-fmad=false``) and the separately rounded
torch ops give the same bits.  A torch ``c / tensor`` is ``reciprocal * c``,
so divisions here are tensor by tensor or ``1.0 / tensor`` only.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import torch

from .. import raymath as rm
from ..accel import build_lbvh
from ..scene import RenderConfig, Scene
from .cast import Cast, Hit
from .cast_vjp import closest_hit, occlude2_detached, occlude_detached
from .geometry import WorldGeometry, mesh_boxes, mesh_of_triangles

F32_NEG_BIG = -3.0e38
F32_BIG = 3.0e38

# inst_f32 row layout
_IF_BMIN = 0   # 0:3 world AABB min
_IF_BMAX = 3   # 3:6 world AABB max
_IF_POS = 6    # 6:9 frame position
_IF_QUAT = 9   # 9:13 frame quaternion [x,y,z,w] (global->local)
_IF_LMIN = 13  # 13:16 mesh-local AABB min
_IF_LMAX = 16  # 16:19 mesh-local AABB max
_IF_FNRM = 19  # 19:37 six world-space face normals, f = axis*2 + side
_IF_WIDTH = 40

# inst_i32 row layout
_II_TMPL_START = 0  # first row in the template table
_II_TRI_COUNT = 1   # triangle count
_II_WTRI_START = 2  # world-triangle id of the instance's first triangle
_II_VALID = 3       # 1 for every real instance
_II_IS_BOX = 4      # 1 when the mesh is an identity-rotation box
_II_MAT = 5         # material id (box meshes are single-material)
_II_FACE_WTRI = 8   # 8:14 first world-tri id per face
_II_FACE_WTRI2 = 14  # 14:20 second world-tri id per face
_II_WIDTH = 24

# exact_uv: a face triangle contains the hit when its signed barycentrics
# are >= -BARY_EPS and sum to <= 1 + BARY_EPS (in f32, 1.00001)
BARY_EPS = 1e-5

# template row layout (per mesh-local triangle)
_TF_A = 0      # 0:3 vertex a
_TF_B = 3      # 3:6 vertex b
_TF_C = 6      # 6:9 vertex c
_TF_PNU = 9    # 9:12 unit plane normal
_TF_AREA = 12  # |cross(b-a, c-a)|
_TF_MAT = 13   # material id as f32
_TF_NA = 16    # 16:19 vertex normal a (mesh-local)
_TF_NB = 19    # 19:22 vertex normal b
_TF_NC = 22    # 22:25 vertex normal c
_TF_WIDTH = 32

_NODE_WIDTH = 8  # min xyz, max xyz, valid, pad


@dataclass
class SceneTables:
    inst_f32: torch.Tensor  # [N, 40] f32
    inst_i32: torch.Tensor  # [N, 24] i32
    tmpl: torch.Tensor  # [T, 32] f32


@dataclass
class CastData:
    """What the cast needs at run time (``prepare_pallas_cast``'s dict).
    The LBVH fields are ``None`` on the candidate-list cull, which reads
    the tables only."""

    tables: SceneTables
    nodes: Optional[torch.Tensor] = None  # [2n-1, 8] f32: min, max, valid
    ordering: Optional[torch.Tensor] = None  # [n] i32, -1 for padding

    @property
    def n_leaves(self) -> int:
        return 0 if self.ordering is None else self.ordering.shape[0]


# ---------------------------------------------------------------------------
# tables
# ---------------------------------------------------------------------------

def _detect_box_meshes(scene: Scene, mesh_min: torch.Tensor,
                       mesh_max: torch.Tensor):
    """Per-mesh axis-aligned-box detection against the mesh boxes
    ``mesh_min/max [M, 3]`` of the current vertices
    (``geometry.mesh_boxes``).  Returns ``(is_box [M] bool, mat [M] i32,
    face_tri [M, 6] i32, face_of [T] i32, face_tri2 [M, 6] i32)`` exactly
    as ``pallas_engine._detect_box_meshes`` does with those boxes."""
    dev = scene.verts.device
    T = scene.tri_v.shape[0]
    M = scene.mesh_pos.shape[0]
    tol = 1e-5
    tri_v = scene.tri_v.long()

    va = scene.verts[tri_v[:, 0]]
    vb = scene.verts[tri_v[:, 1]]
    vc = scene.verts[tri_v[:, 2]]
    tri_rows = torch.arange(T, dtype=torch.int32, device=dev)
    starts = scene.mesh_tri_start
    mesh_of, _ = mesh_of_triangles(scene)  # [T] i64

    bmin = mesh_min[mesh_of]  # [T,3]
    bmax = mesh_max[mesh_of]
    scale = torch.clamp((bmax - bmin).amax(dim=-1, keepdim=True), min=1e-8)
    tol_s = tol * scale

    def on_corner(v):
        lo = torch.abs(v - bmin) <= tol_s
        hi = torch.abs(v - bmax) <= tol_s
        return torch.all(lo | hi, dim=-1)

    corners_ok = on_corner(va) & on_corner(vb) & on_corner(vc)

    def plane_flags(plane):
        return ((torch.abs(va - plane) <= tol_s)
                & (torch.abs(vb - plane) <= tol_s)
                & (torch.abs(vc - plane) <= tol_s))

    lo_f = plane_flags(bmin)
    hi_f = plane_flags(bmax)
    flags = torch.stack([lo_f[:, 0], hi_f[:, 0], lo_f[:, 1], hi_f[:, 1],
                         lo_f[:, 2], hi_f[:, 2]], -1)  # [T, 6]
    one_face = flags.sum(dim=-1) == 1
    face_of = torch.argmax(flags.to(torch.int32), dim=-1)  # [T] i64

    na = scene.norms[tri_v[:, 0]]
    nb = scene.norms[tri_v[:, 1]]
    nc = scene.norms[tri_v[:, 2]]
    faceted = (torch.all(torch.abs(na - nb) <= 1e-5, dim=-1)
               & torch.all(torch.abs(na - nc) <= 1e-5, dim=-1))

    tri_ok = corners_ok & one_face & faceted

    mf = mesh_of * 6 + face_of  # [T] i64
    i32 = torch.int32
    counts = torch.zeros(M * 6, dtype=i32, device=dev).index_add_(
        0, mf, tri_ok.to(i32))
    first = torch.full((M * 6,), T, dtype=i32, device=dev).scatter_reduce_(
        0, mf, torch.where(tri_ok, tri_rows, T), "amin", include_self=True)
    second = torch.full((M * 6,), -1, dtype=i32, device=dev).scatter_reduce_(
        0, mf, torch.where(tri_ok, tri_rows, -1), "amax", include_self=True)
    counts = counts.reshape(M, 6)
    face_tri = torch.clamp(first.reshape(M, 6), 0, max(T - 1, 0))
    face_tri2 = torch.clamp(second.reshape(M, 6), 0, max(T - 1, 0))

    # both triangles of a face must agree on the faceted normal
    nsum = torch.zeros(M * 6, 3, dtype=torch.float32, device=dev).index_add_(
        0, mf, torch.where(tri_ok[:, None], na, 0.0))
    normals_agree = torch.all(
        torch.abs((nsum * nsum).sum(dim=-1).reshape(M, 6) - 4.0) < 1e-3,
        dim=-1)

    ref_mat = scene.tri_mat[torch.clamp(starts, 0, max(T - 1, 0)).long()]
    same_mat = torch.zeros(M, dtype=i32, device=dev).index_add_(
        0, mesh_of, (scene.tri_mat != ref_mat[mesh_of]).to(i32)) == 0
    all_ok = torch.zeros(M, dtype=i32, device=dev).index_add_(
        0, mesh_of, (~tri_ok).to(i32)) == 0
    is_box = ((scene.mesh_tri_count == 12) & all_ok
              & torch.all(counts == 2, dim=-1) & normals_agree & same_mat)
    return (is_box, ref_mat.to(i32), face_tri, face_of.to(i32), face_tri2)


def build_tables(scene: Scene, geom: WorldGeometry, *,
                 exact_uv: bool = False,
                 texture_mapping: bool = False,
                 box_exact_uv: bool = False) -> SceneTables:
    """The kernels' instance and template tables (``pallas_engine.
    build_tables``).  ``exact_uv=True`` without ``box_exact_uv`` zeroes
    ``is_box`` so every instance takes the template loop; with
    ``box_exact_uv`` the box fast path stays, and the kernels' ``exact_uv``
    branch resolves the hit face's triangle from the ``_II_FACE_WTRI`` /
    ``_II_FACE_WTRI2`` columns (filled either way).  Otherwise
    ``texture_mapping=True`` takes ``is_box`` from every box mesh with a
    textured triangle: the fast path reports a fixed uv, and the atlas
    needs the template loop's true barycentrics; untextured box meshes
    keep it."""
    n = scene.inst_pos.shape[0]
    dev = scene.inst_pos.device
    i32 = torch.int32
    mesh = scene.inst_mesh.long()
    q_i = scene.inst_rot
    q_m = scene.mesh_rot[mesh]
    p_i = scene.inst_pos
    p_m = scene.mesh_pos[mesh]
    # composed frame: v_local = q_m (q_i (v - p_i) - p_m) = q (v - p)
    q = rm.quat_mul(q_m, q_i)
    p = p_i + rm.quat_rotate_inv(q_i, p_m)

    inst_f32 = torch.zeros(n, _IF_WIDTH, dtype=torch.float32, device=dev)
    inst_f32[:, _IF_BMIN:_IF_BMIN + 3] = geom.aabb_min
    inst_f32[:, _IF_BMAX:_IF_BMAX + 3] = geom.aabb_max
    inst_f32[:, _IF_POS:_IF_POS + 3] = p
    inst_f32[:, _IF_QUAT:_IF_QUAT + 4] = q
    # the boxes of the current vertices (the stored fields may be stale)
    mesh_min, mesh_max = mesh_boxes(scene)
    inst_f32[:, _IF_LMIN:_IF_LMIN + 3] = mesh_min[mesh]
    inst_f32[:, _IF_LMAX:_IF_LMAX + 3] = mesh_max[mesh]

    counts = scene.mesh_tri_count[mesh]
    tmpl_start = scene.mesh_tri_start[mesh]
    wtri_start = torch.cat([torch.zeros(1, dtype=i32, device=dev),
                            torch.cumsum(counts, 0, dtype=i32)[:-1]])
    inst_i32 = torch.zeros(n, _II_WIDTH, dtype=i32, device=dev)
    inst_i32[:, _II_TMPL_START] = tmpl_start
    inst_i32[:, _II_TRI_COUNT] = counts
    inst_i32[:, _II_WTRI_START] = wtri_start
    inst_i32[:, _II_VALID] = 1

    is_box_m, mat_m, face_tri_m, _, face_tri2_m = _detect_box_meshes(
        scene, mesh_min, mesh_max)
    if exact_uv and not box_exact_uv:
        is_box_m = torch.zeros_like(is_box_m)
    elif texture_mapping:
        rows = torch.arange(scene.tri_v.shape[0], device=dev)
        starts = scene.mesh_tri_start
        ends = starts + scene.mesh_tri_count
        in_mesh = ((rows[None, :] >= starts[:, None])
                   & (rows[None, :] < ends[:, None]))
        any_tex = (in_mesh & ~scene.tri_coord_degenerate[None, :]).any(dim=1)
        is_box_m = is_box_m & ~any_tex
    ident_rot = ((torch.abs(q[:, 0]) < 1e-6) & (torch.abs(q[:, 1]) < 1e-6)
                 & (torch.abs(q[:, 2]) < 1e-6))
    inst_i32[:, _II_IS_BOX] = (is_box_m[mesh] & ident_rot).to(i32)
    inst_i32[:, _II_MAT] = mat_m[mesh]
    w_max = max(geom.a.shape[0] - 1, 0)
    face_wtri = torch.clamp(
        wtri_start[:, None] + (face_tri_m[mesh] - tmpl_start[:, None]),
        0, w_max)  # [n, 6]
    inst_i32[:, _II_FACE_WTRI:_II_FACE_WTRI + 6] = face_wtri
    face_wtri2 = torch.clamp(
        wtri_start[:, None] + (face_tri2_m[mesh] - tmpl_start[:, None]),
        0, w_max)
    inst_i32[:, _II_FACE_WTRI2:_II_FACE_WTRI2 + 6] = face_wtri2
    fnrm = geom.na[face_wtri.long()]  # [n, 6, 3]
    inst_f32[:, _IF_FNRM:_IF_FNRM + 18] = fnrm.reshape(n, 18)

    tri_v = scene.tri_v.long()
    va = scene.verts[tri_v[:, 0]]
    vb = scene.verts[tri_v[:, 1]]
    vc = scene.verts[tri_v[:, 2]]
    pn = rm.cross(vb - va, vc - va)
    area = torch.sqrt(pn[:, 0] * pn[:, 0] + pn[:, 1] * pn[:, 1]
                      + pn[:, 2] * pn[:, 2])
    t = scene.tri_v.shape[0]
    tmpl = torch.zeros(t, _TF_WIDTH, dtype=torch.float32, device=dev)
    tmpl[:, _TF_A:_TF_A + 3] = va
    tmpl[:, _TF_B:_TF_B + 3] = vb
    tmpl[:, _TF_C:_TF_C + 3] = vc
    tmpl[:, _TF_PNU:_TF_PNU + 3] = rm.normalize(pn)
    tmpl[:, _TF_AREA] = area
    tmpl[:, _TF_MAT] = scene.tri_mat.to(torch.float32)
    tmpl[:, _TF_NA:_TF_NA + 3] = scene.norms[tri_v[:, 0]]
    tmpl[:, _TF_NB:_TF_NB + 3] = scene.norms[tri_v[:, 1]]
    tmpl[:, _TF_NC:_TF_NC + 3] = scene.norms[tri_v[:, 2]]
    return SceneTables(inst_f32=inst_f32, inst_i32=inst_i32, tmpl=tmpl)


def _use_walk(cfg: RenderConfig, n_inst: int) -> bool:
    """``pallas_engine._use_walk``: the LBVH walk for ``"bvh"``, or for
    ``"auto"`` above 256 instances; the candidate-list cull otherwise."""
    return cfg.pallas_traversal == "bvh" or (
        cfg.pallas_traversal == "auto" and n_inst > 256)


@torch.no_grad()
def prepare_cast(scene: Scene, geom: WorldGeometry,
                 cfg: RenderConfig) -> CastData:
    """The scalar kernels' run-time data (``prepare_pallas_cast``): the
    tables (with ``box_exact_uv`` under ``edge_aware_grads``; textured box
    meshes on the template loop under ``texture_mapping``), plus the LBVH
    nodes when ``_use_walk`` picks the walk (the cull reads the tables
    only).  Runs under ``no_grad``, the counterpart of the
    JAX package's ``stop_gradient(scene)``: the tables are written in place
    and never join a graph, since the casts' gradients come from their VJP
    rules.  The MXU kernel has its own data (``mxu.prepare_mxu_cast``)."""
    if cfg.pallas_kernel != "scalar":
        raise ValueError(f"prepare_cast builds the scalar kernels' data, not "
                         f"pallas_kernel={cfg.pallas_kernel!r}")
    tables = build_tables(scene, geom, exact_uv=cfg.edge_aware_grads,
                          box_exact_uv=cfg.edge_aware_grads,
                          texture_mapping=cfg.texture_mapping)
    if not _use_walk(cfg, scene.inst_pos.shape[0]):
        return CastData(tables=tables)
    lbvh = build_lbvh(geom.aabb_min, geom.aabb_max)
    total = 2 * lbvh.n_leaves - 1
    nodes = torch.zeros(total, _NODE_WIDTH, dtype=torch.float32,
                        device=geom.aabb_min.device)
    nodes[:, 0:3] = lbvh.box_min
    nodes[:, 3:6] = lbvh.box_max
    nodes[:, 6] = lbvh.valid.to(torch.float32)
    return CastData(tables=tables, nodes=nodes, ordering=lbvh.ordering)


# ---------------------------------------------------------------------------
# plain versions (batched torch; the CPU path and the kernels' oracle)
# ---------------------------------------------------------------------------

def _ray_recips(d):
    """Safe reciprocal directions: only EXACT zeros count as parallel."""
    par = [d[:, k] == 0.0 for k in range(3)]
    inv = [1.0 / torch.where(par[k], 1.0, d[:, k]) for k in range(3)]
    return par, inv


def _slab_terms(box, o, inv, par):
    """Per-axis slab times against ``box`` (last axis: min xyz, max xyz;
    one box ``[6+]`` or one per ray ``[R, 6+]``); parallel axes are
    unconstrained but require the origin inside that slab."""
    tns, tfs = [], []
    inside = None
    for k in range(3):
        lo, hi = box[..., k], box[..., k + 3]
        t1 = (lo - o[k]) * inv[k]
        t2 = (hi - o[k]) * inv[k]
        tns.append(torch.where(par[k], F32_NEG_BIG, torch.minimum(t1, t2)))
        tfs.append(torch.where(par[k], F32_BIG, torch.maximum(t1, t2)))
        ins = ~par[k] | ((o[k] >= lo) & (o[k] <= hi))
        inside = ins if inside is None else inside & ins
    return tns, tfs, inside


def _max3(x):
    return torch.maximum(torch.maximum(x[0], x[1]), x[2])


def _min3(x):
    return torch.minimum(torch.minimum(x[0], x[1]), x[2])


def _quat_rotate_tile(q, v):
    """Rotate per-ray vectors ``v`` (3 tensors) by a quaternion ``q`` (4
    scalars, or 4 per-ray tensors), in ``pallas_engine._quat_rotate_tile``'s
    order."""
    qx, qy, qz, qw = q
    vx, vy, vz = v
    n2 = qx * qx + qy * qy + qz * qz + qw * qw
    s = torch.where(n2 > 1e-12, 1.0 / n2, 0.0)
    xx, yy, zz = 2 * qx * qx * s, 2 * qy * qy * s, 2 * qz * qz * s
    wx, wy, wz = 2 * qw * qx * s, 2 * qw * qy * s, 2 * qw * qz * s
    xy, xz, yz = 2 * qx * qy * s, 2 * qx * qz * s, 2 * qy * qz * s
    rx = (1 - (yy + zz)) * vx + (xy - wz) * vy + (xz + wy) * vz
    ry = (xy + wz) * vx + (1 - (xx + zz)) * vy + (yz - wx) * vz
    rz = (xz - wy) * vx + (yz + wx) * vy + (1 - (xx + yy)) * vz
    return rx, ry, rz


def _box_face_hit(tns, tfs, inside, d, inst_f, inst_i, with_face=False):
    """Closest hit of an axis-aligned box from its slab times: the entry
    face, or the exit face from inside.  ``inst_f``/``inst_i`` are one
    instance's rows or one row per ray.  Returns ``(ok, t, wtri, normal
    [R,3])``, and the face ``axis * 2 + side_hi`` after them when
    ``with_face``; ties pick x, then y, then z."""
    t_entry = _max3(tns)
    t_exit = _min3(tfs)
    hit_box = (t_entry <= t_exit) & inside
    is_entry = t_entry >= rm.THRESHOLD
    t_hit = torch.where(is_entry, t_entry, t_exit)
    ok = hit_box & (t_hit >= rm.THRESHOLD)

    tx = torch.where(is_entry, tns[0], tfs[0])
    ty = torch.where(is_entry, tns[1], tfs[1])
    ax_x = tx == t_hit
    ax_y = ~ax_x & (ty == t_hit)
    dsel = torch.where(ax_x, d[0], torch.where(ax_y, d[1], d[2]))
    side_hi = (dsel >= 0.0) ^ is_entry
    axis = torch.where(ax_x, 0, torch.where(ax_y, 1, 2))
    face = axis * 2 + side_hi.long()
    face_w = inst_i[..., _II_FACE_WTRI:_II_FACE_WTRI + 6]
    fnrm = inst_f[..., _IF_FNRM:_IF_FNRM + 18]
    if inst_i.dim() == 1:  # one instance for every ray
        out = ok, t_hit, face_w[face], fnrm.reshape(6, 3)[face]
    else:
        rows = torch.arange(face.shape[0], device=face.device)
        out = (ok, t_hit, face_w[rows, face],
               fnrm.reshape(-1, 6, 3)[rows, face])
    return out + (face,) if with_face else out


def _signed_bary(row, h):
    """Signed barycentrics ``(u, v)`` (the b and c weights) of the
    instance-local points ``h`` against template rows ``[R, 32]``:
    ``((h - a) x (c - a)).n / |n_raw|`` and ``((b - a) x (h - a)).n /
    |n_raw|`` -- ``bary`` of ``pallas_engine._intersect_instance``."""
    a = [row[:, _TF_A + k] for k in range(3)]
    b = [row[:, _TF_B + k] for k in range(3)]
    c = [row[:, _TF_C + k] for k in range(3)]
    n = [row[:, _TF_PNU + k] for k in range(3)]
    area = row[:, _TF_AREA]
    inv = 1.0 / torch.maximum(area, area.new_tensor(1e-20))
    pa = [h[k] - a[k] for k in range(3)]
    ca = [c[k] - a[k] for k in range(3)]
    ba = [b[k] - a[k] for k in range(3)]
    u = ((pa[1] * ca[2] - pa[2] * ca[1]) * n[0]
         + (pa[2] * ca[0] - pa[0] * ca[2]) * n[1]
         + (pa[0] * ca[1] - pa[1] * ca[0]) * n[2]) * inv
    v = ((ba[1] * pa[2] - ba[2] * pa[1]) * n[0]
         + (ba[2] * pa[0] - ba[0] * pa[2]) * n[1]
         + (ba[0] * pa[1] - ba[1] * pa[0]) * n[2]) * inv
    return u, v


def _box_exact_uv(inst_f, inst_i, tmpl, o, d, t_hit, face):
    """The ``exact_uv`` branch of the box fast path for rays hitting
    ``face`` at ``t_hit`` (one instance's rows, or one row per ray): the
    local hit point ``o + t d - pos``, the signed barycentrics against the
    face's two triangles, and the first unless only the second contains
    the hit.  Returns ``(u, v, wtri)`` per ray."""
    h = [o[k] + t_hit * d[k] - inst_f[..., _IF_POS + k] for k in range(3)]
    base = inst_i[..., _II_TMPL_START] - inst_i[..., _II_WTRI_START]
    w1 = inst_i[..., _II_FACE_WTRI:_II_FACE_WTRI + 6]
    w2 = inst_i[..., _II_FACE_WTRI2:_II_FACE_WTRI2 + 6]
    if inst_i.dim() == 1:
        w1, w2 = w1[face], w2[face]
    else:
        rows = torch.arange(face.shape[0], device=face.device)
        w1, w2 = w1[rows, face], w2[rows, face]
    last = tmpl.shape[0] - 1
    u1, v1 = _signed_bary(tmpl[torch.clamp(w1 + base, 0, last).long()], h)
    u2, v2 = _signed_bary(tmpl[torch.clamp(w2 + base, 0, last).long()], h)
    hi = 1.0 + BARY_EPS
    in1 = (u1 >= -BARY_EPS) & (v1 >= -BARY_EPS) & (u1 + v1 <= hi)
    in2 = (u2 >= -BARY_EPS) & (v2 >= -BARY_EPS) & (u2 + v2 <= hi)
    use2 = ~in1 & in2
    return (torch.where(use2, u2, u1), torch.where(use2, v2, v1),
            torch.where(use2, w2, w1))


def _template_tri(row, lo, ld):
    """Plane + barycentric-area test of one template triangle (a row
    ``[32]``, or one per ray ``[R, 32]``) in the instance frame.  Returns
    ``(ok_geom, tt, b0, b1, b2)``; the caller adds its own ``tt`` bound."""
    a = [row[..., _TF_A + k] for k in range(3)]
    b = [row[..., _TF_B + k] for k in range(3)]
    c = [row[..., _TF_C + k] for k in range(3)]
    n = [row[..., _TF_PNU + k] for k in range(3)]
    area = row[..., _TF_AREA]
    denom = ld[0] * n[0] + ld[1] * n[1] + ld[2] * n[2]
    plane_ok = torch.abs(denom) >= rm.THRESHOLD
    tt = ((a[0] - lo[0]) * n[0] + (a[1] - lo[1]) * n[1]
          + (a[2] - lo[2]) * n[2]) / torch.where(plane_ok, denom, 1.0)
    h = [lo[k] + tt * ld[k] for k in range(3)]
    inv_area = 1.0 / torch.where(area > 0.0, area, 1.0)

    def edge_area(p0, p1):
        ex = p0[1] * p1[2] - p0[2] * p1[1]
        ey = p0[2] * p1[0] - p0[0] * p1[2]
        ez = p0[0] * p1[1] - p0[1] * p1[0]
        return torch.sqrt(ex * ex + ey * ey + ez * ez)

    ch = [c[k] - h[k] for k in range(3)]
    bh = [b[k] - h[k] for k in range(3)]
    ah = [a[k] - h[k] for k in range(3)]
    b0 = edge_area(ch, bh) * inv_area
    b1 = edge_area(ch, ah) * inv_area
    b2 = edge_area(ah, bh) * inv_area
    inside_t = torch.abs(b0 + b1 + b2 - 1.0) <= rm.THRESHOLD
    ok = plane_ok & inside_t & (area > 0.0) & (tt >= rm.THRESHOLD)
    return ok, tt, b0, b1, b2


def _to_local(inst_f, o, d):
    """Ray into the instance frame (one instance row, or one per ray):
    o' = q (o - p), d' = q d."""
    p = [inst_f[..., _IF_POS + k] for k in range(3)]
    q = [inst_f[..., _IF_QUAT + k] for k in range(4)]
    lo = _quat_rotate_tile(q, [o[k] - p[k] for k in range(3)])
    ld = _quat_rotate_tile(q, d)
    return q, lo, ld


def _leaves(data: CastData):
    """Every leaf ``(flat, instance)`` in walk order, on the host (one
    device read per call); the instance is -1 where the leaf is padding or
    its node is not valid."""
    n = data.n_leaves
    order = data.ordering.cpu().tolist()
    ok = (data.nodes[:n, 6] > 0.0).cpu().tolist()
    return [(f, order[f] if ok[f] else -1) for f in range(n - 1, -1, -1)]


# Per-ray work counts the plain versions add into when handed a ``work``
# tensor (int64 ``[R, len(WORK_COLUMNS)]``), one column each: slab tests
# (tree nodes or instance boxes), box-face evaluations, template instances
# entered (the ray taken into the instance frame), template triangle tests,
# and box-face hits that took the closest-hit update, each of which runs
# the exact_uv branch's two barycentric evaluations under ``exact_uv``.  They are what the kernels do
# for these rays; chip_smoke.py reads them for the bounds.
WORK_COLUMNS = ("slab", "box", "inst", "tri", "exact")


def _slab_vote(row, o, inv, par):
    """``(tmin, slab_ok)`` of a node or instance box: the slab interval is
    not empty, ends at or after THRESHOLD, and a parallel axis holds the
    origin."""
    tns, tfs, inside = _slab_terms(row, o, inv, par)
    tmin = _max3(tns)
    tmax = _min3(tfs)
    return tmin, (tmin <= tmax) & (tmax >= rm.THRESHOLD) & inside


class _WalkVisits:
    """The per-thread stackless walk's node visits, taken in the plain
    versions' leaf loop: the rays that reach each leaf, and (into ``work``)
    the slab tests.  A walk visits a node iff every ancestor voted
    and the walk has not ended; a node's vote reads the state (best t,
    blocked) the leaves before it in preorder left, which is the state the
    leaf loop holds before the node's leftmost leaf.  The leaves of the
    implicit heap all sit at one depth (``n_leaves`` is a power of two), so
    preorder visits them by falling flat index."""

    def __init__(self, data: CastData, work: Optional[torch.Tensor]):
        n = data.n_leaves
        if n & (n - 1):
            raise ValueError(f"{n} leaves: the heap needs a power of two")
        self.n, self.total, self.nodes = n, 2 * n - 1, data.nodes
        self.work = work  # None: the visits are not counted
        self.go = {}  # internal node -> rays that visited it and voted

    def enter_leaf(self, flat: int, vote, ended):
        """Visit the nodes whose leftmost leaf is ``flat``, top-down, the
        leaf last; ``vote(row)`` is a node's vote under the current state
        and ``ended`` the rays whose walk is over.  Returns the rays that
        visit the leaf."""
        v = self.total - flat
        depth = (v & -v).bit_length() - 1  # left-child steps above the leaf
        for s in range(depth, -1, -1):
            u = v >> s
            if u == 1:
                seen = ~ended
            else:  # a right child is its parent's last use
                up = self.go.pop(u >> 1) if u & 1 else self.go[u >> 1]
                seen = up & ~ended
            if self.work is not None:
                self.work[:, 0] += seen
            if u < self.n:
                self.go[u] = seen & vote(self.nodes[self.total - u])
        return seen


def bvh_cast_reference(ro: torch.Tensor, rd: torch.Tensor,
                       data: CastData, *, exact_uv: bool = False,
                       work: Optional[torch.Tensor] = None) -> Hit:
    """Plain version of K1: closest hit for rays ``[R, 3]``; ``exact_uv``:
    the box fast path's true triangle and barycentrics.  ``work``: see
    ``WORK_COLUMNS``."""
    R = ro.shape[0]
    dev = ro.device
    f32 = torch.float32
    o = [ro[:, k] for k in range(3)]
    d = [rd[:, k] for k in range(3)]
    par, inv = _ray_recips(rd)
    inst_f, inst_i, tmpl = (data.tables.inst_f32, data.tables.inst_i32,
                            data.tables.tmpl)
    is_box = (inst_i[:, _II_IS_BOX] > 0).cpu().tolist()
    tri_info = inst_i[:, [_II_TMPL_START, _II_TRI_COUNT,
                          _II_WTRI_START]].cpu().tolist()

    bt = torch.full((R,), float("inf"), dtype=f32, device=dev)
    btri = torch.zeros(R, dtype=torch.int32, device=dev)
    bu = torch.zeros(R, dtype=f32, device=dev)
    bv = torch.zeros(R, dtype=f32, device=dev)
    bn = [torch.zeros(R, dtype=f32, device=dev),
          torch.zeros(R, dtype=f32, device=dev),
          torch.ones(R, dtype=f32, device=dev)]
    bmat = torch.zeros(R, dtype=torch.int32, device=dev)

    walk = None if work is None else _WalkVisits(data, work)
    never = torch.zeros(R, dtype=torch.bool, device=dev)

    def vote(row):  # a node's vote under the current best
        tmin, ok = _slab_vote(row, o, inv, par)
        return ok & (tmin < bt) & (row[6] > 0.0)

    for flat, i in _leaves(data):
        seen = walk.enter_leaf(flat, vote, never) if walk else None
        if i < 0:
            continue
        tns, tfs, inside = _slab_terms(data.nodes[flat], o, inv, par)
        tmin = _max3(tns)
        tmax = _min3(tfs)
        gate = ((tmin <= tmax) & (tmax >= rm.THRESHOLD) & (tmin < bt)
                & inside)
        if walk:
            work[:, 1 if is_box[i] else 2] += seen & gate
        if is_box[i]:
            ok, t_hit, wtri, nrm, face = _box_face_hit(
                tns, tfs, inside, d, inst_f[i], inst_i[i], with_face=True)
            ok = gate & ok & (t_hit < bt)
            if walk:
                work[:, 4] += seen & ok
            bt = torch.where(ok, t_hit, bt)
            btri = torch.where(ok, wtri, btri)
            bu = torch.where(ok, 1.0 / 3.0, bu)
            bv = torch.where(ok, 1.0 / 3.0, bv)
            bn = [torch.where(ok, nrm[:, k], bn[k]) for k in range(3)]
            bmat = torch.where(ok, inst_i[i, _II_MAT], bmat)
            if exact_uv:
                u, v, w = _box_exact_uv(inst_f[i], inst_i[i], tmpl, o, d,
                                        t_hit, face)
                bu = torch.where(ok, u, bu)
                bv = torch.where(ok, v, bv)
                btri = torch.where(ok, w, btri)
            continue
        q, lo, ld = _to_local(inst_f[i], o, d)
        qc = (-q[0], -q[1], -q[2], q[3])
        tmpl_start, tri_count, wtri_start = tri_info[i]
        if walk:
            work[:, 3] += (seen & gate) * tri_count
        for j in range(tri_count):
            row = tmpl[tmpl_start + j]
            ok, tt, b0, b1, b2 = _template_tri(row, lo, ld)
            ok = gate & ok & (tt < bt)
            sn = [b0 * row[_TF_NA + k] + b1 * row[_TF_NB + k]
                  + b2 * row[_TF_NC + k] for k in range(3)]
            wn = _quat_rotate_tile(qc, sn)
            bt = torch.where(ok, tt, bt)
            btri = torch.where(ok, wtri_start + j, btri)
            bu = torch.where(ok, b1, bu)
            bv = torch.where(ok, b2, bv)
            bn = [torch.where(ok, wn[k], bn[k]) for k in range(3)]
            bmat = torch.where(ok, row[_TF_MAT].to(torch.int32), bmat)

    # re-normalize the interpolated normal once (reference fix_isect)
    nlen = torch.sqrt(bn[0] * bn[0] + bn[1] * bn[1] + bn[2] * bn[2])
    ninv = 1.0 / torch.clamp(nlen, min=rm.THRESHOLD)
    return Hit(
        valid=torch.isfinite(bt),
        t=bt,
        wtri=btri,
        uv=torch.stack([bu, bv], dim=-1),
        normal=torch.stack([bn[k] * ninv for k in range(3)], dim=-1),
        mat=bmat,
    )


def k1_walk_replay(ro: torch.Tensor, rd: torch.Tensor, data: CastData, *,
                   exact_uv: bool = False):
    """K1's walk as its kernel runs it (``csrc/bvh_kernels.cu``), every ray
    one step at a time: a step tests both children of the node the ray
    entered; two leaves go through their own gates in preorder; of two
    inner children that both vote, the left is entered and the right's
    vote is kept for later; with nothing to enter the ray pops to the
    deepest right child kept.  Leaf updates are the plain versions'
    (``cull._closest_update``).  Returns ``(Hit, visits, stale)``:
    ``visits`` [R] the node boxes each ray's walk tests (the kernel's
    ``visits_out``: the root, then two a step), ``stale`` [R] the pops to a
    kept right child whose own vote fails when the walk gets there (each
    costs the walk two tests that the per-thread walk of ``_WalkVisits``
    does not make, so ``visits = _WalkVisits + 2 stale``)."""
    from .cull import _Best, _closest_update

    n, tab = data.n_leaves, data.tables
    total = 2 * n - 1
    R = ro.shape[0]
    o = [ro[:, k] for k in range(3)]
    d = [rd[:, k] for k in range(3)]
    par, inv = _ray_recips(rd)
    max_tris = int(tab.inst_i32[:, _II_TRI_COUNT].max())
    any_tmpl = bool((tab.inst_i32[:, _II_IS_BOX] == 0).any())
    best = _Best(R, ro.device)

    def gate(u):
        row = data.nodes[(total - u).clamp(0, total - 1)]
        tns, tfs, inside = _slab_terms(row, o, inv, par)
        tmin, tmax = _max3(tns), _min3(tfs)
        ok = ((tmin <= tmax) & (tmax >= rm.THRESHOLD) & inside
              & (row[:, 6] > 0.0))
        return tns, tfs, inside, tmin, ok

    def leaf(u, g, lanes):
        tns, tfs, inside, tmin, ok = g
        inst = data.ordering[(total - u).clamp(0, n - 1)].long()
        go = lanes & ok & (tmin < best.t) & (inst >= 0)
        i = inst.clamp(min=0)
        _closest_update(best, tab.inst_f32[i], tab.inst_i32[i], go, tns, tfs,
                        inside, o, d, tab.tmpl, max_tris, any_tmpl,
                        exact_uv=exact_uv)

    one = torch.ones(R, dtype=torch.long, device=ro.device)
    g = gate(one)
    visits = one.clone()
    stale = torch.zeros_like(one)
    if n == 1:
        leaf(one, g, one > 0)
        return best.hit(), visits, stale
    v = torch.where(g[4] & (g[3] < best.t), one, 0)
    depth = torch.zeros_like(one)
    pend = torch.zeros_like(one)
    while bool((v > 0).any()):
        live = v > 0
        visits += 2 * live
        c = 2 * v
        g0, g1 = gate(c), gate(c + 1)
        leaves = live & (c >= n)
        leaf(c, g0, leaves)
        leaf(c + 1, g1, leaves)
        inner = live & ~leaves
        go0 = inner & g0[4] & (g0[3] < best.t)
        go1 = inner & g1[4] & (g1[3] < best.t)
        down = go0 | go1
        pend = torch.where(go0 & go1, pend | (1 << (depth + 1)), pend)
        pop = live & ~down & (pend > 0)
        # the deepest kept right child: pend's highest bit (frexp is exact)
        top = torch.frexp(pend.clamp(min=1).double()).exponent.long() - 1
        right = (v >> (depth - top).clamp(min=0)) | 1
        rg = gate(right)  # the kept vote, taken again under today's best
        stale += pop & ~(rg[4] & (rg[3] < best.t))
        v = torch.where(down, torch.where(go0, c, c + 1),
                        torch.where(pop, right, torch.where(live, 0, v)))
        depth = torch.where(down, depth + 1, torch.where(pop, top, depth))
        pend = torch.where(pop, pend & ~(1 << top), pend)
    return best.hit(), visits, stale


def _occlude_rows(f, ii, tmpl, gate, tns, tfs, inside, o, d, max_t,
                  max_tris: int, any_tmpl: bool, work=None):
    """``_occlude_instance`` for rays ``[R]`` each against its own instance
    (table rows ``f [R, 40]``, ``ii [R, 24]``) where ``gate`` (its box
    test, the prune included) passed; ``tns, tfs, inside``: the slab terms
    of the box that gate read.  Returns the rays it blocks within
    ``[THRESHOLD, max_t]``.  ``work``: the triangle tests go to its ``tri``
    column (the loop stops at the first block)."""
    is_box = ii[:, _II_IS_BOX] > 0
    tmin, tmax = _max3(tns), _min3(tfs)
    t_hit = torch.where(tmin >= rm.THRESHOLD, tmin, tmax)
    blk = (gate & is_box & (tmin <= tmax) & inside & (t_hit >= rm.THRESHOLD)
           & (t_hit <= max_t))
    if not any_tmpl:
        return blk
    _, lo, ld = _to_local(f, o, d)
    start = ii[:, _II_TMPL_START]
    count = ii[:, _II_TRI_COUNT]
    tgate = gate & ~is_box
    for j in range(max_tris):
        if work is not None:
            work[:, 3] += tgate & (j < count) & ~blk
        row = tmpl[torch.clamp(start + j, max=tmpl.shape[0] - 1).long()]
        tok, tt, _, _, _ = _template_tri(row, lo, ld)
        blk = blk | (tgate & (j < count) & tok & (tt <= max_t))
    return blk


def occlude_walk_replay(ro: torch.Tensor, rd: torch.Tensor,
                        max_t: torch.Tensor, data: CastData):
    """K2's and K3's walk as their kernels run it (``csrc/bvh_kernels.cu``
    ``occlude_walk``), every ray one step at a time: a step tests both
    children of the node the ray entered; two leaves go through their
    instances left first, and a block ends the walk; of two inner children
    that both vote, the left is entered and the right's vote kept (it never
    goes stale: max_t is fixed); with nothing to enter the ray pops to the
    deepest right child kept.  Returns ``(blocked, visits, first)``, each
    ``[R]``: ``blocked`` equals the plain version's mask,
    ``visits`` counts the node boxes the walk tests (the root, then two a
    step), ``first`` is 1 where the first instance the ray tests blocks it,
    0 where it does not, -1 where the ray tests none."""
    n, tab = data.n_leaves, data.tables
    total = 2 * n - 1
    R = ro.shape[0]
    o = [ro[:, k] for k in range(3)]
    d = [rd[:, k] for k in range(3)]
    par, inv = _ray_recips(rd)
    max_tris = int(tab.inst_i32[:, _II_TRI_COUNT].max())
    any_tmpl = bool((tab.inst_i32[:, _II_IS_BOX] == 0).any())
    blk = torch.zeros(R, dtype=torch.bool, device=ro.device)
    first = torch.full((R,), -1, dtype=torch.long, device=ro.device)

    def gate(u):
        row = data.nodes[(total - u).clamp(0, total - 1)]
        tns, tfs, inside = _slab_terms(row, o, inv, par)
        tmin, tmax = _max3(tns), _min3(tfs)
        go = ((tmin <= tmax) & (tmax >= rm.THRESHOLD) & (tmin <= max_t)
              & inside & (row[:, 6] > 0.0))
        return tns, tfs, inside, tmin, go

    def leaf(u, g, lanes):
        nonlocal blk, first
        tns, tfs, inside, _, go = g
        inst = data.ordering[(total - u).clamp(0, n - 1)].long()
        test = lanes & go & (inst >= 0)
        i = inst.clamp(min=0)
        b = _occlude_rows(tab.inst_f32[i], tab.inst_i32[i], tab.tmpl, test,
                          tns, tfs, inside, o, d, max_t, max_tris, any_tmpl)
        first = torch.where(test & (first < 0), b.long(), first)
        blk = blk | b
        return b

    one = torch.ones(R, dtype=torch.long, device=ro.device)
    g = gate(one)
    visits = one.clone()
    if n == 1:
        leaf(one, g, one > 0)
        return blk, visits, first
    v = torch.where(g[4], one, 0)
    depth = torch.zeros_like(one)
    pend = torch.zeros_like(one)
    while bool((v > 0).any()):
        live = v > 0
        visits += 2 * live
        c = 2 * v
        g0, g1 = gate(c), gate(c + 1)
        leaves = live & (c >= n)
        blocked = leaf(c, g0, leaves)
        blocked = blocked | leaf(c + 1, g1, leaves & ~blocked)
        inner = live & ~leaves
        go0, go1 = inner & g0[4], inner & g1[4]
        down = go0 | go1
        pend = torch.where(go0 & go1, pend | (1 << (depth + 1)), pend)
        pop = live & ~down & ~blocked & (pend > 0)
        # the deepest kept right child: pend's highest bit (frexp is exact)
        top = torch.frexp(pend.clamp(min=1).double()).exponent.long() - 1
        right = (v >> (depth - top).clamp(min=0)) | 1
        v = torch.where(down, torch.where(go0, c, c + 1),
                        torch.where(pop, right, torch.where(live, 0, v)))
        depth = torch.where(down, depth + 1, torch.where(pop, top, depth))
        pend = torch.where(pop, pend & ~(1 << top), pend)
    return blk, visits, first


def _occlude_reference(queries, data: CastData,
                       work: Optional[torch.Tensor] = None):
    """Any-hit queries (a list of ``(ro [R,3], rd [R,3], max_t [R])``) over
    the leaves in walk order, one shared leaf loop.  A query is blocked iff
    a leaf that its walk reaches (every ancestor votes: the slab test
    passes, its entry at most max_t) has a hit with ``THRESHOLD <= t <=
    max_t``.  A leaf whose own gate passes has ancestors that pass too,
    since a node's box holds its children's, except where 0 * inf makes an
    ancestor's slab NaN (an origin on its plane, a direction component
    whose reciprocal overflows) and the leaf's gives a box hit at t = +inf,
    which counts only under max_t = +inf: that leaf is not reached, by the
    kernels' walks or here.  Returns one bool ``[R]`` per query.
    ``work``: see ``WORK_COLUMNS``, summed over the queries' own walks
    (each ends at its first block, as K2 runs one walk a query)."""
    inst_f, inst_i, tmpl = (data.tables.inst_f32, data.tables.inst_i32,
                            data.tables.tmpl)
    is_box = (inst_i[:, _II_IS_BOX] > 0).cpu().tolist()
    tri_info = inst_i[:, [_II_TMPL_START, _II_TRI_COUNT]].cpu().tolist()
    qs = []
    for ro, rd, mt in queries:
        par, inv = _ray_recips(rd)
        qs.append(dict(o=[ro[:, k] for k in range(3)],
                       d=[rd[:, k] for k in range(3)], mt=mt,
                       par=par, inv=inv, walk=_WalkVisits(data, work),
                       blk=torch.zeros(ro.shape[0], dtype=torch.bool,
                                       device=ro.device)))

    def vote(qy):  # a node's vote for query qy while it is not blocked
        def of(row):
            tmin, ok = _slab_vote(row, qy["o"], qy["inv"], qy["par"])
            return ok & ~qy["blk"] & (tmin <= qy["mt"]) & (row[6] > 0.0)
        return of

    for flat, i in _leaves(data):
        seen = [qy["walk"].enter_leaf(flat, vote(qy), qy["blk"])
                for qy in qs]
        if i < 0:
            continue
        for qy, reached in zip(qs, seen):
            o, d, mt, blk = qy["o"], qy["d"], qy["mt"], qy["blk"]
            tns, tfs, inside = _slab_terms(data.nodes[flat], o, qy["inv"],
                                           qy["par"])
            tmin = _max3(tns)
            tmax = _min3(tfs)
            active = (reached & (tmin <= tmax) & (tmax >= rm.THRESHOLD)
                      & (tmin <= mt) & inside)
            if work is not None:
                work[:, 1 if is_box[i] else 2] += active
            if is_box[i]:
                # blocked iff the slab hit time lands in [THRESHOLD, max_t]
                t_hit = torch.where(tmin >= rm.THRESHOLD, tmin, tmax)
                blk = blk | (active & (tmin <= tmax) & inside
                             & (t_hit >= rm.THRESHOLD) & (t_hit <= mt))
            else:
                _, lo, ld = _to_local(inst_f[i], o, d)
                tmpl_start, tri_count = tri_info[i]
                for j in range(tri_count):
                    if work is not None:  # the loop stops at the first block
                        work[:, 3] += active & ~blk
                    ok, tt, _, _, _ = _template_tri(tmpl[tmpl_start + j],
                                                    lo, ld)
                    blk = blk | (active & ok & (tt <= mt))
            qy["blk"] = blk
    return [qy["blk"] for qy in qs]


def bvh_occlude_reference(ro, rd, max_t, data: CastData, *,
                          work: Optional[torch.Tensor] = None):
    """Plain version of K3: bool ``[R]``, blocked iff some hit has
    ``THRESHOLD <= t <= max_t``."""
    (blk,) = _occlude_reference([(ro, rd, max_t)], data, work)
    return blk


def bvh_occlude2_reference(o1, d1, mt1, o2, d2, mt2, data: CastData, *,
                           work: Optional[torch.Tensor] = None):
    """Plain version of K2: ``(blocked1, blocked2)`` bool ``[R]``, each
    equal to :func:`bvh_occlude_reference` of its query."""
    b1, b2 = _occlude_reference([(o1, d1, mt1), (o2, d2, mt2)], data, work)
    return b1, b2


# ---------------------------------------------------------------------------
# wrappers: the kernel for CUDA tensors, the plain version for CPU tensors
# ---------------------------------------------------------------------------

def _check(name, x, dtype, shape, device):
    if x.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(x.shape)}")
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, rays on {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_tables(t: SceneTables, device):
    n_inst = t.inst_f32.shape[0]
    _check("inst_f32", t.inst_f32, torch.float32, (n_inst, _IF_WIDTH), device)
    _check("inst_i32", t.inst_i32, torch.int32, (n_inst, _II_WIDTH), device)
    _check("tmpl", t.tmpl, torch.float32, (t.tmpl.shape[0], _TF_WIDTH),
           device)


def _check_data(data: CastData, device):
    """The tables and the LBVH, which the walk kernels read."""
    if data.nodes is None or data.ordering is None:
        raise ValueError("the LBVH walk needs CastData.nodes and .ordering "
                         "(prepare_cast leaves them out on the cull)")
    _check_tables(data.tables, device)
    n = data.n_leaves
    _check("nodes", data.nodes, torch.float32, (2 * n - 1, _NODE_WIDTH),
           device)
    if data.nodes.data_ptr() % 16:  # K2 and K3 load a row in 16-B pieces
        raise ValueError("nodes: must be 16-byte aligned")
    _check("ordering", data.ordering, torch.int32, (n,), device)


def _device_kind(x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    return x.device.type


def _ptr(x: torch.Tensor):
    return ctypes.c_void_p(x.data_ptr())


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def _k1(ro, rd, data: CastData, exact_uv: bool, visits):
    """Launches K1 on CUDA rays; ``visits``: an int32 ``[R]`` to count into,
    or None.  Returns the Hit."""
    from . import kernels

    R = ro.shape[0]
    _check_data(data, ro.device)
    dev = ro.device
    t = torch.empty(R, dtype=torch.float32, device=dev)
    wtri = torch.empty(R, dtype=torch.int32, device=dev)
    uv = torch.empty(R, 2, dtype=torch.float32, device=dev)
    normal = torch.empty(R, 3, dtype=torch.float32, device=dev)
    mat = torch.empty(R, dtype=torch.int32, device=dev)
    if R > 0:
        tab = data.tables
        err = kernels.library().rt_bvh_cast(
            _ptr(ro), _ptr(rd), R, _ptr(data.nodes), _ptr(data.ordering),
            data.n_leaves, _ptr(tab.inst_f32), _ptr(tab.inst_i32),
            _ptr(tab.tmpl), _ptr(t), _ptr(wtri), _ptr(uv), _ptr(normal),
            _ptr(mat), int(exact_uv), None if visits is None else _ptr(visits),
            dev.index, kernels.stream_handle(dev))
        _raise_on(err, "bvh_cast")
    return Hit(valid=torch.isfinite(t), t=t, wtri=wtri, uv=uv,
               normal=normal, mat=mat)


def _check_rays(ro, rd):
    R = ro.shape[0]
    _check("ro", ro, torch.float32, (R, 3), ro.device)
    _check("rd", rd, torch.float32, (R, 3), ro.device)
    return _device_kind(ro)


def bvh_cast(ro: torch.Tensor, rd: torch.Tensor, data: CastData, *,
             exact_uv: bool = False) -> Hit:
    """K1 (``_bvh_cast_kernel``): closest hit of rays ``[R, 3]`` f32;
    ``exact_uv`` takes the kernel's exact_uv instantiation (the box fast
    path's true triangle and barycentrics)."""
    if _check_rays(ro, rd) == "cpu":
        return bvh_cast_reference(ro, rd, data, exact_uv=exact_uv)
    hit = _k1(ro, rd, data, exact_uv, None)
    if ro.shape[0] > 0:
        bvh_cast.launches += 1
        bvh_cast.exact_uv_launches += int(exact_uv)
    return hit


bvh_cast.launches = 0  # every launch of K1's closest hit
bvh_cast.exact_uv_launches = 0  # of its exact_uv instantiation


def bvh_visit_counts(ro: torch.Tensor, rd: torch.Tensor,
                     data: CastData) -> torch.Tensor:
    """K1's ``visits_out`` (``cast.visit_counts`` of the JAX package, which
    counts per tile): int32 ``[R]``, the node boxes each ray's walk tests,
    from K1's visits instantiation (its hits are dropped).  On CPU tensors
    the plain version (:func:`bvh_visit_counts_reference`)."""
    if _check_rays(ro, rd) == "cpu":
        return bvh_visit_counts_reference(ro, rd, data)
    visits = torch.empty(ro.shape[0], dtype=torch.int32, device=ro.device)
    _k1(ro, rd, data, False, visits)
    if ro.shape[0] > 0:
        bvh_visit_counts.launches += 1
    return visits


bvh_visit_counts.launches = 0


def bvh_occlude(ro, rd, max_t, data: CastData):
    """K3 (``_bvh_occlude_kernel``): one any-hit query.  Rays ``[R, 3]``
    f32, ``max_t`` ``[R]`` f32.  Returns bool ``[R]``."""
    R = ro.shape[0]
    dev = ro.device
    _check("ro", ro, torch.float32, (R, 3), dev)
    _check("rd", rd, torch.float32, (R, 3), dev)
    _check("max_t", max_t, torch.float32, (R,), dev)
    if _device_kind(ro) == "cpu":
        return bvh_occlude_reference(ro, rd, max_t, data)
    _check_data(data, dev)
    from . import kernels

    blk = torch.empty(R, dtype=torch.bool, device=dev)
    if R > 0:
        tab = data.tables
        err = kernels.library().rt_bvh_occlude(
            _ptr(ro), _ptr(rd), _ptr(max_t), R, _ptr(data.nodes),
            _ptr(data.ordering), data.n_leaves, _ptr(tab.inst_f32),
            _ptr(tab.inst_i32), _ptr(tab.tmpl), _ptr(blk), dev.index,
            kernels.stream_handle(dev))
        _raise_on(err, "bvh_occlude")
        bvh_occlude.launches += 1
    return blk


bvh_occlude.launches = 0


def bvh_occlude2(o1, d1, mt1, o2, d2, mt2, data: CastData):
    """K2 (``_bvh_occlude2_kernel``): two any-hit queries over one walk.
    Rays ``[R, 3]`` f32, ``max_t`` ``[R]`` f32.  Returns two bool ``[R]``."""
    R = o1.shape[0]
    dev = o1.device
    for name, x in (("o1", o1), ("d1", d1), ("o2", o2), ("d2", d2)):
        _check(name, x, torch.float32, (R, 3), dev)
    _check("mt1", mt1, torch.float32, (R,), dev)
    _check("mt2", mt2, torch.float32, (R,), dev)
    if _device_kind(o1) == "cpu":
        return bvh_occlude2_reference(o1, d1, mt1, o2, d2, mt2, data)
    _check_data(data, dev)
    from . import kernels

    blk1 = torch.empty(R, dtype=torch.bool, device=dev)
    blk2 = torch.empty(R, dtype=torch.bool, device=dev)
    if R > 0:
        tab = data.tables
        err = kernels.library().rt_bvh_occlude2(
            _ptr(o1), _ptr(d1), _ptr(mt1), _ptr(o2), _ptr(d2), _ptr(mt2), R,
            _ptr(data.nodes), _ptr(data.ordering), data.n_leaves,
            _ptr(tab.inst_f32), _ptr(tab.inst_i32), _ptr(tab.tmpl),
            _ptr(blk1), _ptr(blk2), dev.index, kernels.stream_handle(dev))
        _raise_on(err, "bvh_occlude2")
        bvh_occlude2.launches += 1
    return blk1, blk2


bvh_occlude2.launches = 0


def bvh_march(origin, dir_unit, max_t, light_col, active, kt, steps: int,
              data: CastData) -> torch.Tensor:
    """The transmissive shadow march in one launch: K1's walk and
    ``shading.march_steps``' rules in one thread a lane (the kernel
    ``bvh_cast_kernel(MarchArgs, Tables)``).  ``origin`` ``[R, 3]`` f32,
    ``dir_unit`` ``[R, 3]`` or ``[3]`` (one direction for every lane),
    ``max_t`` ``[R]`` f32 or a float (``+inf`` for a directional light),
    ``active`` bool ``[R]``, ``light_col`` ``[4]``, the materials' ``kt``
    ``[K, 4]``.  Returns the light arriving, ``[R, 4]`` f32.  CUDA tensors
    only: the plain version is ``shading.march_steps`` over a cast."""
    R = origin.shape[0]
    dev = origin.device
    if _device_kind(origin) != "cuda":
        raise ValueError("bvh_march launches on CUDA tensors only (the "
                         "plain march is shading.march_steps)")
    _check("origin", origin, torch.float32, (R, 3), dev)
    per_lane = dir_unit.dim() == 2
    _check("dir_unit", dir_unit, torch.float32, (R, 3) if per_lane else (3,),
           dev)
    if isinstance(max_t, torch.Tensor):
        _check("max_t", max_t, torch.float32, (R,), dev)
        mt_ptr, mt_all = _ptr(max_t), 0.0
    else:
        mt_ptr, mt_all = None, float(max_t)
    _check("active", active, torch.bool, (R,), dev)
    _check("light_col", light_col, torch.float32, (4,), dev)
    _check("kt", kt, torch.float32, (kt.shape[0], 4), dev)
    _check_data(data, dev)
    from . import kernels

    rv = torch.empty(R, 4, dtype=torch.float32, device=dev)
    if R > 0:
        tab = data.tables
        err = kernels.library().rt_bvh_march(
            _ptr(origin), _ptr(dir_unit), 3 if per_lane else 0, mt_ptr,
            mt_all, _ptr(active), _ptr(light_col), _ptr(kt), int(steps), R,
            _ptr(data.nodes), _ptr(data.ordering), data.n_leaves,
            _ptr(tab.inst_f32), _ptr(tab.inst_i32), _ptr(tab.tmpl), _ptr(rv),
            dev.index, kernels.stream_handle(dev))
        _raise_on(err, "bvh_march")
        bvh_march.launches += 1
    return rv


bvh_march.launches = 0


def bvh_visit_counts_reference(ro, rd, data: CastData) -> torch.Tensor:
    """The plain version of K1's visit counts: int32 ``[R]``, the node
    boxes K1's walk tests (:func:`k1_walk_replay`)."""
    return k1_walk_replay(ro, rd, data)[1].to(torch.int32)


def make_cuda_cast(data: CastData, cfg: RenderConfig,
                   geo: Optional[torch.Tensor] = None, *, plain: bool) -> Cast:
    """The LBVH walk's :class:`Cast` under the autodiff rules of
    ``cast_vjp``: the reparam rule over the packed rows ``geo`` where given
    (``edge_aware_grads``, with K1's exact_uv branch), else the detached
    one.  ``plain`` calls the plain versions on any device; else the
    dispatching wrappers, and on CUDA tables the cast also has ``march``,
    the transmissive shadow march in one launch of :func:`bvh_march`
    (forward only).  The candidate-list cull has its own
    (``cull.make_cull_cast``; ``engine.make_cast`` picks)."""
    if data.nodes is None:
        raise ValueError("make_cuda_cast walks the LBVH: CastData without "
                         "nodes is the cull's (cull.make_cull_cast)")
    cast_k, occ_q, occ2_q, visits_k = (
        (bvh_cast_reference, bvh_occlude_reference, bvh_occlude2_reference,
         bvh_visit_counts_reference) if plain
        else (bvh_cast, bvh_occlude, bvh_occlude2, bvh_visit_counts))
    exact_uv = cfg.edge_aware_grads

    def cast_q(ro, rd, d):
        return cast_k(ro, rd, d, exact_uv=exact_uv)

    def closest(ro, rd):
        return closest_hit(cast_q, ro, rd, data, geo)

    def occlude(ro, rd, max_t):
        return occlude_detached(occ_q, ro, rd, max_t, data)

    def occlude2(o1, d1, mt1, o2, d2, mt2):
        return occlude2_detached(occ2_q, o1, d1, mt1, o2, d2, mt2, data)

    @torch.no_grad()
    def visit_counts(ro, rd):
        return visits_k(ro.contiguous(), rd.contiguous(), data)

    def march(origin, dir_unit, max_t, light_col, active, kt, steps):
        if isinstance(max_t, torch.Tensor):
            max_t = max_t.contiguous()
        return bvh_march(origin.contiguous(), dir_unit.contiguous(), max_t,
                         light_col.contiguous(), active.contiguous(),
                         kt.contiguous(), steps, data)

    return Cast(closest, occlude, occlude2, visit_counts=visit_counts,
                march=None if plain or not data.nodes.is_cuda else march)
