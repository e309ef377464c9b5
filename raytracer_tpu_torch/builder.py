"""Host-side retained-mode scene construction (numpy).

A copy of ``raytracer_tpu/builder.py``: the reference's ``SceneBuilder`` /
``MeshBuilder`` API surface (reference: include/scene_builder.h:29-117).
``finish()`` flattens everything into a :class:`~raytracer_tpu_torch.scene.Scene`
of numpy arrays; :func:`~raytracer_tpu_torch.scene.to_device` moves it to
torch tensors.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from .pngio import read_png_rgba_f32
from .scene import Camera, Lights, Materials, Scene

f32 = np.float32

IDENTITY_QUAT = np.array([0.0, 0.0, 0.0, 1.0], dtype=np.float32)


@dataclass
class Material:
    """Host-side Phong material (reference: include/rayprimitives/material.h:14-115).

    Defaults match the reference's default constructor (material.h:30): all colors
    zero, alpha=0, eta=1."""

    ke: np.ndarray = field(default_factory=lambda: np.zeros(4, dtype=np.float32))
    ka: np.ndarray = field(default_factory=lambda: np.zeros(4, dtype=np.float32))
    kd: np.ndarray = field(default_factory=lambda: np.zeros(4, dtype=np.float32))
    ks: np.ndarray = field(default_factory=lambda: np.zeros(4, dtype=np.float32))
    kt: np.ndarray = field(default_factory=lambda: np.zeros(4, dtype=np.float32))
    kr: np.ndarray = field(default_factory=lambda: np.zeros(4, dtype=np.float32))
    alpha: float = 0.0
    eta: float = 1.0

    def key(self) -> bytes:
        parts = [np.asarray(a, dtype=np.float32).tobytes() for a in
                 (self.ke, self.ka, self.kd, self.ks, self.kt, self.kr)]
        parts.append(np.float32(self.alpha).tobytes())
        parts.append(np.float32(self.eta).tobytes())
        return b"".join(parts)


@dataclass
class TextureCoords:
    """Per-triangle atlas rect; ``degenerate`` means untextured
    (reference: include/rayprimitives/texture_coords.h:12-29)."""

    texture_x: float = 0.0
    texture_y: float = 0.0
    u: float = 0.0
    v: float = 0.0
    degenerate: bool = True


@dataclass
class Transformation:
    """An instance: rigid frame + mesh index (reference: rayenv/transformation.h)."""

    hitable_idx: int
    pos: np.ndarray = field(default_factory=lambda: np.zeros(3, dtype=np.float32))
    rot: np.ndarray = field(default_factory=lambda: IDENTITY_QUAT.copy())

    def set_position(self, p) -> None:
        self.pos = np.asarray(p, dtype=np.float32)

    def set_orientation(self, q) -> None:
        self.rot = np.asarray(q, dtype=np.float32)


class MeshBuilder:
    def __init__(self, hitable_idx: int, pos=None, rot=None):
        self.hitable_idx = hitable_idx
        self.triangles: List[np.ndarray] = []
        self.coords: List[TextureCoords] = []
        self.mats: List[Material] = []
        self.pos = np.zeros(3, dtype=np.float32) if pos is None else np.asarray(pos, f32)
        self.rot = IDENTITY_QUAT.copy() if rot is None else np.asarray(rot, f32)

    def add_triangle(self, tri, coords: TextureCoords, mat: Material) -> None:
        self.triangles.append(np.asarray(tri, dtype=np.int32))
        self.coords.append(coords)
        self.mats.append(mat)


# Cube corner layout (reference: src/scene_builder.cu:181-204):
#
#    e-----f
#   /|    /|
#  a-----b |
#  | g---|-h
#  |/    |/
#  c-----d
_CUBE_CORNERS = {
    "a": (-0.5, 0.5, -0.5),
    "b": (0.5, 0.5, -0.5),
    "c": (-0.5, -0.5, -0.5),
    "d": (0.5, -0.5, -0.5),
    "e": (-0.5, 0.5, 0.5),
    "f": (0.5, 0.5, 0.5),
    "g": (-0.5, -0.5, 0.5),
    "h": (0.5, -0.5, 0.5),
}

# 12 triangles, winding per reference (src/scene_builder.cu:209-237).
_CUBE_TRIS = [
    ("d", "a", "b"), ("c", "a", "d"),  # front
    ("a", "e", "b"), ("e", "f", "b"),  # top
    ("d", "b", "h"), ("b", "f", "h"),  # right
    ("c", "g", "a"), ("a", "g", "e"),  # left
    ("g", "h", "e"), ("e", "h", "f"),  # back
    ("g", "c", "d"), ("d", "h", "g"),  # bottom
]


class SceneBuilder:
    """Retained-mode scene description; ``finish()`` emits the flat Scene pytree."""

    def __init__(self, atlas_path: Optional[str] = None):
        self.vertices: List[np.ndarray] = []
        self.meshes: List[MeshBuilder] = []
        self.point_light_pos: List[np.ndarray] = []
        self.point_light_col: List[np.ndarray] = []
        self.dir_light_dir: List[np.ndarray] = []
        self.dir_light_col: List[np.ndarray] = []
        self.trans: List[Transformation] = []
        self.atlas_path = atlas_path

    # ---- construction API (parity with scene_builder.h:69-114) -------------

    def add_vertex(self, v) -> int:
        idx = len(self.vertices)
        self.vertices.append(np.asarray(v, dtype=np.float32))
        return idx

    def create_mesh(self, pos=None, rot=None) -> int:
        hi = len(self.meshes)
        self.meshes.append(MeshBuilder(hi, pos, rot))
        return hi

    def get_mesh_builder(self, idx: int) -> MeshBuilder:
        return self.meshes[idx]

    def get_transformation(self, idx: int) -> Transformation:
        return self.trans[idx]

    def add_trans(self, builder: MeshBuilder) -> int:
        idx = len(self.trans)
        assert builder.hitable_idx < len(self.meshes)
        self.trans.append(Transformation(builder.hitable_idx))
        return idx

    def add_directional_light(self, direction, col) -> None:
        # DirLight::set_shine_dir normalizes (include/rayprimitives/cpu/light.h:52-54).
        d = np.asarray(direction, dtype=np.float32)
        ln = np.float32(np.sqrt(np.dot(d, d)))
        d = d / ln if ln > 1e-5 else np.zeros(3, f32)
        self.dir_light_dir.append(d.astype(np.float32))
        self.dir_light_col.append(np.asarray(col, dtype=np.float32))

    def add_point_light(self, pos, col) -> None:
        self.point_light_pos.append(np.asarray(pos, dtype=np.float32))
        self.point_light_col.append(np.asarray(col, dtype=np.float32))

    def build_cube(self, scale: float, coords: TextureCoords, mat: Material) -> int:
        """Emit a 12-triangle cube mesh with per-face duplicated vertices.

        Each triangle gets three *fresh* vertices (the reference calls
        ``add_vertex`` 36 times, src/scene_builder.cu:209-237), so the
        area-accumulated vertex normals reduce to flat face normals — cubes
        render faceted, which is load-bearing for image parity."""
        s = f32(scale)
        corners = {k: s * np.asarray(v, dtype=np.float32) for k, v in _CUBE_CORNERS.items()}
        mesh_idx = self.create_mesh()
        mb = self.get_mesh_builder(mesh_idx)
        for ca, cb, cc in _CUBE_TRIS:
            tri = [self.add_vertex(corners[ca]), self.add_vertex(corners[cb]),
                   self.add_vertex(corners[cc])]
            mb.add_triangle(tri, coords, mat)
        return mesh_idx

    # ---- flattening ----------------------------------------------------------

    def generate_normals(self) -> np.ndarray:
        """Area-weighted vertex normals (reference: src/scene_builder.cc:11-29):
        accumulate each face's *unit* normal onto its three vertices, then
        renormalize the sums."""
        verts = np.stack(self.vertices) if self.vertices else np.zeros((0, 3), f32)
        normals = np.zeros_like(verts)
        for mesh in self.meshes:
            for tri in mesh.triangles:
                a = verts[tri[1]] - verts[tri[0]]
                b = verts[tri[2]] - verts[tri[0]]
                n = np.cross(a, b).astype(np.float32)
                ln = np.float32(np.sqrt(np.dot(n, n)))
                n = n / ln if ln > 1e-5 else np.zeros(3, f32)
                for k in range(3):
                    normals[tri[k]] += n
        lens = np.sqrt((normals**2).sum(-1, keepdims=True))
        normals = np.where(lens > 1e-5, normals / np.maximum(lens, 1e-30), 0.0)
        return normals.astype(np.float32)

    def finish(self, default_atlas_shape: Tuple[int, int] = (1, 1)) -> Scene:
        verts = (np.stack(self.vertices).astype(np.float32)
                 if self.vertices else np.zeros((0, 3), f32))
        norms = self.generate_normals()

        # Flatten triangles + dedupe materials.
        tri_v, tri_mat, rects, degen = [], [], [], []
        mesh_tri_start, mesh_tri_count = [], []
        mat_table: List[Material] = []
        mat_index = {}
        for mesh in self.meshes:
            mesh_tri_start.append(len(tri_v))
            mesh_tri_count.append(len(mesh.triangles))
            for tri, coords, mat in zip(mesh.triangles, mesh.coords, mesh.mats):
                key = mat.key()
                if key not in mat_index:
                    mat_index[key] = len(mat_table)
                    mat_table.append(mat)
                tri_v.append(tri)
                tri_mat.append(mat_index[key])
                rects.append([coords.texture_x, coords.texture_y, coords.u, coords.v])
                degen.append(coords.degenerate)
        if not mat_table:
            mat_table.append(Material())

        T = len(tri_v)
        tri_v_arr = np.stack(tri_v).astype(np.int32) if T else np.zeros((0, 3), np.int32)

        mesh_pos = (np.stack([m.pos for m in self.meshes]).astype(np.float32)
                    if self.meshes else np.zeros((0, 3), f32))
        mesh_rot = (np.stack([m.rot for m in self.meshes]).astype(np.float32)
                    if self.meshes else np.zeros((0, 4), f32))
        starts = np.asarray(mesh_tri_start, dtype=np.int32)
        counts = np.asarray(mesh_tri_count, dtype=np.int32)

        # Mesh-local AABBs over referenced vertices.
        M = len(self.meshes)
        aabb_min = np.zeros((M, 3), f32)
        aabb_max = np.zeros((M, 3), f32)
        for i in range(M):
            idx = tri_v_arr[starts[i] : starts[i] + counts[i]].reshape(-1)
            if idx.size:
                vs = verts[idx]
                aabb_min[i] = vs.min(0)
                aabb_max[i] = vs.max(0)

        materials = Materials(
            ke=np.stack([m.ke for m in mat_table]).astype(np.float32),
            ka=np.stack([m.ka for m in mat_table]).astype(np.float32),
            kd=np.stack([m.kd for m in mat_table]).astype(np.float32),
            ks=np.stack([m.ks for m in mat_table]).astype(np.float32),
            kt=np.stack([m.kt for m in mat_table]).astype(np.float32),
            kr=np.stack([m.kr for m in mat_table]).astype(np.float32),
            alpha=np.asarray([m.alpha for m in mat_table], dtype=np.float32),
            eta=np.asarray([m.eta for m in mat_table], dtype=np.float32),
        )

        # Instances.
        N = len(self.trans)
        inst_pos = (np.stack([t.pos for t in self.trans]).astype(np.float32)
                    if N else np.zeros((0, 3), f32))
        inst_rot = (np.stack([t.rot for t in self.trans]).astype(np.float32)
                    if N else np.zeros((0, 4), f32))
        inst_mesh = np.asarray([t.hitable_idx for t in self.trans], dtype=np.int32)

        # World-triangle expansion maps (grouped by instance, contiguous).
        wtri_inst, wtri_tri = [], []
        for i, t in enumerate(self.trans):
            s, c = int(starts[t.hitable_idx]), int(counts[t.hitable_idx])
            wtri_inst.extend([i] * c)
            wtri_tri.extend(range(s, s + c))
        wtri_inst = np.asarray(wtri_inst, dtype=np.int32)
        wtri_tri = np.asarray(wtri_tri, dtype=np.int32)

        lights = Lights(
            point_pos=(np.stack(self.point_light_pos).astype(np.float32)
                       if self.point_light_pos else np.zeros((0, 3), f32)),
            point_col=(np.stack(self.point_light_col).astype(np.float32)
                       if self.point_light_col else np.zeros((0, 4), f32)),
            dir_dir=(np.stack(self.dir_light_dir).astype(np.float32)
                     if self.dir_light_dir else np.zeros((0, 3), f32)),
            dir_col=(np.stack(self.dir_light_col).astype(np.float32)
                     if self.dir_light_col else np.zeros((0, 4), f32)),
        )

        if self.atlas_path:
            atlas = read_png_rgba_f32(self.atlas_path)
        else:
            atlas = np.zeros((*default_atlas_shape, 4), dtype=np.float32)

        return Scene(
            verts=verts,
            norms=norms,
            tri_v=tri_v_arr,
            tri_mat=np.asarray(tri_mat, dtype=np.int32),
            tri_coord_rect=(np.asarray(rects, dtype=np.float32)
                            if T else np.zeros((0, 4), f32)),
            tri_coord_degenerate=np.asarray(degen, dtype=bool),
            mesh_pos=mesh_pos,
            mesh_rot=mesh_rot,
            mesh_tri_start=starts,
            mesh_tri_count=counts,
            mesh_aabb_min=aabb_min,
            mesh_aabb_max=aabb_max,
            materials=materials,
            inst_pos=inst_pos,
            inst_rot=inst_rot,
            inst_mesh=inst_mesh,
            wtri_inst=wtri_inst,
            wtri_tri=wtri_tri,
            lights=lights,
            ambience=np.zeros(4, dtype=np.float32),
            dist_atten=np.zeros(3, dtype=np.float32),
            atlas=atlas,
        )


def scale_camera(cam: Camera, new_width: int, base_width: int) -> Camera:
    """Adapt a camera to a different canvas resolution while keeping the same
    field of view: pixel density (unit_to_pixels) scales with the width ratio,
    the focal distance (global_near) is a world-space quantity and stays put.
    Use this when rendering reduced-resolution previews/tests of a scene whose
    camera was built for the config's full canvas — otherwise a smaller canvas
    is a narrow center crop, not a downscale."""
    import dataclasses

    factor = np.float32(new_width / base_width)
    return dataclasses.replace(
        cam, unit_to_pixels=np.float32(cam.unit_to_pixels) * factor
    )


def make_camera(fov: float, unit_to_pixels: float, width: int, height: int) -> Camera:
    """Pinhole camera (reference: src/rayenv/camera.cu:6-9).  Note the reference
    computes ``0.5*W / u2p / tan(fov)`` with the FULL fov, not fov/2 — preserved."""
    import math

    return Camera(
        pos=np.zeros(3, dtype=np.float32),
        rot=IDENTITY_QUAT.copy(),
        global_near=np.float32(0.5 * width / unit_to_pixels / math.tan(fov)),
        unit_to_pixels=np.float32(unit_to_pixels),
    )


def make_grid_world(side: int):
    """A plane of ``side x side`` touching unit cubes of one material at
    ``(x, 0, z)`` for integer ``x, z < side`` (``tests/test_accel.py``'s
    grid), one point light above its middle and one directional light, and
    a 640x480 camera pitched 50 degrees down at the middle.  Returns
    ``(scene, camera, cfg)`` with numpy leaves: the fixture of instance
    counts far above the terrains' (the LBVH walk's O(log N) visits, the
    cull's lists of thousands of instances)."""
    import dataclasses
    import math

    from .scene import RenderConfig, scene_render_flags

    sb = SceneBuilder()
    mat = Material(kd=np.array([0.6, 0.5, 0.3, 1.0], f32),
                   ka=np.array([0.2, 0.2, 0.2, 1.0], f32),
                   ks=np.array([0.2, 0.2, 0.2, 1.0], f32), alpha=8.0)
    mb = sb.get_mesh_builder(sb.build_cube(1.0, TextureCoords(), mat))
    for gx in range(side):
        for gz in range(side):
            sb.get_transformation(sb.add_trans(mb)).set_position(
                [float(gx), 0.0, float(gz)])
    mid = 0.5 * (side - 1)
    sb.add_point_light([mid, 0.5 * side + 4.0, mid], [1.0, 0.95, 0.9, 1.0])
    sb.add_directional_light([0.3, -1.0, 0.5], [0.45, 0.45, 0.55, 1.0])
    scene = dataclasses.replace(
        sb.finish(), ambience=np.array([0.15, 0.15, 0.15, 1.0], f32),
        dist_atten=np.array([1.0, 0.02, 0.002], f32))
    pitch = math.radians(50.0)
    rot = np.array([math.sin(0.5 * pitch), 0.0, 0.0, math.cos(0.5 * pitch)],
                   f32)
    fwd = np.array([0.0, -math.sin(pitch), math.cos(pitch)], f32)
    dist = 0.35 * side + 6.0
    cam = dataclasses.replace(
        make_camera(0.7853982, 64.0, 640, 480),
        pos=(np.array([mid, 0.0, mid], f32) - dist * fwd).astype(f32),
        rot=rot)
    cfg = RenderConfig(width=640, height=480, recurse_depth=0,
                       **scene_render_flags(scene))
    return scene, cam, cfg
