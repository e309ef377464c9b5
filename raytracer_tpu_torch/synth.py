"""Synthetic worlds for tests and measurements.

The port's copy of ``raytracer_tpu/synth.py``, built through the port's own
``SceneBuilder``; each builder returns ``(scene, camera, cfg)`` with numpy
leaves, bit for bit the JAX package's (the same builder calls and the same
``np.random.RandomState`` draws in the same order):

* ``make_mixed_world``: reflective AND refractive cubes over a diffuse
  floor, so both wavefront child streams stay live every bounce round and
  the engine takes the compacted 2x stream (the reference's
  ``propagate_ray`` pushes a reflect and a refract frame from one hit,
  ``src/rayenv/scene.cu:130-183``);
* ``make_big_world``: N cube instances scattered in a cube volume, for the
  LBVH walk against the candidate-list cull at scale;
* ``make_sphere_world``: icosphere meshes (80 triangles each at subdiv 1),
  which take the template triangle loop and the MXU cast's dense columns.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .builder import Material, SceneBuilder, TextureCoords, make_camera
from .scene import RenderConfig, scene_render_flags

f32 = np.float32


def _environment(scene, ambience):
    return dataclasses.replace(
        scene, ambience=np.array(ambience, f32),
        dist_atten=np.array([1.0, 0.0, 0.0], f32))


def make_mixed_world(depth: int = 3):
    """A 5x5 diffuse floor with a mirror cube and a glass cube above it, one
    directional and one point light.  ``cfg.any_reflective`` and
    ``cfg.any_refractive`` are both True (the compacted stream)."""
    sb = SceneBuilder()
    tc = TextureCoords()

    diffuse = Material(
        kd=np.array([0.1, 0.7, 0.2, 1.0], f32),
        ka=np.array([0.1, 0.2, 0.1, 1.0], f32),
    )
    mirror = Material(
        kd=np.array([0.05, 0.05, 0.1, 1.0], f32),
        ks=np.array([0.4, 0.4, 0.4, 1.0], f32),
        kr=np.array([0.7, 0.7, 0.8, 1.0], f32),
        alpha=16.0,
    )
    glass = Material(
        kd=np.array([0.05, 0.05, 0.05, 1.0], f32),
        kt=np.array([0.9, 0.9, 0.95, 1.0], f32),
        eta=0.9,
    )

    m_diff = sb.build_cube(1.0, tc, diffuse)
    m_mirr = sb.build_cube(1.0, tc, mirror)
    m_glas = sb.build_cube(1.0, tc, glass)

    for ix in range(-2, 3):  # the floor at y = -1
        for iz in range(-2, 3):
            t = sb.add_trans(sb.get_mesh_builder(m_diff))
            sb.get_transformation(t).set_position([float(ix), -1.0, float(iz)])
    t = sb.add_trans(sb.get_mesh_builder(m_mirr))
    sb.get_transformation(t).set_position([-0.8, 0.0, 0.5])
    t = sb.add_trans(sb.get_mesh_builder(m_glas))
    sb.get_transformation(t).set_position([0.8, 0.0, 0.5])

    sb.add_directional_light([0.3, -1.0, 0.4], [0.9, 0.9, 0.9, 1.0])
    sb.add_point_light([0.0, 3.0, -2.0], [0.6, 0.6, 0.6, 1.0])
    scene = _environment(sb.finish(), [0.3, 0.3, 0.3, 1.0])

    cam = make_camera(0.7853982, 64.0, 128, 96)  # 45 degrees
    cam = dataclasses.replace(cam, pos=np.array([0.0, 0.6, -3.5], f32))
    cfg = RenderConfig(width=128, height=96, recurse_depth=depth,
                       **scene_render_flags(scene))
    assert cfg.any_reflective and cfg.any_refractive
    return scene, cam, cfg


def _scatter(sb, mb, n_instances, rng, spacing, jitter):
    """Place ``n_instances`` of ``mb`` on a shuffled cubic grid of
    ``spacing``, each cell jittered by up to ``jitter``; returns the grid's
    side and half-extent."""
    side = int(np.ceil(n_instances ** (1.0 / 3.0)))
    cells = [(x, y, z) for x in range(side) for y in range(side)
             for z in range(side)]
    rng.shuffle(cells)
    half = 0.5 * (side - 1) * spacing
    for (cx, cy, cz) in cells[:n_instances]:
        t = sb.add_trans(mb)
        jit = rng.uniform(-jitter, jitter, 3)
        sb.get_transformation(t).set_position([
            cx * spacing - half + jit[0],
            cy * spacing - half + jit[1],
            cz * spacing - half + jit[2],
        ])
    return side, half


def _far_camera(side, half, spacing):
    cam = make_camera(0.7853982, 64.0, 128, 96)
    return dataclasses.replace(
        cam, pos=np.array([0.0, 0.0, -(half + side * spacing)], f32))


def make_big_world(n_instances: int, seed: int = 7, spacing: float = 2.5):
    """``n_instances`` unit cubes of one diffuse material on a jittered grid
    (no overlaps) and one directional light; the camera looks down +z at
    the whole volume."""
    sb = SceneBuilder()
    mat = Material(
        kd=np.array([0.6, 0.5, 0.3, 1.0], f32),
        ka=np.array([0.2, 0.2, 0.2, 1.0], f32),
    )
    mesh = sb.build_cube(1.0, TextureCoords(), mat)
    side, half = _scatter(sb, sb.get_mesh_builder(mesh), n_instances,
                          np.random.RandomState(seed), spacing, 0.4)
    sb.add_directional_light([0.3, -1.0, 0.5], [1.0, 1.0, 1.0, 1.0])
    scene = _environment(sb.finish(), [0.25, 0.25, 0.25, 1.0])
    cfg = RenderConfig(width=128, height=96, recurse_depth=0,
                       **scene_render_flags(scene))
    return scene, _far_camera(side, half, spacing), cfg


def _icosphere(subdiv: int = 1):
    """Icosphere ``(verts [V,3], tris [T,3])``: 20 triangles, four times as
    many per subdivision (80 at subdiv 1)."""
    t = (1.0 + 5.0 ** 0.5) / 2.0
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
    ], f32)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    tris = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], np.int32)
    for _ in range(subdiv):
        cache = {}
        vlist = list(verts)

        def mid(a, b):
            key = (min(a, b), max(a, b))
            if key not in cache:
                m = vlist[a] + vlist[b]
                m = m / np.linalg.norm(m)
                cache[key] = len(vlist)
                vlist.append(m.astype(f32))
            return cache[key]

        out = []
        for (a, b, c) in tris:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            out += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.asarray(vlist, f32)
        tris = np.asarray(out, np.int32)
    return verts, tris


def make_sphere_world(n_instances: int = 64, subdiv: int = 1, seed: int = 3,
                      spacing: float = 2.5):
    """``n_instances`` icospheres on a jittered grid: general triangle
    meshes, so the box fast path is off and every hit takes the template
    triangle loop (or the MXU cast's columns)."""
    sb = SceneBuilder()
    tc = TextureCoords()
    mat = Material(
        kd=np.array([0.55, 0.45, 0.75, 1.0], f32),
        ka=np.array([0.2, 0.2, 0.25, 1.0], f32),
        alpha=8.0,
    )
    verts, tris = _icosphere(subdiv)
    mb = sb.get_mesh_builder(sb.create_mesh())
    base = [sb.add_vertex(v) for v in verts]
    for (a, b, c) in tris:
        mb.add_triangle([base[a], base[b], base[c]], tc, mat)
    side, half = _scatter(sb, mb, n_instances, np.random.RandomState(seed),
                          spacing, 0.3)
    sb.add_directional_light([0.3, -1.0, 0.5], [1.0, 1.0, 1.0, 1.0])
    scene = _environment(sb.finish(), [0.25, 0.25, 0.25, 1.0])
    cfg = RenderConfig(width=128, height=96, recurse_depth=0,
                       **scene_render_flags(scene))
    return scene, _far_camera(side, half, spacing), cfg
