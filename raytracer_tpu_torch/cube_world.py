"""Procedural cube-world generation from ``world*.json`` configs.

Counterpart of ``raytracer_tpu/cube_world.py`` (numpy, bit-identical arrays);
relative atlas paths resolve against the config's directory only.

Bit-faithful port of the reference's config schema and terrain stacking
(reference: src/procedural/cube_world.cc:38-225):

* defaults: seed=42, grid_size=8, 640x480, fov=pi/4, unit_length=200, amplitude=1
  (cube_world.cc:15-21);
* ``fov`` in the JSON is degrees, converted via ``deg*pi/180`` (cube_world.cc:57);
* color-ish vectors (Ke/Ka/Kd/Ks, light colors, ambience) are 0-255 and scaled by
  1/255 on load, while Kt/Kr/alpha/eta are raw floats (cube_world.cc:84-107,124-135);
* per cube type, one 0.999-scaled cube mesh is built (cube_world.cc:109-112), then a
  Perlin heightfield stacks instances per grid column on top of the previous types'
  accumulated heights (cube_world.cc:140-170);
* the camera is placed at ``(0, max_height+10, -grid_size/2)`` and pitched about +x by
  **45 radians** — the reference passes 45 to an axis-angle constructor that expects
  radians (cube_world.cc:172-173, geometry.h:36-41).  Preserved verbatim: it is what
  the published images show.
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np

from .builder import Material, SceneBuilder, TextureCoords, make_camera
from .perlin import Perlin
from .scene import Camera, RenderConfig, Scene

f32 = np.float32

DEFAULT_SEED = 42
DEFAULT_GRID_SIZE = 8
DEFAULT_WIDTH = 640
DEFAULT_HEIGHT = 480
DEFAULT_FOV = math.pi / 4
DEFAULT_UNIT_LEN = 200.0
DEFAULT_AMPLITUDE = 1.0

_U8 = np.float32(1.0 / 255.0)


def _vec4(v) -> np.ndarray:
    return np.asarray([v[0], v[1], v[2], v[3]], dtype=np.float32)


def _vec3(v) -> np.ndarray:
    return np.asarray([v[0], v[1], v[2]], dtype=np.float32)


def _material_from_json(cube: dict) -> Material:
    mat = Material()
    if "Ke" in cube:
        mat.ke = _U8 * _vec4(cube["Ke"])
    if "Ka" in cube:
        mat.ka = _U8 * _vec4(cube["Ka"])
    if "Kd" in cube:
        mat.kd = _U8 * _vec4(cube["Kd"])
    if "Ks" in cube:
        mat.ks = _U8 * _vec4(cube["Ks"])
    if "Kt" in cube:
        mat.kt = _vec4(cube["Kt"])
    if "Kr" in cube:
        mat.kr = _vec4(cube["Kr"])
    if "alpha" in cube:
        mat.alpha = float(cube["alpha"])
    if "eta" in cube:
        mat.eta = float(cube["eta"])
    return mat


def axis_angle_quat(axis, theta: float) -> np.ndarray:
    """Reference Quat axis-angle ctor (geometry.h:36-41); theta in RADIANS, axis
    used unnormalized. Returns [x,y,z,w]."""
    axis = np.asarray(axis, dtype=np.float32)
    hc = np.float32(math.cos(0.5 * theta))
    hs = np.float32(math.sin(0.5 * theta))
    return np.array([axis[0] * hs, axis[1] * hs, axis[2] * hs, hc], dtype=np.float32)


@dataclass
class GeneratedWorld:
    scene: Scene
    camera: Camera
    config: RenderConfig
    raw: dict
    grid_size: int
    max_height: float


def generate(config_path: str, atlas_search_root: Optional[str] = None) -> GeneratedWorld:
    """Parse a world config and build the scene (numpy leaves) + camera +
    render settings.

    ``atlas_search_root`` lets relative atlas paths (e.g. ``assets/sus.png``)
    resolve against any asset directory; defaults to the config file's own
    directory.

    Quirks kept from the JAX loader: ``ambience`` is a raw 0-1 float (not
    0-255 like the other colors) and the camera pitch is 45 *radians*."""
    with open(config_path) as fh:
        doc = json.load(fh)

    seed = int(doc.get("seed", DEFAULT_SEED))
    grid_size = int(doc.get("grid_size", DEFAULT_GRID_SIZE))
    width = int(doc.get("width", DEFAULT_WIDTH))
    height = int(doc.get("height", DEFAULT_HEIGHT))
    fov = float(doc["fov"]) * math.pi / 180.0 if "fov" in doc else DEFAULT_FOV
    unit_length = float(doc.get("unit_length", DEFAULT_UNIT_LEN))
    amplitude = float(doc.get("amplitude", DEFAULT_AMPLITUDE))

    atlas_rel = doc.get("atlas")
    atlas_path = None
    if atlas_rel:
        roots = [atlas_search_root or os.path.dirname(os.path.abspath(config_path)),
                 os.path.dirname(os.path.abspath(config_path))]
        for root in roots:
            cand = os.path.join(root, atlas_rel)
            if os.path.exists(cand):
                atlas_path = cand
                break

    builder = SceneBuilder(atlas_path)
    cam = make_camera(fov, unit_length, width, height)

    cubes = doc.get("cubes", [])
    for cube in cubes:
        builder.build_cube(0.999, TextureCoords(), _material_from_json(cube))

    lights = doc.get("lights", {})
    for light in lights.get("directional", []):
        builder.add_directional_light(_vec3(light["dir"]), _U8 * _vec4(light["col"]))
    for light in lights.get("point", []):
        builder.add_point_light(_vec3(light["pos"]), _U8 * _vec4(light["col"]))

    # Terrain stacking (cube_world.cc:140-170).  Each type re-seeds an identical
    # Perlin field, so later types stack the same column heights on top.
    last_heights = np.zeros(grid_size * grid_size, dtype=np.float32)
    max_height = f32(0.0)
    for c in range(len(cubes)):
        perlin = Perlin(seed, (grid_size + 4) // 5)
        perlin.set_amplitude(amplitude)
        perlin.set_period(grid_size)
        mb = builder.get_mesh_builder(c)
        for i in range(grid_size):
            for j in range(grid_size):
                x = f32(i - grid_size / 2.0)
                z = f32(j - grid_size / 2.0)
                s = perlin.sample(f32(i), f32(j), f32(0.0))
                y_off = f32(math.floor(f32(0.5) * (s + f32(amplitude))) + 1)
                d = 0
                while d < y_off:
                    y = f32(last_heights[i * grid_size + j] + d)
                    tid = builder.add_trans(mb)
                    builder.get_transformation(tid).set_position([x, y, z])
                    d += 1
                last_heights[i * grid_size + j] += y_off
                max_height = max(max_height, last_heights[i * grid_size + j])

    cam.pos = np.array([0.0, max_height + 10.0, -grid_size / 2.0], dtype=np.float32)
    cam.rot = axis_angle_quat([1.0, 0.0, 0.0], 45.0)  # radians; see module docstring

    scene = builder.finish()

    # Environment globals (finish_env, cube_world.cc:177-191).
    if "ambience" in doc:
        scene.ambience = _vec4(doc["ambience"])
    depth = int(doc.get("depth", 0))  # Environment default (environment.h:30-31)
    if "distance_attenuation" in doc:
        da = doc["distance_attenuation"]
        scene.dist_atten = np.array(
            [da["constant_term"], da["linear_term"], da["quadratic_term"]],
            dtype=np.float32,
        )

    max_tris = int(scene.mesh_tri_count.max()) if scene.mesh_tri_count.size else 1
    config = RenderConfig(
        width=width,
        height=height,
        recurse_depth=depth,
        max_tris_per_mesh=max_tris,
        max_candidates=min(64, max(scene.inst_pos.shape[0], 1)),
        # Static material facts (material.h:104-112): lets the engine drop
        # impossible bounce spawns / transmissive shadow marching at trace time.
        any_reflective=bool(np.any(np.asarray(scene.materials.kr) > 0.0)),
        any_refractive=bool(np.any(np.asarray(scene.materials.kt) > 0.0)),
    )
    return GeneratedWorld(
        scene=scene,
        camera=cam,
        config=config,
        raw=doc,
        grid_size=grid_size,
        max_height=float(max_height),
    )
