"""The benchmark's own reading of a cube-world file (numpy only).

A frozen copy of the procedural terrain of the upstream renderer
(``src/procedural/cube_world.cc``, ``perlin.cu``): a seeded ``std::mt19937``,
its Perlin field, and the column stacking of one 0.999-scaled unit cube per
cube type.  It gives the boxes, the material table, the lights and the
camera of a world, and is what the benchmark hands to both sides: the
traffic takes the camera from it, and the plain reference
(``rtbench/reference``) takes the whole scene.  It imports nothing of the
program, so an edit of the program's loader does not move the yardstick.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

f32 = np.float32

# cube_world.cc:15-21
DEFAULTS = dict(seed=42, grid_size=8, width=640, height=480,
                unit_length=200.0, amplitude=1.0)
CUBE_SCALE = f32(0.999)  # cube_world.cc:109-112
_U8 = f32(1.0 / 255.0)
MATERIAL_KEYS = ("ke", "ka", "kd", "ks", "kt", "kr", "alpha", "eta")
LIGHT_KEYS = ("point_pos", "point_col", "dir_dir", "dir_col")
# the trainable values of a world and its camera, by the benchmark's names
PARAM_NAMES = tuple([f"materials.{k}" for k in MATERIAL_KEYS]
                    + [f"lights.{k}" for k in LIGHT_KEYS]
                    + ["cam_pos", "cam_rot"])


class MT19937:
    """``std::mt19937`` with libstdc++'s ``uniform_real_distribution<float>``
    (one draw, ``float(u32) / 2^32`` in float32, kept below 1) and the raw
    draw of ``uniform_int_distribution<unsigned>``."""

    def __init__(self, seed: int):
        self.mt = [seed & 0xFFFFFFFF]
        for i in range(1, 624):
            prev = self.mt[-1]
            self.mt.append((1812433253 * (prev ^ (prev >> 30)) + i)
                           & 0xFFFFFFFF)
        self.i = 624

    def u32(self) -> int:
        if self.i >= 624:
            mt = self.mt
            for k in range(624):
                y = (mt[k] & 0x80000000) | (mt[(k + 1) % 624] & 0x7FFFFFFF)
                mt[k] = mt[(k + 397) % 624] ^ (y >> 1) ^ (
                    0x9908B0DF if y & 1 else 0)
            self.i = 0
        y = self.mt[self.i]
        self.i += 1
        y ^= y >> 11
        y ^= (y << 7) & 0x9D2C5680
        y ^= (y << 15) & 0xEFC60000
        y ^= y >> 18
        return y & 0xFFFFFFFF

    def real(self) -> np.float32:
        v = f32(f32(self.u32()) / f32(4294967296.0))
        return v if v < f32(1.0) else np.nextafter(f32(1.0), f32(0.0))


def _unit(v: np.ndarray) -> np.ndarray:
    n = f32(np.sqrt(f32(np.dot(v, v))))
    return (f32(1.0) / n) * v if n > f32(1e-5) else np.zeros(3, f32)


def _shine_dir(v: np.ndarray) -> np.ndarray:
    """A directional light's unit direction (light.h:52-54 divides)."""
    n = f32(np.sqrt(np.dot(v, v)))
    return (v / n).astype(f32) if n > f32(1e-5) else np.zeros(3, f32)


class Perlin:
    """The reference's gradient noise (perlin.cu): gradients and the
    permutation both drawn from a freshly seeded stream (``std::bind``
    copies the generator), and its reversed lerp ``w*a + (1-w)*b``."""

    def __init__(self, seed: int, n: int, amplitude: float, period: float):
        self.n, self.amp, self.period = n, f32(amplitude), f32(period)
        rng = MT19937(seed)
        vecs = []
        for _ in range(n):
            theta = f32(math.acos(float(f32(f32(2.0) * rng.real()) - f32(1.0))))
            phi = f32(float(f32(f32(2.0) * rng.real())) * math.pi)
            vecs.append(_unit(np.array(
                [f32(math.cos(phi) * math.sin(theta)),
                 f32(math.sin(phi) * math.sin(theta)),
                 f32(math.cos(theta))], f32)))
        self.vecs = vecs
        rng = MT19937(seed)
        perm = list(range(n))
        for i in range(n):
            j = rng.u32() % n
            perm[i], perm[j] = perm[j], perm[i]
        self.perm = perm

    def sample(self, x: float, y: float) -> np.float32:
        n, p = self.n, self.perm
        s = [f32(f32(c) * f32(n) / self.period) for c in (x, y, 0.0)]
        i = [int(math.floor(c)) % n for c in s]
        m = []
        for c in s:
            d = f32(c - f32(math.floor(c)))
            m.append(f32(d * d * (f32(3.0) - f32(2.0) * d)))

        def weight(dx, dy, dz):
            off = _unit(np.array([f32(dx) - m[0], f32(dy) - m[1],
                                  f32(dz) - m[2]], f32))
            h = (p[(p[(i[0] + dx) % n] + i[1] + dy) % n] + i[2] + dz) % n
            return f32(np.dot(self.vecs[p[h]], off))

        def lerp(a, b, w):
            return f32(w * a + (f32(1.0) - w) * b)

        x00 = lerp(weight(0, 0, 0), weight(1, 0, 0), m[0])
        x01 = lerp(weight(0, 0, 1), weight(1, 0, 1), m[0])
        x10 = lerp(weight(0, 1, 0), weight(1, 1, 0), m[0])
        x11 = lerp(weight(0, 1, 1), weight(1, 1, 1), m[0])
        xyz = lerp(lerp(x00, x10, m[1]), lerp(x01, x11, m[1]), m[2])
        return f32(self.amp * xyz)


@dataclass
class World:
    """A loaded cube world: axis-aligned boxes, their material rows, the
    lights, the camera (``[x, y, z, w]`` quaternion, local to global) and
    the canvas the file states.  float32 numpy leaves."""

    box_lo: np.ndarray  # [N, 3]
    box_hi: np.ndarray  # [N, 3]
    box_mat: np.ndarray  # [N] int64 row of the material table
    materials: dict  # MATERIAL_KEYS -> [K, 4] / [K]
    point_pos: np.ndarray  # [Lp, 3]
    point_col: np.ndarray  # [Lp, 4]
    dir_dir: np.ndarray  # [Ld, 3] unit: the direction the light shines
    dir_col: np.ndarray  # [Ld, 4]
    ambience: np.ndarray  # [4]
    dist_atten: np.ndarray  # [3] constant, linear, quadratic
    cam_pos: np.ndarray  # [3]
    cam_rot: np.ndarray  # [4]
    cam_near: np.float32
    cam_unit_to_pixels: np.float32
    width: int
    height: int
    depth: int

    @property
    def any_reflective(self) -> bool:
        return bool((self.materials["kr"] > 0).any())

    @property
    def any_refractive(self) -> bool:
        return bool((self.materials["kt"] > 0).any())

    def values(self) -> dict:
        """The trainable values by :data:`PARAM_NAMES`."""
        vals = {f"materials.{k}": self.materials[k] for k in MATERIAL_KEYS}
        vals.update({f"lights.{k}": getattr(self, k) for k in LIGHT_KEYS})
        vals.update(cam_pos=self.cam_pos, cam_rot=self.cam_rot)
        return vals


def _vec(v, n) -> np.ndarray:
    return np.asarray([v[k] for k in range(n)], f32)


def _material(cube: dict) -> dict:
    row = {k: np.zeros(4, f32) for k in MATERIAL_KEYS[:6]}
    row["alpha"], row["eta"] = f32(0.0), f32(1.0)
    for key, name in (("Ke", "ke"), ("Ka", "ka"), ("Kd", "kd"), ("Ks", "ks")):
        if key in cube:
            row[name] = _U8 * _vec(cube[key], 4)
    for key, name in (("Kt", "kt"), ("Kr", "kr")):
        if key in cube:
            row[name] = _vec(cube[key], 4)
    for name in ("alpha", "eta"):
        if name in cube:
            row[name] = f32(cube[name])
    return row


def load(doc: dict) -> World:
    """The world a cube-world document describes (cube_world.cc:38-191)."""
    seed = int(doc.get("seed", DEFAULTS["seed"]))
    grid = int(doc.get("grid_size", DEFAULTS["grid_size"]))
    width = int(doc.get("width", DEFAULTS["width"]))
    height = int(doc.get("height", DEFAULTS["height"]))
    fov = (float(doc["fov"]) * math.pi / 180.0 if "fov" in doc
           else math.pi / 4)
    unit = float(doc.get("unit_length", DEFAULTS["unit_length"]))
    amplitude = float(doc.get("amplitude", DEFAULTS["amplitude"]))
    if doc.get("atlas"):
        raise ValueError("textured worlds are not read by this loader")

    # the material table, deduplicated in first-use order (SceneBuilder)
    rows, keys, cube_mat = [], [], []
    for cube in doc.get("cubes", []):
        row = _material(cube)
        key = b"".join(np.asarray(row[k], f32).tobytes()
                       for k in MATERIAL_KEYS)
        if key not in keys:
            keys.append(key)
            rows.append(row)
        cube_mat.append(keys.index(key))
    if not rows:
        rows.append(_material({}))
    materials = {k: np.stack([np.asarray(r[k], f32) for r in rows])
                 for k in MATERIAL_KEYS}

    half = f32(CUBE_SCALE * f32(0.5))
    last = np.zeros(grid * grid, f32)
    max_h = f32(0.0)
    pos, mats = [], []
    for c in range(len(cube_mat)):
        noise = Perlin(seed, (grid + 4) // 5, amplitude, grid)
        for i in range(grid):
            for j in range(grid):
                s = noise.sample(f32(i), f32(j))
                stack = f32(math.floor(f32(0.5) * (s + f32(amplitude))) + 1)
                d = 0
                while d < stack:
                    pos.append([f32(i - grid / 2.0),
                                f32(last[i * grid + j] + d),
                                f32(j - grid / 2.0)])
                    mats.append(cube_mat[c])
                    d += 1
                last[i * grid + j] += stack
                max_h = max(max_h, last[i * grid + j])
    pos = np.asarray(pos, f32).reshape(-1, 3)

    lights = doc.get("lights", {})
    dirs = [_shine_dir(_vec(l["dir"], 3))
            for l in lights.get("directional", [])]
    dcol = [_U8 * _vec(l["col"], 4) for l in lights.get("directional", [])]
    ppos = [_vec(l["pos"], 3) for l in lights.get("point", [])]
    pcol = [_U8 * _vec(l["col"], 4) for l in lights.get("point", [])]
    da = doc.get("distance_attenuation")
    # the camera: above the terrain, pitched about +x by 45 *radians*
    # (cube_world.cc:172-173 passes 45 to an axis-angle that takes radians)
    half_angle = 0.5 * 45.0
    return World(
        box_lo=(pos - half).astype(f32),
        box_hi=(pos + half).astype(f32),
        box_mat=np.asarray(mats, np.int64),
        materials=materials,
        point_pos=np.asarray(ppos, f32).reshape(-1, 3),
        point_col=np.asarray(pcol, f32).reshape(-1, 4),
        dir_dir=np.asarray(dirs, f32).reshape(-1, 3),
        dir_col=np.asarray(dcol, f32).reshape(-1, 4),
        ambience=(_vec(doc["ambience"], 4) if "ambience" in doc
                  else np.zeros(4, f32)),
        dist_atten=(np.array([da["constant_term"], da["linear_term"],
                              da["quadratic_term"]], f32) if da
                    else np.zeros(3, f32)),
        cam_pos=np.array([0.0, max_h + 10.0, -grid / 2.0], f32),
        cam_rot=np.array([f32(math.sin(half_angle)), 0.0, 0.0,
                          f32(math.cos(half_angle))], f32),
        cam_near=f32(0.5 * width / unit / math.tan(fov)),
        cam_unit_to_pixels=f32(unit),
        width=width, height=height, depth=int(doc.get("depth", 0)))
