"""The one traffic generator: what a mix's parameters and ``--seed`` make.

Every draw comes from ``numpy.random.default_rng([seed, stream])`` on the
host, one stream a purpose, so that a seed gives the same inputs on any
machine and one draw does not shift another.  The inputs are small (a
camera path, a few dozen material and light values), so nothing here
touches the device; the world itself is fixed by its file.

* a turntable orbit: the world's camera carried round the world's y axis,
  its position and its orientation turned together (``dr * rot``, the
  arithmetic of ``camera_motion.orbit_frames``, which turns the
  orientation alone), ``deg_per_frame`` a frame from a start angle drawn
  from the seed.  The world stays in view, so the work a frame does not
  swing with the part of the turn that the window's end cuts off; a step
  that does not divide 360 (2.01 degrees: a view comes back after 12,000
  frames) gives every frame of a window a camera of its own;
* a training start: the camera carried round by a yaw drawn from
  ``[-yaw_deg, yaw_deg]``, ``kd`` of the target scaled by a factor drawn
  from ``kd_scale``, and the trainable values perturbed by a relative
  ``perturb`` (the camera by ``cam_perturb`` world units and quaternion
  units);
* which frames and pixels the check reads: a reservoir of ``check_frames``
  frames over the window, and ``check_pixels`` pixels of each.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np

STREAM_ORBIT, STREAM_TRAIN, STREAM_FRAMES, STREAM_PIXELS = 1, 2, 3, 4


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 64), stream])


def yaw_quat(deg: float) -> np.ndarray:
    """The rotation by ``deg`` about +y, ``[x, y, z, w]``, float64."""
    h = math.radians(deg) / 2.0
    return np.array([0.0, math.sin(h), 0.0, math.cos(h)])


def quat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    ax, ay, az, aw = a
    bx, by, bz, bw = b
    return np.array([ax * bw + aw * bx + ay * bz - az * by,
                     ay * bw + aw * by + az * bx - ax * bz,
                     az * bw + aw * bz + ax * by - ay * bx,
                     aw * bw - ax * bx - ay * by - az * bz])


def turned(pos: np.ndarray, rot: np.ndarray, deg: float
           ) -> Tuple[np.ndarray, np.ndarray]:
    """A camera carried round the world's y axis by ``deg``: its position
    turned about the axis and its orientation composed with the turn
    (``dr * rot``), each rounded once to float32."""
    c, s = math.cos(math.radians(deg)), math.sin(math.radians(deg))
    x, y, z = np.asarray(pos, np.float64)
    return (np.array([c * x + s * z, y, c * z - s * x], np.float32),
            quat_mul(yaw_quat(deg), np.asarray(rot, np.float64)).astype(
                np.float32))


def orbit_start(seed: int) -> float:
    """The orbit's angle at the window's first frame, degrees."""
    return float(rng(seed, STREAM_ORBIT).uniform(0.0, 360.0))


def orbit_view(pos: np.ndarray, rot: np.ndarray, start_deg: float,
               deg_per_frame: float, i: int
               ) -> Tuple[np.ndarray, np.ndarray]:
    """The camera of frame ``i`` of the orbit (float32 ``pos``, ``rot``)."""
    return turned(pos, rot, (start_deg + i * deg_per_frame) % 360.0)


def train_start(values: Dict[str, np.ndarray], seed: int, traffic: dict
                ) -> Tuple[np.ndarray, np.ndarray, float,
                           Dict[str, np.ndarray]]:
    """``(camera pos, camera rot, kd factor, start values)`` of a training
    run.
    ``values`` are the world's trainable values by name (``cam_pos``,
    ``cam_rot`` and the rest); zeros stay zero (an opaque world stays
    opaque, a light without a component keeps it so)."""
    g = rng(seed, STREAM_TRAIN)
    pos, rot = turned(values["cam_pos"], values["cam_rot"], float(
        g.uniform(-traffic["yaw_deg"], traffic["yaw_deg"])))
    lo, hi = traffic["kd_scale"]
    factor = float(g.uniform(lo, hi))
    start = {}
    for name in sorted(values):
        v = np.asarray({"cam_pos": pos, "cam_rot": rot}.get(name, values[name]),
                       np.float64)
        if name.startswith("cam_"):
            v = v + traffic["cam_perturb"] * g.uniform(-1.0, 1.0, v.shape)
        else:
            v = v * (1.0 + traffic["perturb"] * g.uniform(-1.0, 1.0, v.shape))
        start[name] = v.astype(np.float32)
    return pos, rot, factor, start


class Reservoir:
    """A uniform sample of ``k`` items of a stream of unknown length
    (Algorithm R), its draws from the seed."""

    def __init__(self, k: int, seed: int):
        self.k, self.n, self.items = k, 0, []
        self.g = rng(seed, STREAM_FRAMES)

    def offer(self, make) -> None:
        """Count one item; ``make()`` builds it only when it is kept."""
        self.n += 1
        if len(self.items) < self.k:
            self.items.append(make())
            return
        j = int(self.g.integers(self.n))
        if j < self.k:
            self.items[j] = make()


def pixels(seed: int, n_frames: int, n_pixels: int, per_frame: int
           ) -> List[np.ndarray]:
    """For each of ``n_frames`` frames, ``per_frame`` distinct pixels
    (flat, sorted) of ``n_pixels``, or all of them when fewer."""
    g = rng(seed, STREAM_PIXELS)
    k = min(per_frame, n_pixels)
    return [np.sort(g.choice(n_pixels, size=k, replace=False))
            for _ in range(n_frames)]
