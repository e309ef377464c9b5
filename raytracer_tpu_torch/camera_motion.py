"""Interactive-camera motion: the WASD and mouse-look moves of the
reference's window loop, as pure functions on the port's ``Camera``.

Counterpart of ``raytracer_tpu/camera_motion.py``.  ``translate`` is the
reference's camera-relative move (``p += rot(o, dp)``, entity.h:53-56) and
``rotate`` composes a rotation delta (``o = dr * o``, entity.h:63-66); the
mouse-look quaternions turn about the camera's current up and right axes
(main.cc:169-179).  The camera's leaves are tensors (``scene.to_device``);
every result stays on the camera's device, and the camera math runs in
float32 there.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from . import raymath as rm
from .scene import Camera

MOVE_SPEED = 0.2  # main.cc:19
ROT_SPEED = 0.01  # main.cc:20


def camera_basis(cam: Camera):
    """(right, up, forward) unit vectors: the columns of the camera's
    local-to-global rotation (src/rayenv/camera.cu:12-30)."""
    m = rm.quat_to_mat(cam.rot)
    return (rm.normalize(m[:, 0]), rm.normalize(m[:, 1]),
            rm.normalize(m[:, 2]))


def translate(cam: Camera, dp) -> Camera:
    """Camera-relative translation (entity.h:53-56: ``p += rot(o, dp)``)."""
    dp = torch.as_tensor(dp, dtype=torch.float32, device=cam.rot.device)
    return dataclasses.replace(cam, pos=cam.pos + rm.quat_rotate(cam.rot, dp))


def rotate(cam: Camera, dr_quat) -> Camera:
    """Compose a rotation delta: ``o = dr * o`` (entity.h:63-66)."""
    dr = torch.as_tensor(dr_quat, dtype=torch.float32, device=cam.rot.device)
    return dataclasses.replace(cam, rot=rm.quat_mul(dr, cam.rot))


def mouse_look(cam: Camera, dx: float, dy: float) -> Camera:
    """Mouse-motion rotation as the reference's loop composes it
    (main.cc:171-177): the motion normalized (zero stays zero: the identity
    rotation), yaw about the camera's up axis and pitch about its right
    axis, each scaled by ROT_SPEED."""
    rel = rm.normalize(torch.tensor([dx, dy], dtype=torch.float32,
                                    device=cam.rot.device))
    right, up, _ = camera_basis(cam)
    yaw = rm.quat_from_axis_angle(up, ROT_SPEED * rel[0])
    pitch = rm.quat_from_axis_angle(right, ROT_SPEED * rel[1])
    return rotate(cam, rm.quat_mul(yaw, pitch))


def key_move(cam: Camera, key: str, speed: float = MOVE_SPEED) -> Camera:
    """WASD moves (main.cc:146-161): w/s along +/-z, a/d along -/+x."""
    deltas = {
        "w": (0.0, 0.0, speed),
        "s": (0.0, 0.0, -speed),
        "a": (-speed, 0.0, 0.0),
        "d": (speed, 0.0, 0.0),
    }
    return translate(cam, deltas[key])


def orbit_frames(cam: Camera, n_frames: int, degrees_per_frame: float = 2.0):
    """Yield the cameras of a turntable orbit about the world's y axis, one
    ``degrees_per_frame`` step a frame (the fly-through demo)."""
    dev = cam.rot.device
    dr = rm.quat_from_axis_angle(
        torch.tensor([0.0, 1.0, 0.0], device=dev),
        torch.tensor(math.radians(degrees_per_frame), dtype=torch.float32,
                     device=dev))
    cur = cam
    for _ in range(n_frames):
        cur = rotate(cur, dr)
        yield cur
