"""The system under test, as the benchmark drives it: the world loaded by
the program's own loader, its scene on the device, and its cameras.

Everything the window calls goes through module attributes of the
program (``engine.render_frame_with_stats``, ``diff.train_step``), so a
test can break the timed path underneath the harness.
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np
import torch


def load_world(world_doc: dict, device, width: int, height: int, spp: int,
               **cfg):
    """``(scene, render config)``: the program's loader on the frozen world
    document, the scene on ``device``, the kernels' engine."""
    import raytracer_tpu_torch as rt

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "world.json")
        with open(path, "w") as fh:
            json.dump(world_doc, fh)
        world = rt.generate(path)
    scene = rt.to_device(world.scene, device)
    config = world.config.replace(width=width, height=height, engine="cuda",
                                  spp=spp, **cfg)
    return scene, config


def camera(pos, rot, near, unit_to_pixels, device):
    """A program camera from the benchmark's values (``rot`` may already be
    a device tensor)."""
    from raytracer_tpu_torch import Camera

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32) if not
                               isinstance(x, torch.Tensor) else x,
                               device=device)

    return Camera(pos=t(pos), rot=t(rot), global_near=t(near),
                  unit_to_pixels=t(unit_to_pixels))


def unit_to_pixels(world, width: int) -> np.float32:
    """The camera's pixel density at ``width``, the field of view kept
    (the world's camera is built for its own canvas)."""
    return np.float32(world.cam_unit_to_pixels) * np.float32(
        width / world.width)

