"""Rank functions of ``tests/test_torch_dist.py`` and
``tests/test_torch_dist_geom.py``.

``raytracer_tpu_torch.dist.launch`` runs each of them in every rank
process (gloo, on the CPU); what one returns comes back to the test, which
compares it with the port run in one process and with the JAX package.
Imports no JAX: a rank holds the port alone.
"""

import os
import sys
import time

import numpy as np
import torch

import raytracer_tpu_torch as rtt
from raytracer_tpu_torch import diff, dist
from raytracer_tpu_torch.builder import scale_camera
from raytracer_tpu_torch.render.geometry import camera_rays

WORLDS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "raytracer_tpu_torch", "worlds")
FRAMES = {  # key: (width, height, config changes, balance)
    "contiguous": (64, 48, {}, "contiguous"),
    "cyclic": (64, 48, {}, "cyclic"),
    "uneven": (64, 52, {}, "contiguous"),
    "uneven_cyclic": (64, 52, {}, "cyclic"),
    "spp": (64, 48, {"spp": 3}, "contiguous"),
}
STEP = (32, 32)  # the training steps' frame
RING = (64, 48)  # the ring cast's primary rays


def world(name, width, height, device, **change):
    """``(scene, camera, cfg)`` of a port world at ``width`` x ``height``
    (the full field of view), ``engine="torch"``."""
    w = rtt.generate(os.path.join(WORLDS, f"{name}.json"))
    return (rtt.to_device(w.scene, device),
            rtt.to_device(scale_camera(w.camera, width, w.config.width),
                          device),
            w.config.replace(width=width, height=height, engine="torch",
                             **change))


def step_target(width, height):
    """The training steps' seeded target frame."""
    return np.random.default_rng(5).uniform(
        0.0, 0.5, (height, width, 4)).astype(np.float32)


def rows(device):
    """The row-sharded frames of ``FRAMES`` and the row-sharded training
    step (materials, lights, camera) on the 1-D mesh."""
    mesh = dist.make_mesh()
    out = {}
    for key, (w, h, change, balance) in FRAMES.items():
        scene, cam, cfg = world("terrain8", w, h, device, **change)
        out[key] = dist.make_sharded_render(scene, cam, cfg, mesh, balance)()
    scene, cam, cfg = world("terrain8", *STEP, device, early_exit=False)
    params = diff.trainable_params(scene, cam)
    loss, grads = dist.make_sharded_grad_fn(scene, cam, cfg, mesh)(
        params, torch.from_numpy(step_target(*STEP)))
    out["step"] = {"loss": loss, "grads": dist.flat_tree(grads)}
    return out


def geom(device):
    """On the 2x2 mesh: the geometry-sharded frame, the ring cast of this
    rank's block of primary rays, and the geometry-sharded step with
    vertices and edge-aware grads."""
    mesh = dist.make_mesh2d(2, 2)
    scene, cam, cfg = world("terrain8", 64, 48, device)
    out = {"frame": dist.make_geom_sharded_render(scene, cam, cfg, mesh)()}

    shard = dist.take_shard(dist.split_scene_by_instances(scene, 2),
                            mesh.index(dist.GEOM_AXIS), device)
    w, h = RING
    ro, rd = camera_rays(cam, w, h)
    k = h // mesh.size(dist.RAY_AXIS)
    i = mesh.index(dist.RAY_AXIS)
    hit = dist.make_ring_geom_cast(scene, cfg, shard, mesh)(
        ro[i * k:(i + 1) * k].reshape(-1, 3),
        rd[i * k:(i + 1) * k].reshape(-1, 3))
    out["ring"] = {"valid": hit.valid, "t": hit.t, "wtri": hit.wtri,
                   "uv": hit.uv, "normal": hit.normal, "mat": hit.mat}

    scene, cam, cfg = world("terrain8", *STEP, device, early_exit=False,
                            edge_aware_grads=True)
    params = diff.trainable_params(scene, cam, include_vertices=True)
    loss, grads = dist.make_geom_sharded_grad_fn(scene, cam, cfg, mesh)(
        params, torch.from_numpy(step_target(*STEP)))
    out["step"] = {"loss": loss, "grads": dist.flat_tree(grads)}
    out["staged"] = sorted(mesh.staged)
    return out


def fail(device):
    """Rank 1 raises; every other rank waits in a collective for it."""
    if torch.distributed.get_rank() == 1:
        raise RuntimeError("rank 1 fails on purpose")
    torch.distributed.barrier()
    return {}


def hang(device):
    """Never returns."""
    while True:
        time.sleep(1.0)


def modules(device):
    """The JAX modules and the JAX package's modules this rank holds."""
    return {"jax": sorted(m for m in sys.modules
                          if m.split(".")[0] in ("jax", "jaxlib",
                                                 "raytracer_tpu"))}
