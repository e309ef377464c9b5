"""Carry the JAX package's scene state across to the port.

The JAX package's ``Scene`` / ``Camera`` (``raytracer_tpu/scene.py``) have the
same fields as the port's.  These functions read them by name, as numpy
arrays, and build the port's dataclasses on a torch device, so that both
packages compute on identical inputs.  The scene arrays play the role that
weights play for a model.  Nothing here imports JAX: any object with the
right attributes (numpy or JAX array leaves) is accepted.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .scene import Camera, Lights, Materials, RenderConfig, Scene, to_device


def _from_fields(cls, src):
    kw = {}
    for f in dataclasses.fields(cls):
        v = getattr(src, f.name)
        if f.name == "materials":
            kw[f.name] = _from_fields(Materials, v)
        elif f.name == "lights":
            kw[f.name] = _from_fields(Lights, v)
        else:
            kw[f.name] = np.asarray(v)
    return cls(**kw)


def scene_from_numpy(jax_scene, device="cpu") -> Scene:
    """The port's Scene on ``device`` from the JAX package's Scene leaves."""
    return to_device(_from_fields(Scene, jax_scene), device)


def camera_from_numpy(jax_camera, device="cpu") -> Camera:
    """The port's Camera on ``device`` from the JAX package's Camera."""
    return to_device(_from_fields(Camera, jax_camera), device)


_ENGINES = {"jnp": "torch", "pallas": "cuda"}


def config_from_jax(jax_cfg) -> RenderConfig:
    """The port's RenderConfig from the JAX package's: the same fields, with
    the JAX engine names mapped (``jnp`` -> ``torch``, ``pallas`` ->
    ``cuda``)."""
    kw = {f.name: getattr(jax_cfg, f.name)
          for f in dataclasses.fields(RenderConfig)}
    kw["engine"] = _ENGINES[kw["engine"]]
    return RenderConfig(**kw)
