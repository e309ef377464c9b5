"""Carry the JAX package's scene state and parameters across to the port.

The JAX package's ``Scene`` / ``Camera`` (``raytracer_tpu/scene.py``) have the
same fields as the port's.  These functions read them by name, as numpy
arrays, and build the port's dataclasses on a torch device, so that both
packages compute on identical inputs.  The scene arrays play the role that
weights play for a model.  Nothing here imports JAX: any object with the
right attributes (numpy or JAX array leaves) is accepted.

``params_from_numpy`` / ``params_to_numpy`` carry the ``trainable_params``
dict of ``raytracer_tpu.diff`` (materials, lights, camera) both ways, so
that both packages can take the same parameters and their gradients can be
compared leaf by leaf.

``device`` is a required keyword of every function here that builds
tensors: the port runs on the card unless its caller asks for the CPU, so a
caller that wants the CPU says ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import tree
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


def scene_from_numpy(jax_scene, *, device) -> Scene:
    """The port's Scene on ``device`` from the JAX package's Scene leaves."""
    return to_device(_from_fields(Scene, jax_scene), device)


def camera_from_numpy(jax_camera, *, device) -> Camera:
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


_PARAM_TYPES = {"materials": Materials, "lights": Lights}


def params_from_numpy(jax_params, *, device) -> dict:
    """The port's parameter dict (leaves on ``device`` with
    ``requires_grad``) from the JAX package's ``trainable_params`` dict."""
    out = {}
    for k, v in jax_params.items():
        v = (_from_fields(_PARAM_TYPES[k], v) if k in _PARAM_TYPES
             else np.asarray(v))
        out[k] = tree.tree_map(
            lambda x: torch.from_numpy(np.array(x)).to(device)
            .requires_grad_(True), v)
    return out


def params_to_numpy(params) -> dict:
    """A port parameter (or gradient) dict with numpy leaves, in the same
    structure; its materials and lights have the JAX classes' fields."""
    return tree.tree_map(lambda x: x.detach().cpu().numpy(), params)
