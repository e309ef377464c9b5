"""Differentiable rendering: parameter trees, losses and gradient steps.

Counterpart of ``raytracer_tpu/diff.py``.  Parameters are a dict holding the
port's ``Materials``/``Lights`` dataclasses and camera tensors, each leaf a
tensor with ``requires_grad``; gradients come back in the same structure.
Gradients through shading, attenuation and the hit time are exact
autodiff; visibility (which triangle is hit, shadow masks) is piecewise
constant, through the rules of ``render/cast_vjp.py``.  Vertex positions
(``include_vertices``) train under ``cfg.edge_aware_grads``: the reparam
cast rule and the silhouette band carry their gradient.

Not ported: the spp gradient accumulation of ``make_spp_grad_fn``, which
raises.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from . import tree
from .render.engine import render_frame
from .scene import Camera, RenderConfig, Scene


def _trainable(x: torch.Tensor) -> torch.Tensor:
    return x.detach().clone().requires_grad_(True)


def trainable_params(scene: Scene, camera: Camera,
                     include_lights: bool = True,
                     include_camera: bool = True,
                     include_vertices: bool = False) -> Dict[str, Any]:
    """The optimizable parameters of a scene and camera, as fresh leaves
    with ``requires_grad``; ``include_vertices`` adds the mesh-local vertex
    positions (``verts``), whose gradients need ``cfg.edge_aware_grads``."""
    params: Dict[str, Any] = {"materials": scene.materials}
    if include_lights:
        params["lights"] = scene.lights
    if include_camera:
        params["cam_pos"] = camera.pos
        params["cam_rot"] = camera.rot
    if include_vertices:
        params["verts"] = scene.verts
    return tree.tree_map(_trainable, params)


def merge_params(scene: Scene, camera: Camera, params: Dict[str, Any]
                 ) -> Tuple[Scene, Camera]:
    """Rebuild ``(scene, camera)`` with ``params`` substituted in."""
    scene_kw = {k: params[k] for k in ("materials", "lights", "verts")
                if k in params}
    if scene_kw:
        scene = dataclasses.replace(scene, **scene_kw)
    cam_kw = {f: params[k] for k, f in (("cam_pos", "pos"),
                                        ("cam_rot", "rot")) if k in params}
    if cam_kw:
        camera = dataclasses.replace(camera, **cam_kw)
    return scene, camera


def render_with_params(scene: Scene, camera: Camera, cfg: RenderConfig,
                       params: Dict[str, Any]):
    s, c = merge_params(scene, camera, params)
    return render_frame(s, c, cfg)


def l2_image_loss(img, target):
    return torch.mean((img - target) ** 2)


def make_loss_fn(scene: Scene, camera: Camera, cfg: RenderConfig, target,
                 loss: Callable = l2_image_loss):
    """``loss_fn(params) -> scalar tensor``; differentiate it with
    :func:`grad_of`."""

    def loss_fn(params):
        return loss(render_with_params(scene, camera, cfg, params), target)

    return loss_fn


def grad_of(value: torch.Tensor, params: Dict[str, Any]) -> Dict[str, Any]:
    """``d value / d params`` in the structure of ``params``; a leaf the
    value does not depend on (``kt`` of an opaque world) gets zeros, as
    under ``jax.grad``."""
    leaves = tree.leaves(params)
    grads = torch.autograd.grad(value, leaves, allow_unused=True)
    return tree.unflatten(params, [torch.zeros_like(p) if g is None else g
                                   for p, g in zip(leaves, grads)])


def make_spp_grad_fn(*_args, **_kw):
    raise NotImplementedError(
        "spp gradient accumulation is not ported (ROADMAP.md Queue 1 item 6: "
        "spp > 1)")


def sgd_step(params, grads, lr: float):
    """``p - lr * g`` on every leaf, as fresh leaves with ``requires_grad``."""
    with torch.no_grad():
        return tree.tree_map(lambda p, g: (p - lr * g).requires_grad_(True),
                             params, grads)


def train_step(scene: Scene, camera: Camera, cfg: RenderConfig, target,
               params, lr: float = 1e-2):
    """One optimization step: ``(loss, grads, new_params)``."""
    value = make_loss_fn(scene, camera, cfg, target)(params)
    grads = grad_of(value, params)
    return value.detach(), grads, sgd_step(params, grads, lr)
