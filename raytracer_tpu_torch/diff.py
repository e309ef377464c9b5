"""Differentiable rendering: parameter trees, losses and gradient steps.

Counterpart of ``raytracer_tpu/diff.py``.  Parameters are a dict holding the
port's ``Materials``/``Lights`` dataclasses and camera tensors, each leaf a
tensor with ``requires_grad``; gradients come back in the same structure.
Gradients through shading, attenuation and the hit time are exact
autodiff; visibility (which triangle is hit, shadow masks) is piecewise
constant, through the rules of ``render/cast_vjp.py``.  Vertex positions
(``include_vertices``) train under ``cfg.edge_aware_grads``: the reparam
cast rule and the silhouette band carry their gradient.  At ``spp > 1``
:func:`make_spp_grad_fn` accumulates the exact full-image gradient over
checkpointed sample frames, whole or in chunks.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from . import tree
from .render.engine import render_frame, render_frame_sum, spp_jitter_grid
from .scene import Camera, RenderConfig, Scene
from .tracing import span


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


def _grad_leaves(value, leaves, grad_output=None) -> list:
    """``d value / d leaves`` (pulled back from ``grad_output``), zeros for
    a leaf the value does not depend on (``kt`` of an opaque world), as
    under ``jax.grad``.  The backward is one ``rt.backward`` span."""
    with span("rt.backward"):
        grads = torch.autograd.grad(value, leaves, grad_outputs=grad_output,
                                    allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(leaves, grads)]


def grad_of(value: torch.Tensor, params: Dict[str, Any]) -> Dict[str, Any]:
    """``d value / d params`` in the structure of ``params``."""
    return tree.unflatten(params, _grad_leaves(value, tree.leaves(params)))


def make_spp_grad_fn(scene: Scene, camera: Camera, cfg: RenderConfig,
                     spp: int, spp_chunk: Optional[int] = None,
                     remat: bool = True,
                     with_stats: bool = False) -> Callable:
    """``step(params, target) -> (loss, grads)``: the exact full-image L2
    loss and gradient at ``spp`` samples a pixel (``diff.make_spp_grad_fn``
    of the JAX package), over ``spp_jitter_grid(spp, ...)``'s offsets with
    ``cfg.replace(spp=1)``.  ``with_stats`` returns ``(loss, grads,
    {"dropped": i32})``: the drops of every sample, probe included (a
    ``static_tile_cap`` probed at the first camera can drop hits once the
    camera moves; a training loop should see 0).

    ``spp_chunk=None`` (or ``>= spp``): one backward through the sum of
    all samples, each checkpointed (``remat``), so memory stays O(1) in
    spp.  A smaller ``spp_chunk`` (dividing spp) sums the chunks' frames
    without a graph first, then pulls ``dL/dimg = 2 (img - target) /
    (img.numel() * spp)`` back through each chunk in turn and adds the
    grads leaf by leaf: the same math, at most one chunk's graph alive."""
    if spp_chunk is None or spp_chunk >= spp:
        spp_chunk = spp
    if spp % spp_chunk:
        raise ValueError(f"spp_chunk {spp_chunk} does not divide spp {spp}")
    n_chunks = spp // spp_chunk
    offs, _ = spp_jitter_grid(spp, cfg.width, cfg.height, camera.pos.device)
    chunks = offs.reshape(n_chunks, spp_chunk, 2)
    cfg1 = cfg.replace(spp=1)

    def render_chunk(params, offs_c):
        s, c = merge_params(scene, camera, params)
        return render_frame_sum(s, c, cfg1, offs_c, remat=remat,
                                with_stats=True)

    def step_stats(params, target):
        leaves = tree.leaves(params)
        if n_chunks == 1:
            img_sum, stats = render_chunk(params, offs)
            loss = l2_image_loss(img_sum / spp, target)
            grads = _grad_leaves(loss, leaves)
            return (loss.detach(), tree.unflatten(params, grads),
                    {"dropped": stats["dropped"]})
        with torch.no_grad():
            acc, stats = render_chunk(params, chunks[0])
            dropped = stats["dropped"]
            for offs_c in chunks[1:]:
                a, stats = render_chunk(params, offs_c)
                acc = acc + a
                dropped = dropped + stats["dropped"]
            img = acc / spp
            loss = l2_image_loss(img, target)
            g_img = 2.0 * (img - target) / (img.numel() * spp)
        grads = None
        for offs_c in chunks:
            g = _grad_leaves(render_chunk(params, offs_c)[0], leaves, g_img)
            grads = g if grads is None else [a + b for a, b in zip(grads, g)]
        return loss, tree.unflatten(params, grads), {"dropped": dropped}

    if with_stats:
        return step_stats

    def step(params, target):
        loss, grads, _ = step_stats(params, target)
        return loss, grads

    return step


def sgd_step(params, grads, lr: float):
    """``p - lr * g`` on every leaf, as fresh leaves with ``requires_grad``."""
    with torch.no_grad():
        return tree.tree_map(lambda p, g: (p - lr * g).requires_grad_(True),
                             params, grads)


def train_step(scene: Scene, camera: Camera, cfg: RenderConfig, target,
               params, lr: float = 1e-2):
    """One optimization step: ``(loss, grads, new_params)``, one ``rt.step``
    span."""
    with span("rt.step"):
        value = make_loss_fn(scene, camera, cfg, target)(params)
        grads = grad_of(value, params)
        return value.detach(), grads, sgd_step(params, grads, lr)
