"""Distribution layer on ``torch.distributed``: meshes of ranks, row and
cyclic-band sharding, geometry sharding with its hit merge and gradient,
the ring cast, the multi-process cluster and the dryrun step.

Counterpart of ``raytracer_tpu/dist.py``.  The JAX module drives a mesh of
devices from one program (``shard_map``, ``NamedSharding``); here every rank
is a process of its own, with an explicit device and explicit process
groups, and calls the same functions as every other rank:

* **rays** (row sharding): each rank of the ``rays`` group renders its rows
  of the frame, contiguous or in cyclic 8-row bands, and an all_gather
  gives every rank the whole frame; a training step all-reduces the loss
  and the gradients as a sum over the ranks (:func:`make_sharded_grad_fn`,
  :func:`dryrun_multichip`);
* **geom** (geometry sharding): the instances are split into contiguous
  shards (:func:`split_scene_by_instances`); each rank casts against its
  shard, the shards' closest hits merge through one all_gather and an
  argmin over the ``geom`` group, and shading reads the full geometry
  (:func:`make_geom_sharded_cast`); :func:`make_ring_geom_cast` passes the
  shards around the ``geom`` ring instead.

The JAX module's ``replicated``, ``ray_sharded`` and ``shard_scene`` place
arrays on the devices of a mesh that one controller drives.  A program of
many controllers has nothing to place: each rank holds its own copy of the
scene (``to_device(scene, device)``) and takes its rows or its shard by its
coordinates in the :class:`Mesh`.  They have no counterpart here.

Backends.  The caller names the backend (``"nccl"`` or ``"gloo"``).  NCCL
takes one rank a card; ranks that share a card run over gloo with their
tensors on the card.  Gloo runs all_gather and all_reduce on CUDA tensors,
but point-to-point sends on host tensors only: around those the tensors go
to the host and back, and the mesh records the collective
(``Mesh.staged``).  The hit merge's autograd all_gather is the port's own
(:class:`_AllGather`, whose backward is one all_reduce).

Launching ranks.  :func:`launch` starts ``n`` rank processes, ``python -m
raytracer_tpu_torch.dist <role> ...``, on a fresh TCP port of this host,
with a wall-clock timeout; it kills every rank when one fails or the time
runs out, and then raises with each rank's stderr.  A role is ``cluster``,
``dryrun`` or any ``module:function`` taking ``(device, **kwargs)``.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import importlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from . import tree
from .builder import scale_camera
from .cube_world import generate
from .diff import grad_of, merge_params, sgd_step, trainable_params
from .render.cast import Cast, Hit, occlude_by_closest
from .render.engine import (make_cast, prepared, render_rays,
                            render_rays_stats, spp_jitter_grid, sum_samples)
from .render.geometry import camera_rays, expand_geometry
from .scene import Camera, RenderConfig, Scene, _np, to_device

RAY_AXIS = "rays"
GEOM_AXIS = "geom"
BAND = 8  # rows per band of the cyclic balance (and the row padding)
WORLD8 = os.path.join(os.path.dirname(os.path.abspath(__file__)), "worlds",
                      "terrain8.json")

# ---------------------------------------------------------------------------
# bring-up and meshes
# ---------------------------------------------------------------------------

def initialize_distributed(init_method: str, world_size: int, rank: int,
                           backend: str,
                           timeout: datetime.timedelta = datetime.timedelta(
                               seconds=600),
                           device: str = "cuda") -> torch.device:
    """Join the process group of ``world_size`` ranks at ``init_method``
    (``tcp://host:port``) as ``rank``, over ``backend`` (``"nccl"`` or
    ``"gloo"``: named by the caller, never guessed), with ``timeout`` on
    the rendezvous and on every collective.  Returns this rank's device:
    ``cuda:{local_rank % device_count}`` (``LOCAL_RANK``, else ``rank``),
    made current, or the CPU for ``device="cpu"``.  Unlike the JAX
    function, one process still forms a group: a rank's collectives need
    one."""
    if device == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    elif device == "cpu":
        dev = torch.device("cpu")
    else:
        raise ValueError(f"device {device!r}: expected 'cuda' or 'cpu'")
    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=timeout)
    return dev


@dataclass
class Mesh:
    """This rank's place in a mesh of ranks: the dimension names, their
    sizes, this rank's coordinate along each, and for each dimension the
    process group of the ranks that differ from this one along it alone.
    ``staged`` collects the collectives that went through the host."""

    names: tuple
    shape: tuple
    coords: tuple
    groups: dict
    backend: str
    staged: set = field(default_factory=set)

    def size(self, name: str) -> int:
        return self.shape[self.names.index(name)]

    def index(self, name: str) -> int:
        return self.coords[self.names.index(name)]


def make_mesh() -> Mesh:
    """The 1-D ``("rays",)`` mesh over every rank of the world."""
    return Mesh(names=(RAY_AXIS,), shape=(dist.get_world_size(),),
                coords=(dist.get_rank(),), groups={RAY_AXIS: dist.group.WORLD},
                backend=dist.get_backend())


def make_mesh2d(n_ray: int, n_geom: int) -> Mesh:
    """The 2-D ``("rays", "geom")`` mesh: rank ``r`` sits at ``(r //
    n_geom, r % n_geom)``.  Every rank creates every row and column group,
    in the same order (``new_group``'s rule); the world must hold exactly
    ``n_ray * n_geom`` ranks."""
    world = dist.get_world_size()
    if world != n_ray * n_geom:
        raise ValueError(f"a {n_ray}x{n_geom} mesh needs {n_ray * n_geom} "
                         f"ranks, the world has {world}")
    rank = dist.get_rank()
    i, j = divmod(rank, n_geom)
    groups = {}
    for row in range(n_ray):  # the geom groups: one ray block each
        g = dist.new_group([row * n_geom + c for c in range(n_geom)])
        if row == i:
            groups[GEOM_AXIS] = g
    for col in range(n_geom):  # the rays groups: one geometry shard each
        g = dist.new_group([r * n_geom + col for r in range(n_ray)])
        if col == j:
            groups[RAY_AXIS] = g
    return Mesh(names=(RAY_AXIS, GEOM_AXIS), shape=(n_ray, n_geom),
                coords=(i, j), groups=groups, backend=dist.get_backend())


def pad_to_multiple(n: int, m: int) -> int:
    return (n + m - 1) // m * m


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

class _AllGather(torch.autograd.Function):
    """``[G, ...]``: ``x`` of every rank of ``group``, in group order.  Its
    backward hands each rank its slice of the cotangent all-reduced over
    the group: the SUM of every rank's cotangent of its ``x``.  (The
    backward of ``torch.distributed.nn.functional.all_gather`` under gloo
    scatters from each group-local rank as if it were a global one, and
    fails on any group but the world.)"""

    @staticmethod
    def forward(ctx, x, group, index):
        ctx.group, ctx.index = group, index
        out = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(out, x.contiguous(), group=group)
        return torch.stack(out)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g[ctx.index], None, None


def _all_gather(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """``[G, ...]``: ``x`` of every rank of ``axis``'s group, in group
    order, with :class:`_AllGather`'s gradient."""
    if mesh.size(axis) == 1:
        return x[None]
    return _AllGather.apply(x, mesh.groups[axis], mesh.index(axis))


def _all_reduce_sum(x: torch.Tensor, mesh: Mesh,
                    axis: Optional[str] = None) -> torch.Tensor:
    """The sum of ``x`` over ``axis``'s group (every rank for None)."""
    group = dist.group.WORLD if axis is None else mesh.groups[axis]
    x = x.clone().contiguous()
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def _reduce_step(loss, grads, mesh: Mesh, scale: float = 1.0):
    """``(loss, grads)`` summed over every rank and times ``scale``, in one
    all_reduce of the flattened leaves."""
    leaves = tree.leaves(grads)
    flat = torch.cat([loss.detach().reshape(1)]
                     + [g.reshape(-1) for g in leaves])
    flat = _all_reduce_sum(flat, mesh) * scale
    out, k = [], 1
    for g in leaves:
        out.append(flat[k:k + g.numel()].reshape(g.shape))
        k += g.numel()
    return flat[0], tree.unflatten(grads, out)


# ---------------------------------------------------------------------------
# row sharding
# ---------------------------------------------------------------------------

def _padded_rays(camera: Camera, cfg: RenderConfig, hp: int, jitter=None):
    """The frame's camera rays ``[hp, W, 3]``: rows past the height take
    origin 0 and direction (0, 0, 1), as the JAX module pads them (the
    camera mapping stays at the true height)."""
    ro, rd = camera_rays(camera, cfg.width, cfg.height, jitter=jitter)
    pad = hp - cfg.height
    if pad:
        ro = torch.nn.functional.pad(ro, (0, 0, 0, 0, 0, pad))
        rd = torch.cat([rd, rd.new_tensor([0.0, 0.0, 1.0]).expand(
            pad, cfg.width, 3)])
    return ro, rd


def _band_order(hp: int, n: int, balance: str) -> Optional[np.ndarray]:
    """The static row permutation of ``balance``: None for contiguous
    stripes; for ``"cyclic"``, band ``b`` of ``BAND`` rows goes to rank ``b
    mod n`` (each rank's bands in screen order)."""
    if balance == "contiguous":
        return None
    if balance != "cyclic":
        raise ValueError(f"balance {balance!r}: expected 'contiguous' or "
                         "'cyclic'")
    order = np.arange(hp // BAND).reshape(-1, n).T.reshape(-1)
    return (order[:, None] * BAND + np.arange(BAND)[None, :]).reshape(-1)


def _render_rows(scene: Scene, camera: Camera, cfg: RenderConfig, hp: int,
                 rows: torch.Tensor, pixel_angle=None) -> torch.Tensor:
    """The padded frame's rows ``rows`` ``[k, W, 4]`` through
    :func:`render_rays`.  At ``spp > 1`` the mean of the jittered samples of
    ``render_frame`` (``spp_jitter_grid``, ``(off + shift) % 1``), over cast
    tables built once, through the engine's sweep (``sum_samples``: each
    sample checkpointed in grad mode)."""
    geom, aux = prepared(scene, cfg)
    if cfg.spp <= 1:
        ro, rd = _padded_rays(camera, cfg, hp)
        return render_rays(scene, geom, make_cast(scene, geom, cfg, aux=aux),
                           cfg, ro[rows], rd[rows], pixel_angle)
    offs, shift = spp_jitter_grid(cfg.spp, cfg.width, cfg.height,
                                  camera.pos.device)

    def sample(off):
        ro, rd = _padded_rays(camera, cfg, hp, jitter=(off + shift) % 1.0)
        return render_rays_stats(scene, geom,
                                 make_cast(scene, geom, cfg, aux=aux), cfg,
                                 ro[rows], rd[rows], pixel_angle)

    acc, _ = sum_samples(sample, offs)
    return acc / cfg.spp


def _my_rows(hp: int, mesh: Mesh, perm=None) -> torch.Tensor:
    """The padded-frame rows this rank renders (int64 on the CPU)."""
    n, i = mesh.size(RAY_AXIS), mesh.index(RAY_AXIS)
    k = hp // n
    rows = np.arange(i * k, (i + 1) * k) if perm is None else \
        perm[i * k:(i + 1) * k]
    return torch.from_numpy(np.ascontiguousarray(rows))


def make_sharded_render(scene: Scene, camera: Camera, cfg: RenderConfig,
                        mesh: Mesh, balance: str = "contiguous"
                        ) -> Callable[[], torch.Tensor]:
    """``run() -> [H, W, 4]``, called by every rank of the mesh's ``rays``
    group: each renders its rows of the frame and an all_gather gives every
    rank the whole frame (no gradient).

    The height need not divide the group: the ray grid is padded with
    dummy rows up to a multiple of ``n * BAND`` and cropped after.
    ``balance="cyclic"`` deals the 8-row bands round robin (band ``b`` to
    rank ``b mod n``) so that a cluster of expensive rows spreads over the
    ranks; the permutation and its inverse are static, and a frame equals
    the contiguous one bit for bit."""
    n = mesh.size(RAY_AXIS)
    hp = pad_to_multiple(cfg.height, n * BAND)
    perm = _band_order(hp, n, balance)
    dev = scene.inst_pos.device
    rows = _my_rows(hp, mesh, perm).to(dev)
    inv = None
    if perm is not None:
        inv = np.empty_like(perm)
        inv[perm] = np.arange(hp)
        inv = torch.from_numpy(inv).to(dev)

    @torch.no_grad()
    def run():
        block = _render_rows(scene, camera, cfg, hp, rows)
        full = _all_gather(block, mesh, RAY_AXIS).reshape(hp, cfg.width, 4)
        if inv is not None:
            full = full[inv]
        return full[:cfg.height]

    return run


def make_sharded_grad_fn(scene: Scene, camera: Camera, cfg: RenderConfig,
                         mesh: Mesh) -> Callable:
    """``step(params, target) -> (loss, grads)`` on every rank of a 1-D
    mesh: the rank renders its contiguous rows from the MERGED camera (so
    the camera gradients flow; ``pixel_angle`` detached), its loss is
    ``sum((img - target)^2) / n_px`` over its real rows (``n_px`` =
    H*W*4: the full frame's L2 mean once summed), and the loss and every
    gradient leaf are all-reduced as a sum over the ranks.  ``target`` is
    the whole ``[H, W, 4]`` frame on every rank."""
    n = mesh.size(RAY_AXIS)
    hp = pad_to_multiple(cfg.height, n * BAND)
    dev = scene.inst_pos.device
    rows = _my_rows(hp, mesh).to(dev)
    real = (rows < cfg.height)[:, None, None]
    n_px = float(cfg.height * cfg.width * 4)

    def step(params, target):
        s, c = merge_params(scene, camera, params)
        pixel_angle = (1.0 / (c.unit_to_pixels * c.global_near)).detach()
        img = _render_rows(s, c, cfg, hp, rows, pixel_angle)
        tgt = torch.nn.functional.pad(
            target, (0, 0, 0, 0, 0, hp - cfg.height))[rows]
        loss = torch.where(real, (img - tgt) ** 2, 0.0).sum() / n_px
        return _reduce_step(loss, grad_of(loss, params), mesh)

    return step


# ---------------------------------------------------------------------------
# geometry partitioning ("tensor parallel" over instances)
# ---------------------------------------------------------------------------

def split_scene_by_instances(scene: Scene, n_shards: int) -> dict:
    """Host-side partition of the instances into ``n_shards`` contiguous
    chunks, padded to one size: ``per = ceil(n / S) + 1`` instances a
    shard, the last (index ``per - 1``) a pad instance parked at 1e30 that
    owns the pad world-triangle rows, so they never alias real geometry.
    Returns numpy arrays stacked over the shards: ``inst_pos/rot/mesh [S,
    per, ...]``, ``wtri_inst`` (LOCAL instance ids) and ``wtri_tri [S,
    Wp]``, ``wtri_base [S]`` (the global world-triangle id of the shard's
    first row).  Rank ``g`` of the ``geom`` group takes row ``g``
    (:func:`take_shard`)."""
    n = int(_np(scene.inst_pos).shape[0])
    per = pad_to_multiple(n, n_shards) // n_shards + 1

    inst_pos = _np(scene.inst_pos)
    inst_rot = _np(scene.inst_rot)
    inst_mesh = _np(scene.inst_mesh)
    wtri_inst = _np(scene.wtri_inst)
    wtri_tri = _np(scene.wtri_tri)

    pos_s, rot_s, mesh_s = [], [], []
    winst_s, wtri_s, wbase_s = [], [], []
    # world tris are contiguous per instance (expand_geometry's layout)
    inst_starts = np.searchsorted(wtri_inst, np.arange(n))
    w_max = 0
    chunks = []
    for s in range(n_shards):
        lo = min(s * (per - 1), n)
        hi = min(lo + per - 1, n)
        w_lo = int(inst_starts[lo]) if lo < n else len(wtri_inst)
        w_hi = int(inst_starts[hi]) if hi < n else len(wtri_inst)
        chunks.append((lo, hi, w_lo, w_hi))
        w_max = max(w_max, w_hi - w_lo)

    for lo, hi, w_lo, w_hi in chunks:
        k = hi - lo
        p = np.full((per, 3), 1.0e30, np.float32)
        r = np.tile(np.array([0, 0, 0, 1], np.float32), (per, 1))
        m = np.zeros((per,), np.int32)
        p[:k] = inst_pos[lo:hi]
        r[:k] = inst_rot[lo:hi]
        m[:k] = inst_mesh[lo:hi]
        wi = np.full((w_max,), per - 1, np.int32)  # pad rows: pad instance
        wt = np.zeros((w_max,), np.int32)
        wi[: w_hi - w_lo] = wtri_inst[w_lo:w_hi] - lo  # LOCAL instance ids
        wt[: w_hi - w_lo] = wtri_tri[w_lo:w_hi]
        pos_s.append(p)
        rot_s.append(r)
        mesh_s.append(m)
        winst_s.append(wi)
        wtri_s.append(wt)
        wbase_s.append(w_lo)

    return {
        "inst_pos": np.stack(pos_s),
        "inst_rot": np.stack(rot_s),
        "inst_mesh": np.stack(mesh_s),
        "wtri_inst": np.stack(winst_s),
        "wtri_tri": np.stack(wtri_s),
        "wtri_base": np.asarray(wbase_s, np.int32),
    }


def take_shard(shards: dict, g: int, device) -> Dict[str, torch.Tensor]:
    """Shard ``g`` of :func:`split_scene_by_instances` as tensors on
    ``device`` (``wtri_base`` a 0-d int32 tensor)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v[g])).to(device)
            for k, v in shards.items()}


def _local_scene(scene: Scene, shard: dict) -> Scene:
    """The scene whose instance tables are one geometry shard."""
    return dataclasses.replace(
        scene, inst_pos=shard["inst_pos"], inst_rot=shard["inst_rot"],
        inst_mesh=shard["inst_mesh"], wtri_inst=shard["wtri_inst"],
        wtri_tri=shard["wtri_tri"])


def _need_scalar(cfg: RenderConfig) -> None:
    """The merged casts read each shard's ``normal`` and ``mat``, which only
    the scalar casts give."""
    if cfg.pallas_kernel != "scalar":
        raise ValueError(f"pallas_kernel {cfg.pallas_kernel!r}: geometry "
                         "sharding takes the scalar cast (the MXU cast gives "
                         "no normal or material)")


def _pick(x: torch.Tensor, arg: torch.Tensor) -> torch.Tensor:
    """``x[arg[r], r]`` of a gathered ``[G, R, k]``."""
    idx = arg[None, :, None].expand(1, x.shape[1], x.shape[2])
    return torch.gather(x, 0, idx)[0]


def make_geom_sharded_cast(scene: Scene, cfg: RenderConfig, shard: dict,
                           mesh: Mesh) -> Cast:
    """The merged cast of a geometry shard, called by every rank of the
    ``geom`` group on the same rays: the engine's cast against this rank's
    shard, then one all_gather of the float fields ``(t with inf for a
    miss, uv, normal)``, differentiable, and one of the int32 fields
    ``(wtri + wtri_base, mat)`` over the group, and the argmin of t over
    the shards (the first minimum wins, as ``jnp.argmin`` picks it);
    ``valid`` is a finite t (the JAX cast also gathers ``valid`` and never
    reads it).  Its ``occlude`` is the local any-hit query all-reduced as
    an int32 sum, then ``> 0``.  It has no ``occlude2``: the fused-shadow
    round falls back to one query a light, as the JAX merged cast does.

    Gradients: the merged pick is a gather whose backward, through the
    all_gather's, reaches the OWNING shard's cast (its VJP rule; the
    reparam rule under ``edge_aware_grads``, into this shard's triangle
    rows and through them ``scene.verts``).  Every ``geom`` rank computes
    the same merged loss, so that backward sums G equal cotangents: take
    the mean over ``geom`` (:func:`make_geom_sharded_grad_fn`).

    The scalar casts of both engines give ``normal`` and ``mat``, which
    shading reads; the MXU cast does not, and raises ``ValueError`` here
    (the JAX function asserts its scalar Pallas cast)."""
    _need_scalar(cfg)
    local = _local_scene(scene, shard)
    # uncached (not engine.prepared): each call builds a new local scene
    inner = make_cast(local, expand_geometry(local), cfg)
    base = shard["wtri_base"]

    def closest(o, d):
        h = inner(o, d)
        t = torch.where(h.valid, h.t, torch.inf)
        floats = _all_gather(torch.cat([t[:, None], h.uv, h.normal], 1), mesh,
                             GEOM_AXIS)
        ints = _all_gather(torch.stack([h.wtri + base, h.mat], 1)
                           .to(torch.int32), mesh, GEOM_AXIS)
        arg = torch.argmin(floats[..., 0], dim=0)
        f, i = _pick(floats, arg), _pick(ints, arg)
        best_t = f[:, 0]
        return Hit(valid=torch.isfinite(best_t), t=best_t, wtri=i[:, 0],
                   uv=f[:, 1:3], normal=f[:, 3:6], mat=i[:, 1])

    def occlude(o, d, max_t):
        blk = inner.occlude(o, d, max_t).to(torch.int32)
        return _all_reduce_sum(blk, mesh, GEOM_AXIS) > 0

    return Cast(closest, occlude)


def geom_sharded_render_rays(scene: Scene, cfg: RenderConfig, shard: dict,
                             ro_b, rd_b, mesh: Mesh, pixel_angle=None):
    """Shading over the merged cast of :func:`make_geom_sharded_cast`: the
    CAST runs against this rank's shard; SHADING against the FULL geometry
    (``expand_geometry(scene)``), since the merged hits carry GLOBAL
    world-triangle ids (the edge-aware band reads ``band_tbl[hit.wtri]``)."""
    cast = make_geom_sharded_cast(scene, cfg, shard, mesh)
    # uncached, as the cast's: each call builds a new local scene
    img, _ = render_rays_stats(scene, expand_geometry(scene), cast, cfg,
                               ro_b, rd_b, pixel_angle)
    return img


def make_geom_sharded_render(scene: Scene, camera: Camera, cfg: RenderConfig,
                             mesh: Mesh) -> Callable[[], torch.Tensor]:
    """``run() -> [H, W, 4]`` on every rank of a 2-D mesh: ray rows padded
    to a multiple of ``n_ray``, each ``rays`` row of the mesh rendering its
    block against each rank's geometry shard through the merged cast, the
    blocks gathered over the ``rays`` group.  Both engines' scalar casts
    give ``normal`` and ``mat`` (the JAX function asserts its Pallas engine
    for that reason); the MXU cast raises ``ValueError``."""
    n_ray = mesh.size(RAY_AXIS)
    dev = scene.inst_pos.device
    shard = take_shard(split_scene_by_instances(scene, mesh.size(GEOM_AXIS)),
                       mesh.index(GEOM_AXIS), dev)
    hp = pad_to_multiple(cfg.height, n_ray)
    k = hp // n_ray
    i = mesh.index(RAY_AXIS)

    @torch.no_grad()
    def run():
        ro, rd = _padded_rays(camera, cfg, hp)
        img = geom_sharded_render_rays(scene, cfg, shard,
                                       ro[i * k:(i + 1) * k],
                                       rd[i * k:(i + 1) * k], mesh)
        full = _all_gather(img, mesh, RAY_AXIS).reshape(hp, cfg.width, 4)
        return full[:cfg.height]

    return run


def make_geom_sharded_grad_fn(scene: Scene, camera: Camera,
                              cfg: RenderConfig, mesh: Mesh) -> Callable:
    """``step(params, target) -> (loss, grads)`` on every rank of a 2-D
    mesh: each ``rays`` row renders its block from the MERGED camera
    through the merged cast (``pixel_angle`` detached), the loss is
    ``sum((img - target)^2) / n_px`` over the real rows, and the loss and
    grads are summed over every rank and divided by ``n_geom``: a sum over
    ``rays`` and a mean over ``geom``, since every ``geom`` rank computes the
    same merged loss and the merge's backward sums their cotangents."""
    n_ray, n_geom = mesh.size(RAY_AXIS), mesh.size(GEOM_AXIS)
    dev = scene.inst_pos.device
    shard = take_shard(split_scene_by_instances(scene, n_geom),
                       mesh.index(GEOM_AXIS), dev)
    hp = pad_to_multiple(cfg.height, n_ray)
    k = hp // n_ray
    i = mesh.index(RAY_AXIS)
    real = (torch.arange(i * k, (i + 1) * k, device=dev)
            < cfg.height)[:, None, None]
    n_px = float(cfg.height * cfg.width * 4)

    def step(params, target):
        s, c = merge_params(scene, camera, params)
        ro, rd = _padded_rays(c, cfg, hp)
        pixel_angle = (1.0 / (c.unit_to_pixels * c.global_near)).detach()
        img = geom_sharded_render_rays(s, cfg, shard, ro[i * k:(i + 1) * k],
                                       rd[i * k:(i + 1) * k], mesh,
                                       pixel_angle)
        tgt = torch.nn.functional.pad(
            target, (0, 0, 0, 0, 0, hp - cfg.height))[i * k:(i + 1) * k]
        loss = torch.where(real, (img - tgt) ** 2, 0.0).sum() / n_px
        return _reduce_step(loss, grad_of(loss, params), mesh,
                            scale=1.0 / n_geom)

    return step


_SHARD_F32 = ("inst_pos", "inst_rot")
_SHARD_I32 = ("inst_mesh", "wtri_inst", "wtri_tri", "wtri_base")


def _pass_shard(shard: dict, mesh: Mesh) -> dict:
    """Send ``shard`` to the next rank of the ``geom`` ring and receive the
    previous rank's (two tensors each way, in one ``batch_isend_irecv``)."""
    group = mesh.groups[GEOM_AXIS]
    ranks = dist.get_process_group_ranks(group)
    g, n = mesh.index(GEOM_AXIS), mesh.size(GEOM_AXIS)
    nxt, prv = ranks[(g + 1) % n], ranks[(g - 1) % n]
    out = [torch.cat([shard[k].reshape(-1) for k in names])
           for names in (_SHARD_F32, _SHARD_I32)]
    if out[0].is_cuda and mesh.backend == "gloo":  # gloo sends host memory
        mesh.staged.add("send/recv")
        out = [x.cpu() for x in out]
    inc = [torch.empty_like(x) for x in out]
    ops = [dist.P2POp(dist.isend, x, nxt, group=group, tag=t)
           for t, x in enumerate(out)]
    ops += [dist.P2POp(dist.irecv, x, prv, group=group, tag=t)
            for t, x in enumerate(inc)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    dev = shard["inst_pos"].device
    new = {}
    for names, flat in zip((_SHARD_F32, _SHARD_I32), inc):
        at = 0
        for k in names:
            m = shard[k].numel()
            new[k] = flat[at:at + m].reshape(shard[k].shape).to(dev)
            at += m
    return new


def make_ring_geom_cast(scene: Scene, cfg: RenderConfig, shard: dict,
                        mesh: Mesh) -> Cast:
    """Ring-streaming geometry partitioning: the rays stay, the geometry
    shards travel.  ``cast(o, d) -> Hit``, called by every rank of the
    ``geom`` group: G steps, each casting against the visiting shard and
    folding its hits where ``t < best`` (strict: a tie keeps the earlier
    shard), then passing the shard to the next rank of the ring
    (``batch_isend_irecv``; one instance table a step instead of per-ray
    hits).  Forward only, as the JAX function is used.  A miss keeps wtri 0
    and zero attributes, as the JAX fold does.  Its ``occlude`` is the
    closest hit's (``occlude_by_closest``).  The scalar casts only, as
    :func:`make_geom_sharded_cast`."""
    _need_scalar(cfg)
    n = mesh.size(GEOM_AXIS)

    @torch.no_grad()
    def cast(o, d):
        rays = o.shape[:-1]
        i32 = dict(dtype=torch.int32, device=o.device)
        best = (torch.full(rays, torch.inf, device=o.device),
                torch.zeros(rays, **i32), o.new_zeros(rays + (2,)),
                torch.zeros_like(o), torch.zeros(rays, **i32))
        sh = shard
        for step in range(n):
            local = _local_scene(scene, sh)
            # uncached: each call builds a new local scene
            h = make_cast(local, expand_geometry(local), cfg)(o, d)
            now = (torch.where(h.valid, h.t, torch.inf),
                   h.wtri + sh["wtri_base"], h.uv, h.normal, h.mat)
            better = now[0] < best[0]
            best = tuple(torch.where(better.reshape(
                better.shape + (1,) * (a.dim() - better.dim())), a, b)
                for a, b in zip(now, best))
            if step + 1 < n:
                sh = _pass_shard(sh, mesh)
        t, wtri, uv, normal, mat = best
        return Hit(valid=torch.isfinite(t), t=t, wtri=wtri, uv=uv,
                   normal=normal, mat=mat)

    return Cast(cast, occlude_by_closest(cast))


# ---------------------------------------------------------------------------
# the dryrun step (``__graft_entry__.dryrun_multichip``)
# ---------------------------------------------------------------------------

def _resolve_device(device) -> torch.device:
    if str(device) == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def dryrun_config(width: int, height: int, device) -> tuple:
    """``(scene, camera, cfg)`` of the dryrun step on ``device``: terrain8
    (world8's shape) at ``width`` x ``height`` with the full field of view,
    ``engine="cuda"`` (``"torch"`` on the CPU), ``pallas_kernel="scalar"``,
    spp 2, ``edge_aware_grads``, ``shadow_steps=2``, ``early_exit=False``."""
    dev = _resolve_device(device)
    w = generate(WORLD8)
    cfg = w.config.replace(
        width=width, height=height, ray_chunk=width * height,
        early_exit=False, shadow_steps=2,
        engine="cuda" if dev.type == "cuda" else "torch",
        pallas_kernel="scalar", spp=2, edge_aware_grads=True)
    camera = to_device(scale_camera(w.camera, width, w.config.width), dev)
    return to_device(w.scene, dev), camera, cfg


def dryrun_multichip(n_ranks: int, width: Optional[int] = None,
                     height: Optional[int] = None, device="cuda") -> tuple:
    """One row-sharded differentiable training step of the full
    configuration (:func:`dryrun_config`), run on every rank of an
    ``n_ranks`` world: materials, lights, camera pose and vertices
    trainable, each rank rendering its rows (each sample checkpointed),
    the loss and grads all-reduced as a sum over ``rays``
    (:func:`make_sharded_grad_fn`), then ``sgd_step(lr=1e-2)``.  The default
    size is the JAX function's: ``height = 8 n``, ``width = 2 height``.
    Rank 0 prints its summary line.  Returns ``(loss, grads,
    new_params)``."""
    if dist.get_world_size() != n_ranks:
        raise ValueError(f"dryrun_multichip({n_ranks}) in a world of "
                         f"{dist.get_world_size()} ranks")
    height = height or 8 * n_ranks
    width = width or 2 * height
    scene, camera, cfg = dryrun_config(width, height, device)
    params = trainable_params(scene, camera, include_camera=True,
                              include_vertices=True)
    target = torch.zeros(height, width, 4, device=scene.inst_pos.device)
    loss, grads = make_sharded_grad_fn(scene, camera, cfg, make_mesh())(
        params, target)
    new_params = sgd_step(params, grads, 1e-2)
    if dist.get_rank() == 0:
        vl1 = float(grads["verts"].abs().sum())
        cl1 = float(grads["cam_pos"].abs().sum()) + float(
            grads["cam_rot"].abs().sum())
        gsum = sum(float(p.detach().abs().sum())
                   for p in tree.leaves(new_params))
        print(f"dryrun_multichip({n_ranks}): loss={float(loss):.6f} "
              f"vert_grad_l1={vl1:.6f} cam_grad_l1={cl1:.6f} "
              f"params_l1={gsum:.3f} OK (terrain8 {width}x{height}, "
              f"{cfg.engine} cast, spp=2 checkpointed samples, edge-aware "
              f"vertex+camera grads, all_reduce over {n_ranks} ranks)",
              flush=True)
    return loss, grads, new_params


# ---------------------------------------------------------------------------
# ranks: the worker and the launcher
# ---------------------------------------------------------------------------

def flat_tree(t) -> Dict[str, torch.Tensor]:
    """A parameter or gradient tree as ``{key path: CPU tensor}``."""
    return {k: v.detach().cpu() for k, v in tree.leaves_with_paths(t)}


def _role_cluster(device, width: int = 32, height: int = 32) -> dict:
    """The cluster check: a row-sharded terrain8 frame's sum and an
    all-reduce of each rank's share of ``arange(16)^2`` (1240)."""
    dev = _resolve_device(device)
    w = generate(WORLD8)
    cfg = w.config.replace(width=width, height=height,
                           engine="cuda" if dev.type == "cuda" else "torch")
    mesh = make_mesh()
    frame = make_sharded_render(
        to_device(w.scene, dev),
        to_device(scale_camera(w.camera, width, w.config.width), dev),
        cfg, mesh)()
    x = torch.arange(16.0, device=dev).chunk(dist.get_world_size())[
        dist.get_rank()]
    coll = float(_all_reduce_sum((x * x).sum(), mesh))
    total = float(frame.sum())
    print(f"RESULT rank={dist.get_rank()} frame_sum={total:.6f} "
          f"collective={coll:.1f}", flush=True)
    return {"frame_sum": total, "collective": coll}


def _role_dryrun(device, width: Optional[int] = None,
                 height: Optional[int] = None) -> dict:
    loss, grads, new = dryrun_multichip(dist.get_world_size(), width, height,
                                        device)
    return {"loss": float(loss), "grads": flat_tree(grads),
            "new_params": flat_tree(new)}


ROLES = {"cluster": _role_cluster, "dryrun": _role_dryrun}


def _role(name: str) -> Callable:
    if name in ROLES:
        return ROLES[name]
    module, _, fn = name.partition(":")
    if not fn:
        raise ValueError(f"role {name!r}: expected one of {sorted(ROLES)} "
                         "or module:function")
    return getattr(importlib.import_module(module), fn)


def free_port() -> int:
    """A TCP port of this host that is free now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class LaunchError(RuntimeError):
    """A rank failed or the launch ran out of time."""


def launch(role: str, n_ranks: int, *, backend: str,
           kwargs: Optional[dict] = None, device: str = "cuda",
           timeout: float = 600.0, threads: int = 0,
           pythonpath: Sequence[str] = ()) -> list:
    """Run ``role`` on ``n_ranks`` rank processes (``python -m
    raytracer_tpu_torch.dist``) rendezvousing on a fresh TCP port of this
    host over ``backend`` (``"gloo"`` or ``"nccl"``), each rank on
    ``device`` (``"cuda"`` or ``"cpu"``); ``kwargs`` (JSON) go to the
    role's function.  Returns, per rank,
    ``{"result": what the role returned (CPU tensors), "stdout": ...}``.

    Every rank must exit 0 within ``timeout`` seconds: when one exits
    otherwise, or the time runs out, every rank is killed and
    :class:`LaunchError` carries each rank's stderr.  ``threads`` sets each
    rank's ``torch.set_num_threads``; ``pythonpath`` entries go before the
    inherited ``PYTHONPATH`` (the role's module must be importable)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [*pythonpath, root] + ([env["PYTHONPATH"]]
                               if env.get("PYTHONPATH") else []))
    init = f"tcp://127.0.0.1:{free_port()}"
    with tempfile.TemporaryDirectory() as tmp:
        procs, files = [], []
        try:
            for r in range(n_ranks):
                out = open(os.path.join(tmp, f"rank{r}.out"), "w+")
                err = open(os.path.join(tmp, f"rank{r}.err"), "w+")
                files.append((out, err))
                cmd = [sys.executable, "-m", "raytracer_tpu_torch.dist", role,
                       "--rank", str(r), "--world-size", str(n_ranks),
                       "--init-method", init, "--backend", backend,
                       "--device", device, "--timeout", str(timeout),
                       "--threads", str(threads), "--out", tmp,
                       "--kwargs", json.dumps(kwargs or {})]
                procs.append(subprocess.Popen(cmd, stdout=out, stderr=err,
                                              cwd=root, env=env))
            deadline = time.monotonic() + timeout
            failed = None
            while failed is None:
                codes = [p.poll() for p in procs]
                bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if bad:
                    failed = f"rank {bad[0]} exited {codes[bad[0]]}"
                elif all(c == 0 for c in codes):
                    break
                elif time.monotonic() > deadline:
                    failed = f"timed out after {timeout:.0f} s"
                else:
                    time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()

        def text(f):
            f.flush()
            f.seek(0)
            return f.read()

        logs = [(text(o), text(e)) for o, e in files]
        for o, e in files:
            o.close()
            e.close()
        if failed is not None:
            raise LaunchError(f"{role} on {n_ranks} ranks: {failed}\n" + "\n"
                              .join(f"--- rank {r} stderr ---\n{e[-4000:]}"
                                    for r, (_, e) in enumerate(logs)))
        return [{"result": torch.load(os.path.join(tmp, f"rank{r}.pt"),
                                      weights_only=True),
                 "stdout": logs[r][0]} for r in range(n_ranks)]


def _to_cpu(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_cpu(v) for v in x)
    return x


def _main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m raytracer_tpu_torch.dist",
        description="One rank of a launch (see raytracer_tpu_torch.dist."
                    "launch, which starts every rank).")
    ap.add_argument("role", help=f"{' | '.join(sorted(ROLES))} | "
                                 "module:function")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world-size", type=int, required=True)
    ap.add_argument("--init-method", required=True,
                    help="tcp://host:port of the rendezvous")
    ap.add_argument("--backend", required=True, choices=("gloo", "nccl"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds for the rendezvous and each collective")
    ap.add_argument("--threads", type=int, default=0,
                    help="torch.set_num_threads (0: torch's default)")
    ap.add_argument("--kwargs", default="{}", help="JSON keyword arguments")
    ap.add_argument("--out", default=None,
                    help="directory for rank<r>.pt (the role's result)")
    args = ap.parse_args(argv)
    if args.threads:
        torch.set_num_threads(args.threads)
    dev = initialize_distributed(
        args.init_method, args.world_size, args.rank, args.backend,
        datetime.timedelta(seconds=args.timeout), args.device)
    result = _role(args.role)(dev, **json.loads(args.kwargs))
    if args.out:
        torch.save(_to_cpu(result),
                   os.path.join(args.out, f"rank{args.rank}.pt"))
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(_main())
