"""The candidate-list cull: per-tile lists, closest hit (K4), any hit (K5).

Counterpart of the cull traversal of ``raytracer_tpu/render/pallas_engine.py``,
the JAX package's path for worlds of <= 256 instances under
``pallas_traversal="auto"`` (and for ``"cull"``):

* :func:`tile_candidates` (``pallas_engine.tile_candidates``, torch ops): an
  interval-arithmetic slab test of each ray tile's origin and direction
  bounds against every instance AABB, compacted near to far into a list of
  at most ``max_cand`` instances per tile, or flagged overflow;
* K4 ``_cast_kernel`` -> :func:`cull_cast` / :func:`cull_cast_reference`:
  closest hit over each tile's list (over all instances on overflow), with
  the ``tmin < best`` prune;
* K5 ``_occlude_kernel`` -> :func:`cull_occlude` /
  :func:`cull_occlude_reference`: the any-hit query over the same lists,
  stopping once the ray is blocked.

The rays are laid out exactly as the JAX package lays them out
(:class:`CullLayout`): chunks of ``cfg.pallas_ray_chunk``
(``cast._chunked_over_rays``), each padded to a multiple of the tile
(``_pad_rays``), pad rows at origin 1e30 and direction (0, 0, 1).  So each
ray lands in the same tile, and candidate lists, overflow flags and the order
of visits are the JAX package's own.  A pad row, or a parked shadow lane
(origin 1e30), widens its tile's origin bounds, and such a tile usually votes
for nearly every instance and overflows: that is the JAX package's behaviour,
kept.

The CUDA kernels (``csrc/cull_kernels.cu``) run one ray per thread over its
tile's list, from a copy of the list in shared memory (in pieces of at most
:data:`PIECE` entries, so any instance count runs), four entries at a
time, passing over what no lane of a warp can use (K5: leaving once no lane
can be blocked; K4: once no lane can find a closer hit in the rest of the
list); the plain versions take the same instances in the same order for
each ray (slot ``k`` of the ray's tile, or ``k`` itself on overflow) with
the table rows gathered per ray, and give the same bits.  Under
``edge_aware_grads`` K4 runs its exact_uv instantiation.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from .. import raymath as rm
from ..scene import RenderConfig
from . import cuda_engine as ce
from .cast import Cast, Hit
from .cast_vjp import closest_hit, occlude2_detached, occlude_detached

LANES = 128  # the JAX package's lane width: a tile is tile_rows * LANES rays
MAX_CAND = 64  # make_pallas_cast's default list length
# K4 and K5 stage a tile's list in shared memory in pieces of at most PIECE
# entries (csrc/cull_kernels.cu kPiece); a list of up to PIECE columns is
# one piece, and the overflow list's pieces have their union boxes built
# once per launch into scratch of 8 floats a piece
PIECE = 512


def auto_tile_rows(width: int, height: int) -> int:
    """``pallas_engine.auto_tile_rows``: 48 rows up to 8,192 rows of 128
    rays after padding the frame to multiples of 32, else 64."""
    hp = -(-height // 32) * 32
    wp = -(-width // 32) * 32
    return 48 if hp * wp // LANES <= 8192 else 64


def tile_rows_of(cfg: RenderConfig) -> int:
    """``cfg.tile_rows``, or :func:`auto_tile_rows` when it is 0."""
    rows = int(cfg.tile_rows) or auto_tile_rows(cfg.width, cfg.height)
    if rows <= 0 or rows % 8:
        raise ValueError(f"tile_rows must be a positive multiple of 8, got "
                         f"{rows}")
    return rows


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclass(frozen=True)
class CullLayout:
    """Where ``R`` rays sit among the padded rays the kernels see:
    ``n_chunks`` chunks of ``chunk`` rays (the last one filled up with pad
    rows), each padded to ``chunk_p``, a multiple of ``tile``."""

    R: int
    chunk: int
    n_chunks: int
    chunk_p: int
    tile: int

    @classmethod
    def of(cls, R: int, ray_chunk: int, tile: int) -> "CullLayout":
        chunk = min(ray_chunk, R) if R else 1
        n_chunks = _round_up(max(R, 1), chunk) // chunk
        return cls(R=R, chunk=chunk, n_chunks=n_chunks,
                   chunk_p=_round_up(chunk, tile), tile=tile)

    @property
    def n_padded(self) -> int:
        return self.n_chunks * self.chunk_p

    @property
    def n_tiles(self) -> int:
        return self.n_padded // self.tile

    def pad(self, x: torch.Tensor, value) -> torch.Tensor:
        """``x`` ``[R, ...]`` -> ``[n_padded, ...]``, pad rows = ``value``
        (a scalar or a row)."""
        rest = x.shape[1:]
        fill = torch.as_tensor(value, dtype=x.dtype, device=x.device)
        body = torch.cat([x, fill.expand(
            (self.n_chunks * self.chunk - self.R,) + rest)])
        body = body.reshape((self.n_chunks, self.chunk) + rest)
        tail = fill.expand((self.n_chunks, self.chunk_p - self.chunk) + rest)
        return torch.cat([body, tail], 1).reshape((-1,) + rest)

    def pad_rays(self, ro, rd, pad_origin: float):
        """Padded ``(ro, rd)``: pad rows at ``pad_origin`` with direction
        (0, 0, 1), in both padding steps."""
        return (self.pad(ro, pad_origin),
                self.pad(rd, torch.tensor([0.0, 0.0, 1.0])))

    def unpad(self, x: torch.Tensor) -> torch.Tensor:
        rest = x.shape[1:]
        x = x.reshape((self.n_chunks, self.chunk_p) + rest)[:, :self.chunk]
        return x.reshape((-1,) + rest)[:self.R]


def tile_candidates(ro: torch.Tensor, rd: torch.Tensor, tile: int,
                    inst_f32: torch.Tensor, max_cand: int):
    """``pallas_engine.tile_candidates`` on padded rays ``[T * tile, 3]``:
    returns ``(cand [T, C] i32, info [T, 2] i32)`` with ``C = min(max_cand,
    N)``; ``info[:, 0]`` is the loop trip count (``N`` on overflow) and
    ``info[:, 1]`` the overflow flag.  Every operation is the JAX package's,
    in its order; the sort is stable, as ``jnp.argsort(stable=True)``."""
    T = ro.shape[0] // tile
    o = ro.reshape(T, tile, 3)
    d = rd.reshape(T, tile, 3)
    olo, ohi = o.amin(1), o.amax(1)  # [T, 3]
    dlo, dhi = d.amin(1), d.amax(1)

    bmin = inst_f32[:, ce._IF_BMIN:ce._IF_BMIN + 3]  # [N, 3]
    bmax = inst_f32[:, ce._IF_BMAX:ce._IF_BMAX + 3]

    # an axis whose direction interval spans 0 cannot cull
    spans0 = (dlo <= 0.0) & (dhi >= 0.0)
    inv_lo = 1.0 / torch.where(spans0, 1.0, dlo)
    inv_hi = 1.0 / torch.where(spans0, 1.0, dhi)

    def axis_times(bplane):  # [N, 3] -> [T, N, 3] extremes
        num_lo = bplane[None] - ohi[:, None]
        num_hi = bplane[None] - olo[:, None]
        cands = torch.stack(
            [num_lo * inv_lo[:, None], num_lo * inv_hi[:, None],
             num_hi * inv_lo[:, None], num_hi * inv_hi[:, None]], 0)
        return cands.amin(0), cands.amax(0)

    lo1, hi1 = axis_times(bmin)
    lo2, hi2 = axis_times(bmax)
    near = torch.minimum(lo1, lo2)
    far = torch.maximum(hi1, hi2)
    near = torch.where(spans0[:, None, :], ce.F32_NEG_BIG, near)
    far = torch.where(spans0[:, None, :], ce.F32_BIG, far)
    tmin = near.amax(-1)  # [T, N]
    tmax = far.amin(-1)
    # axes along which the whole tile is parallel constrain by origin
    # containment instead (exact zeros only, as _ray_recips)
    all_par = (dlo == 0.0) & (dhi == 0.0)
    contained = (ohi[:, None] >= bmin[None]) & (olo[:, None] <= bmax[None])
    par_ok = torch.all(~all_par[:, None] | contained, dim=-1)  # [T, N]
    vote = (tmin <= tmax) & (tmax >= rm.THRESHOLD) & par_ok

    count = vote.sum(-1).to(torch.int32)  # [T]
    n = vote.shape[-1]
    c = min(max_cand, n)
    # near to far: early close hits let K4's tmin < best prune skip far ones
    key = torch.where(vote, tmin, float("inf"))
    order = torch.sort(key, dim=-1, stable=True).indices
    cand = order[:, :c].to(torch.int32).contiguous()
    overflow = count > c
    loop_n = torch.where(overflow, n, count.clamp(max=c))
    info = torch.stack([loop_n, overflow.to(torch.int32)], -1)
    return cand, info.to(torch.int32).contiguous()


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

class _Lists:
    """The tile lists seen from each ray of ``[T * tile]`` padded rays."""

    def __init__(self, cand, info, tile: int, R: int):
        self.cand = cand
        self.tile_of = torch.arange(R, device=cand.device) // tile
        self.loop = info[self.tile_of, 0]
        self.over = info[self.tile_of, 1] > 0
        self.steps = int(info[:, 0].max()) if info.numel() else 0

    def at(self, k: int):
        """Instance each ray visits at step ``k`` (slot ``k`` of its tile's
        list, or ``k`` itself on overflow), and whether the step exists."""
        slot = self.cand[:, min(k, self.cand.shape[1] - 1)][self.tile_of]
        return torch.where(self.over, k, slot.long()), k < self.loop


class _Best:
    """The closest-hit state of rays ``[R]`` (``_init_best``): a miss is t
    = +inf, tri 0, uv 0, normal (0, 0, 1), mat 0."""

    def __init__(self, R: int, dev):
        f32 = torch.float32
        self.t = torch.full((R,), float("inf"), dtype=f32, device=dev)
        self.tri = torch.zeros(R, dtype=torch.int32, device=dev)
        self.u = torch.zeros(R, dtype=f32, device=dev)
        self.v = torch.zeros(R, dtype=f32, device=dev)
        self.n = [torch.zeros(R, dtype=f32, device=dev),
                  torch.zeros(R, dtype=f32, device=dev),
                  torch.ones(R, dtype=f32, device=dev)]
        self.mat = torch.zeros(R, dtype=torch.int32, device=dev)

    def take(self, ok, t, tri, u, v, n, mat):
        self.t = torch.where(ok, t, self.t)
        self.tri = torch.where(ok, tri, self.tri)
        self.u = torch.where(ok, u, self.u)
        self.v = torch.where(ok, v, self.v)
        self.n = [torch.where(ok, n[c], self.n[c]) for c in range(3)]
        self.mat = torch.where(ok, mat, self.mat)

    def hit(self) -> Hit:
        """``_write_best``: the normal re-normalized once, at the end."""
        bn = self.n
        nlen = torch.sqrt(bn[0] * bn[0] + bn[1] * bn[1] + bn[2] * bn[2])
        ninv = 1.0 / torch.clamp(nlen, min=rm.THRESHOLD)
        return Hit(valid=torch.isfinite(self.t), t=self.t, wtri=self.tri,
                   uv=torch.stack([self.u, self.v], dim=-1),
                   normal=torch.stack([bn[c] * ninv for c in range(3)],
                                      dim=-1),
                   mat=self.mat)


def _closest_update(best: _Best, f, ii, gate, tns, tfs, inside, o, d,
                    tmpl, max_tris: int, any_tmpl: bool, *,
                    exact_uv: bool = False, work=None) -> None:
    """``_intersect_instance`` for rays ``[R]`` each against its own
    instance (table rows ``f [R, 40]``, ``ii [R, 24]``) where ``gate``
    (its box test, the prune included) passed; ``tns, tfs, inside``: the
    slab terms of the box that gate read.  ``exact_uv``: the box fast
    path's true triangle and barycentrics.  ``work``: the box updates go
    to its ``exact`` column."""
    is_box = ii[:, ce._II_IS_BOX] > 0
    ok, t_hit, wtri, nrm, face = ce._box_face_hit(tns, tfs, inside, d, f, ii,
                                                  with_face=True)
    ok = gate & is_box & ok & (t_hit < best.t)
    if work is not None:
        work[:, 4] += ok
    if exact_uv:
        u, v, wtri = ce._box_exact_uv(f, ii, tmpl, o, d, t_hit, face)
    else:
        u = v = torch.full_like(best.u, 1.0 / 3.0)
    best.take(ok, t_hit, wtri, u, v, [nrm[:, c] for c in range(3)],
              ii[:, ce._II_MAT])
    if not any_tmpl:
        return
    q, lo, ld = ce._to_local(f, o, d)
    qc = (-q[0], -q[1], -q[2], q[3])
    start = ii[:, ce._II_TMPL_START]
    count = ii[:, ce._II_TRI_COUNT]
    wstart = ii[:, ce._II_WTRI_START]
    tgate = gate & ~is_box
    for j in range(max_tris):
        row = tmpl[torch.clamp(start + j, max=tmpl.shape[0] - 1).long()]
        tok, tt, b0, b1, b2 = ce._template_tri(row, lo, ld)
        tok = tgate & (j < count) & tok & (tt < best.t)
        sn = [b0 * row[:, ce._TF_NA + c] + b1 * row[:, ce._TF_NB + c]
              + b2 * row[:, ce._TF_NC + c] for c in range(3)]
        best.take(tok, tt, wstart + j, b1, b2, ce._quat_rotate_tile(qc, sn),
                  row[:, ce._TF_MAT].to(torch.int32))


def cull_cast_reference(ro: torch.Tensor, rd: torch.Tensor,
                        cand: torch.Tensor, info: torch.Tensor, tile: int,
                        tables: ce.SceneTables, *, exact_uv: bool = False,
                        work: Optional[torch.Tensor] = None) -> Hit:
    """Plain version of K4 on padded rays ``[T * tile, 3]``: closest hit
    over each ray's tile list, visited in the kernel's order; ``exact_uv``
    as ``cuda_engine.bvh_cast_reference``.  ``work``: see
    ``cuda_engine.WORK_COLUMNS``."""
    R = ro.shape[0]
    o = [ro[:, k] for k in range(3)]
    d = [rd[:, k] for k in range(3)]
    par, inv = ce._ray_recips(rd)
    inst_f, inst_i = tables.inst_f32, tables.inst_i32
    lists = _Lists(cand, info, tile, R)
    max_tris = int(inst_i[:, ce._II_TRI_COUNT].max())
    any_tmpl = bool((inst_i[:, ce._II_IS_BOX] == 0).any())
    best = _Best(R, ro.device)

    for k in range(lists.steps):
        i, live = lists.at(k)
        f = inst_f[i]  # [R, 40]
        ii = inst_i[i]  # [R, 24]
        tns, tfs, inside = ce._slab_terms(f, o, inv, par)
        tmin = ce._max3(tns)
        tmax = ce._min3(tfs)
        gate = (live & (ii[:, ce._II_VALID] > 0) & (tmin <= tmax)
                & (tmax >= rm.THRESHOLD) & (tmin < best.t) & inside)
        if work is not None:
            is_box = ii[:, ce._II_IS_BOX] > 0
            work[:, 0] += live
            work[:, 1] += gate & is_box
            work[:, 2] += gate & ~is_box
            work[:, 3] += (gate & ~is_box) * ii[:, ce._II_TRI_COUNT]
        _closest_update(best, f, ii, gate, tns, tfs, inside, o, d,
                        tables.tmpl, max_tris, any_tmpl, exact_uv=exact_uv,
                        work=work)
    return best.hit()


def cull_occlude_reference(ro, rd, max_t, cand, info, tile: int,
                           tables: ce.SceneTables, *,
                           work: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Plain version of K5 on padded rays: bool ``[T * tile]``, blocked iff
    some instance of the ray's tile list has a hit in ``[THRESHOLD,
    max_t]``.  ``work``: see ``cuda_engine.WORK_COLUMNS`` (a ray stops at
    its first block)."""
    R = ro.shape[0]
    o = [ro[:, k] for k in range(3)]
    d = [rd[:, k] for k in range(3)]
    par, inv = ce._ray_recips(rd)
    inst_f, inst_i, tmpl = tables.inst_f32, tables.inst_i32, tables.tmpl
    lists = _Lists(cand, info, tile, R)
    max_tris = int(inst_i[:, ce._II_TRI_COUNT].max())
    any_tmpl = bool((inst_i[:, ce._II_IS_BOX] == 0).any())
    blk = torch.zeros(R, dtype=torch.bool, device=ro.device)

    for k in range(lists.steps):
        i, live = lists.at(k)
        f = inst_f[i]
        ii = inst_i[i]
        tns, tfs, inside = ce._slab_terms(f, o, inv, par)
        tmin = ce._max3(tns)
        tmax = ce._min3(tfs)
        active = (live & (ii[:, ce._II_VALID] > 0) & (tmin <= tmax)
                  & (tmax >= rm.THRESHOLD) & ~blk & (tmin <= max_t) & inside)
        if work is not None:
            is_box = ii[:, ce._II_IS_BOX] > 0
            work[:, 0] += live & ~blk
            work[:, 1] += active & is_box
            work[:, 2] += active & ~is_box
        blk = blk | ce._occlude_rows(f, ii, tmpl, active, tns, tfs, inside,
                                     o, d, max_t, max_tris, any_tmpl, work)
    return blk


# ---------------------------------------------------------------------------
# wrappers: the kernel for CUDA tensors, the plain version for CPU tensors
# ---------------------------------------------------------------------------

def _check_lists(ro, cand, info, tile: int):
    R = ro.shape[0]
    if tile <= 0 or R % tile:
        raise ValueError(f"{R} rays are not a whole number of {tile}-ray "
                         "tiles")
    T = R // tile
    ce._check("cand", cand, torch.int32, (T, cand.shape[1]), ro.device)
    ce._check("info", info, torch.int32, (T, 2), ro.device)
    if cand.shape[1] < 1:
        raise ValueError("cand: needs at least one column")


def overflow_piece_boxes(tables: ce.SceneTables,
                         piece: int = PIECE) -> torch.Tensor:
    """Plain version of K4/K5's ``piece_boxes_kernel``: ``[P, 6]`` the union
    (min xyz, max xyz) of the valid instance boxes of each piece of
    ``piece`` instances in table order -- the overflow list's pieces; a
    piece without a valid box keeps the inverted box."""
    n = tables.inst_f32.shape[0]
    box = tables.inst_f32[:, ce._IF_BMIN:ce._IF_BMIN + 6]
    valid = (tables.inst_i32[:, ce._II_VALID] > 0)[:, None]
    inverted = box.new_tensor([ce.F32_BIG] * 3 + [ce.F32_NEG_BIG] * 3)
    box = torch.where(valid, box, inverted)
    pad = -n % piece
    box = torch.cat([box, inverted.expand(pad, 6)]).reshape(-1, piece, 6)
    return torch.cat([box[..., :3].amin(1), box[..., 3:].amax(1)], -1)


def _staging(name: str, cand, tables: ce.SceneTables):
    """What K4/K5 need to stage a tile's list: returns the instance count
    and the scratch for the overflow list's piece boxes (None where that
    list is one piece)."""
    n_inst = tables.inst_f32.shape[0]
    if cand.shape[1] > PIECE:
        raise ValueError(f"{name}: lists of {cand.shape[1]} columns; a "
                         f"listed tile's list is one piece of at most "
                         f"{PIECE}")
    if tables.inst_f32.data_ptr() % 16:
        raise ValueError(f"inst_f32: {name} reads 16-byte aligned rows")
    scratch = None
    if n_inst > PIECE:
        scratch = torch.empty(-(-n_inst // PIECE), 8, dtype=torch.float32,
                              device=cand.device)
    return n_inst, scratch


def cull_cast(ro: torch.Tensor, rd: torch.Tensor, cand: torch.Tensor,
              info: torch.Tensor, tile: int, tables: ce.SceneTables, *,
              exact_uv: bool = False) -> Hit:
    """K4 (``_cast_kernel``): closest hit of padded rays ``[T * tile, 3]``
    f32 over the lists of :func:`tile_candidates`, of any length;
    ``exact_uv`` takes the kernel's exact_uv instantiation."""
    R = ro.shape[0]
    dev = ro.device
    ce._check("ro", ro, torch.float32, (R, 3), dev)
    ce._check("rd", rd, torch.float32, (R, 3), dev)
    _check_lists(ro, cand, info, tile)
    if ce._device_kind(ro) == "cpu":
        return cull_cast_reference(ro, rd, cand, info, tile, tables,
                                   exact_uv=exact_uv)
    ce._check_tables(tables, dev)
    n_inst, scratch = _staging("cull_cast", cand, tables)
    from . import kernels

    t = torch.empty(R, dtype=torch.float32, device=dev)
    wtri = torch.empty(R, dtype=torch.int32, device=dev)
    uv = torch.empty(R, 2, dtype=torch.float32, device=dev)
    normal = torch.empty(R, 3, dtype=torch.float32, device=dev)
    mat = torch.empty(R, dtype=torch.int32, device=dev)
    if R > 0:
        err = kernels.library().rt_cull_cast(
            ce._ptr(ro), ce._ptr(rd), R, ce._ptr(cand), ce._ptr(info),
            cand.shape[1], tile, ce._ptr(tables.inst_f32),
            ce._ptr(tables.inst_i32), n_inst, ce._ptr(tables.tmpl),
            None if scratch is None else ce._ptr(scratch), int(exact_uv),
            ce._ptr(t), ce._ptr(wtri), ce._ptr(uv), ce._ptr(normal),
            ce._ptr(mat), dev.index, kernels.stream_handle(dev))
        ce._raise_on(err, "cull_cast")
        cull_cast.launches += 1
        cull_cast.exact_uv_launches += int(exact_uv)
    return Hit(valid=torch.isfinite(t), t=t, wtri=wtri, uv=uv,
               normal=normal, mat=mat)


cull_cast.launches = 0  # every launch of K4
cull_cast.exact_uv_launches = 0  # of its exact_uv instantiation


def cull_occlude(ro, rd, max_t, cand, info, tile: int,
                 tables: ce.SceneTables) -> torch.Tensor:
    """K5 (``_occlude_kernel``): any-hit query of padded rays ``[T * tile,
    3]`` f32 with ``max_t`` ``[T * tile]`` f32 over the tile lists, of any
    length.  Returns bool ``[T * tile]``."""
    R = ro.shape[0]
    dev = ro.device
    ce._check("ro", ro, torch.float32, (R, 3), dev)
    ce._check("rd", rd, torch.float32, (R, 3), dev)
    ce._check("max_t", max_t, torch.float32, (R,), dev)
    _check_lists(ro, cand, info, tile)
    if ce._device_kind(ro) == "cpu":
        return cull_occlude_reference(ro, rd, max_t, cand, info, tile,
                                      tables)
    ce._check_tables(tables, dev)
    n_inst, scratch = _staging("cull_occlude", cand, tables)
    from . import kernels

    blk = torch.empty(R, dtype=torch.bool, device=dev)
    if R > 0:
        err = kernels.library().rt_cull_occlude(
            ce._ptr(ro), ce._ptr(rd), ce._ptr(max_t), R, ce._ptr(cand),
            ce._ptr(info), cand.shape[1], tile, ce._ptr(tables.inst_f32),
            ce._ptr(tables.inst_i32), n_inst, ce._ptr(tables.tmpl),
            None if scratch is None else ce._ptr(scratch), ce._ptr(blk),
            dev.index, kernels.stream_handle(dev))
        ce._raise_on(err, "cull_occlude")
        cull_occlude.launches += 1
    return blk


cull_occlude.launches = 0


# ---------------------------------------------------------------------------
# the engine's cast
# ---------------------------------------------------------------------------

def make_cull_cast(data: ce.CastData, cfg: RenderConfig,
                   geo: Optional[torch.Tensor] = None, *, plain: bool) -> Cast:
    """The cull's :class:`Cast` (``make_pallas_cast`` with
    ``traversal="cull"`` under ``cast_vjp``'s chunked rules): ``closest``
    through K4 (its exact_uv branch under ``edge_aware_grads``, with the
    reparam rule over the packed rows ``geo``), ``occlude`` through K5 and
    ``occlude2`` as two K5 queries (``_pallas_chunked_occlude2``'s fallback
    for a traversal without a fused kernel).  ``plain`` takes the plain
    versions."""
    cast_k, occ_k = ((cull_cast_reference, cull_occlude_reference) if plain
                     else (cull_cast, cull_occlude))
    tile = tile_rows_of(cfg) * LANES
    tables = data.tables

    def layout_of(ro):
        return CullLayout.of(ro.shape[0], cfg.pallas_ray_chunk, tile)

    def cast_query(ro, rd, _data):
        lay = layout_of(ro)
        ro_p, rd_p = lay.pad_rays(ro, rd, 1.0e30)
        cand, info = tile_candidates(ro_p, rd_p, tile, tables.inst_f32,
                                     MAX_CAND)
        hit = cast_k(ro_p, rd_p, cand, info, tile, tables,
                     exact_uv=cfg.edge_aware_grads)
        return Hit(valid=lay.unpad(hit.valid), t=lay.unpad(hit.t),
                   wtri=lay.unpad(hit.wtri), uv=lay.unpad(hit.uv),
                   normal=lay.unpad(hit.normal), mat=lay.unpad(hit.mat))

    def occlude_query(ro, rd, max_t, _data):
        lay = layout_of(ro)
        ro_p, rd_p = lay.pad_rays(ro, rd, 1.0e30)
        cand, info = tile_candidates(ro_p, rd_p, tile, tables.inst_f32,
                                     MAX_CAND)
        return lay.unpad(occ_k(ro_p, rd_p, lay.pad(max_t, 0.0), cand, info,
                               tile, tables))

    def occlude2_query(o1, d1, mt1, o2, d2, mt2, _data):
        return (occlude_query(o1, d1, mt1, _data),
                occlude_query(o2, d2, mt2, _data))

    def closest(ro, rd):
        return closest_hit(cast_query, ro, rd, data, geo)

    def occlude(ro, rd, max_t):
        return occlude_detached(occlude_query, ro, rd, max_t, data)

    def occlude2(o1, d1, mt1, o2, d2, mt2):
        return occlude2_detached(occlude2_query, o1, d1, mt1, o2, d2, mt2,
                                 data)

    return Cast(closest, occlude, occlude2)
