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
tile's list (K5 from a copy of the list in shared memory, four entries at a
time, leaving early what no listed box can block); the plain versions take
the same instances in the same order for each ray (slot ``k`` of the ray's
tile, or ``k`` itself on overflow) with the table rows gathered per ray, and
give the same bits.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from .. import raymath as rm
from ..scene import RenderConfig
from . import cuda_engine as ce
from .cast import Hit
from .cast_vjp import cast_detached, occlude2_detached, occlude_detached

LANES = 128  # the JAX package's lane width: a tile is tile_rows * LANES rays
MAX_CAND = 64  # make_pallas_cast's default list length
# K5 stages a tile's list in shared memory: box, flags and instance of an
# entry, and its share of the box of its group of four
_K5_ENTRY_BYTES = 32 + 8
_SHARED_BYTES = 232448  # dynamic shared memory a block can have (H100)


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


def cull_cast_reference(ro: torch.Tensor, rd: torch.Tensor,
                        cand: torch.Tensor, info: torch.Tensor, tile: int,
                        tables: ce.SceneTables, *,
                        work: Optional[torch.Tensor] = None) -> Hit:
    """Plain version of K4 on padded rays ``[T * tile, 3]``: closest hit
    over each ray's tile list, visited in the kernel's order.  ``work``:
    see ``cuda_engine.WORK_COLUMNS``."""
    R = ro.shape[0]
    dev = ro.device
    f32 = torch.float32
    o = [ro[:, k] for k in range(3)]
    d = [rd[:, k] for k in range(3)]
    par, inv = ce._ray_recips(rd)
    inst_f, inst_i, tmpl = tables.inst_f32, tables.inst_i32, tables.tmpl
    lists = _Lists(cand, info, tile, R)
    max_tris = int(inst_i[:, ce._II_TRI_COUNT].max())
    any_tmpl = bool((inst_i[:, ce._II_IS_BOX] == 0).any())

    bt = torch.full((R,), float("inf"), dtype=f32, device=dev)
    btri = torch.zeros(R, dtype=torch.int32, device=dev)
    bu = torch.zeros(R, dtype=f32, device=dev)
    bv = torch.zeros(R, dtype=f32, device=dev)
    bn = [torch.zeros(R, dtype=f32, device=dev),
          torch.zeros(R, dtype=f32, device=dev),
          torch.ones(R, dtype=f32, device=dev)]
    bmat = torch.zeros(R, dtype=torch.int32, device=dev)

    for k in range(lists.steps):
        i, live = lists.at(k)
        f = inst_f[i]  # [R, 40]
        ii = inst_i[i]  # [R, 24]
        tns, tfs, inside = ce._slab_terms(f, o, inv, par)
        tmin = ce._max3(tns)
        tmax = ce._min3(tfs)
        gate = (live & (ii[:, ce._II_VALID] > 0) & (tmin <= tmax)
                & (tmax >= rm.THRESHOLD) & (tmin < bt) & inside)
        is_box = ii[:, ce._II_IS_BOX] > 0
        if work is not None:
            work[:, 0] += live
            work[:, 1] += gate & is_box
            work[:, 2] += gate & ~is_box
            work[:, 3] += (gate & ~is_box) * ii[:, ce._II_TRI_COUNT]
        ok, t_hit, wtri, nrm = ce._box_face_hit(tns, tfs, inside, d, f, ii)
        ok = gate & is_box & ok & (t_hit < bt)
        bt = torch.where(ok, t_hit, bt)
        btri = torch.where(ok, wtri, btri)
        bu = torch.where(ok, 1.0 / 3.0, bu)
        bv = torch.where(ok, 1.0 / 3.0, bv)
        bn = [torch.where(ok, nrm[:, c], bn[c]) for c in range(3)]
        bmat = torch.where(ok, ii[:, ce._II_MAT], bmat)
        if not any_tmpl:
            continue
        q, lo, ld = ce._to_local(f, o, d)
        qc = (-q[0], -q[1], -q[2], q[3])
        start = ii[:, ce._II_TMPL_START]
        count = ii[:, ce._II_TRI_COUNT]
        wstart = ii[:, ce._II_WTRI_START]
        tgate = gate & ~is_box
        for j in range(max_tris):
            row = tmpl[torch.clamp(start + j, max=tmpl.shape[0] - 1).long()]
            tok, tt, b0, b1, b2 = ce._template_tri(row, lo, ld)
            tok = tgate & (j < count) & tok & (tt < bt)
            sn = [b0 * row[:, ce._TF_NA + c] + b1 * row[:, ce._TF_NB + c]
                  + b2 * row[:, ce._TF_NC + c] for c in range(3)]
            wn = ce._quat_rotate_tile(qc, sn)
            bt = torch.where(tok, tt, bt)
            btri = torch.where(tok, wstart + j, btri)
            bu = torch.where(tok, b1, bu)
            bv = torch.where(tok, b2, bv)
            bn = [torch.where(tok, wn[c], bn[c]) for c in range(3)]
            bmat = torch.where(tok, row[:, ce._TF_MAT].to(torch.int32), bmat)

    nlen = torch.sqrt(bn[0] * bn[0] + bn[1] * bn[1] + bn[2] * bn[2])
    ninv = 1.0 / torch.clamp(nlen, min=rm.THRESHOLD)
    return Hit(valid=torch.isfinite(bt), t=bt, wtri=btri,
               uv=torch.stack([bu, bv], dim=-1),
               normal=torch.stack([bn[c] * ninv for c in range(3)], dim=-1),
               mat=bmat)


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
        is_box = ii[:, ce._II_IS_BOX] > 0
        if work is not None:
            work[:, 0] += live & ~blk
            work[:, 1] += active & is_box
            work[:, 2] += active & ~is_box
        t_hit = torch.where(tmin >= rm.THRESHOLD, tmin, tmax)
        blk = blk | (active & is_box & (tmin <= tmax) & inside
                     & (t_hit >= rm.THRESHOLD) & (t_hit <= max_t))
        if not any_tmpl:
            continue
        _, lo, ld = ce._to_local(f, o, d)
        start = ii[:, ce._II_TMPL_START]
        count = ii[:, ce._II_TRI_COUNT]
        tgate = active & ~is_box
        for j in range(max_tris):
            if work is not None:
                work[:, 3] += tgate & (j < count) & ~blk
            row = tmpl[torch.clamp(start + j, max=tmpl.shape[0] - 1).long()]
            tok, tt, _, _, _ = ce._template_tri(row, lo, ld)
            blk = blk | (tgate & (j < count) & tok & (tt <= max_t))
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


def cull_cast(ro: torch.Tensor, rd: torch.Tensor, cand: torch.Tensor,
              info: torch.Tensor, tile: int, tables: ce.SceneTables) -> Hit:
    """K4 (``_cast_kernel``): closest hit of padded rays ``[T * tile, 3]``
    f32 over the lists of :func:`tile_candidates`."""
    R = ro.shape[0]
    dev = ro.device
    ce._check("ro", ro, torch.float32, (R, 3), dev)
    ce._check("rd", rd, torch.float32, (R, 3), dev)
    _check_lists(ro, cand, info, tile)
    if ce._device_kind(ro) == "cpu":
        return cull_cast_reference(ro, rd, cand, info, tile, tables)
    ce._check_tables(tables, dev)
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
            ce._ptr(tables.inst_i32), ce._ptr(tables.tmpl), ce._ptr(t),
            ce._ptr(wtri), ce._ptr(uv), ce._ptr(normal), ce._ptr(mat),
            dev.index, kernels.stream_handle(dev))
        ce._raise_on(err, "cull_cast")
        cull_cast.launches += 1
    return Hit(valid=torch.isfinite(t), t=t, wtri=wtri, uv=uv,
               normal=normal, mat=mat)


cull_cast.launches = 0


def cull_occlude(ro, rd, max_t, cand, info, tile: int,
                 tables: ce.SceneTables) -> torch.Tensor:
    """K5 (``_occlude_kernel``): any-hit query of padded rays ``[T * tile,
    3]`` f32 with ``max_t`` ``[T * tile]`` f32 over the tile lists.
    Returns bool ``[T * tile]``."""
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
    n_inst = tables.inst_f32.shape[0]
    entries = max(cand.shape[1], n_inst)
    if (entries + 3) * _K5_ENTRY_BYTES > _SHARED_BYTES:
        raise ValueError(f"K5 stages a tile's list in shared memory: "
                         f"{entries} entries of {_K5_ENTRY_BYTES} bytes "
                         f"exceed a block's {_SHARED_BYTES}")
    if tables.inst_f32.data_ptr() % 16:
        raise ValueError("inst_f32: K5 reads 16-byte aligned rows")
    from . import kernels

    blk = torch.empty(R, dtype=torch.bool, device=dev)
    if R > 0:
        err = kernels.library().rt_cull_occlude(
            ce._ptr(ro), ce._ptr(rd), ce._ptr(max_t), R, ce._ptr(cand),
            ce._ptr(info), cand.shape[1], tile, ce._ptr(tables.inst_f32),
            ce._ptr(tables.inst_i32), n_inst, ce._ptr(tables.tmpl),
            ce._ptr(blk), dev.index, kernels.stream_handle(dev))
        ce._raise_on(err, "cull_occlude")
        cull_occlude.launches += 1
    return blk


cull_occlude.launches = 0


# ---------------------------------------------------------------------------
# the engine's cast
# ---------------------------------------------------------------------------

def make_cull_cast(data: ce.CastData, cfg: RenderConfig):
    """The engine's cast on the cull (``make_pallas_cast`` with
    ``traversal="cull"`` under ``cast_vjp``'s chunked rules): ``cast(ro,
    rd)`` through K4 with ``occlude`` through K5 and ``occlude2`` as two K5
    queries (``_pallas_chunked_occlude2``'s fallback for a traversal without
    a fused kernel).  ``engine="torch"`` takes the plain versions."""
    if cfg.engine == "cuda":
        cast_k, occ_k = cull_cast, cull_occlude
    elif cfg.engine == "torch":
        cast_k, occ_k = cull_cast_reference, cull_occlude_reference
    else:
        raise ValueError(f"unknown engine {cfg.engine!r} "
                         "(expected 'torch' or 'cuda')")
    tile = tile_rows_of(cfg) * LANES
    tables = data.tables

    def layout_of(ro):
        return CullLayout.of(ro.shape[0], cfg.pallas_ray_chunk, tile)

    def cast_query(ro, rd, _data):
        lay = layout_of(ro)
        ro_p, rd_p = lay.pad_rays(ro, rd, 1.0e30)
        cand, info = tile_candidates(ro_p, rd_p, tile, tables.inst_f32,
                                     MAX_CAND)
        hit = cast_k(ro_p, rd_p, cand, info, tile, tables)
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

    def cast(ro, rd):
        return cast_detached(cast_query, ro, rd, data)

    def occlude(ro, rd, max_t):
        return occlude_detached(occlude_query, ro, rd, max_t, data)

    def occlude2(o1, d1, mt1, o2, d2, mt2):
        return occlude2_detached(occlude2_query, o1, d1, mt1, o2, d2, mt2,
                                 data)

    cast.occlude = occlude
    cast.occlude2 = occlude2
    return cast
