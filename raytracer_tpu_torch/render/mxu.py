"""The MXU cast: Pluecker ray-triangle tests over staged triangle columns (K6).

Counterpart of ``raytracer_tpu/render/pallas_mxu.py`` (``pallas_kernel=
"mxu"``).  A ray is the 6-vector ``[d, m]`` with moment ``m = o x d``; an
edge ``p -> q`` carries ``[p x q, q - p]``, and the signed weight ``d.(p x q)
+ m.(q - p)`` is bilinear, so each triangle is a column of five 8-wide rows
(three edges, the plane's numerator and denominator) that every ray meets
with 8-term dot products.  The barycentrics are the three edge weights over
their sum, inside iff none is below ``-BARY_TOL``; the hit time is the plane
numerator over the denominator.

* :func:`build_mxu_tables` (``pallas_mxu.build_mxu_tables``): the five row
  tables over the world triangles, side by side as one ``[Wp, 40]`` column
  table, zero-padded to ``Wp`` (a multiple of ``k_cols``), exact FP32.
* :func:`stage_mxu`: ``make_mxu_cast``'s staging -- the candidate lists of
  ``cull.tile_candidates`` with ``max_cand = k_cols // max_tris`` slots, the
  per-tile column ids and (for the plain version) the gathered columns, the
  ray rows ``rd6 = [d, o x d, 0, 0]`` and ``rp8 = [o, d, 1, 0]``.
* K6 ``_mxu_kernel`` -> :func:`mxu_cast` / :func:`mxu_cast_reference`: per
  ray, the first minimum over the tile's live columns, or over all ``Wp``
  columns when the tile's list overflowed.

The plain version reads the columns staged as ``[T, K, 40]`` (the five rows
of a column side by side) where the JAX package keeps five ``[T, 8, K]``
operands; the values are the same.  The CUDA kernel takes no staged copy: it
gathers each live column from the ``[Wp, 40]`` table by its id, as ten
16-byte loads (``csrc/mxu_kernel.cu``).
Rays are padded as ``engine.make_cast`` pads them for this kernel: chunks of
``cfg.pallas_ray_chunk``, then a multiple of the 512-ray tile, pad rows at
origin 0 with direction (0, 0, 1).  The cast gives no normal and no
material (shading takes them from the geometry) and has no ``occlude``, so
shadows take a closest-hit cast per light (``shading.march_shadow``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import raymath as rm
from ..scene import RenderConfig, Scene
from . import cuda_engine as ce
from .cast import Hit
from .cast_vjp import cast_detached
from .cull import LANES, CullLayout, tile_candidates
from .geometry import WorldGeometry

BARY_TOL = 1e-5
TILE_ROWS = 4  # make_mxu_cast's default: 512-ray tiles
K_COLS = 384  # staged columns per tile
ROW = 8  # floats per table row
COL = 5 * ROW  # floats per staged column
_GROUP = 1 << 22  # plain version: ray x column pairs per step
# K6 holds a chunk's list, 2 * ceil(k_cols / 40) ints, in 24 KB of shared
# memory
_MAX_K_COLS = 40 * 3072


@dataclass
class MxuSceneTables:
    # [Wp, 40]: per column the five rows, each [Wp, 8] in the JAX package:
    # 0:8 edge b -> c (weight of vertex a), 8:16 edge c -> a, 16:24 edge
    # a -> b, 24:32 plane numerator (. [o, d, 1, 0] = n.(a - o), unit n),
    # 32:40 plane denominator (. [o, d, 1, 0] = n.d)
    columns: torch.Tensor
    inst_f32: torch.Tensor  # [N, 40] the scalar kernels' instance rows
    inst_start: torch.Tensor  # [N] i32 first world triangle
    inst_count: torch.Tensor  # [N] i32


def build_mxu_tables(scene: Scene, geom: WorldGeometry,
                     pad_tris: int) -> MxuSceneTables:
    """World-space row tables (``pallas_mxu.build_mxu_tables``).  The
    ``pad_tris`` zero rows at the end have degenerate planes, which the
    epsilon tests reject."""
    a, b, c = geom.a, geom.b, geom.c
    w = a.shape[0]
    z1 = a.new_zeros(w, 1)
    z2 = a.new_zeros(w, 2)
    z3 = a.new_zeros(w, 3)

    def pluecker_edge(p, q):
        return torch.cat([rm.cross(p, q), q - p, z2], -1)

    n_unit = rm.normalize(rm.cross(b - a, c - a))
    ndota = rm.dot(n_unit, a, keepdims=True)

    def pad(x):
        return torch.nn.functional.pad(x, (0, 0, 0, pad_tris))

    v2 = ce.build_tables(scene, geom)
    return MxuSceneTables(
        columns=pad(torch.cat([
            pluecker_edge(b, c), pluecker_edge(c, a), pluecker_edge(a, b),
            torch.cat([-n_unit, z3, ndota, z1], -1),
            torch.cat([z3, n_unit, z1, z1], -1)], -1)).contiguous(),
        inst_f32=v2.inst_f32,
        inst_start=v2.inst_i32[:, ce._II_WTRI_START].contiguous(),
        inst_count=v2.inst_i32[:, ce._II_TRI_COUNT].contiguous(),
    )


@dataclass
class MxuData:
    """What the MXU cast needs at run time (``make_mxu_cast``'s closure)."""

    tables: MxuSceneTables
    n_tris: int
    max_tris: int
    k_cols: int = K_COLS
    tile: int = TILE_ROWS * LANES

    @property
    def columns(self) -> torch.Tensor:
        return self.tables.columns

    @property
    def wp(self) -> int:
        return self.columns.shape[0]


@torch.no_grad()
def prepare_mxu_cast(scene: Scene, geom: WorldGeometry, cfg: RenderConfig,
                     k_cols: int = K_COLS) -> MxuData:
    """The tables of the MXU cast, padded so that the dense sweep's last
    chunk stays in range.  Under ``no_grad``, as ``prepare_cast``.
    ``k_cols`` staged columns per tile hold ``k_cols // max_tris``
    candidate instances."""
    if k_cols % 64:
        raise ValueError(f"k_cols must be a multiple of 64, got {k_cols}")
    n_tris = geom.a.shape[0]
    wp = -(-n_tris // k_cols) * k_cols
    return MxuData(tables=build_mxu_tables(scene, geom, pad_tris=wp - n_tris),
                   n_tris=n_tris, max_tris=int(cfg.max_tris_per_mesh),
                   k_cols=k_cols)


def gather_columns(columns: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The columns ``[T, K, 40]`` of ``ids`` ``[T, K]`` (a dead column takes
    row 0; its id keeps it out of every result)."""
    safe = torch.clamp(ids, 0, columns.shape[0] - 1).long()
    return columns[safe].contiguous()


def stage_mxu(ro: torch.Tensor, rd: torch.Tensor, data: MxuData,
              columns: bool = True):
    """``make_mxu_cast``'s staging for padded rays ``[T * tile, 3]``.
    Returns ``(info [T, 2] i32, staged [T, K, 40] f32, ids [T, K] f32,
    rd6 [R, 8] f32, rp8 [R, 8] f32)``; ``ids`` is the world triangle of
    each column, -1 for a dead one.  The live columns lie within the first
    ``info[t, 0] * max_tris`` of a tile.  ``columns=False`` leaves the
    gather out and returns ``None`` for ``staged`` (the CUDA kernel gathers
    the live columns itself)."""
    tab = data.tables
    k, max_tris = data.k_cols, data.max_tris
    slots = k // max_tris
    n_inst = tab.inst_f32.shape[0]
    cand, info = tile_candidates(ro, rd, data.tile, tab.inst_f32, slots)
    dev = ro.device
    # slot s covers columns [s * max_tris, (s + 1) * max_tris)
    in_range = torch.arange(slots, device=dev)[None, :] < info[:, :1]
    cand_slots = cand[:, :slots]
    if cand_slots.shape[1] < slots:  # fewer instances than slots
        cand_slots = torch.nn.functional.pad(
            cand_slots, (0, slots - cand_slots.shape[1]))
    cand_inst = torch.clamp(cand_slots, 0, max(n_inst - 1, 0)).long()
    col = torch.arange(k, device=dev)
    tri_in_slot = col // max_tris
    tri_off = col % max_tris
    col_start = tab.inst_start[cand_inst][:, tri_in_slot]  # [T, K]
    col_live = (in_range[:, tri_in_slot]
                & (tri_off[None] < tab.inst_count[cand_inst][:, tri_in_slot]))
    row_ids = col_start + tri_off[None]
    ids = torch.where(col_live, row_ids.to(torch.float32), -1.0)
    staged = gather_columns(data.columns, ids) if columns else None

    m = rm.cross(ro, rd)
    z1 = ro.new_zeros(ro.shape[0], 1)
    rd6 = torch.cat([rd, m, z1, z1], -1)
    rp8 = torch.cat([ro, rd, torch.ones_like(z1), z1], -1)
    return info, staged, ids.contiguous(), rd6, rp8


# ---------------------------------------------------------------------------
# K6: plain version and wrapper
# ---------------------------------------------------------------------------

def _dot8(x, cols, first: int):
    """``x [G, tile, 8]`` against the 8 values of each column ``[G', K,
    40]`` from ``first``: ``[G, tile, K]``, summed left to right as the
    kernel sums."""
    acc = x[..., 0:1] * cols[:, None, :, first]
    for j in range(1, ROW):
        acc = acc + x[..., j:j + 1] * cols[:, None, :, first + j]
    return acc


def _score(a, p, cols, ids):
    """Best column per ray of ``a``/``p`` ``[G, tile, 8]`` among ``cols``
    ``[G', K, 40]`` with ids ``[G', K]``: ``(t, id, u, v)`` ``[G, tile]``,
    the first minimum in column order, ``t = inf`` where none is valid."""
    wa = _dot8(a, cols, 0)
    wb = _dot8(a, cols, ROW)
    wc = _dot8(a, cols, 2 * ROW)
    num = _dot8(p, cols, 3 * ROW)
    den = _dot8(p, cols, 4 * ROW)
    s = wa + wb + wc
    s_ok = torch.abs(s) > 1e-30
    inv_s = 1.0 / torch.where(s_ok, s, 1.0)
    ba = wa * inv_s
    bb = wb * inv_s
    bc = wc * inv_s
    inside = (ba >= -BARY_TOL) & (bb >= -BARY_TOL) & (bc >= -BARY_TOL)
    den_ok = torch.abs(den) >= rm.THRESHOLD
    tt = num / torch.where(den_ok, den, 1.0)
    valid = (inside & den_ok & s_ok & (tt >= rm.THRESHOLD)
             & (ids[:, None, :] >= 0.0))
    tt = torch.where(valid, tt, float("inf"))
    tmin = tt.amin(-1)
    pick = (tt == tmin[..., None]).to(torch.uint8).argmax(-1, keepdim=True)
    return (tmin, torch.gather(ids[:, None, :].expand_as(tt), -1,
                               pick)[..., 0],
            torch.gather(bb, -1, pick)[..., 0],
            torch.gather(bc, -1, pick)[..., 0])


def _merge(best, cand):
    better = cand[0] < best[0]
    return tuple(torch.where(better, c, b) for b, c in zip(best, cand))


def mxu_cast_reference(info, columns, n_tris: int, staged, ids, rd6, rp8,
                       tile: int):
    """Plain version of K6 on padded rays: ``(t, id, u, v)`` f32 ``[T *
    tile]``; a miss is ``t = inf`` with id, u, v 0."""
    T = info.shape[0]
    dev = rd6.device
    k = staged.shape[1]
    a = rd6.reshape(T, tile, ROW)
    p = rp8.reshape(T, tile, ROW)
    inf = torch.full((T, tile), float("inf"), device=dev)
    zero = torch.zeros((T, tile), device=dev)
    out = [inf, zero, zero.clone(), zero.clone()]
    group = max(1, _GROUP // (tile * k))
    over = info[:, 1] > 0
    staged_tiles = torch.nonzero(~over).flatten()
    dense_tiles = torch.nonzero(over).flatten()
    for g0 in range(0, staged_tiles.numel(), group):
        g = staged_tiles[g0:g0 + group]
        best = _merge([x[g] for x in out], _score(a[g], p[g], staged[g],
                                                  ids[g]))
        for x, b in zip(out, best):
            x[g] = b
    col = torch.arange(k, device=dev, dtype=torch.float32)
    for g0 in range(0, dense_tiles.numel(), group):
        g = dense_tiles[g0:g0 + group]
        best = [x[g] for x in out]
        for c0 in range(0, columns.shape[0], k):
            cid = col + c0
            cid = torch.where(cid < n_tris, cid, -1.0)
            best = _merge(best, _score(a[g], p[g], columns[None, c0:c0 + k],
                                       cid[None]))
        for x, b in zip(out, best):
            x[g] = b
    return tuple(x.reshape(-1) for x in out)


def mxu_cast(info, columns, n_tris: int, ids, rd6, rp8, tile: int,
             max_tris: int, *, stamps: bool = False):
    """K6 (``_mxu_kernel``) on padded rays ``[T * tile]``: ``(t, id, u,
    v)`` f32.  ``columns`` ``[Wp, 40]``, ``ids`` ``[T, K]`` f32 (the
    staging's: a tile's live columns lie within its first ``info[t, 0] *
    max_tris``; an id beyond them is dead whatever it says), ``rd6``/``rp8``
    ``[T * tile, 8]``, ``info`` ``[T, 2]`` i32.  The kernel gathers the live
    columns from ``columns`` itself; on CPU tensors the plain version
    answers, on the columns staged here.  ``stamps=True`` (CUDA only) also
    returns the start and end in ns of each block, i64 ``[T + W, 2]``: the
    ``T`` blocks of the launch over the tiles, then the ``W`` blocks that
    work off the chunks of the tiles that have several."""
    T = info.shape[0]
    R = T * tile
    dev = rd6.device
    k = ids.shape[1] if ids.dim() == 2 else 0
    wp = columns.shape[0]
    ce._check("info", info, torch.int32, (T, 2), dev)
    ce._check("columns", columns, torch.float32, (wp, COL), dev)
    ce._check("ids", ids, torch.float32, (T, k), dev)
    ce._check("rd6", rd6, torch.float32, (R, ROW), dev)
    ce._check("rp8", rp8, torch.float32, (R, ROW), dev)
    if (k % 64 or k == 0 or wp % k or not 0 < tile <= 512 or tile % 32
            or max_tris <= 0 or not 0 <= n_tris <= wp):
        raise ValueError(f"K6 takes k_cols a multiple of 64 dividing Wp, "
                         f"n_tris <= Wp and tiles of 32..512 rays (k_cols "
                         f"{k}, Wp {wp}, n_tris {n_tris}, tile {tile}, "
                         f"max_tris {max_tris})")
    if ce._device_kind(rd6) == "cpu":
        if stamps:
            raise ValueError("K6's block stamps exist on the card only")
        listed = (torch.arange(k, device=dev)[None, :]
                  < info[:, :1] * max_tris)
        ids = torch.where(listed, ids, -1.0)
        return mxu_cast_reference(info, columns, n_tris,
                                  gather_columns(columns, ids), ids, rd6,
                                  rp8, tile)
    if k > _MAX_K_COLS:
        raise ValueError(f"K6 holds a chunk's list in shared memory: k_cols "
                         f"{k} > {_MAX_K_COLS}")
    for name, x in (("columns", columns), ("rd6", rd6), ("rp8", rp8)):
        if x.data_ptr() % 16:
            raise ValueError(f"{name}: K6 reads 16-byte aligned rows")
    from . import kernels

    lib = kernels.library()
    outs = [torch.empty(R, dtype=torch.float32, device=dev)
            for _ in range(4)]
    # scratch: the key per ray that merges a tile's chunks, and the list of
    # the (tile, chunk) items of the tiles that have several
    keys = torch.empty(R, dtype=torch.int64, device=dev)
    work = torch.empty(2 + 2 * T * lib.rt_mxu_split(), dtype=torch.int32,
                       device=dev)
    times = (torch.zeros(T + lib.rt_mxu_workers(dev.index), 2,
                         dtype=torch.int64, device=dev) if stamps else None)
    if R > 0:
        err = lib.rt_mxu_cast(
            ce._ptr(info), ce._ptr(columns), n_tris, ce._ptr(ids), k,
            max_tris, ce._ptr(rd6), ce._ptr(rp8), R, tile,
            *[ce._ptr(x) for x in outs], ce._ptr(keys), ce._ptr(work),
            ce._ptr(times) if stamps else None, dev.index,
            kernels.stream_handle(dev))
        ce._raise_on(err, "mxu_cast")
        mxu_cast.launches += 1
    return tuple(outs) + ((times,) if stamps else ())


mxu_cast.launches = 0


def make_mxu_cast(data: MxuData, cfg: RenderConfig):
    """The engine's MXU cast (``engine.make_cast``'s ``pallas_kernel="mxu"``
    branch: ``detach_visibility`` over the ray-chunked kernel).  The hit has
    no normal and no material, and the cast has no ``occlude``/``occlude2``
    queries.  ``engine="torch"`` takes the plain version."""
    if cfg.engine not in ("cuda", "torch"):
        raise ValueError(f"unknown engine {cfg.engine!r} "
                         "(expected 'torch' or 'cuda')")
    plain = cfg.engine == "torch"

    def query(ro, rd, _data):
        lay = CullLayout.of(ro.shape[0], cfg.pallas_ray_chunk, data.tile)
        ro_p, rd_p = lay.pad_rays(ro, rd, 0.0)
        info, staged, ids, rd6, rp8 = stage_mxu(ro_p, rd_p, data,
                                                columns=plain)
        if plain:
            t, idf, u, v = mxu_cast_reference(
                info, data.columns, data.n_tris, staged, ids, rd6, rp8,
                data.tile)
        else:
            t, idf, u, v = mxu_cast(info, data.columns, data.n_tris, ids,
                                    rd6, rp8, data.tile, data.max_tris)
        t = lay.unpad(t)
        return Hit(valid=torch.isfinite(t), t=t,
                   wtri=torch.clamp(lay.unpad(idf), min=0.0).to(torch.int32),
                   uv=torch.stack([lay.unpad(u), lay.unpad(v)], -1))

    def cast(ro, rd):
        return cast_detached(query, ro, rd, data, with_attrs=False)

    return cast
