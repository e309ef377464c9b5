#!/usr/bin/env python3
"""Where the hand-written kernels spend a launch: K6 (the MXU cast), K5 and
K4 (the candidate-list any-hit and closest hit), K1 (the LBVH closest hit)
and K2/K3 (the LBVH shadow queries).

    python3 raytracer_tpu_torch/probe_kernels.py [--root DIR ...]
                                                 [--frames-only | --walks-only
                                                  | --march] [--out F]

On one GPU, at 640x480 and 1920x1080, for each ``--root`` (a checkout that
holds ``raytracer_tpu_torch``; default: this one; name several to compare
trees in turns on one card, e.g. ``--root _checkout/parent --root . --root .
--root _checkout/parent`` after ``git archive <commit> raytracer_tpu_torch |
tar -x -C _checkout/parent``):

* each tree's build: registers and spills of K1-K4 (``-Xptxas -v``) and
  the blocks an SM holds by their registers;
* K1 on terrain8's primary rays: per 32-ray warp (in launch order) the
  largest and the mean node visits of its lanes' per-thread walks (the plain
  version's ``work=`` counts) and the nodes of the union of its lanes' walks
  (what a warp-vote walk visits); then the whole launch and launches over
  whole warps: the 1% of warps with the most visits, and the rest;
* K2 and K3 on that frame's shadow queries (the point light's at finite
  max_t, the directional light's at +inf): per query and per warp the
  longest and mean walk of the per-thread walk (the plain versions'
  ``work=`` counts), of the pair walk (``cuda_engine.occlude_walk_replay``)
  and, for K2, of the union walk of both queries; the share of rays that
  the first instance they test blocks, and of parked rays (origin 1e30);
  then K2, and K3 on each query, over the whole launch, the longest 1% of
  warps and the rest, each held to its plain version;
* the terrain8 frame (the main path: K1 and K2);
* ``--march`` alone: terrain8_mixed's 1080p frame, then each of its
  transmissive marches as the frame runs it (the fused kernel,
  ``bvh_march``, where the tree has it) and as the loop of torch ops over
  K1 casts, with the kernel's byte bound and its gap to the loop;
* K4 on terrain6's primary rays: the whole launch, then its overflowed
  tiles (every instance walked), its listed tiles and its empty-list tiles,
  each with the list steps it walks;

and on terrain6:

* K6 on the primary rays and on the point light's shadow rays: the whole
  launch, then launches on subsets of its tiles -- the dense ones (list
  overflowed: the sweep over every triangle), the listed ones (a list with
  live columns), the sky ones (an empty list) -- with each subset's live
  columns.  A subset is a launch of its own over just those tiles' rows, so
  its time is what those tiles cost with the card to themselves;
* K5 on the point light's shadow query: the whole launch, then its
  overflowed tiles, the tiles whose lanes are all parked (origin 1e30: no
  slab test can pass, so the time is the bare list walk) and the rest, with
  the list steps each subset walks;
* the staging in front of K6 (``stage_mxu``), with the ``[T, K, 40]``
  column gather and, where the tree has it, without;
* the frame on the cull and on the MXU cast (median of 10, CUDA events);
  ``--frames-only`` times the frames (terrain8's too) and nothing else,
  for many turns of two trees.

Every time is given twice: the wrapper under CUDA events (median of 10
after a warm-up; includes the ctypes call and the output allocation) and the
device time alone (kernels and memsets of a ``torch.profiler`` trace, per
call).  Works on a tree whose ``mxu_cast`` takes the staged columns and on
one whose kernel gathers them itself.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import importlib
import inspect
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile

import torch

SIZES = [(640, 480), (1920, 1080)]
MARCH_SIZE = (1920, 1080)  # --march: the mixed cell's canvas
REPS = 10
WARP = 32
# per size: K1's, K2's and K3's walk statistics, and K1-K4's plain
# versions' results (the same for every tree); "ce": this checkout's
# cuda_engine, whose walk replays give the statistics
_WALKS = {}


def _event_ms(fn, reps=REPS):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps=10, exact_calls=False):
    """Device ms per call of ``fn``, and the same by kernel name: every
    kernel and memset it launches, from a profiler trace of ``reps`` calls.
    A trace can come back without the events of some calls, so each
    kernel's mean duration is taken over the events that did arrive and
    weighted by how often a call launches it (its count over the count of
    the call's least frequent ``rt::`` kernel, or with ``exact_calls``
    over ``reps``: for a call that launches an ``rt::`` kernel several
    times); an empty trace is taken again."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as fh:
                events = json.load(fh)["traceEvents"]
        seen = {}
        for e in events:
            if e.get("cat") in ("kernel", "gpu_memset"):
                c = seen.setdefault(e["name"], [0, 0.0])
                c[0] += 1
                c[1] += e["dur"] / 1e3
        ours = [c[0] for k, c in seen.items() if "rt::" in k]
        if seen:
            # plain torch: no kernel of ours
            calls = reps if exact_calls or not ours else min(ours)
            by_name = {k[:80]: c[1] / c[0] * max(1, round(c[0] / calls))
                       for k, c in seen.items()}
            return sum(by_name.values()), by_name
    raise RuntimeError("the profiler trace shows no kernel")


def _times(fn, exact_calls=False):
    dev, by_name = device_ms(fn, exact_calls=exact_calls)
    return {"event_ms": _event_ms(fn), "device_ms": dev, "kernels": by_name}


def _ptxas(log):
    """``{kernel: {"registers": n, "spill_bytes": n}}`` from nvcc's
    ``-Xptxas -v`` log, for the kernels whose name holds ``bvh_cast``,
    ``bvh_occlude``, ``cull_cast`` or ``shade_``; each with the
    128-thread blocks an SM holds by its registers (65,536 an SM, given
    out per warp in steps of 256)."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:entry function|Function properties for) '?(\w+)",
                      line)
        if m:
            cur = m.group(1)
            continue
        if cur is None or not any(k in cur for k in (
                "bvh_cast", "bvh_occlude", "cull_cast", "shade_")):
            continue
        rec = out.setdefault(cur, {"registers": None, "spill_bytes": 0})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            rec["spill_bytes"] += int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            regs = int(m.group(1))
            per_warp = -(-regs * 32 // 256) * 256
            rec["registers"] = regs
            rec["blocks_per_sm_by_registers"] = min(
                65536 // per_warp, 64) // 4
    return out


def _k1_walks(ce, ro, rd, data):
    """K1's per-thread walks on rays ``[R, 3]`` (``R`` a multiple of 32):
    per ray the nodes it visits (the plain version's ``work=`` count), and
    per warp of 32 rays the nodes of the union of its lanes' walks.  A node
    is visited iff its parent was and voted, so the union counts, for each
    internal node that some lane of the warp voted for, its two
    children."""
    R = ro.shape[0]
    union = torch.ones(R // WARP, dtype=torch.int64, device=ro.device)

    class Voted(dict):  # internal node -> rays that visited it and voted
        def __setitem__(self, u, mask):
            union.add_(2 * mask.view(-1, WARP).any(-1))
            super().__setitem__(u, mask)

    class Visits(ce._WalkVisits):
        def __init__(self, *args):
            super().__init__(*args)
            self.go = Voted()

    work = torch.zeros(R, len(ce.WORK_COLUMNS), dtype=torch.int64,
                       device=ro.device)
    saved = ce._WalkVisits
    ce._WalkVisits = Visits
    try:
        ce.bvh_cast_reference(ro, rd, data, work=work)
    finally:
        ce._WalkVisits = saved
    return work[:, 0], union


def _k1(rtt, mod, root, dev, key, w, h, out):
    """K1 on terrain8's primary rays at ``w x h``: warp statistics of the
    walks, then the whole launch and the launches over the longest 1% of
    warps and over the rest; K2 and K3 on the frame's shadow queries
    (``_occ``)."""
    ce = mod("raytracer_tpu_torch.render.cuda_engine")
    engine = mod("raytracer_tpu_torch.render.engine")
    world = rtt.generate(os.path.join(root, "raytracer_tpu_torch", "worlds",
                                      "terrain8.json"))
    scene = rtt.to_device(world.scene, dev)
    cfg = world.config.replace(engine="cuda", width=w, height=h)
    geom = mod("raytracer_tpu_torch.render.geometry").expand_geometry(scene)
    data = ce.prepare_cast(scene, geom, cfg)
    cam = rtt.to_device(mod("raytracer_tpu_torch.builder").scale_camera(
        world.camera, w, world.config.width), dev)
    ro, rd, _, _ = engine._frame_rays_blocked(cam, cfg)
    if key not in _WALKS:
        visits, union = _k1_walks(ce, ro, rd, data)
        vw = visits.view(-1, WARP)
        vmax, vmean = vw.amax(-1), vw.float().mean(-1)
        nw = vmax.numel()
        top = torch.argsort(vmax, descending=True, stable=True)[
            :max(1, nw // 100)]
        ratio = union.float() / vmax.float()
        stats = {
            "warps": nw, "rays": int(ro.shape[0]),
            "max_visits": int(vmax.max()),
            "mean_of_warp_max": float(vmax.float().mean()),
            "mean_visits": float(vmean.mean()),
            "top1_warps": int(top.numel()),
            "top1_min_of_max": int(vmax[top].min()),
            "top1_mean_of_max": float(vmax[top].float().mean()),
            "top1_mean_visits": float(vmean[top].mean()),
            "top1_union_over_max": float(ratio[top].mean()),
            "union_over_max": float(ratio.mean()),
            "sum_warp_max": int(vmax.sum()), "sum_union": int(union.sum()),
            "max_union": int(union.max())}
        _WALKS[key] = (top, stats)
        out[f"k1_walks_{key}"] = stats
        print(f"K1 walks {key}: {json.dumps(stats)}")
        _WALKS[key + "_plain"] = ce.bvh_cast_reference(ro, rd, data)
    top, stats = _WALKS[key]
    out[f"k1_differs_{key}"] = _identical(ce.bvh_cast(ro, rd, data),
                                          _WALKS[key + "_plain"])
    print(f"K1 {key} against its plain version: differs in "
          f"{out[f'k1_differs_{key}']}")
    nw = stats["warps"]
    chosen = torch.zeros(nw, dtype=torch.bool, device=dev)
    chosen[top] = True
    lanes = torch.arange(WARP, device=dev)
    for sname, mask in (("all", torch.ones_like(chosen)), ("top1", chosen),
                        ("rest", ~chosen)):
        rows = (torch.nonzero(mask).flatten()[:, None] * WARP
                + lanes).flatten()
        o, d = ro[rows].contiguous(), rd[rows].contiguous()
        r = _times(lambda: ce.bvh_cast(o, d, data))
        r.update(warps=int(mask.sum()))
        out[f"k1_{sname}_{key}"] = r
        print(f"K1 {key} {sname:4s}: {int(mask.sum()):6d} warps: "
              f"{r['event_ms']:.4f} ms (device {r['device_ms']:.4f})")
    # K2 and K3 on the frame's shadow queries
    hit = _WALKS[key + "_plain"]
    t = torch.where(hit.valid, hit.t, 1.0)
    o1, d1, dist, o2, d2 = mod("raytracer_tpu_torch.render.shading"
                               ).shadow_rays(scene, ro + t[:, None] * rd,
                                             hit.valid)
    occ = (o1, d1, dist, o2, d2.contiguous(),
           torch.full_like(dist, float("inf")))
    _occ(ce, occ, data, dev, key, out)


def _frame8(rtt, mod, root, dev, key, w, h, out):
    """The main path's frame (terrain8 on the walk: K1 and K2)."""
    engine = mod("raytracer_tpu_torch.render.engine")
    world = rtt.generate(os.path.join(root, "raytracer_tpu_torch", "worlds",
                                      "terrain8.json"))
    scene = rtt.to_device(world.scene, dev)
    cfg = world.config.replace(engine="cuda", width=w, height=h)
    cam = rtt.to_device(mod("raytracer_tpu_torch.builder").scale_camera(
        world.camera, w, world.config.width), dev)
    ms = _event_ms(lambda: engine.render_frame(scene, cam, cfg))
    out[f"frame_walk_{key}"] = ms
    print(f"frame walk {key}: {ms:.3f} ms (median of {REPS})")


def _warp_stats(x, live):
    """Per 32-lane warp in launch order: the longest and the mean of ``x``
    over the lanes, summarized over all warps and over the warps with a
    lane in ``live`` (a ray that is not parked)."""
    xw = x.view(-1, WARP)
    vmax, vmean = xw.amax(-1).float(), xw.float().mean(-1)
    lw = live.view(-1, WARP).any(-1)
    return {"max": int(vmax.max()), "mean_of_warp_max": float(vmax.mean()),
            "mean": float(vmean.mean()), "sum_warp_max": int(vmax.sum()),
            "live_warps": int(lw.sum()),
            "live_mean_of_warp_max": float(vmax[lw].mean()),
            "live_mean": float(x[live].float().mean())}


def _occ_walks(ce, occ, data):
    """K2's and K3's walks on the shadow queries ``occ`` (K2's six
    inputs): per query the per-thread walk's node visits (the plain
    version's ``work=`` counts: one node a step), the pair walk's steps
    (``cuda_engine.occlude_walk_replay``) and whether the first instance a
    ray tests blocks it; K2's union
    walk (both queries in one walk, one node a step, until both are
    blocked); the parked share (origin 1e30)."""
    R = occ[0].shape[0]
    queries = {"point": occ[:3], "directional": occ[3:]}
    parked = occ[0][:, 0] > 1e29
    stats = {"rays": R, "parked_share": float(parked.float().mean())}
    own = {}
    for name, q in queries.items():
        work = torch.zeros(R, len(ce.WORK_COLUMNS), dtype=torch.int64,
                           device=q[0].device)
        blk = ce.bvh_occlude_reference(*q, data, work=work)
        own[name] = work[:, 0]
        b, visits, first = ce.occlude_walk_replay(*q, data)
        if not torch.equal(b, blk):
            raise AssertionError(f"{name}: the pair walk's mask is not the "
                                 "plain version's")
        tested = int((first >= 0).sum())
        stats[name] = {
            "blocked": int(blk.sum()),
            "per_thread": _warp_stats(work[:, 0], ~parked),
            "pair_steps": _warp_stats((visits - 1) // 2, ~parked),
            "tested": tested,
            "first_blocks_share": float((first == 1).sum()) / max(1, tested)}
    work = torch.zeros(R, len(ce.WORK_COLUMNS), dtype=torch.int64,
                       device=occ[0].device)
    ce.bvh_occlude2_reference(*occ, data, work=work)
    union = work[:, 0] // 2  # two slab tests a node
    longer = torch.maximum(own["point"], own["directional"])
    stats["union"] = _warp_stats(union, ~parked)
    stats["longer_own"] = _warp_stats(longer, ~parked)
    stats["union_over_longer_own"] = float(union.sum() / longer.sum())
    ranks = {"k2": union, "k3_point": own["point"],
             "k3_directional": own["directional"]}
    return stats, ranks


def _occ(ce, occ, data, dev, key, out):
    """K2 and K3 on the shadow queries: the walk statistics (once a size),
    then each kernel's whole launch and its launches over whole warps --
    the 1% of warps whose longest per-thread walk (K2: union walk) is the
    longest, and the rest."""
    here = _WALKS["ce"]  # this checkout's plain versions and replay
    if key + "_occ" not in _WALKS:
        stats, ranks = _occ_walks(here, occ, data)
        top = {}
        for name, x in ranks.items():
            vmax = x.view(-1, WARP).amax(-1)
            top[name] = torch.argsort(vmax, descending=True, stable=True)[
                :max(1, vmax.numel() // 100)]
            stats[f"top1_{name}_min_of_max"] = int(vmax[top[name]].min())
        _WALKS[key + "_occ"] = (stats, top, {
            "k2": here.bvh_occlude2_reference(*occ, data),
            "k3_point": here.bvh_occlude_reference(*occ[:3], data),
            "k3_directional": here.bvh_occlude_reference(*occ[3:], data)})
        out[f"occ_walks_{key}"] = stats
        print(f"K2/K3 walks {key}: {json.dumps(stats)}")
    stats, top, plain = _WALKS[key + "_occ"]
    lanes = torch.arange(WARP, device=dev)
    nw = occ[0].shape[0] // WARP
    for name, fn in (
            ("k2", lambda q: ce.bvh_occlude2(*q, data)),
            ("k3_point", lambda q: ce.bvh_occlude(*q[:3], data)),
            ("k3_directional", lambda q: ce.bvh_occlude(*q[3:], data))):
        got = fn(occ)
        got = got if name != "k2" else torch.stack(got)
        want = plain[name] if name != "k2" else torch.stack(plain[name])
        out[f"{name}_differs_{key}"] = int((got != want).sum())
        chosen = torch.zeros(nw, dtype=torch.bool, device=dev)
        chosen[top[name]] = True
        for sname, mask in (("all", torch.ones_like(chosen)),
                            ("top1", chosen), ("rest", ~chosen)):
            rows = (torch.nonzero(mask).flatten()[:, None] * WARP
                    + lanes).flatten()
            q = tuple(x[rows].contiguous() for x in occ)
            r = _times(lambda: fn(q))
            r.update(warps=int(mask.sum()))
            out[f"{name}_{sname}_{key}"] = r
            print(f"{name.upper()} {key} {sname:4s}: {int(mask.sum()):6d} "
                  f"warps: {r['event_ms']:.4f} ms (device "
                  f"{r['device_ms']:.4f}); differs from plain in "
                  f"{out[f'{name}_differs_{key}']}")


def _identical(hk, hp):
    """The outputs in which a kernel's hits differ from its plain
    version's, with the number of values (empty: identical)."""
    out = {}
    for name in ("valid", "t", "wtri", "uv", "normal", "mat"):
        a, b = getattr(hk, name), getattr(hp, name)
        if not torch.equal(a, b):
            out[name] = int((a != b).sum())
    return out


def _load(root):
    """Import ``raytracer_tpu_torch`` from ``root`` (dropping any copy
    imported from another root)."""
    for name in [m for m in sys.modules if m.split(".")[0]
                 == "raytracer_tpu_torch"]:
        del sys.modules[name]
    sys.path.insert(0, root)
    try:
        return importlib.import_module("raytracer_tpu_torch")
    finally:
        sys.path.remove(root)


def float32_steps(a, b):
    """Largest distance of two float32 tensors in float32 steps (the zeros
    of both signs one value)."""
    def ordered(x):
        i = x.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int((ordered(a) - ordered(b)).abs().max())


def _march(rtt, mod, root, dev, out):
    """terrain8_mixed at 1080p (``MARCH_SIZE``): the frame (median of 10),
    then each of its transmissive marches (2 lights x 3 rounds, inputs
    recorded from one frame) as the frame runs it (``march_transmissive``:
    the fused kernel where the tree has one) and as the loop of torch ops
    over K1 casts (``shading.march_steps``; on a tree without it, its
    ``march_transmissive``), with the kernel's byte bound and its largest
    gap to the loop in float32 steps."""
    shading = mod("raytracer_tpu_torch.render.shading")
    engine = mod("raytracer_tpu_torch.render.engine")
    scale_camera = mod("raytracer_tpu_torch.builder").scale_camera
    w = rtt.generate(os.path.join(root, "raytracer_tpu_torch", "worlds",
                                  "terrain8_mixed.json"))
    scene = rtt.to_device(w.scene, dev)
    (width, height), size = MARCH_SIZE, "x".join(map(str, MARCH_SIZE))
    cfg = w.config.replace(engine="cuda", width=width, height=height)
    cam = rtt.to_device(scale_camera(w.camera, width, w.config.width), dev)
    ms = _event_ms(lambda: engine.render_frame(scene, cam, cfg))
    out[f"frame_mixed_{size}"] = ms
    print(f"frame terrain8_mixed {size}: {ms:.3f} ms (median of {REPS})")
    calls, orig = [], shading.march_transmissive

    def record(*args):
        calls.append(args)
        return orig(*args)

    shading.march_transmissive = record
    try:
        engine.render_frame(scene, cam, cfg)
    finally:
        shading.march_transmissive = orig
    loop_fn = getattr(shading, "march_steps", None)
    for i, (sc, geom, cast, c, o, d, mt, col, act) in enumerate(calls):
        key = f"march_{i}_{'point' if d.dim() == 2 else 'directional'}"
        rec = {"lanes": o.shape[0], "active": int(act.sum())}
        if loop_fn is None:
            def loop():
                return orig(sc, geom, cast, c, o, d, mt, col, act)
        else:
            def loop():
                return loop_fn(cast, geom, sc.materials, o, d, mt, col, act,
                               c.shadow_steps, c.early_exit)
        rec["loop"] = _times(loop, exact_calls=True)  # a K1 launch a step
        # getattr: a parent tree (--root) may cast through a closure with
        # no march attribute, where this tree's Cast has a march field
        if getattr(cast, "march", None) is not None:
            def fused():
                return cast.march(o, d, mt, col, act, sc.materials.kt,
                                  c.shadow_steps)
            rec["kernel"] = _times(fused)
            nbytes = o.shape[0] * (12 + 1 + 16 + (12 if d.dim() == 2 else 0)
                                   + (4 if isinstance(mt, torch.Tensor)
                                      else 0))
            rec["bytes"] = nbytes
            rec["bound_ms"] = nbytes / 3.35e12 * 1e3
            rec["ulps_to_loop"] = float32_steps(fused(), loop())
            rec["values_off_loop"] = int((fused() != loop()).sum())
        out[key] = rec
        print(f"{key}: {rec['active']} of {rec['lanes']} lanes active; loop "
              f"{rec['loop']['event_ms']:.4f} ms (device "
              f"{rec['loop']['device_ms']:.4f})" + (
                  f"; kernel {rec['kernel']['event_ms']:.4f} ms (device "
                  f"{rec['kernel']['device_ms']:.4f}), bound "
                  f"{rec['bound_ms']:.4f} ms ({rec['bytes']} B), "
                  f"{rec['values_off_loop']} values off the loop's, "
                  f"{rec['ulps_to_loop']} float32 steps at most"
                  if "kernel" in rec else ""))


def probe(root, dev, smi, frames_only=False, logs=None, walks_only=False,
          march=False):
    rtt = _load(root)
    mod = importlib.import_module
    ce = mod("raytracer_tpu_torch.render.cuda_engine")
    cull = mod("raytracer_tpu_torch.render.cull")
    mxu = mod("raytracer_tpu_torch.render.mxu")
    engine = mod("raytracer_tpu_torch.render.engine")
    scale_camera = mod("raytracer_tpu_torch.builder").scale_camera
    expand_geometry = mod("raytracer_tpu_torch.render.geometry").expand_geometry
    shadow_rays = mod("raytracer_tpu_torch.render.shading").shadow_rays
    kernels = mod("raytracer_tpu_torch.render.kernels")
    _, log = kernels.build()
    kernels.library()
    logs = {} if logs is None else logs
    if log:  # a tree's log is read where it is first built
        logs[root] = _ptxas(log)

    world = rtt.generate(os.path.join(root, "raytracer_tpu_torch", "worlds",
                                      "terrain6.json"))
    scene = rtt.to_device(world.scene, dev)
    cfg = world.config.replace(engine="cuda")
    geom = expand_geometry(scene)
    data = ce.prepare_cast(scene, geom, cfg)
    mdata = mxu.prepare_mxu_cast(scene, geom, cfg.replace(
        pallas_kernel="mxu"))
    takes_staged = "staged" in inspect.signature(mxu.mxu_cast).parameters
    out = {"root": root, "gpu": smi, "k6_takes_staged": takes_staged}
    print(f"== {root} [{smi}]: mxu_cast "
          f"{'reads staged columns' if takes_staged else 'gathers columns'}")
    out["ptxas"] = logs.get(root)
    for name, rec in (logs.get(root) or {}).items():
        print(f"ptxas {name}: {rec}")
    if march:
        _march(rtt, mod, root, dev, out)
        return out
    for w, h in SIZES:
        if not frames_only:
            _k1(rtt, mod, root, dev, f"{w}x{h}", w, h, out)
        _frame8(rtt, mod, root, dev, f"{w}x{h}", w, h, out)
    if walks_only:
        return out

    for w, h in SIZES:
        key = f"{w}x{h}"
        c = cfg.replace(width=w, height=h)
        cam = rtt.to_device(scale_camera(world.camera, w,
                                         world.config.width), dev)
        for pname, pcfg in (("cull", c),
                            ("mxu", c.replace(pallas_kernel="mxu"))):
            ms = _event_ms(lambda: engine.render_frame(scene, cam, pcfg))
            out[f"frame_{pname}_{key}"] = ms
            print(f"frame {pname} {key}: {ms:.3f} ms (median of {REPS})")
        if frames_only:
            continue
        ro, rd, _, _ = engine._frame_rays_blocked(cam, c)

        # the cull's primary cast gives the shadow queries
        tile = cull.tile_rows_of(c) * cull.LANES
        lay = cull.CullLayout.of(ro.shape[0], c.pallas_ray_chunk, tile)
        o_p, d_p = lay.pad_rays(ro, rd, 1.0e30)
        cand, info = cull.tile_candidates(o_p, d_p, tile,
                                          data.tables.inst_f32, cull.MAX_CAND)
        hit = cull.cull_cast(o_p, d_p, cand, info, tile, data.tables)
        valid = lay.unpad(hit.valid)
        t = torch.where(valid, lay.unpad(hit.t), 1.0)
        so, sd, dist, _, _ = shadow_rays(scene, ro + t[:, None] * rd, valid)

        # ---- K4 -----------------------------------------------------------
        if f"k4_plain_{key}" not in _WALKS:
            _WALKS[f"k4_plain_{key}"] = cull.cull_cast_reference(
                o_p, d_p, cand, info, tile, data.tables)
        diffs = _identical(hit, _WALKS[f"k4_plain_{key}"])
        out[f"k4_differs_{key}"] = diffs
        print(f"K4 {key} against its plain version: differs in {diffs}")
        T4 = info.shape[0]
        over4 = info[:, 1] > 0
        empty4 = ~over4 & (info[:, 0] == 0)
        subsets = {"all": torch.ones_like(over4), "overflow": over4,
                   "listed": ~over4 & ~empty4, "empty": empty4}
        for sname, mask in subsets.items():
            sel = torch.nonzero(mask).flatten()
            n = int(sel.numel())
            if n == 0:
                continue

            def rows4(x):
                return x.reshape((T4, tile) + x.shape[1:])[sel].reshape(
                    (-1,) + x.shape[1:]).contiguous()

            args4 = (rows4(o_p), rows4(d_p), cand[sel].contiguous(),
                     info[sel].contiguous(), tile, data.tables)
            r = _times(lambda: cull.cull_cast(*args4))
            steps = int(info[sel, 0].sum())
            r.update(tiles=n, list_steps=steps,
                     max_steps=int(info[sel, 0].max()))
            out[f"k4_{sname}_{key}"] = r
            print(f"K4 {key} {sname:8s}: {n:4d} tiles of {tile}, {steps:6d} "
                  f"list steps (max {r['max_steps']}): {r['event_ms']:.4f} ms "
                  f"(device {r['device_ms']:.4f})")

        # ---- K6 -----------------------------------------------------------
        mtile = mdata.tile
        for rname, (o, d) in (("primary", (ro, rd)), ("shadow", (so, sd))):
            mlay = cull.CullLayout.of(o.shape[0], c.pallas_ray_chunk, mtile)
            mo, md = mlay.pad_rays(o, d, 0.0)
            st = mxu.stage_mxu(mo, md, mdata)
            info6, staged, ids, rd6, rp8 = st
            T = info6.shape[0]
            dense = info6[:, 1] > 0
            live = ((ids >= 0) & ~dense[:, None]).sum(-1)
            subsets = {"all": torch.ones_like(dense), "dense": dense,
                       "listed": ~dense & (live > 0),
                       "sky": ~dense & (live == 0)}
            if rname == "primary":
                res = {"with_columns": _times(
                    lambda: mxu.stage_mxu(mo, md, mdata))}
                if not takes_staged:
                    res["without_columns"] = _times(
                        lambda: mxu.stage_mxu(mo, md, mdata, columns=False))
                out[f"stage_mxu_{key}"] = res
                print(f"stage_mxu {key}: " + ", ".join(
                    f"{k} {v['event_ms']:.4f} ms (device {v['device_ms']:.4f})"
                    for k, v in res.items()))
            for sname, mask in subsets.items():
                sel = torch.nonzero(mask).flatten()
                n = int(sel.numel())
                if n == 0:
                    continue
                cols = int(live[sel].sum()) + int(dense[sel].sum()) * \
                    mdata.n_tris
                a6 = rd6.reshape(T, mtile, 8)[sel].reshape(-1, 8).contiguous()
                p8 = rp8.reshape(T, mtile, 8)[sel].reshape(-1, 8).contiguous()
                i6 = info6[sel].contiguous()
                id6 = ids[sel].contiguous()
                if takes_staged:
                    s6 = staged[sel].contiguous()

                    def fn():
                        return mxu.mxu_cast(i6, mdata.columns, mdata.n_tris,
                                            s6, id6, a6, p8, mtile)
                else:
                    def fn():
                        return mxu.mxu_cast(i6, mdata.columns, mdata.n_tris,
                                            id6, a6, p8, mtile,
                                            mdata.max_tris)
                r = _times(fn)
                r.update(tiles=n, live_columns=cols)
                out[f"k6_{rname}_{sname}_{key}"] = r
                print(f"K6 {rname:7s} {key} {sname:6s}: {n:5d} tiles, "
                      f"{cols:8d} live columns: {r['event_ms']:.4f} ms "
                      f"(device {r['device_ms']:.4f})")

        # ---- K5 -----------------------------------------------------------
        slay = cull.CullLayout.of(so.shape[0], c.pallas_ray_chunk, tile)
        o5, d5 = slay.pad_rays(so, sd, 1.0e30)
        mt5 = slay.pad(dist, 0.0)
        cand5, info5 = cull.tile_candidates(o5, d5, tile,
                                            data.tables.inst_f32,
                                            cull.MAX_CAND)
        T5 = info5.shape[0]
        over = info5[:, 1] > 0
        parked = (o5.reshape(T5, tile, 3)[..., 0] > 1e29).all(-1)
        subsets = {"all": torch.ones_like(over), "overflow": over,
                   "parked": parked, "overflow_parked": over & parked,
                   "listed_lit": ~over & ~parked}
        for sname, mask in subsets.items():
            sel = torch.nonzero(mask).flatten()
            n = int(sel.numel())
            if n == 0:
                continue

            def rows(x):
                return x.reshape((T5, tile) + x.shape[1:])[sel].reshape(
                    (-1,) + x.shape[1:]).contiguous()

            args = (rows(o5), rows(d5), rows(mt5), cand5[sel].contiguous(),
                    info5[sel].contiguous(), tile, data.tables)
            r = _times(lambda: cull.cull_occlude(*args))
            steps = int(info5[sel, 0].sum())
            r.update(tiles=n, list_steps=steps,
                     max_steps=int(info5[sel, 0].max()))
            out[f"k5_{sname}_{key}"] = r
            print(f"K5 {key} {sname:15s}: {n:4d} tiles of {tile}, {steps:6d} "
                  f"list steps (max {r['max_steps']}): {r['event_ms']:.4f} ms "
                  f"(device {r['device_ms']:.4f})")
    return out


def main(argv=None) -> int:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", action="append", default=None,
                    help="a checkout holding raytracer_tpu_torch (repeat to "
                         "compare trees in turns); default: this one")
    ap.add_argument("--frames-only", action="store_true",
                    help="time the frames alone (many turns of two trees)")
    ap.add_argument("--walks-only", action="store_true",
                    help="terrain8's LBVH walks (K1-K3) alone")
    ap.add_argument("--march", action="store_true",
                    help="terrain8_mixed's 1080p frame and its transmissive "
                         "marches alone (kernel and loop)")
    ap.add_argument("--out", default=None, help="write the numbers as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_kernels: needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True).stdout.strip()
    logs = {}
    _load(here)
    _WALKS["ce"] = importlib.import_module(
        "raytracer_tpu_torch.render.cuda_engine")
    results = [probe(os.path.abspath(r), dev, smi, args.frames_only, logs,
                     args.walks_only, args.march)
               for r in (args.root or [here])]
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(results, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
