#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (raytracer_tpu_torch) on one GPU.

    python3 chip_smoke.py [--out results.json]

Phases, each failing loudly (nonzero exit) on any mismatch:

1. require CUDA; print the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from csrc/ with nvcc (sm_90a) and print the time;
3. K1 (LBVH closest hit) against its plain PyTorch version on the card:
   terrain8's 640x480 primary rays and 65,536 seeded incoherent rays, with
   box tables and with template tables (build_tables(exact_uv=True));
4. K2 (fused two-light shadow query) against its plain version on that
   frame's shadow queries (finite and +inf max_t), both table kinds;
5. render_frame with engine="cuda" at 640x480 and 1920x1080 with the launch
   counters reset just before, compared with engine="torch" on the card;
   then timings with CUDA events: median frame ms of each engine, and
   per-launch ms of each kernel against its plain version;
6. K3 (single shadow query) against its plain version on that frame's
   point-light (finite max_t) and directional (+inf) queries, both table
   kinds; its masks must also equal each query of K2;
7. per-light frames at 640x480 with the K3 counter reset just before:
   terrain8 with fused_shadows=False must equal the fused frame bit for
   bit, and terrain8_lights3 (2 point + 1 directional light) from the
   "cuda" engine must equal the "torch" engine's;
8. the training step: the fwd+bwd loss gradient at 1920x1080 (materials,
   lights, camera pose; zero target) with the K1/K2 counters reset just
   before -- finite, camera grads non-zero, equal to the "torch" engine's
   grads at rtol 1e-4 / atol 1e-6 -- and 3 SGD steps at 640x480 toward the
   kd * 1.3 target lowering the loss; timings: fwd+bwd step ms and Mrays/s
   of each engine at 1080p, K3 against its plain version; then a
   torch.profiler trace of 3 fwd+bwd steps at 1080p: kernels per step,
   device busy time, idle share and the kernels that take the most time;
9. terrain6 (204 instances: the candidate-list cull): K4 (closest hit over
   the tile lists) against its plain version on the 640x480 primary rays and
   the 65,536 random rays, box and template tables, and K5 (any hit) on that
   frame's point-light and directional shadow queries, both table kinds --
   max abs err 0 -- with the share of tiles whose lists overflow;
10. K6 (the MXU cast) against its plain version on the 640x480 primary rays,
   the random rays (every tile dense) and the point-light shadow rays
   (parked lanes: the dense sweep), and on the 1920x1080 primary and shadow
   rays: t, id, u, v identical; K5 also on the 1920x1080 shadow queries;
11. terrain6 frames on the cull and on the MXU cast at 640x480 and
   1920x1080, "cuda" against "torch", with every launch counter reset just
   before: K4/K5 (or K6) launched, every other kernel not;
12. the cull frame against the LBVH walk's frame, on terrain6 and on
   terrain8 (pallas_traversal="cull");
13. the cull's fwd+bwd step at 1920x1080 (launch counters reset just
   before), grads "cuda" against "torch" at rtol 1e-4 / atol 1e-6; timings
   of the frames, the step and K4/K5/K6 against their plain versions, and
   torch.profiler summaries of the terrain6 frames on both paths and of
   the cull's step.  The cuda engine's MXU frames must never build the
   [T, K, 40] copy of the columns (mxu.gather_columns is counted).

Beside each kernel's ms per launch (CUDA events around the wrapper: the
ctypes call and the output allocation included) the device time alone is
printed, from a torch.profiler trace (every kernel and memset the wrapper
launches), at 640x480 and at 1920x1080; for K6 also, from the blocks' own
clock stamps, the share of the launch that is left when the median block of
its working launch has ended.

Each kernel's bound is the least time the card could take for its work at
the main path's shapes: the larger of the bytes it must move (inputs read
once, outputs written once) over 3.35 TB/s and its FP32 operations over
67 TFLOP/s (the H100 SXM's published peaks at 700 W).  For the walks and the
lists (K1-K5) the operations are what this run's rays reach, counted by the
plain versions (``work=``: the nodes, boxes and triangles each ray's kernel
walk tests); for K6, the live columns of each tile (its listed columns with
a triangle, or every triangle on a dense tile) at the operations a column
needs, and as bytes its rays, ids, info and outputs and the column table
once (no staged copy of the columns: no implementation needs one).

The line before the last is a JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
WORLDS = os.path.join(ROOT, "raytracer_tpu_torch", "worlds")
WORLD = os.path.join(WORLDS, "terrain8.json")
WORLD_LIGHTS3 = os.path.join(WORLDS, "terrain8_lights3.json")
WORLD6 = os.path.join(WORLDS, "terrain6.json")
SOURCE = "raytracer_tpu_torch/csrc/bvh_kernels.cu"
SOURCE_CULL = "raytracer_tpu_torch/csrc/cull_kernels.cu"
SOURCE_MXU = "raytracer_tpu_torch/csrc/mxu_kernel.cu"
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_FP32_PER_S = 67e12  # H100 SXM FP32 outside the tensor cores
# FP32 operations (arithmetic and comparisons) of one unit of work,
# counted from the sources (csrc/bvh_walk.cuh, csrc/mxu_kernel.cu): a slab
# test (6 per axis, entry/exit, the vote), a box-face evaluation, a ray
# taken into an instance frame (two quaternion rotations), a template
# triangle test, the final normal re-normalization of a closest-hit ray,
# and one ray against one live K6 column: the five dot products without
# the terms that are zero by construction (rd6 = [d, o x d, 0, 0] against
# the edges: 6 terms each; rp8 = [o, d, 1, 0] against the plane numerator:
# 4, and the denominator: 3; 45 operations), then the barycentric and
# hit-time tests (17).
OPS = {"slab": 25, "box": 7, "inst": 129, "tri": 89, "write": 11,
       "mxu_col": 62}
SIZES = [(640, 480), (1920, 1080)]
N_RANDOM = 65536
REPS = 10
PLAIN_REPS = 3  # the new phases' plain versions: oracles, not contenders
ATOL_N = 1e-5  # normals, atol
RTOL_T = 1e-5  # hit times, rtol
ATOL_FRAME = 1e-5
# cuda vs torch engine gradients: the hits are identical, so only the
# order of the atomic sums in the gather backward differs
RTOL_GRAD, ATOL_GRAD = 1e-4, 1e-6
LR = 0.05  # the CLI's --lr default


def _ms(fn, reps=REPS, warmup=True):
    """Median device ms of ``fn`` over ``reps`` calls after one warm-up,
    timed with CUDA events."""
    if warmup:
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


def _trace_events(prof):
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            return json.load(fh)["traceEvents"]


def _device_ms(fn, reps=10):
    """Device ms per call of ``fn``: every kernel and memset it launches,
    from a torch.profiler trace of ``reps`` calls.  A trace can come back
    without the events of some calls, so each kernel's mean duration is
    taken over the events that did arrive and weighted by how often a call
    launches it (its count over the count of the call's least frequent
    ``rt::`` kernel); an empty trace is taken again."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        by_name = {}
        for e in _trace_events(prof):
            if e.get("cat") in ("kernel", "gpu_memset"):
                c = by_name.setdefault(e["name"], [0, 0.0])
                c[0] += 1
                c[1] += e["dur"] / 1e3
        ours = [c[0] for k, c in by_name.items() if k.startswith("rt::")]
        if ours:
            calls = min(ours)
            return sum(c[1] / c[0] * max(1, round(c[0] / calls))
                       for c in by_name.values())
    raise AssertionError("the profiler trace shows no kernel of the port")


def _compare_hits(label, hk, hp):
    """K1 contract: valid, mat and tri identical; t at rtol 1e-5; normals
    (and uv) at atol 1e-5.  Returns the largest abs difference seen."""
    if not torch.equal(hk.valid, hp.valid):
        n = int((hk.valid != hp.valid).sum())
        raise AssertionError(f"{label}: valid differs on {n} rays")
    v = hk.valid
    for name in ("wtri", "mat"):
        a, b = getattr(hk, name)[v], getattr(hp, name)[v]
        if not torch.equal(a, b):
            raise AssertionError(f"{label}: {name} differs on "
                                 f"{int((a != b).sum())} rays")
    torch.testing.assert_close(hk.t[v], hp.t[v], rtol=RTOL_T, atol=0.0,
                               msg=lambda m: f"{label}: t: {m}")
    torch.testing.assert_close(hk.normal[v], hp.normal[v], rtol=0.0,
                               atol=ATOL_N,
                               msg=lambda m: f"{label}: normal: {m}")
    torch.testing.assert_close(hk.uv[v], hp.uv[v], rtol=0.0, atol=ATOL_N,
                               msg=lambda m: f"{label}: uv: {m}")
    err = 0.0
    if bool(v.any()):
        for a, b in ((hk.t, hp.t), (hk.normal, hp.normal), (hk.uv, hp.uv)):
            err = max(err, float((a[v] - b[v]).abs().max()))
    return err


def _nbytes(*xs):
    return sum(x.numel() * x.element_size() for x in xs)


def _bound(nbytes, ops):
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the FP32 rate."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FP32_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": int(nbytes), "ops": int(ops)}


def _work(reference, *args):
    """Per-ray work counts (``cuda_engine.WORK_COLUMNS``) of a kernel on
    ``args``, from its plain version."""
    work = torch.zeros(args[0].shape[0], 4, dtype=torch.int64,
                       device=args[0].device)
    reference(*args, work=work)
    return work


def _work_ops(work, closest_hit):
    """FP32 operations of a walk or list kernel from its per-ray work
    counts."""
    slab, box, inst, tri = work.sum(0).tolist()
    ops = (slab * OPS["slab"] + box * OPS["box"] + inst * OPS["inst"]
           + tri * OPS["tri"])
    return ops + (work.shape[0] * OPS["write"] if closest_hit else 0)


def _profile(step, smi, steps=3, label="fwd+bwd"):
    """Trace ``steps`` calls of ``step`` with torch.profiler; print the
    kernels per step, device busy time, idle share and the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    kernels = [e for e in _trace_events(prof) if e.get("cat") == "kernel"]
    busy_ms = sum(e["dur"] for e in kernels) / 1e3 / steps
    by_name = {}
    for e in kernels:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    gather_ms = sum(v for k, v in by_name.items() if "gather" in k) / steps
    out = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "idle_share": 1.0 - busy_ms / wall_ms,
           "kernels_per_step": len(kernels) / steps,
           "gather_ms_per_step": gather_ms,
           "top_ms_per_step": [[k[:100], v / steps] for k, v in top]}
    print(f"profile {label} [{smi}]: wall {wall_ms:.3f} ms/step, device busy "
          f"{busy_ms:.3f} ms (gather kernels {gather_ms:.3f} ms), idle share "
          f"{out['idle_share']:.3f}, {out['kernels_per_step']:.0f} "
          "kernels/step")
    for k, v in out["top_ms_per_step"]:
        print(f"  {v:9.3f} ms  {k}")
    return out


def _terrain6(dev, smi, rays_random, frame8_main, cfg8_main, cam8_main,
              scene8):
    """Phases 9-13: the candidate-list cull (K4, K5) and the MXU cast (K6)
    on terrain6.  Returns the numbers for the report and the kernels
    line."""
    import raytracer_tpu_torch as rtt
    from raytracer_tpu_torch import tree
    from raytracer_tpu_torch.builder import scale_camera
    from raytracer_tpu_torch.diff import (grad_of, make_loss_fn,
                                          trainable_params)
    from raytracer_tpu_torch.render import cuda_engine as ce
    from raytracer_tpu_torch.render import cull, mxu
    from raytracer_tpu_torch.render.engine import (_frame_rays_blocked,
                                                   render_frame)
    from raytracer_tpu_torch.render.geometry import expand_geometry
    from raytracer_tpu_torch.render.shading import shadow_rays

    out = {"errs": {"cull_cast": 0.0, "cull_occlude": 0.0, "mxu_cast": 0.0},
           "overflow": {}, "timing": {}, "frames": {}, "bounds": {}}
    world = rtt.generate(WORLD6)
    scene = rtt.to_device(world.scene, dev)
    cfg = world.config.replace(engine="cuda")
    geom = expand_geometry(scene)
    n_inst = scene.inst_pos.shape[0]
    data = ce.prepare_cast(scene, geom, cfg)
    if data.nodes is not None:
        raise AssertionError(f"terrain6 ({n_inst} instances) must take the "
                             "cull under pallas_traversal='auto'")
    tabs = {"box": data.tables,
            "template": ce.build_tables(scene, geom, exact_uv=True)}
    print(f"terrain6: {n_inst} instances, {scene.wtri_tri.shape[0]} world "
          "triangles: the candidate-list cull")
    cams = {s: rtt.to_device(scale_camera(world.camera, s[0],
                                          world.config.width), dev)
            for s in SIZES}
    cfgs = {s: cfg.replace(width=s[0], height=s[1]) for s in SIZES}
    main = SIZES[0]
    main_key = f"{main[0]}x{main[1]}"

    def lists(cfg_s, o, d):
        tile = cull.tile_rows_of(cfg_s) * cull.LANES
        lay = cull.CullLayout.of(o.shape[0], cfg_s.pallas_ray_chunk, tile)
        o_p, d_p = lay.pad_rays(o, d, 1.0e30)
        cand, info = cull.tile_candidates(o_p, d_p, tile,
                                          data.tables.inst_f32,
                                          cull.MAX_CAND)
        return lay, o_p, d_p, cand, info, tile

    def share(info):
        return float(info[:, 1].float().mean())

    # ---- phase 9: K4 and K5 against their plain versions --------------------
    shadow_q = {}
    for s in SIZES:
        ro, rd, _, _ = _frame_rays_blocked(cams[s], cfgs[s])
        lay, o_p, d_p, cand, info, tile = lists(cfgs[s], ro, rd)
        key = f"{s[0]}x{s[1]}"
        out["overflow"][f"k4_primary_{key}"] = share(info)
        hit = cull.cull_cast(o_p, d_p, cand, info, tile, data.tables)
        valid = lay.unpad(hit.valid)
        t = torch.where(valid, lay.unpad(hit.t), 1.0)
        o1, d1, dist, o2, d2 = shadow_rays(scene, ro + t[:, None] * rd,
                                           valid)
        shadow_q[s] = {"point": (o1, d1, dist),
                       "directional": (o2, d2.contiguous(),
                                       torch.full_like(dist, float("inf")))}
        for q, (o, d, _) in shadow_q[s].items():
            out["overflow"][f"k5_{q}_{key}"] = share(lists(cfgs[s], o, d)[4])
        print(f"cull {key}: overflowing tiles {out['overflow']}")
    ro, rd, _, _ = _frame_rays_blocked(cams[main], cfgs[main])
    k_rays = {f"primary {main_key}": (ro, rd),
              f"random {N_RANDOM}": rays_random}
    for tname, tab in tabs.items():
        for rname, (o, d) in k_rays.items():
            lay, o_p, d_p, cand, info, tile = lists(cfgs[main], o, d)
            hk = cull.cull_cast(o_p, d_p, cand, info, tile, tab)
            hp = cull.cull_cast_reference(o_p, d_p, cand, info, tile, tab)
            torch.cuda.synchronize()
            e = _compare_hits(f"K4 {tname}/{rname}", hk, hp)
            if e != 0.0:
                raise AssertionError(f"K4 {tname}/{rname}: max abs err {e}")
            out["errs"]["cull_cast"] = max(out["errs"]["cull_cast"], e)
            print(f"K4 {tname:8s} {rname:16s}: {int(hk.valid.sum())} hits "
                  f"over {info.shape[0]} tiles ({share(info):.3f} "
                  "overflow), identical to plain (max abs err 0)")
        for qname, (o, d, mt) in shadow_q[main].items():
            lay, o_p, d_p, cand, info, tile = lists(cfgs[main], o, d)
            mt_p = lay.pad(mt, 0.0)
            bk = cull.cull_occlude(o_p, d_p, mt_p, cand, info, tile, tab)
            bp = cull.cull_occlude_reference(o_p, d_p, mt_p, cand, info,
                                             tile, tab)
            torch.cuda.synchronize()
            if not torch.equal(bk, bp):
                raise AssertionError(f"K5 {tname}/{qname}: mask differs on "
                                     f"{int((bk != bp).sum())} rays")
            out["errs"]["cull_occlude"] = max(
                out["errs"]["cull_occlude"],
                float((bk.float() - bp.float()).abs().max()))
            print(f"K5 {tname:8s} {qname:11s}: blocked {int(bk.sum())} of "
                  f"{bk.numel()} padded rays, identical to plain")

    big = SIZES[-1]
    big_key = f"{big[0]}x{big[1]}"
    for qname, (o, d, mt) in shadow_q[big].items():
        lay, o_p, d_p, cand, info, tile = lists(cfgs[big], o, d)
        mt_p = lay.pad(mt, 0.0)
        bk = cull.cull_occlude(o_p, d_p, mt_p, cand, info, tile, data.tables)
        bp = cull.cull_occlude_reference(o_p, d_p, mt_p, cand, info, tile,
                                         data.tables)
        torch.cuda.synchronize()
        if not torch.equal(bk, bp):
            raise AssertionError(f"K5 {big_key}/{qname}: mask differs on "
                                 f"{int((bk != bp).sum())} rays")
        print(f"K5 box      {qname:11s} {big_key}: blocked {int(bk.sum())} "
              f"of {bk.numel()} padded rays, identical to plain")

    # ---- phase 10: K6 against its plain version -----------------------------
    cfg_m = cfg.replace(pallas_kernel="mxu")
    mdata = mxu.prepare_mxu_cast(scene, geom, cfg_m)

    def staging(o, d):
        """K6's arguments for rays ``o, d``, and its plain version's (which
        also reads the columns staged as [T, K, 40])."""
        lay = cull.CullLayout.of(o.shape[0], cfg.pallas_ray_chunk,
                                 mdata.tile)
        o_p, d_p = lay.pad_rays(o, d, 0.0)
        info, staged, ids, rd6, rp8 = mxu.stage_mxu(o_p, d_p, mdata)
        lean = mxu.stage_mxu(o_p, d_p, mdata, columns=False)
        if lean[1] is not None or not all(
                torch.equal(a, b) for a, b in zip(
                    (info, ids, rd6, rp8), lean[:1] + lean[2:])):
            raise AssertionError("stage_mxu without columns differs")
        return ((info, mdata.columns, mdata.n_tris, ids, rd6, rp8,
                 mdata.tile, mdata.max_tris),
                (info, mdata.columns, mdata.n_tris, staged, ids, rd6, rp8,
                 mdata.tile))

    ro_b, rd_b, _, _ = _frame_rays_blocked(cams[big], cfgs[big])
    m_rays = dict(k_rays)
    m_rays[f"shadow {main_key}"] = shadow_q[main]["point"][:2]
    m_rays[f"primary {big_key}"] = (ro_b, rd_b)
    m_rays[f"shadow {big_key}"] = shadow_q[big]["point"][:2]
    m_args = {}
    for rname, (o, d) in m_rays.items():
        args, args_plain = staging(o, d)
        m_args[rname] = args
        if rname == f"primary {main_key}":
            k6_plain = args_plain
        ok_ = mxu.mxu_cast(*args)
        op_ = mxu.mxu_cast_reference(*args_plain)
        del args_plain
        torch.cuda.synchronize()
        for name, a, b in zip(("t", "id", "u", "v"), ok_, op_):
            if not torch.equal(a, b):
                raise AssertionError(f"K6 {rname}: {name} differs on "
                                     f"{int((a != b).sum())} rays")
            out["errs"]["mxu_cast"] = max(out["errs"]["mxu_cast"], float(
                torch.where(a == b, 0.0, (a - b).abs()).max()))
        out["overflow"][f"k6_{'_'.join(rname.split())}"] = share(args[0])
        print(f"K6 {rname:16s}: {int(torch.isfinite(ok_[0]).sum())} hits, "
              f"{share(args[0]):.3f} of {args[0].shape[0]} tiles dense, "
              "t/id/u/v identical to plain")

    # ---- phase 11: the frames of both paths ---------------------------------
    all_k = {"bvh_cast": ce.bvh_cast, "bvh_occlude2": ce.bvh_occlude2,
             "bvh_occlude": ce.bvh_occlude, "cull_cast": cull.cull_cast,
             "cull_occlude": cull.cull_occlude, "mxu_cast": mxu.mxu_cast}
    paths = {"cull": (cfg, ("cull_cast", "cull_occlude")),
             "mxu": (cfg_m, ("mxu_cast",))}
    launches = {}
    frames6 = {}
    gathers = [0]
    gather_columns = mxu.gather_columns

    def counted_gather(columns, ids):
        gathers[0] += 1
        return gather_columns(columns, ids)

    for pname, (pcfg, used) in paths.items():
        for k in all_k.values():
            k.launches = 0
        mxu.gather_columns = counted_gather
        try:
            imgs = {s: render_frame(scene, cams[s], pcfg.replace(
                width=s[0], height=s[1])) for s in SIZES}
        finally:
            mxu.gather_columns = gather_columns
        torch.cuda.synchronize()
        if gathers[0]:
            raise AssertionError(f"{pname} frames staged the [T, K, 40] "
                                 f"columns {gathers[0]} times")
        counts = {name: k.launches for name, k in all_k.items()}
        print(f"terrain6 {pname} frames launches: {counts}")
        for name, n in counts.items():
            if (n > 0) != (name in used):
                raise AssertionError(f"{pname} frames launched {name} "
                                     f"{n} times")
        launches.update({name: counts[name] for name in used})
        for s in SIZES:
            img = imgs[s]
            ref = render_frame(scene, cams[s], pcfg.replace(
                width=s[0], height=s[1], engine="torch"))
            if tuple(img.shape) != (s[1], s[0], 4) or not bool(
                    torch.isfinite(img).all()):
                raise AssertionError(f"terrain6 {pname} {s}: bad frame")
            diff = float((img - ref).abs().max())
            hit_share = float((img[..., :3].amax(-1) > 0.0).float().mean())
            if diff > ATOL_FRAME or hit_share <= 0.05:
                raise AssertionError(f"terrain6 {pname} {s}: cuda vs torch "
                                     f"{diff}, hit share {hit_share}")
            print(f"terrain6 {pname} {s[0]}x{s[1]}: cuda == torch engine "
                  f"(max abs diff {diff:.3g}), hit share {hit_share:.4f}")
            out["frames"][f"{pname}_{s[0]}x{s[1]}"] = {
                "max_abs_diff": diff, "hit_share": hit_share}
        frames6[pname] = imgs
    d_mxu = float((frames6["mxu"][main] - frames6["cull"][main]).abs().max())
    print(f"terrain6 {main_key}: MXU frame vs cull frame max abs diff "
          f"{d_mxu:.3g}")
    out["frames"]["mxu_vs_cull_max_abs_diff"] = d_mxu

    # ---- phase 12: the cull frame against the LBVH walk's -------------------
    walk6 = render_frame(scene, cams[main], cfgs[main].replace(
        pallas_traversal="bvh"))
    cull8 = render_frame(scene8, cam8_main, cfg8_main.replace(
        pallas_traversal="cull"))
    for wname, a, b in (("terrain6", frames6["cull"][main], walk6),
                        ("terrain8", cull8, frame8_main)):
        d = float((a - b).abs().max())
        if d > ATOL_FRAME:
            raise AssertionError(f"{wname}: cull vs LBVH frame {d}")
        print(f"{wname} {main_key}: cull frame == LBVH frame (max abs diff "
              f"{d:.3g})")
        out["frames"][f"cull_vs_lbvh_{wname}"] = d

    # ---- phase 13: the cull's training step ---------------------------------
    target0 = torch.zeros(big[1], big[0], 4, device=dev)

    def loss_and_grads(engine):
        params = trainable_params(scene, cams[big])
        loss = make_loss_fn(scene, cams[big], cfgs[big].replace(
            engine=engine), target0)(params)
        return loss.detach(), grad_of(loss, params)

    for k in all_k.values():
        k.launches = 0
    loss_c, g_c = loss_and_grads("cuda")
    torch.cuda.synchronize()
    step_launches = {name: k.launches for name, k in all_k.items()}
    print(f"terrain6 cull step {big_key} launches: {step_launches}")
    if (step_launches["cull_cast"] < 1 or step_launches["cull_occlude"] < 2
            or any(step_launches[n] for n in ("bvh_cast", "bvh_occlude",
                                              "bvh_occlude2", "mxu_cast"))):
        raise AssertionError("the cull step did not run through K4/K5 alone")
    loss_t, g_t = loss_and_grads("torch")
    err = {"max_abs": 0.0}
    for (key, a), b in zip(tree.leaves_with_paths(g_c), tree.leaves(g_t)):
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"cull step grad {key} not finite")
        torch.testing.assert_close(
            a, b, rtol=RTOL_GRAD, atol=ATOL_GRAD,
            msg=lambda m, key=key: f"cull grad {key} cuda vs torch: {m}")
        err["max_abs"] = max(err["max_abs"], float((a - b).abs().max()))
    if float(g_c["cam_pos"].abs().max()) == 0.0:
        raise AssertionError("cull step: camera grads are zero")
    print(f"terrain6 cull step {big_key}: loss {float(loss_c):.6f} (torch "
          f"{float(loss_t):.6f}), grads cuda == torch engine (max abs "
          f"{err['max_abs']:.3g})")
    out["step"] = {"launches": step_launches, "grad_err": err,
                   "loss": float(loss_c)}

    # ---- timings ------------------------------------------------------------
    timing = out["timing"]
    for pname, (pcfg, _) in paths.items():
        for s in SIZES:
            key = f"{pname}_{s[0]}x{s[1]}"
            c = pcfg.replace(width=s[0], height=s[1])
            timing[f"frame_ms_cuda_{key}"] = _ms(
                lambda: render_frame(scene, cams[s], c))
            timing[f"frame_ms_torch_{key}"] = _ms(
                lambda: render_frame(scene, cams[s], c.replace(
                    engine="torch")), reps=1, warmup=False)
            print(f"time terrain6 {key} [{smi}]: frame cuda "
                  f"{timing[f'frame_ms_cuda_{key}']:.3f} ms / torch "
                  f"{timing[f'frame_ms_torch_{key}']:.3f} ms")
    timing[f"step_ms_cuda_cull_{big_key}"] = _ms(
        lambda: loss_and_grads("cuda"), reps=5)
    print(f"time terrain6 cull fwd+bwd {big_key} [{smi}]: "
          f"{timing[f'step_ms_cuda_cull_{big_key}']:.3f} ms (median of 5)")

    lay, o_p, d_p, cand, info, tile = lists(cfgs[main], ro, rd)
    k4 = (o_p, d_p, cand, info, tile, data.tables)
    o, d, mt = shadow_q[main]["point"]
    lay5, o5, d5, cand5, info5, tile5 = lists(cfgs[main], o, d)
    k5 = (o5, d5, lay5.pad(mt, 0.0), cand5, info5, tile5, data.tables)
    k6 = m_args[f"primary {main_key}"]
    timing.update({
        "k4_ms": _ms(lambda: cull.cull_cast(*k4)),
        "k4_plain_ms": _ms(lambda: cull.cull_cast_reference(*k4),
                           reps=PLAIN_REPS),
        "k5_ms": _ms(lambda: cull.cull_occlude(*k5)),
        "k5_plain_ms": _ms(lambda: cull.cull_occlude_reference(*k5),
                           reps=PLAIN_REPS),
        "k6_ms": _ms(lambda: mxu.mxu_cast(*k6)),
        "k6_plain_ms": _ms(lambda: mxu.mxu_cast_reference(*k6_plain),
                           reps=PLAIN_REPS),
    })
    print(f"time terrain6 {main_key} [{smi}]: K4 {timing['k4_ms']:.4f} ms / "
          f"plain {timing['k4_plain_ms']:.3f} ms; K5 {timing['k5_ms']:.4f} "
          f"ms / plain {timing['k5_plain_ms']:.3f} ms; K6 "
          f"{timing['k6_ms']:.4f} ms / plain {timing['k6_plain_ms']:.3f} ms "
          f"(median of {REPS} / {PLAIN_REPS})")

    # the kernels alone (device time of a profiler trace), both sizes; for
    # K6 the blocks' own stamps: how much of the launch is left when the
    # median block of its working launch (the chunk workers) has ended
    lay_b, ob, db, cand_b, info_b, tile_b = lists(cfgs[big], ro_b, rd_b)
    o, d, mt = shadow_q[big]["point"]
    lay5b, o5b, d5b, cand5b, info5b, tile5b = lists(cfgs[big], o, d)
    per_size = {
        main_key: (k4, k5, k6),
        big_key: ((ob, db, cand_b, info_b, tile_b, data.tables),
                  (o5b, d5b, lay5b.pad(mt, 0.0), cand5b, info5b, tile5b,
                   data.tables), m_args[f"primary {big_key}"])}
    for key, (a4, a5, a6) in per_size.items():
        dev_ms = {"k4": _device_ms(lambda: cull.cull_cast(*a4)),
                  "k5": _device_ms(lambda: cull.cull_occlude(*a5)),
                  "k6": _device_ms(lambda: mxu.mxu_cast(*a6))}
        stamps = mxu.mxu_cast(*a6, stamps=True)[4]
        torch.cuda.synchronize()
        workers = stamps[a6[0].shape[0]:]
        span = int(stamps[:, 1].max() - stamps[:, 0].min())
        tail = int(workers[:, 1].max() - workers[:, 1].median())
        timing[f"device_ms_{key}"] = dev_ms
        timing[f"k6_stamps_{key}"] = {
            "span_ms": span / 1e6, "after_median_worker_ms": tail / 1e6,
            "tail_share": tail / max(span, 1)}
        print(f"device time terrain6 {key} [{smi}]: K4 {dev_ms['k4']:.4f} "
              f"ms, K5 {dev_ms['k5']:.4f} ms, K6 {dev_ms['k6']:.4f} ms; K6 "
              f"blocks span {span / 1e6:.4f} ms, {tail / 1e6:.4f} ms "
              f"({tail / max(span, 1):.3f}) of it after the median worker "
              "block ended")

    # ---- bounds at the main path's shapes -----------------------------------
    tab_bytes = _nbytes(data.tables.inst_f32, data.tables.inst_i32,
                        data.tables.tmpl)
    h4 = cull.cull_cast(*k4)
    out["bounds"]["cull_cast"] = _bound(
        _nbytes(o_p, d_p, cand, info, h4.t, h4.wtri, h4.uv, h4.normal,
                h4.mat) + tab_bytes,
        _work_ops(_work(cull.cull_cast_reference, *k4), closest_hit=True))
    b5 = cull.cull_occlude(*k5)
    out["bounds"]["cull_occlude"] = _bound(
        _nbytes(*k5[:5], b5) + tab_bytes,
        _work_ops(_work(cull.cull_occlude_reference, *k5),
                  closest_hit=False))
    # K6: a listed tile's live columns hold a triangle (id >= 0); a dense
    # tile's are the n_tris triangles of the table, not its zero padding
    info6, ids6 = k6[0], k6[3]
    over6 = info6[:, 1] > 0
    n_dense = int(over6.sum())
    live_staged = int((ids6[~over6] >= 0.0).sum())
    live_cols = live_staged + n_dense * mdata.n_tris
    out["k6_columns"] = {"live_staged": live_staged,
                         "staged": (info6.shape[0] - n_dense) * mdata.k_cols,
                         "dense_tiles": n_dense, "n_tris": mdata.n_tris}
    # bytes: info, the table once, ids, the ray rows; t, id, u, v out
    out["bounds"]["mxu_cast"] = _bound(
        _nbytes(*[x for x in k6 if isinstance(x, torch.Tensor)])
        + 4 * 4 * info6.shape[0] * mdata.tile,
        live_cols * mdata.tile * OPS["mxu_col"])
    print(f"K6 {main_key} columns: {out['k6_columns']}")
    for name, b in out["bounds"].items():
        print(f"bound {name}: {b['bound_ms']:.5f} ms ({b['bound_by']}: "
              f"{b['bytes']} bytes, {b['ops']} FP32 ops)")

    for pname, (pcfg, _) in paths.items():
        for s in SIZES:
            c = pcfg.replace(width=s[0], height=s[1])
            out[f"profile_{pname}_{s[0]}x{s[1]}"] = _profile(
                lambda: render_frame(scene, cams[s], c), smi, steps=5,
                label=f"terrain6 {pname} frame {s[0]}x{s[1]}")
    out[f"profile_cull_step_{big_key}"] = _profile(
        lambda: loss_and_grads("cuda"), smi,
        label=f"terrain6 cull fwd+bwd {big_key}")
    out["launches"] = launches
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write every number to this JSON file")
    args = ap.parse_args(argv)

    t_start = time.perf_counter()
    # ---- phase 1: the card -------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this run needs an NVIDIA GPU")
    import raytracer_tpu_torch as rtt
    from raytracer_tpu_torch import tree
    from raytracer_tpu_torch.diff import (grad_of, make_loss_fn, train_step,
                                          trainable_params)
    from raytracer_tpu_torch.builder import scale_camera
    from raytracer_tpu_torch.render import cuda_engine as ce
    from raytracer_tpu_torch.render import kernels
    from raytracer_tpu_torch.render.engine import (_frame_rays_blocked,
                                                   render_frame)
    from raytracer_tpu_torch.render.geometry import expand_geometry
    from raytracer_tpu_torch.render.shading import shadow_rays

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"gpu: {smi}")
    print(f"torch {torch.__version__}, cuda {torch.version.cuda}")
    report = {"gpu": smi, "torch": torch.__version__}

    # ---- phase 2: build ----------------------------------------------------
    t0 = time.perf_counter()
    path, log = kernels.build()
    kernels.library()
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.2f} s -> {os.path.relpath(path, ROOT)}")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Function properties" in line:
            print(f"  ptxas: {line.strip()}")
    report["build_s"] = build_s

    # ---- the world ---------------------------------------------------------
    world = rtt.generate(WORLD)
    scene = rtt.to_device(world.scene, dev)
    cfg = world.config.replace(engine="cuda")
    geom = expand_geometry(scene)
    data = ce.prepare_cast(scene, geom, cfg)
    data_tmpl = ce.CastData(
        tables=ce.build_tables(scene, geom, exact_uv=True),
        nodes=data.nodes, ordering=data.ordering)
    assert int(data_tmpl.tables.inst_i32[:, ce._II_IS_BOX].sum()) == 0
    n_box = int(data.tables.inst_i32[:, ce._II_IS_BOX].sum())
    print(f"world: {scene.inst_pos.shape[0]} instances ({n_box} box fast "
          f"path), {scene.wtri_tri.shape[0]} world triangles, "
          f"{data.n_leaves} LBVH leaves")

    cams = {s: rtt.to_device(scale_camera(world.camera, s[0],
                                          world.config.width), dev)
            for s in SIZES}
    cfgs = {s: cfg.replace(width=s[0], height=s[1]) for s in SIZES}
    main = SIZES[0]
    main_key = f"{main[0]}x{main[1]}"
    ro, rd, _, _ = _frame_rays_blocked(cams[main], cfgs[main])
    rng = np.random.default_rng(0)
    o_rand = rng.uniform(-6.0, 6.0, (N_RANDOM, 3)).astype(np.float32)
    o_rand[:, 1] += 4.0
    d_rand = rng.standard_normal((N_RANDOM, 3)).astype(np.float32)
    d_rand /= np.linalg.norm(d_rand, axis=-1, keepdims=True)
    o_rand = torch.from_numpy(o_rand).to(dev)
    d_rand = torch.from_numpy(d_rand).to(dev)

    # ---- phase 3: K1 against its plain version ------------------------------
    errs = {"bvh_cast": 0.0, "bvh_occlude2": 0.0}
    rays = {f"primary {main_key}": (ro, rd),
            f"random {N_RANDOM}": (o_rand, d_rand)}
    primary_hit = {}
    for tname, tdata in (("box", data), ("template", data_tmpl)):
        for rname, (o, d) in rays.items():
            hk = ce.bvh_cast(o, d, tdata)
            hp = ce.bvh_cast_reference(o, d, tdata)
            torch.cuda.synchronize()
            e = _compare_hits(f"K1 {tname}/{rname}", hk, hp)
            errs["bvh_cast"] = max(errs["bvh_cast"], e)
            print(f"K1 {tname:8s} {rname:16s}: {int(hk.valid.sum())} hits, "
                  f"identical valid/tri/mat, max abs err {e:.3g}")
            if rname.startswith("primary"):
                primary_hit[tname] = hk

    # ---- phase 4: K2 against its plain version ------------------------------
    hit = primary_hit["box"]
    t_safe = torch.where(hit.valid, hit.t, 1.0)
    hit_pos = ro + t_safe[:, None] * rd
    o1, d1, dist, o2, d2 = shadow_rays(scene, hit_pos, hit.valid)
    d2 = d2.contiguous()
    mt_inf = torch.full_like(dist, float("inf"))
    occ_inputs = (o1, d1, dist, o2, d2, mt_inf)
    for tname, tdata in (("box", data), ("template", data_tmpl)):
        bk = ce.bvh_occlude2(*occ_inputs, tdata)
        bp = ce.bvh_occlude2_reference(*occ_inputs, tdata)
        torch.cuda.synchronize()
        for q in range(2):
            if not torch.equal(bk[q], bp[q]):
                n = int((bk[q] != bp[q]).sum())
                raise AssertionError(f"K2 {tname}: query {q + 1} mask "
                                     f"differs on {n} rays")
            errs["bvh_occlude2"] = max(
                errs["bvh_occlude2"],
                float((bk[q].float() - bp[q].float()).abs().max()))
        print(f"K2 {tname:8s}: blocked {int(bk[0].sum())} (point, finite "
              f"max_t) + {int(bk[1].sum())} (directional, +inf max_t) of "
              f"{int(hit.valid.sum())} hits, masks identical")

    # ---- phase 5: the main path ---------------------------------------------
    ce.bvh_cast.launches = 0
    ce.bvh_occlude2.launches = 0
    frames = {s: render_frame(scene, cams[s], cfgs[s]) for s in SIZES}
    torch.cuda.synchronize()
    launches = {"bvh_cast": ce.bvh_cast.launches,
                "bvh_occlude2": ce.bvh_occlude2.launches}
    print(f"main path launches: {launches}")
    for name, n in launches.items():
        if n < 1:
            raise AssertionError(f"{name} was not launched by the main path")

    report["frames"] = {}
    for s in SIZES:
        img = frames[s]
        ref = render_frame(scene, cams[s], cfgs[s].replace(engine="torch"))
        if tuple(img.shape) != (s[1], s[0], 4):
            raise AssertionError(f"frame {s}: shape {tuple(img.shape)}")
        if not bool(torch.isfinite(img).all()):
            raise AssertionError(f"frame {s}: non-finite values")
        diff = float((img - ref).abs().max())
        if diff > ATOL_FRAME:
            raise AssertionError(f"frame {s}: cuda vs torch engine max abs "
                                 f"diff {diff} > {ATOL_FRAME}")
        hits = img[..., :3].amax(dim=-1) > 0.0
        hit_share = float(hits.float().mean())
        sat = img[..., :3] >= 1.0
        all_sat = bool(sat.any(dim=-1)[hits].all()) if bool(hits.any()) else True
        if hit_share <= 0.05 or all_sat:
            raise AssertionError(f"frame {s}: hit share {hit_share:.3f}, "
                                 f"every hit saturated: {all_sat}")
        print(f"frame {s[0]}x{s[1]}: cuda == torch engine (max abs diff "
              f"{diff:.3g}), hit share {hit_share:.4f}")
        report["frames"][f"{s[0]}x{s[1]}"] = {"max_abs_diff": diff,
                                              "hit_share": hit_share}

    # ---- timings -----------------------------------------------------------
    timing = {}
    for s in SIZES:
        key = f"{s[0]}x{s[1]}"
        ms_cuda = _ms(lambda: render_frame(scene, cams[s], cfgs[s]))
        ms_torch = _ms(lambda: render_frame(
            scene, cams[s], cfgs[s].replace(engine="torch")))
        rays_n = s[0] * s[1]
        timing[key] = {"frame_ms_cuda": ms_cuda, "frame_ms_torch": ms_torch,
                       "primary_mrays_per_s_cuda": rays_n / ms_cuda / 1e3}
        ro_s, rd_s, _, _ = _frame_rays_blocked(cams[s], cfgs[s])
        hk = ce.bvh_cast(ro_s, rd_s, data)
        tp = torch.where(hk.valid, hk.t, 1.0)
        sq = shadow_rays(scene, ro_s + tp[:, None] * rd_s, hk.valid)
        occ = (sq[0], sq[1], sq[2], sq[3], sq[4].contiguous(),
               torch.full_like(sq[2], float("inf")))
        timing[key].update({
            "k1_ms": _ms(lambda: ce.bvh_cast(ro_s, rd_s, data)),
            "k1_plain_ms": _ms(lambda: ce.bvh_cast_reference(ro_s, rd_s,
                                                             data)),
            "k2_ms": _ms(lambda: ce.bvh_occlude2(*occ, data)),
            "k2_plain_ms": _ms(lambda: ce.bvh_occlude2_reference(*occ,
                                                                 data)),
            "k1_device_ms": _device_ms(lambda: ce.bvh_cast(ro_s, rd_s,
                                                           data)),
            "k2_device_ms": _device_ms(lambda: ce.bvh_occlude2(*occ, data)),
            "k3_device_ms": _device_ms(lambda: ce.bvh_occlude(*occ[:3],
                                                              data)),
        })
        t = timing[key]
        print(f"time {key} [{smi}]: frame cuda {t['frame_ms_cuda']:.3f} ms "
              f"/ torch {t['frame_ms_torch']:.3f} ms; K1 {t['k1_ms']:.4f} ms "
              f"/ plain {t['k1_plain_ms']:.3f} ms; K2 {t['k2_ms']:.4f} ms "
              f"/ plain {t['k2_plain_ms']:.3f} ms (median of {REPS}); device "
              f"time alone K1 {t['k1_device_ms']:.4f}, K2 "
              f"{t['k2_device_ms']:.4f}, K3 {t['k3_device_ms']:.4f} ms")
    # ---- phase 6: K3 against its plain version and K2 -----------------------
    errs["bvh_occlude"] = 0.0
    single = (("point", (o1, d1, dist)), ("directional", (o2, d2, mt_inf)))
    for tname, tdata in (("box", data), ("template", data_tmpl)):
        pair = ce.bvh_occlude2(*occ_inputs, tdata)
        for q, (lname, (o, d, mt)) in enumerate(single):
            bk = ce.bvh_occlude(o, d, mt, tdata)
            bp = ce.bvh_occlude_reference(o, d, mt, tdata)
            torch.cuda.synchronize()
            for other, what in ((bp, "its plain version"),
                                (pair[q], f"K2 query {q + 1}")):
                if not torch.equal(bk, other):
                    n = int((bk != other).sum())
                    raise AssertionError(f"K3 {tname}/{lname}: mask differs "
                                         f"from {what} on {n} rays")
            errs["bvh_occlude"] = max(errs["bvh_occlude"], float(
                (bk.float() - bp.float()).abs().max()))
            print(f"K3 {tname:8s} {lname:11s}: blocked {int(bk.sum())} of "
                  f"{int(hit.valid.sum())} hits, mask identical to plain and "
                  "to K2")

    # ---- phase 7: per-light frames (the K3 path) ----------------------------
    world3 = rtt.generate(WORLD_LIGHTS3)
    scene3 = rtt.to_device(world3.scene, dev)
    cam3 = rtt.to_device(scale_camera(world3.camera, main[0],
                                      world3.config.width), dev)
    cfg3 = world3.config.replace(engine="cuda", width=main[0],
                                 height=main[1])
    cfg_pl = cfgs[main].replace(fused_shadows=False)
    ce.bvh_occlude.launches = 0
    img_pl = render_frame(scene, cams[main], cfg_pl)
    img3 = render_frame(scene3, cam3, cfg3)
    torch.cuda.synchronize()
    launches["bvh_occlude"] = ce.bvh_occlude.launches
    print(f"per-light path launches: bvh_occlude {launches['bvh_occlude']}")
    if launches["bvh_occlude"] < 1:
        raise AssertionError("bvh_occlude was not launched by the per-light "
                             "path")
    if not torch.equal(img_pl, frames[main]):
        raise AssertionError("terrain8 per-light frame differs from the fused "
                             "frame on "
                             f"{int((img_pl != frames[main]).sum())} values")
    ref3 = render_frame(scene3, cam3, cfg3.replace(engine="torch"))
    diff3 = float((img3 - ref3).abs().max())
    if diff3 > ATOL_FRAME or not bool(torch.isfinite(img3).all()):
        raise AssertionError(f"terrain8_lights3: cuda vs torch engine max abs "
                             f"diff {diff3} > {ATOL_FRAME} (or non-finite)")
    d_fused = float((img3 - frames[main]).abs().max())
    if d_fused < 1e-3:
        raise AssertionError("terrain8_lights3 frame equals terrain8's: the "
                             "second point light did not shade")
    print(f"per-light frames {main_key}: terrain8 fused_shadows=False == fused "
          f"frame (bit for bit); terrain8_lights3 cuda == torch engine (max "
          f"abs diff {diff3:.3g})")
    report["frames"]["per_light"] = {"terrain8_equal_fused": True,
                                     "lights3_max_abs_diff": diff3}

    # ---- phase 8: the training step -----------------------------------------
    big = SIZES[-1]
    big_key = f"{big[0]}x{big[1]}"
    target0 = torch.zeros(big[1], big[0], 4, device=dev)

    def loss_and_grads(engine, params):
        loss = make_loss_fn(scene, cams[big], cfgs[big].replace(
            engine=engine), target0)(params)
        return loss.detach(), grad_of(loss, params)

    params_c = trainable_params(scene, cams[big])
    ce.bvh_cast.launches = 0
    ce.bvh_occlude2.launches = 0
    loss_c, g_c = loss_and_grads("cuda", params_c)
    torch.cuda.synchronize()
    step_launches = {"bvh_cast": ce.bvh_cast.launches,
                     "bvh_occlude2": ce.bvh_occlude2.launches}
    print(f"train step {big_key} launches: {step_launches}")
    for name, n in step_launches.items():
        if n < 1:
            raise AssertionError(f"{name} was not launched by the train step")
    leaves_c = tree.leaves_with_paths(g_c)
    if not math.isfinite(float(loss_c)):
        raise AssertionError(f"train step loss {float(loss_c)}")
    for key, g in leaves_c:
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"train step grad {key} not finite")
    for key in ("cam_pos", "cam_rot"):
        if float(g_c[key].abs().max()) == 0.0:
            raise AssertionError(f"train step grad {key} is zero")
    loss_t, g_t = loss_and_grads("torch",
                                 trainable_params(scene, cams[big]))
    grad_err = {"max_abs": 0.0, "max_rel": 0.0}
    for (key, a), b in zip(leaves_c, tree.leaves(g_t)):
        torch.testing.assert_close(
            a, b, rtol=RTOL_GRAD, atol=ATOL_GRAD,
            msg=lambda m, key=key: f"grad {key} cuda vs torch engine: {m}")
        d = (a - b).abs()
        grad_err["max_abs"] = max(grad_err["max_abs"], float(d.max()))
        grad_err["max_rel"] = max(grad_err["max_rel"], float(
            (d / b.abs().clamp(min=ATOL_GRAD)).max()))
    print(f"train step {big_key}: loss {float(loss_c):.6f} (torch engine "
          f"{float(loss_t):.6f}); grads finite, camera grads non-zero, cuda "
          f"== torch engine (max abs {grad_err['max_abs']:.3g}, max rel "
          f"{grad_err['max_rel']:.3g}; bound rtol {RTOL_GRAD} atol "
          f"{ATOL_GRAD})")

    mats = scene.materials
    bright = dataclasses.replace(mats, kd=mats.kd * 1.3)
    with torch.no_grad():
        target_b = render_frame(dataclasses.replace(scene, materials=bright),
                                cams[main], cfgs[main])
    params = trainable_params(scene, cams[main], include_camera=False)
    losses = []
    for _ in range(3):
        loss, _, params = train_step(scene, cams[main], cfgs[main],
                                     target_b, params, lr=LR)
        losses.append(float(loss))
    with torch.no_grad():
        losses.append(float(make_loss_fn(scene, cams[main], cfgs[main],
                                         target_b)(params)))
    print(f"train {main_key} toward kd*1.3: losses {losses}")
    if not all(b < a for a, b in zip(losses, losses[1:])):
        raise AssertionError(f"3 SGD steps did not lower the loss: {losses}")
    report["train"] = {"loss_1080p": float(loss_c), "grad_err": grad_err,
                       "step_launches": step_launches,
                       f"losses_{main_key}": losses}

    # ---- timings of the new phases ------------------------------------------
    def fwd_bwd(engine):
        params_s = trainable_params(scene, cams[big])
        return lambda: loss_and_grads(engine, params_s)

    step_ms = _ms(fwd_bwd("cuda"))
    step_ms_torch = _ms(fwd_bwd("torch"), reps=1, warmup=False)
    k3_in = (o1, d1, dist)
    timing[main_key].update({
        "k3_ms": _ms(lambda: ce.bvh_occlude(*k3_in, data)),
        "k3_plain_ms": _ms(lambda: ce.bvh_occlude_reference(*k3_in, data),
                           reps=PLAIN_REPS),
    })
    timing[big_key].update({
        "fwd_bwd_ms_cuda": step_ms, "fwd_bwd_ms_torch": step_ms_torch,
        "fwd_bwd_mrays_per_s_cuda": big[0] * big[1] / step_ms / 1e3,
    })
    t = timing[main_key]
    print(f"time {main_key} [{smi}]: K3 {t['k3_ms']:.4f} ms / plain "
          f"{t['k3_plain_ms']:.3f} ms (median of {REPS} / {PLAIN_REPS})")
    t = timing[big_key]
    print(f"time {big_key} [{smi}]: fwd+bwd step cuda {step_ms:.3f} ms "
          f"({t['fwd_bwd_mrays_per_s_cuda']:.2f} Mrays/s, median of {REPS}) "
          f"/ torch engine {step_ms_torch:.3f} ms (once)")
    report["profile"] = _profile(fwd_bwd("cuda"), smi)

    # ---- bounds of K1-K3 at the main path's shapes (terrain8, 640x480) ------
    tab8 = _nbytes(data.tables.inst_f32, data.tables.inst_i32,
                   data.tables.tmpl, data.nodes, data.ordering)
    work = {"bvh_cast": _work(ce.bvh_cast_reference, ro, rd, data),
            "bvh_occlude2": _work(ce.bvh_occlude2_reference, *occ_inputs,
                                  data),
            "bvh_occlude": _work(ce.bvh_occlude_reference, o1, d1, dist,
                                 data)}
    h1 = ce.bvh_cast(ro, rd, data)
    b2 = ce.bvh_occlude2(*occ_inputs, data)
    b3 = ce.bvh_occlude(o1, d1, dist, data)
    bounds = {
        "bvh_cast": _bound(_nbytes(ro, rd, h1.t, h1.wtri, h1.uv, h1.normal,
                                   h1.mat) + tab8,
                           _work_ops(work["bvh_cast"], closest_hit=True)),
        "bvh_occlude2": _bound(_nbytes(*occ_inputs, *b2) + tab8, _work_ops(
            work["bvh_occlude2"], closest_hit=False)),
        "bvh_occlude": _bound(_nbytes(o1, d1, dist, b3) + tab8, _work_ops(
            work["bvh_occlude"], closest_hit=False)),
    }
    for name, b in bounds.items():
        print(f"bound {name}: {b['bound_ms']:.5f} ms ({b['bound_by']}: "
              f"{b['bytes']} bytes, {b['ops']} FP32 ops)")

    # ---- phases 9-13: terrain6 on the cull and the MXU cast -----------------
    t6 = _terrain6(dev, smi, (o_rand, d_rand), frames[main], cfgs[main],
                   cams[main], scene)
    bounds.update(t6["bounds"])
    errs.update(t6["errs"])
    launches.update(t6["launches"])
    timing[main_key].update({k: t6["timing"][k] for k in (
        "k4_ms", "k4_plain_ms", "k5_ms", "k5_plain_ms", "k6_ms",
        "k6_plain_ms")})
    for s in SIZES:
        key = f"{s[0]}x{s[1]}"
        timing[key].update({f"{k}_device_ms": v for k, v in
                            t6["timing"][f"device_ms_{key}"].items()})
    report["terrain6"] = t6
    report["bounds"] = bounds
    report["timing"] = timing
    report["launches"] = launches

    tpu = "raytracer_tpu/render/"
    rows = [  # name, source, replaces, timing key
        ("bvh_cast", SOURCE, tpu + "pallas_engine.py:916", "k1"),
        ("bvh_occlude2", SOURCE, tpu + "pallas_engine.py:1033", "k2"),
        ("bvh_occlude", SOURCE, tpu + "pallas_engine.py:983", "k3"),
        ("cull_cast", SOURCE_CULL, tpu + "pallas_engine.py:869", "k4"),
        ("cull_occlude", SOURCE_CULL, tpu + "pallas_engine.py:1102", "k5"),
        ("mxu_cast", SOURCE_MXU, tpu + "pallas_mxu.py:119", "k6"),
    ]
    # no single PyTorch call computes a closest hit or an any-hit query
    kernels_line = {"kernels": [
        {"name": name, "route": "cuda", "source": source,
         "replaces": replaces, "launches": launches[name],
         "max_abs_err": errs[name], "ms": timing[main_key][f"{key}_ms"],
         "plain_ms": timing[main_key][f"{key}_plain_ms"],
         "bound_ms": bounds[name]["bound_ms"],
         "bound_by": bounds[name]["bound_by"], "library_ms": None,
         "device_ms": timing[main_key][f"{key}_device_ms"]}
        for name, source, replaces, key in rows]}
    report["kernels"] = kernels_line["kernels"]
    report["seconds"] = time.perf_counter() - t_start
    print(f"chip_smoke: {report['seconds']:.1f} s")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(report, fh, indent=1)
    print(json.dumps(kernels_line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
