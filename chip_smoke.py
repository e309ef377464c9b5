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
   device busy time, idle share and the kernels that take the most time.

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
SOURCE = "raytracer_tpu_torch/csrc/bvh_kernels.cu"
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


def _profile(step, smi, steps=3):
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
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    busy_ms = sum(e["dur"] for e in kernels) / 1e3 / steps
    by_name = {}
    for e in kernels:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    out = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "idle_share": 1.0 - busy_ms / wall_ms,
           "kernels_per_step": len(kernels) / steps,
           "top_ms_per_step": [[k[:100], v / steps] for k, v in top]}
    print(f"profile fwd+bwd [{smi}]: wall {wall_ms:.3f} ms/step, device busy "
          f"{busy_ms:.3f} ms, idle share {out['idle_share']:.3f}, "
          f"{out['kernels_per_step']:.0f} kernels/step")
    for k, v in out["top_ms_per_step"]:
        print(f"  {v:9.3f} ms  {k}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write every number to this JSON file")
    args = ap.parse_args(argv)

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
        })
        t = timing[key]
        print(f"time {key} [{smi}]: frame cuda {t['frame_ms_cuda']:.3f} ms "
              f"/ torch {t['frame_ms_torch']:.3f} ms; K1 {t['k1_ms']:.4f} ms "
              f"/ plain {t['k1_plain_ms']:.3f} ms; K2 {t['k2_ms']:.4f} ms "
              f"/ plain {t['k2_plain_ms']:.3f} ms (median of {REPS})")
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

    # ---- phase 7: per-light frames (the K3 path) -----------------------------
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

    # ---- phase 8: the training step ------------------------------------------
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

    # ---- timings of the new phases -------------------------------------------
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

    report["timing"] = timing
    report["launches"] = launches

    kernels_line = {"kernels": [
        {"name": "bvh_cast", "route": "cuda", "source": SOURCE,
         "replaces": "raytracer_tpu/render/pallas_engine.py:916",
         "launches": launches["bvh_cast"],
         "max_abs_err": errs["bvh_cast"],
         "ms": timing[main_key]["k1_ms"],
         "plain_ms": timing[main_key]["k1_plain_ms"]},
        {"name": "bvh_occlude2", "route": "cuda", "source": SOURCE,
         "replaces": "raytracer_tpu/render/pallas_engine.py:1033",
         "launches": launches["bvh_occlude2"],
         "max_abs_err": errs["bvh_occlude2"],
         "ms": timing[main_key]["k2_ms"],
         "plain_ms": timing[main_key]["k2_plain_ms"]},
        {"name": "bvh_occlude", "route": "cuda", "source": SOURCE,
         "replaces": "raytracer_tpu/render/pallas_engine.py:983",
         "launches": launches["bvh_occlude"],
         "max_abs_err": errs["bvh_occlude"],
         "ms": timing[main_key]["k3_ms"],
         "plain_ms": timing[main_key]["k3_plain_ms"]},
    ]}
    report["kernels"] = kernels_line["kernels"]
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
