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
   per-launch ms of each kernel against its plain version.

The line before the last is a JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
WORLD = os.path.join(ROOT, "raytracer_tpu_torch", "worlds", "terrain8.json")
SOURCE = "raytracer_tpu_torch/csrc/bvh_kernels.cu"
SIZES = [(640, 480), (1920, 1080)]
N_RANDOM = 65536
REPS = 10
ATOL_N = 1e-5  # normals, atol
RTOL_T = 1e-5  # hit times, rtol
ATOL_FRAME = 1e-5


def _ms(fn, reps=REPS):
    """Median device ms of ``fn`` over ``reps`` calls after one warm-up,
    timed with CUDA events."""
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
