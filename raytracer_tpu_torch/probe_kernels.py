#!/usr/bin/env python3
"""Where K6 (the MXU cast) and K5 (the candidate-list any-hit) spend a launch.

    python3 raytracer_tpu_torch/probe_kernels.py [--root DIR ...]
                                                 [--frames-only] [--out F]

On one GPU, on terrain6, at 640x480 and 1920x1080, for each ``--root`` (a
checkout that holds ``raytracer_tpu_torch``; default: this one; name two to
compare two trees in turns on one card):

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
  ``--frames-only`` times nothing else, for many turns of two trees.

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
import statistics
import subprocess
import sys
import tempfile

import torch

SIZES = [(640, 480), (1920, 1080)]
REPS = 10


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


def device_ms(fn, reps=10):
    """Device ms per call of ``fn``, and the same by kernel name: every
    kernel and memset it launches, from a profiler trace of ``reps`` calls.
    A trace can come back without the events of some calls, so each
    kernel's mean duration is taken over the events that did arrive and
    weighted by how often a call launches it (its count over the count of
    the call's least frequent ``rt::`` kernel); an empty trace is taken
    again."""
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
        ours = [c[0] for k, c in seen.items() if k.startswith("rt::")]
        if seen:
            calls = min(ours) if ours else reps  # plain torch: no kernel of ours
            by_name = {k[:80]: c[1] / c[0] * max(1, round(c[0] / calls))
                       for k, c in seen.items()}
            return sum(by_name.values()), by_name
    raise RuntimeError("the profiler trace shows no kernel")


def _times(fn):
    dev, by_name = device_ms(fn)
    return {"event_ms": _event_ms(fn), "device_ms": dev, "kernels": by_name}


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


def probe(root, dev, smi, frames_only=False):
    rtt = _load(root)
    mod = importlib.import_module
    ce = mod("raytracer_tpu_torch.render.cuda_engine")
    cull = mod("raytracer_tpu_torch.render.cull")
    mxu = mod("raytracer_tpu_torch.render.mxu")
    engine = mod("raytracer_tpu_torch.render.engine")
    scale_camera = mod("raytracer_tpu_torch.builder").scale_camera
    expand_geometry = mod("raytracer_tpu_torch.render.geometry").expand_geometry
    shadow_rays = mod("raytracer_tpu_torch.render.shading").shadow_rays
    mod("raytracer_tpu_torch.render.kernels").library()

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
    ap.add_argument("--out", default=None, help="write the numbers as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_kernels: needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True).stdout.strip()
    results = [probe(os.path.abspath(r), dev, smi, args.frames_only)
               for r in (args.root or [here])]
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(results, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
