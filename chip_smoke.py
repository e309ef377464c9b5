#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (raytracer_tpu_torch) on one GPU.

    python3 chip_smoke.py [--out results.json]

Phases, each failing loudly (nonzero exit) on any mismatch:

1. require CUDA; print the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from csrc/ with nvcc (sm_90a) and print the time;
3. K1 (LBVH closest hit) against its plain PyTorch version on the card,
   every output identical: terrain8's 640x480 primary rays, 65,536 seeded
   incoherent rays and degenerate rays made from them, with box tables and
   with template tables (build_tables(exact_uv=True)), and the 1920x1080
   primary rays;
4. K2 (fused two-light shadow query) against its plain version, every
   mask identical, both table kinds: the 640x480 and 1920x1080 frames'
   shadow queries (the point light at finite max_t, the directional light
   at +inf), the random rays at seeded random finite max_t and (reversed)
   at +inf, and the degenerate rays at both;
5. render_frame with engine="cuda" at 640x480 and 1920x1080 with the launch
   counters reset just before, compared with engine="torch" on the card;
   then timings with CUDA events: median frame ms of the cuda engine (the
   torch engine's once: its call of the comparison), and per-launch ms of
   each kernel against its plain version (once: its call in phases 3-4);
6. K3 (single shadow query) against its plain version on each query of
   phase 4's inputs, both table kinds (the plain masks are phase 4's:
   bvh_occlude2_reference is bvh_occlude_reference of each of its queries,
   which is checked here on the 640x480 frame's queries); its masks must
   also equal each query of K2;
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
   the tile lists) against its plain version on the 640x480 primary rays,
   the 65,536 random rays and the degenerate rays, box and template tables,
   and on the 1920x1080 primary rays, and K5 (any hit) on that frame's
   point-light and directional shadow queries, both table kinds -- every
   output identical -- with the share of tiles whose lists overflow;
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
   [T, K, 40] copy of the columns (mxu.gather_columns is counted);
14. the geometry-gradient path (edge_aware_grads; tables with the box fast
   path and box_exact_uv): K1's exact_uv instantiation against its plain
   version on terrain8's 640x480 and 1920x1080 primary rays and the
   degenerate rays, every output identical;
15. K1's visits instantiation: its per-ray count equal to its plain version
   (the replay of its walk, cuda_engine.k1_walk_replay) on the 640x480
   primary and the random rays, and equal to the per-thread walk's count
   (_WalkVisits) plus two for each stale kept vote, with no more steps than
   that count; and the
   O(log N) envelope on grids of 256 and 16,384 touching cubes (counters
   reset just before);
16. K4's exact_uv instantiation against its plain version on terrain6's
   640x480 and 1920x1080 primary rays and the degenerate rays;
17. the cull on a 96x96 grid (9,216 instances, lists staged in pieces):
   K4, and K5 along the same rays, against their plain versions on two
   overflowed tiles and one other, and the forced cull's 640x480 frame
   (launch counters reset just before) against the LBVH walk's;
18. the three 1920x1080 geometry-gradient steps (materials, lights, camera
   and vertices; terrain8 on the walk, terrain6 on the cull and on the MXU
   cast), each with the launch counters reset just before: grads equal to
   the "torch" engine's at rtol 1e-4 / atol 1e-6 (verts: 1e-6 max|g|),
   step ms and Mrays/s (median of 3), and the backward's top device
   kernels (torch.profiler); then the new instantiations' timings and
   bounds (the exact_uv branch's work counted by the plain versions: the
   box updates it runs on, ``work`` column ``exact``).

19. terrain8_stress (570 instances: terrain8 plus a reflective cube type,
   5x unit_length, depth 2: the pixel-aligned stream on the LBVH walk, K2
   in every round) at 640x480 and 1920x1080 with every launch counter reset
   just before: K1 and K2 launched, no other kernel; nothing dropped; the
   live rays per round; at 640x480 the frame against the "torch" engine
   (atol 1e-5), K1 on each later round's rays and K2 on each round's
   shadow queries identical to their plain versions, and the per-light
   frame (fused_shadows=False, K3) equal to the fused one bit for bit;
   frame ms (median of 5), device busy, idle share and kernels per frame
   at both sizes (torch.profiler, 3 frames); at both sizes each round's
   queue shaded through the shading kernels (``shade_rays`` and
   ``shade_phong``, their counters reset just before: one launch each)
   and through ``process_round``'s torch ops on the same cast: the
   contributions and the children's attenuation within 4 float32 steps
   (``powf``'s last place), the children's rays, flags and pixels equal;
   round 0's two launches timed (median of 5, and device ms) beside their
   byte bounds, the round through the torch ops once, and the kernels'
   launches in the counted frame;
20. terrain8_mixed (760 instances: a reflective and a refractive type:
   the compacted 2x stream and the transmissive shadow march through K1)
   the same way: K1 alone launched; at 640x480 K1 identical to its plain
   version on each later round's rays (the refracted rays that start
   inside a glass box and take its exit face counted) and on the first
   two steps of the point light's march; the shading kernels checked and
   timed as in phase 19, around each light's fused march;
21. the 1080p fwd+bwd step on both (materials with kr, kt and eta,
   lights, camera; zero target), counters reset just before: grads equal
   to the "torch" engine's at rtol 1e-4 / atol 1e-6, step ms (median of 3)
   and Mrays/s;
22. the synthetic worlds (raytracer_tpu_torch/synth.py) at 128x96: the
   mixed world on the cull (K4 alone: rounds and march), its frame against
   the "torch" engine, K4 identical to its plain version on each later
   round's rays, a drop count above 0 at queue_factor=0.02 and the frame at
   auto_tile_caps' caps equal to the dense frame; the sphere world on the
   cull (K4/K5) and on the MXU cast (K6), each against the "torch" engine;
   the 4,096-instance big world on the walk (K1, K3) and forced onto the
   cull (K4/K5), the two frames equal;
23. spp > 1 at 128x96, spp 4, with every launch counter reset just before
   each frame: terrain8 (walk), terrain6 (cull), terrain6 (MXU cast) and
   the mixed synthetic world (both child streams) against the "torch"
   engine (atol 1e-5), nothing dropped, a starved static_tile_cap (1e-9)
   dropping the "torch" engine's count; auto_tile_caps' static_tile_cap
   where it keeps fewer tiles than the frame has (terrain8 and terrain6 at
   640x480, spp 2; the mixed world in a 192x16 strip): the "torch"
   engine's frame, the uncapped frame, nothing dropped; render_frame(spp=4)
   against the sum of render_frame_sum over 1-sample chunks (bit for bit
   on the aligned walk) and 2-sample chunks (another order of sums: 1e-6);
   make_spp_grad_fn (spp_chunk None, 1, 2; with vertices and edge-aware
   grads None, 2) against the "torch" engine's at rtol 1e-4 / atol 1e-6
   (verts: 1e-6 max|g|);
24. the kernels on this path's rays: K1 and K2 identical to their plain
   versions on a jittered sample of terrain8_stress at 640x480, rounds 0
   and 1; K4 and K5 on a jittered sample's kept tiles of terrain6;
25. the backward's recompute: between the end of the forward and the end
   of backward() the K2, K3 and K5 counters do not move and K1's (K4's)
   moves by the forward's count less the kept-tile probe's (terrain8
   fused and per light, terrain6, terrain8_stress on its kept tiles);
26. the JAX package's heavy-spp shapes on the port's worlds, with
   auto_tile_caps' static_tile_cap, early_exit off and a zero target:
   terrain8 1024x1024 spp 16 (a frame), terrain8_stress 1920x1080 spp 128
   (fwd+bwd of materials, lights and camera, spp_chunk None) and the same
   with vertices and edge-aware grads: one warm step, then 1 timed (CUDA
   events), Mrays/s = W*H*spp / ms / 1e3, dropped (must be 0), peak
   memory over what was allocated before the step (within 1.25x of the
   same step's at spp 8), and the idle share and top kernels of one
   profiled step at spp 8;
27-30. the distribution layer (raytracer_tpu_torch/dist.py), its ranks
   launched by dist.launch as processes that share the one card over gloo
   (NCCL takes one rank a card; a one-rank NCCL group runs its all_reduce
   and all_gather on the card first).  Each rank sets every launch counter
   to 0 just before each path and reads it just after; the parent holds
   what the ranks return against its own single-process results:
27. row sharding on 2 ranks: terrain8 1920x1080, contiguous and cyclic
   bands (bit for bit the single-process frame) and spp 4 (1e-5); K1 and
   K2 identical to their plain versions on rank 1's rows;
28. geometry sharding: on a 1x2 mesh at 1920x1080, terrain8 (191-instance
   shards: K4/K5) and terrain8_stress (286-instance shards behind the
   parked pad instance: K1/K3, no K2: the merged cast has no occlude2),
   on a 2x2 mesh terrain8 at 640x480 (4 ranks), each frame within 1e-5 of
   the single-process frame; the ring cast's hits at 640x480 equal to the
   full cast's; K4/K5 and K1/K3 identical to their plain versions on
   shard 0's rays;
29. the geometry-sharded step (vertices, edge-aware grads) on 1x2 at
   640x480: loss and grads equal to the single-process step at rtol 1e-4
   / atol 1e-6 (verts 1e-6 max|g|); K4's exact_uv instantiation identical
   to its plain version on shard 0's rays;
30. dryrun_multichip(2) at 1920x1080 (spp 2, checkpointed samples,
   vertices and camera): its loss and grads equal to the single-process
   step at phase 29's tolerances; K1 exact_uv and K2 identical to their
   plain versions on rank 1's rows of sample 0.
   Per phase: seconds, per-rank ms (CUDA events in each rank) and the
   single process's ms from the same call.
31-34. the ops surface:
31. texture mapping: terrain8 (the walk) and terrain6 (the cull, and the
   MXU cast) with their top cube type textured from a 256x256 checker
   atlas (``textured_scene``, the fixture of tests/test_torch_texture.py),
   at 640x480 and 1920x1080, counters reset just before each frame: the
   frame equal to the "torch" engine's (atol 1e-5) and unlike the
   untextured one, the textured type off the box fast path, K1/K2, K4/K5
   and K6 identical to their plain versions on the frame's primary rays
   and its shadow queries (K6: the shadow rays' closest hits; the plain
   answers are the "torch" frame's own where their inputs are equal,
   ``_KeptCast``, as in phases 35-36); the 1080p
   fwd+bwd step of textured terrain8 against the "torch" engine (rtol
   1e-4 / atol 1e-6); frame ms (median of 5) beside the untextured
   frame's, and K1's ms per launch and device ms on the template path
   beside the box path's (and both bounds at 640x480);
32. the debug probe (raytracer_tpu_torch/debug.py) on the 1080p
   terrain8_mixed frame: at six bounce pixels and two plain ones
   (tests/test_mixed_wavefront.py's pick), debug_cast's colour equal to the
   frame pixel at rtol/atol 1e-4, K1 alone launched; the 1-ray cast of each
   pixel's primary ray equal to the same ray's hit inside the frame batch;
   one terrain8 pixel (the fused round: K1 and K2 on one ray);
33. cli.main in this process: 2 training steps of terrain8 at 1920x1080
   with --profile-dir (the trace names bvh_cast_kernel and
   bvh_occlude2_kernel; device busy ms and idle share read from it), and
   one -b --wavefront-cap 0.5 -r bench of terrain8_stress at 640x480;
34. elastic training: cli.main --elastic 1 --train-until 3 on terrain8 at
   640x480 with RT_FAULT_AT_STEP=2 (the worker, a process of its own,
   exits 13 after step 2 and is restarted from its checkpoint): exit 0,
   ``crash rc=13`` logged, the final checkpoint equal to an uninterrupted
   run's at rtol 1e-4 / atol 1e-6; the phase's seconds.
35-37. the fly-through, the interactive loop, the viewer, the native library:
35. ``python -m raytracer_tpu_torch.cli --orbit 30`` on terrain8 at
   1920x1080, a process of its own: 30 PNGs, its FPS lines, its last frame
   equal to this process's render of the same camera; camera_motion's
   orbit on the card: frames 0 and 29 at 640x480 against the "torch"
   engine (atol 1e-5), K1 and K2 identical to their plain versions on frame
   29's primary rays and shadow queries; cli.main --orbit 30 at 640x480
   with the counters reset just before (one K1 and one K2 a frame), and
   --orbit 10 on terrain8_lights3 (K1, K3; its last frame against the
   "torch" engine, K3 against its plain version); FPS at both sizes, and
   per frame the render (CUDA events), the u8 copy to the host and
   write_png (host clock);
36. cli.main --interactive on terrain6 at 640x480 (K4, K5), stdin ``w``,
   ``a``, ``mouse 5 -3``, ``click 320 240`` (sky), ``click 320 360`` (a
   hit), ``bogus``, ``quit``, counters
   reset just before: the written frame equal to the "torch" engine's
   render of the camera moved by camera_motion, each probe's colour equal
   to that frame's pixel at 1e-4, ``? bogus`` and ``Exiting...`` printed,
   K4/K5 identical to their plain versions on the moved camera's rays, the
   ms a command; the second probe alone, counted;
37. ``python -m raytracer_tpu_torch.live_viewer ... --selftest`` on
   terrain8 at 640x480 (``selftest OK``, its FPS and render ms a frame);
   the native library built on this machine (native.available()), and
   read_png of a 1024x1024 RGBA PNG of every filter type equal with and
   without it, both times (after the viewer's process has ended).

Beside each kernel's ms per launch (CUDA events around the wrapper: the
ctypes call and the output allocation included) the device time alone is
printed, from a torch.profiler trace (every kernel and memset the wrapper
launches), at 640x480 and at 1920x1080; for K6 also, from the blocks' own
clock stamps, the share of the launch that is left when the median block of
its working launch has ended.

Each kernel's bound is the least time the card could take for its work at
the main path's shapes (and, printed beside it, at 1920x1080): the larger
of the bytes it must move (inputs read once, outputs written once) over
3.35 TB/s and its FP32 operations over 67 TFLOP/s (the H100 SXM's
published peaks at 700 W).  The shading kernels' bound is bytes alone
(their ~200 FP32 operations a lane and light are an order below): every
input of a lane read once and every output written once, beyond its flag
only where the lane is shaded (a medium's ``Kt`` only where it is
inside one).  For the walks and the lists (K1-K5) the
operations are what this run's rays reach, counted by the
plain versions (``work=``: the nodes, boxes and triangles each ray's kernel
walk tests); for K6, the live columns of each tile (its listed columns with
a triangle, or every triangle on a dense tile) at the operations a column
needs, and as bytes its rays, ids, info and outputs and the column table
once (no staged copy of the columns: no implementation needs one).

The line before the last is a JSON object describing each kernel (K1's
exact_uv and visits instantiations and K4's exact_uv one as rows of their
own; ``spp_launches``: its launches in each phase-26 cell;
``dist_launches``: its launches over the ranks in each phase 27-30 path;
``texture_launches``: in each phase-31 frame and step; ``ops_launches``:
in each phase-32 probe, phase-33 CLI run, phase-35 orbit and phase-36
interactive run and probe; the shading kernels' rows count their
launches in phases 19-20 alone, so those four stay empty there);
the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
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
WORLD_STRESS = os.path.join(WORLDS, "terrain8_stress.json")
WORLD_MIXED = os.path.join(WORLDS, "terrain8_mixed.json")
SOURCE = "raytracer_tpu_torch/csrc/bvh_kernels.cu"
SOURCE_CULL = "raytracer_tpu_torch/csrc/cull_kernels.cu"
SOURCE_MXU = "raytracer_tpu_torch/csrc/mxu_kernel.cu"
SOURCE_SHADE = "raytracer_tpu_torch/csrc/shade_kernels.cu"
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
# hit-time tests (17); and the exact_uv branch on a box hit that took the
# update: the local hit point (9), two signed barycentric evaluations with
# their containment tests (2 x 45), the choice (3).
OPS = {"slab": 25, "box": 7, "inst": 129, "tri": 89, "write": 11,
       "mxu_col": 62, "exact": 102}
SIZES = [(640, 480), (1920, 1080)]
N_RANDOM = 65536
REPS = 5  # CUDA-event medians of frames and kernel launches
STEP_REPS = 3  # ... of fwd+bwd steps
# the plain versions' ms: one call, no warm-up (each has run in its phase's
# correctness check already): oracles, not contenders
PLAIN_REPS = 1
ATOL_FRAME = 1e-5
MARCH_ULPS = 2  # bvh_march against the loop: only powf may round otherwise
# the shading kernels against process_round's torch ops: only powf (the
# specular term, Kt^t inside a medium) may round otherwise, in its last place
SHADE_ULPS = 4
# cuda vs torch engine gradients: the hits are identical, so only the
# order of the atomic sums in the gather backward differs
RTOL_GRAD, ATOL_GRAD = 1e-4, 1e-6
LR = 0.05  # the CLI's --lr default
VERTS = "['verts']"  # the vertex leaf's path in a parameter tree
SPP_SMALL = (128, 96)  # the spp correctness phases
SPP_REF = 8  # the spp of the memory comparison and the profiled step
# the JAX package's heavy-spp shapes (bench.py _item_world8_1024_spp16,
# _item_world8_stress_1080p_spp128, _item_world8_stress_geomgrad) on the
# port's worlds of the same shapes: label, world, size, spp, kind
DIST_BIG, DIST_SMALL = (1920, 1080), (640, 480)  # phases 27-30
DIST_SPP = 4
DIST_TIMEOUT = 480.0  # seconds a launch of ranks may take
SPP_CELLS = [
    ("terrain8 1024x1024 spp 16 frame", WORLD, (1024, 1024), 16, "frame"),
    ("terrain8_stress 1920x1080 spp 128 fwd+bwd", WORLD_STRESS,
     (1920, 1080), 128, "step"),
    ("terrain8_stress 1920x1080 spp 128 geometry fwd+bwd", WORLD_STRESS,
     (1920, 1080), 128, "geomgrad"),
]


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


def _timed(fn):
    """``(fn(), ms)``: one call timed with CUDA events.  A plain version's
    or the "torch" engine's time is taken on the call its correctness check
    makes anyway."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


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
    ``rt::`` kernel, template instantiations included); an empty trace is
    taken again."""
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
        ours = [c[0] for k, c in by_name.items() if "rt::" in k]
        if ours:
            calls = min(ours)
            return sum(c[1] / c[0] * max(1, round(c[0] / calls))
                       for c in by_name.values())
    raise AssertionError("the profiler trace shows no kernel of the port")


def _compare_hits(label, hk, hp):
    """K1's and K4's contract: every output (valid, t, triangle, uv,
    normal, material) identical to the plain version's.  Returns the
    largest abs difference, 0."""
    for name in ("valid", "t", "wtri", "uv", "normal", "mat"):
        a, b = getattr(hk, name), getattr(hp, name)
        if a is None and b is None:  # the MXU cast gives no normal or mat
            continue
        if not torch.equal(a, b):
            raise AssertionError(f"{label}: {name} differs on "
                                 f"{int((a != b).sum())} values")
    return 0.0


def _degenerate(o, d, boxes):
    """Rays ``o, d`` made hard for the slab arithmetic, from seeded
    patterns: origins inside an instance box or on its corner (a plane of
    the box and of the tree nodes above it), exact zero direction
    components (axis-parallel: containment decides), components so small
    that 1 / d overflows (0 * inf where an origin lies on a plane)."""
    idx = torch.arange(o.shape[0], device=o.device)
    box = boxes[idx % boxes.shape[0]]
    centre = 0.5 * (box[:, :3] + box[:, 3:6])
    o = torch.where((idx % 5 == 0)[:, None], centre, o)
    o = torch.where((idx % 7 == 0)[:, None], box[:, :3], o)
    d = d.clone()
    d[idx % 3 == 0, 0] = 0.0
    d[idx % 4 == 0, 2] = 0.0
    d[idx % 11 == 0, 1] = 1e-42
    d[idx % 13 == 0, 0] = -1e-42
    d[(d == 0.0).all(-1), 1] = -1.0
    return o.contiguous(), d


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


def _work(reference, *args, **kw):
    """Per-ray work counts (``cuda_engine.WORK_COLUMNS``) of a kernel on
    ``args``, from its plain version."""
    from raytracer_tpu_torch.render import cuda_engine as ce

    work = torch.zeros(args[0].shape[0], len(ce.WORK_COLUMNS),
                       dtype=torch.int64, device=args[0].device)
    reference(*args, work=work, **kw)
    return work


def _work_ops(work, closest_hit, exact_uv=False):
    """FP32 operations of a walk or list kernel from its per-ray work
    counts; ``exact_uv``: its box updates run the exact_uv branch."""
    slab, box, inst, tri, exact = work.sum(0).tolist()
    ops = (slab * OPS["slab"] + box * OPS["box"] + inst * OPS["inst"]
           + tri * OPS["tri"] + (exact * OPS["exact"] if exact_uv else 0))
    return ops + (work.shape[0] * OPS["write"] if closest_hit else 0)


def _profile(step, smi, steps=3, label="fwd+bwd", warmup=True):
    """Trace ``steps`` calls of ``step`` with torch.profiler (after one
    untraced call unless ``warmup`` is False: the caller has just run it);
    print the kernels per step, device busy time, idle share and the top
    kernels."""
    from torch.profiler import ProfilerActivity, profile

    if warmup:
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
    big = SIZES[-1]
    big_key = f"{big[0]}x{big[1]}"
    ro_b, rd_b, _, _ = _frame_rays_blocked(cams[big], cfgs[big])
    k4_rays = dict(k_rays, degenerate=_degenerate(
        *rays_random, data.tables.inst_f32[:, :6]))
    for tname, tab in tabs.items():
        todo = dict(k4_rays)
        if tname == "box":
            todo[f"primary {big_key}"] = (ro_b, rd_b)
        for rname, (o, d) in todo.items():
            c = cfgs[big] if rname.endswith(big_key) else cfgs[main]
            lay, o_p, d_p, cand, info, tile = lists(c, o, d)
            hk = cull.cull_cast(o_p, d_p, cand, info, tile, tab)
            hp = cull.cull_cast_reference(o_p, d_p, cand, info, tile, tab)
            torch.cuda.synchronize()
            out["errs"]["cull_cast"] = max(out["errs"]["cull_cast"],
                                           _compare_hits(
                                               f"K4 {tname}/{rname}", hk, hp))
            print(f"K4 {tname:8s} {rname:18s}: {int(hk.valid.sum())} hits "
                  f"over {info.shape[0]} tiles ({share(info):.3f} "
                  "overflow), every output identical to plain")
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
            ref, out["timing"][f"frame_ms_torch_{pname}_{s[0]}x{s[1]}"] = \
                _timed(lambda: render_frame(scene, cams[s], pcfg.replace(
                    width=s[0], height=s[1], engine="torch")))
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
            print(f"time terrain6 {key} [{smi}]: frame cuda "
                  f"{timing[f'frame_ms_cuda_{key}']:.3f} ms / torch "
                  f"{timing[f'frame_ms_torch_{key}']:.3f} ms")
    timing[f"step_ms_cuda_cull_{big_key}"] = _ms(
        lambda: loss_and_grads("cuda"), reps=STEP_REPS)
    print(f"time terrain6 cull fwd+bwd {big_key} [{smi}]: "
          f"{timing[f'step_ms_cuda_cull_{big_key}']:.3f} ms (median of "
          f"{STEP_REPS})")

    lay, o_p, d_p, cand, info, tile = lists(cfgs[main], ro, rd)
    k4 = (o_p, d_p, cand, info, tile, data.tables)
    o, d, mt = shadow_q[main]["point"]
    lay5, o5, d5, cand5, info5, tile5 = lists(cfgs[main], o, d)
    k5 = (o5, d5, lay5.pad(mt, 0.0), cand5, info5, tile5, data.tables)
    k6 = m_args[f"primary {main_key}"]
    timing.update({
        "k4_ms": _ms(lambda: cull.cull_cast(*k4)),
        "k4_plain_ms": _ms(lambda: cull.cull_cast_reference(*k4),
                           reps=PLAIN_REPS, warmup=False),
        "k5_ms": _ms(lambda: cull.cull_occlude(*k5)),
        "k5_plain_ms": _ms(lambda: cull.cull_occlude_reference(*k5),
                           reps=PLAIN_REPS, warmup=False),
        "k6_ms": _ms(lambda: mxu.mxu_cast(*k6)),
        "k6_plain_ms": _ms(lambda: mxu.mxu_cast_reference(*k6_plain),
                           reps=PLAIN_REPS, warmup=False),
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

    # ---- bounds at both sizes (the kernels line takes the main path's) ------
    tab_bytes = _nbytes(data.tables.inst_f32, data.tables.inst_i32,
                        data.tables.tmpl)
    for key, (a4, a5, a6) in per_size.items():
        bounds = out["bounds"] if key == main_key else {}
        h4 = cull.cull_cast(*a4)
        bounds["cull_cast"] = _bound(
            _nbytes(*a4[:4], h4.t, h4.wtri, h4.uv, h4.normal, h4.mat)
            + tab_bytes,
            _work_ops(_work(cull.cull_cast_reference, *a4),
                      closest_hit=True))
        b5 = cull.cull_occlude(*a5)
        bounds["cull_occlude"] = _bound(
            _nbytes(*a5[:5], b5) + tab_bytes,
            _work_ops(_work(cull.cull_occlude_reference, *a5),
                      closest_hit=False))
        # K6: a listed tile's live columns hold a triangle (id >= 0); a
        # dense tile's are the n_tris triangles of the table, not its zero
        # padding
        info6, ids6 = a6[0], a6[3]
        over6 = info6[:, 1] > 0
        n_dense = int(over6.sum())
        live_staged = int((ids6[~over6] >= 0.0).sum())
        live_cols = live_staged + n_dense * mdata.n_tris
        out[f"k6_columns_{key}"] = {
            "live_staged": live_staged,
            "staged": (info6.shape[0] - n_dense) * mdata.k_cols,
            "dense_tiles": n_dense, "n_tris": mdata.n_tris}
        # bytes: info, the table once, ids, the ray rows; t, id, u, v out
        bounds["mxu_cast"] = _bound(
            _nbytes(*[x for x in a6 if isinstance(x, torch.Tensor)])
            + 4 * 4 * info6.shape[0] * mdata.tile,
            live_cols * mdata.tile * OPS["mxu_col"])
        for name, args in (("cull_cast", a4), ("cull_occlude", a5),
                           ("mxu_cast", a6)):
            bounds[name]["rays"] = args[0].shape[0] if name != "mxu_cast" \
                else args[4].shape[0]
        out[f"bounds_{key}"] = bounds
        print(f"K6 {key} columns: {out[f'k6_columns_{key}']}")
        for name, b in bounds.items():
            print(f"bound {name} {key}: {b['bound_ms']:.5f} ms "
                  f"({b['bound_by']}: {b['bytes']} bytes, {b['ops']} FP32 "
                  "ops)")

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


def _profile_backward(loss_fn, make_params, smi, label, steps=2):
    """torch.profiler over the backward alone (each forward runs outside the
    trace): device ms per backward and its top kernels."""
    from torch.profiler import ProfilerActivity, profile

    from raytracer_tpu_torch.diff import grad_of

    kernels = []
    for i in range(steps + 1):  # the first backward warms up
        params = make_params()
        loss = loss_fn(params)
        torch.cuda.synchronize()
        if i == 0:
            grad_of(loss, params)
            torch.cuda.synchronize()
            continue
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            grad_of(loss, params)
            torch.cuda.synchronize()
        kernels += [e for e in _trace_events(prof) if e.get("cat") == "kernel"]
    by_name = {}
    for e in kernels:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] / 1e3
    busy = sum(by_name.values()) / steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    out = {"device_busy_ms": busy, "kernels_per_backward":
           len(kernels) / steps,
           "top_ms": [[k[:100], v / steps] for k, v in top]}
    print(f"profile {label} backward [{smi}]: device busy {busy:.3f} ms, "
          f"{out['kernels_per_backward']:.0f} kernels")
    for k, v in out["top_ms"]:
        print(f"  {v:9.3f} ms  {k}")
    return out


def _geomgrad(dev, smi, rays_random):
    """Phases 14-18: the geometry-gradient path (``edge_aware_grads``,
    vertices trainable): K1's and K4's exact_uv instantiations, K1's visit
    counts, the cull on 9,216 instances, and the three 1080p steps.  Returns
    the numbers for the report and the kernels line."""
    import raytracer_tpu_torch as rtt
    from raytracer_tpu_torch import tree
    from raytracer_tpu_torch.builder import make_grid_world, scale_camera
    from raytracer_tpu_torch.diff import (grad_of, make_loss_fn,
                                          trainable_params)
    from raytracer_tpu_torch.render import cuda_engine as ce
    from raytracer_tpu_torch.render import cull
    from raytracer_tpu_torch.render.engine import (_frame_rays_blocked,
                                                   render_frame)
    from raytracer_tpu_torch.render.geometry import expand_geometry

    out = {"errs": {"bvh_cast_exact_uv": 0.0, "cull_cast_exact_uv": 0.0,
                    "bvh_visit_counts": 0.0},
           "launches": {}, "timing": {}, "bounds": {}, "steps": {}}
    main, big = SIZES[0], SIZES[-1]
    keys = [f"{s[0]}x{s[1]}" for s in SIZES]

    def world(path, **change):
        w = rtt.generate(path)
        scene = rtt.to_device(w.scene, dev)
        cfg = w.config.replace(engine="cuda", edge_aware_grads=True,
                               **change)
        cams = {s: rtt.to_device(scale_camera(w.camera, s[0],
                                              w.config.width), dev)
                for s in SIZES}
        data = (ce.prepare_cast(scene, expand_geometry(scene), cfg)
                if cfg.pallas_kernel == "scalar" else None)
        return dict(scene=scene, cfg=cfg, cams=cams, data=data)

    w8, w6 = world(WORLD), world(WORLD6)
    if int(w8["data"].tables.inst_i32[:, ce._II_IS_BOX].sum()) == 0:
        raise AssertionError("edge_aware_grads tables lost the box fast path")

    def frame_rays(w, s):
        return _frame_rays_blocked(w["cams"][s], w["cfg"].replace(
            width=s[0], height=s[1]))[:2]

    # ---- phase 14: K1's exact_uv instantiation ------------------------------
    data8 = w8["data"]
    k1_rays = {f"primary {k}": frame_rays(w8, s) for k, s in zip(keys, SIZES)}
    k1_rays["degenerate"] = _degenerate(*rays_random,
                                        data8.tables.inst_f32[:, :6])
    for rname, (o, d) in k1_rays.items():
        hk = ce.bvh_cast(o, d, data8, exact_uv=True)
        hp = ce.bvh_cast_reference(o, d, data8, exact_uv=True)
        torch.cuda.synchronize()
        _compare_hits(f"K1 exact_uv {rname}", hk, hp)
        moved = float((hk.uv[hk.valid] - 1.0 / 3.0).abs().amax(-1).gt(1e-6)
                      .float().mean())
        if moved < 0.5:
            raise AssertionError(f"K1 exact_uv {rname}: only {moved:.3f} of "
                                 "the hits left uv (1/3, 1/3)")
        print(f"K1 exact_uv {rname:18s}: {int(hk.valid.sum())} hits ({moved:.3f}"
              " with their true uv), every output identical to plain")

    # ---- phase 15: K1's visit counts ----------------------------------------
    vis = {}
    for rname, (o, d) in ((f"primary {keys[0]}", k1_rays[f"primary {keys[0]}"]),
                          (f"random {N_RANDOM}", rays_random)):
        v = ce.bvh_visit_counts(o, d, data8).long()
        plain = ce.bvh_visit_counts_reference(o, d, data8).long()
        _, replay, stale = ce.k1_walk_replay(o, d, data8)
        walk = _work(ce.bvh_cast_reference, o, d, data8)[:, 0]
        torch.cuda.synchronize()
        out["errs"]["bvh_visit_counts"] = max(
            out["errs"]["bvh_visit_counts"], float((v - plain).abs().max()))
        if not torch.equal(v, plain):
            raise AssertionError(f"K1 visits {rname}: differ from the plain "
                                 f"version on {int((v != plain).sum())} rays")
        if not torch.equal(replay, plain):
            raise AssertionError(f"K1 visits {rname}: the plain version is "
                                 "not the replay's count")
        if not torch.equal(v, walk + 2 * stale):
            raise AssertionError(f"K1 visits {rname}: not the per-thread "
                                 "walk's plus two a stale vote")
        if not bool(((v - 1) // 2 <= walk).all()):
            raise AssertionError(f"K1 visits {rname}: more steps than the "
                                 "per-thread walk's visits")
        vis[rname] = {"mean": float(v.float().mean()),
                      "walk_mean": float(walk.float().mean()),
                      "above_walk_share": float((v > walk).float().mean()),
                      "max": int(v.max())}
        print(f"K1 visits {rname:18s}: == plain (the replay); mean "
              f"{vis[rname]['mean']:.3f} (per-thread walk "
              f"{vis[rname]['walk_mean']:.3f}; "
              f"{vis[rname]['above_walk_share']:.4f} of rays above it by "
              "two a stale vote)")
    ce.bvh_visit_counts.launches = 0
    grid_means = {}
    for side in (16, 128):
        gs_np, _, gcfg = make_grid_world(side)
        gs = rtt.to_device(gs_np, dev)
        gdata = ce.prepare_cast(gs, expand_geometry(gs),
                                gcfg.replace(pallas_traversal="bvh"))
        xs = torch.linspace(0.5 * side - 6.0, 0.5 * side + 6.0, 32,
                            device=dev)
        gx, gz = torch.meshgrid(xs, xs, indexing="xy")
        o = torch.stack([gx.reshape(-1), torch.full_like(gx, 10.0).reshape(-1),
                         gz.reshape(-1)], -1).contiguous()
        d = torch.tensor([0.0, -1.0, 0.0], device=dev).expand_as(o)
        d = d.contiguous()
        if not bool(ce.bvh_cast(o, d, gdata).valid.all()):
            raise AssertionError(f"grid {side}: rays missed the grid")
        grid_means[side * side] = float(ce.bvh_visit_counts(o, d, gdata)
                                        .float().mean())
    out["launches"]["bvh_visit_counts"] = ce.bvh_visit_counts.launches
    if not grid_means[256] < grid_means[16384] < 4.0 * grid_means[256]:
        raise AssertionError(f"K1 visits: not O(log N): {grid_means}")
    print(f"K1 visits O(log N) [{smi}]: mean per ray {grid_means} "
          f"(ratio {grid_means[16384] / grid_means[256]:.3f} < 4), "
          f"launches {out['launches']['bvh_visit_counts']}")
    out["visits"] = dict(vis, grid_means=grid_means)

    # ---- phase 16: K4's exact_uv instantiation ------------------------------
    tab6 = w6["data"].tables

    def lists(cfg, o, d, tables):
        tile = cull.tile_rows_of(cfg) * cull.LANES
        lay = cull.CullLayout.of(o.shape[0], cfg.pallas_ray_chunk, tile)
        o_p, d_p = lay.pad_rays(o, d, 1.0e30)
        cand, info = cull.tile_candidates(o_p, d_p, tile, tables.inst_f32,
                                          cull.MAX_CAND)
        return o_p, d_p, cand, info, tile

    k4_args = {}
    k4_rays = {f"primary {k}": (s, frame_rays(w6, s))
               for k, s in zip(keys, SIZES)}
    k4_rays["degenerate"] = (main, _degenerate(*rays_random,
                                                tab6.inst_f32[:, :6]))
    for rname, (s, (o, d)) in k4_rays.items():
        args = lists(w6["cfg"].replace(width=s[0], height=s[1]), o, d, tab6)
        k4_args[rname] = args + (tab6,)
        hk = cull.cull_cast(*k4_args[rname], exact_uv=True)
        hp = cull.cull_cast_reference(*k4_args[rname], exact_uv=True)
        torch.cuda.synchronize()
        _compare_hits(f"K4 exact_uv {rname}", hk, hp)
        print(f"K4 exact_uv {rname:18s}: {int(hk.valid.sum())} hits over "
              f"{args[3].shape[0]} tiles, every output identical to plain")

    # ---- phase 17: the cull on 9,216 instances ------------------------------
    g_np, g_cam, g_cfg = make_grid_world(96)
    gs = rtt.to_device(g_np, dev)
    g_cam = rtt.to_device(g_cam, dev)
    g_cfg = g_cfg.replace(engine="cuda", pallas_traversal="cull")
    gdata = ce.prepare_cast(gs, expand_geometry(gs), g_cfg)
    if gdata.nodes is not None:
        raise AssertionError("the forced cull built an LBVH")
    ro, rd, _, _ = _frame_rays_blocked(g_cam, g_cfg)
    o_p, d_p, cand, info, tile = lists(g_cfg, ro, rd, gdata.tables)
    # two overflowed tiles (lists of all 9,216 instances, 18 pieces) and
    # one other (listed or empty), where there is one
    over = (info[:, 1] > 0).nonzero().flatten()
    over = over[over.numel() // 2:][:2].tolist()  # mid-frame: they hit
    pick = over + (info[:, 1] == 0).nonzero().flatten()[:1].tolist()
    if len(over) < 2 or int(info[over[0], 0]) != 9216:
        raise AssertionError(f"grid 96: tiles {info.tolist()}")
    sel = torch.cat([torch.arange(t * tile, (t + 1) * tile, device=dev)
                     for t in pick])
    o, d = o_p[sel].contiguous(), d_p[sel].contiguous()
    c, i = cand[pick].contiguous(), info[pick].contiguous()
    hk = cull.cull_cast(o, d, c, i, tile, gdata.tables)
    hp = cull.cull_cast_reference(o, d, c, i, tile, gdata.tables)
    torch.cuda.synchronize()
    _compare_hits("K4 grid 9216", hk, hp)
    # K5 along the same rays (the shadow rays of a grid seen from above
    # reach no blocker): any hit within +inf, and within 0.9 of the closest
    # hit (no blocker lies before it)
    t_hit = torch.where(hk.valid, hk.t, 1.0)
    for qname, mt in (("+inf", torch.full_like(t_hit, float("inf"))),
                      ("0.9 t_hit", 0.9 * t_hit)):
        bk = cull.cull_occlude(o, d, mt, c, i, tile, gdata.tables)
        bp = cull.cull_occlude_reference(o, d, mt, c, i, tile, gdata.tables)
        torch.cuda.synchronize()
        if not torch.equal(bk, bp):
            raise AssertionError(f"K5 grid 9216 {qname}: differs on "
                                 f"{int((bk != bp).sum())} rays")
        want = hk.valid if qname == "+inf" else torch.zeros_like(hk.valid)
        if not torch.equal(bk, want):
            raise AssertionError(f"K5 grid 9216 {qname}: not the closest "
                                 "hits' mask")
        print(f"K5 grid 9216 max_t {qname:9s}: blocked {int(bk.sum())} of "
              f"{bk.numel()}, identical to plain")
    print(f"K4 grid 9216: tiles {pick} (lists {[int(info[t, 0]) for t in pick]})"
          f", {int(hk.valid.sum())} hits, every output identical to plain")
    cull.cull_cast.launches = cull.cull_occlude.launches = 0
    img_c = render_frame(gs, g_cam, g_cfg)
    torch.cuda.synchronize()
    g_launch = {"cull_cast": cull.cull_cast.launches,
                "cull_occlude": cull.cull_occlude.launches}
    img_w = render_frame(gs, g_cam, g_cfg.replace(pallas_traversal="bvh"))
    d_cw = float((img_c - img_w).abs().max())
    hit_share = float((img_c[..., :3].amax(-1) > 0).float().mean())
    if (g_launch["cull_cast"] < 1 or g_launch["cull_occlude"] < 2
            or d_cw > ATOL_FRAME or hit_share < 0.3):
        raise AssertionError(f"grid 9216 cull frame: launches {g_launch}, "
                             f"vs walk {d_cw}, hit share {hit_share}")
    g_ms = _ms(lambda: render_frame(gs, g_cam, g_cfg), reps=3)
    print(f"grid 9216 {keys[0]} cull frame [{smi}]: == LBVH frame (max abs "
          f"diff {d_cw:.3g}), hit share {hit_share:.4f}, launches {g_launch},"
          f" {g_ms:.3f} ms ({float(info[:, 1].float().mean()):.3f} of tiles "
          "overflowed)")
    out["grid9216"] = {"launches": g_launch, "vs_walk": d_cw,
                       "hit_share": hit_share, "frame_ms": g_ms}

    # ---- phase 18: the three 1080p geometry-gradient steps ------------------
    cases = {"terrain8": (w8, w8["cfg"]), "terrain6": (w6, w6["cfg"]),
             "terrain6_mxu": (w6, w6["cfg"].replace(pallas_kernel="mxu"))}
    need = {"terrain8": (("bvh_cast_exact_uv", 1), ("bvh_occlude2", 1)),
            "terrain6": (("cull_cast_exact_uv", 1), ("cull_occlude", 2)),
            "terrain6_mxu": (("mxu_cast", 3),)}
    counters = _launch_counters()
    target = torch.zeros(big[1], big[0], 4, device=dev)
    rays_big = big[0] * big[1]
    for cname, (w, cfg) in cases.items():
        cfg_b = cfg.replace(width=big[0], height=big[1])

        def params_fn(w=w):
            return trainable_params(w["scene"], w["cams"][big],
                                    include_vertices=True)

        def loss_fn(p, engine="cuda", w=w, cfg_b=cfg_b):
            return make_loss_fn(w["scene"], w["cams"][big],
                                cfg_b.replace(engine=engine), target)(p)

        def step(engine="cuda"):
            p = params_fn()
            loss = loss_fn(p, engine)
            return loss.detach(), grad_of(loss, p)

        for k, attr in counters.values():
            setattr(k, attr, 0)
        loss_c, g_c = step()
        torch.cuda.synchronize()
        counts = {n: getattr(k, attr) for n, (k, attr) in counters.items()}
        for n, least in need[cname]:
            if counts[n] < least:
                raise AssertionError(f"{cname} geometry step: {n} launched "
                                     f"{counts[n]} times: {counts}")
        for n, _ in need[cname]:
            out["launches"].setdefault(n, counts[n])
        loss_t, g_t = step("torch")
        errs = {}
        for (key, a), b in zip(tree.leaves_with_paths(g_c), tree.leaves(g_t)):
            if not bool(torch.isfinite(a).all()):
                raise AssertionError(f"{cname} step grad {key} not finite")
            scale = float(b.abs().max())
            atol = ATOL_GRAD * scale if key == VERTS else ATOL_GRAD
            torch.testing.assert_close(
                a, b, rtol=RTOL_GRAD, atol=atol,
                msg=lambda m, key=key: f"{cname} grad {key}: {m}")
            errs[key] = float((a - b).abs().max())
        if float(g_c["verts"].abs().max()) == 0.0:
            raise AssertionError(f"{cname}: vertex grads are zero")
        ms = _ms(step, reps=STEP_REPS)
        rec = {"loss": float(loss_c), "loss_torch": float(loss_t),
               "launches": counts, "grad_max_abs_err": errs,
               "step_ms": ms, "mrays_per_s": rays_big / ms / 1e3}
        print(f"{cname} geometry step {keys[-1]} [{smi}]: loss "
              f"{float(loss_c):.6f} (torch {float(loss_t):.6f}), grads == "
              f"torch engine (verts max abs {errs[VERTS]:.3g} of max "
              f"|g| {float(g_t['verts'].abs().max()):.3g}); launches "
              f"{ {n: c for n, c in counts.items() if c} }; step {ms:.3f} ms "
              f"({rec['mrays_per_s']:.3f} Mrays/s, median of {STEP_REPS})")
        rec["profile_backward"] = _profile_backward(
            loss_fn, params_fn, smi, f"{cname} geometry step {keys[-1]}")
        out["steps"][cname] = rec

    # ---- timings and bounds of the new instantiations -----------------------
    tab8 = _nbytes(data8.tables.inst_f32, data8.tables.inst_i32,
                   data8.tables.tmpl, data8.nodes, data8.ordering)
    tab6b = _nbytes(tab6.inst_f32, tab6.inst_i32, tab6.tmpl)
    timing = out["timing"]
    for k in keys:
        o, d = k1_rays[f"primary {k}"]
        a4 = k4_args[f"primary {k}"]
        h1 = ce.bvh_cast(o, d, data8, exact_uv=True)
        h4 = cull.cull_cast(*a4, exact_uv=True)
        w1 = _work(ce.bvh_cast_reference, o, d, data8, exact_uv=True)
        w4 = _work(cull.cull_cast_reference, *a4, exact_uv=True)
        wv = _work(ce.bvh_cast_reference, o, d, data8)
        n_exact = {"bvh_cast_exact_uv": int(w1[:, 4].sum()),
                   "cull_cast_exact_uv": int(w4[:, 4].sum())}
        out["bounds"][k] = {
            "bvh_cast_exact_uv": _bound(
                _nbytes(o, d, h1.t, h1.wtri, h1.uv, h1.normal, h1.mat) + tab8,
                _work_ops(w1, closest_hit=True, exact_uv=True)),
            "cull_cast_exact_uv": _bound(
                _nbytes(*a4[:4], h4.t, h4.wtri, h4.uv, h4.normal, h4.mat)
                + tab6b, _work_ops(w4, closest_hit=True, exact_uv=True)),
            # the visits instantiation: K1's walk, its hits and the counts out
            "bvh_visit_counts": _bound(
                _nbytes(o, d, h1.t, h1.wtri, h1.uv, h1.normal, h1.mat)
                + 4 * o.shape[0] + tab8,
                _work_ops(wv, closest_hit=True)),
        }
        for name, b in out["bounds"][k].items():
            b["rays"] = o.shape[0] if name != "cull_cast_exact_uv" \
                else a4[0].shape[0]
            b["exact_updates"] = n_exact.get(name, 0)
            print(f"bound {name} {k}: {b['bound_ms']:.5f} ms ({b['bound_by']}"
                  f": {b['bytes']} bytes, {b['ops']} FP32 ops; "
                  f"{b['exact_updates']} box updates with the exact branch)")
        timing[k] = {
            "k1x_device_ms": _device_ms(
                lambda: ce.bvh_cast(o, d, data8, exact_uv=True)),
            "k4x_device_ms": _device_ms(
                lambda: cull.cull_cast(*a4, exact_uv=True)),
            "k1v_device_ms": _device_ms(
                lambda: ce.bvh_visit_counts(o, d, data8)),
            "k1_box_exact_tables_device_ms": _device_ms(
                lambda: ce.bvh_cast(o, d, data8)),
            "k4_box_exact_tables_device_ms": _device_ms(
                lambda: cull.cull_cast(*a4)),
        }
        if k == keys[0]:
            timing[k].update({
                "k1x_ms": _ms(lambda: ce.bvh_cast(o, d, data8, exact_uv=True)),
                "k1x_plain_ms": _ms(lambda: ce.bvh_cast_reference(
                    o, d, data8, exact_uv=True),
                    reps=PLAIN_REPS, warmup=False),
                "k4x_ms": _ms(lambda: cull.cull_cast(*a4, exact_uv=True)),
                "k4x_plain_ms": _ms(lambda: cull.cull_cast_reference(
                    *a4, exact_uv=True),
                    reps=PLAIN_REPS, warmup=False),
                "k1v_ms": _ms(lambda: ce.bvh_visit_counts(o, d, data8)),
                "k1v_plain_ms": _ms(lambda: ce.bvh_visit_counts_reference(
                    o, d, data8), reps=PLAIN_REPS, warmup=False),
            })
        t = timing[k]
        print(f"device time {k} [{smi}]: K1 exact_uv {t['k1x_device_ms']:.4f}"
              f" ms (K1 on the same tables {t['k1_box_exact_tables_device_ms']:.4f}),"
              f" K4 exact_uv {t['k4x_device_ms']:.4f} ms (K4 "
              f"{t['k4_box_exact_tables_device_ms']:.4f}), K1 visits "
              f"{t['k1v_device_ms']:.4f} ms")
    return out


def _kernel_wrappers():
    from raytracer_tpu_torch.render import cuda_engine as ce
    from raytracer_tpu_torch.render import cull, mxu

    return {"bvh_cast": ce.bvh_cast, "bvh_occlude2": ce.bvh_occlude2,
            "bvh_occlude": ce.bvh_occlude, "bvh_march": ce.bvh_march,
            "cull_cast": cull.cull_cast, "cull_occlude": cull.cull_occlude,
            "mxu_cast": mxu.mxu_cast}


def _counted(label, fn, used):
    """Run ``fn`` with every launch counter set to 0 just before and read
    just after; every kernel of ``used`` must have launched, no other.
    Returns ``(fn's result, counts)``."""
    wrappers = _kernel_wrappers()
    for k in wrappers.values():
        k.launches = 0
    out = fn()
    torch.cuda.synchronize()
    counts = {name: k.launches for name, k in wrappers.items()}
    for name, n in counts.items():
        if (n > 0) != (name in used):
            raise AssertionError(f"{label}: {name} launched {n} times "
                                 f"(expected {'some' if name in used else 0})")
    return out, {name: counts[name] for name in used}


def _frame_checks(label, img, ref, size, atol=ATOL_FRAME):
    """A frame of the right shape, finite, with hits, within ``atol`` of
    ``ref``.  Returns the max abs difference."""
    if tuple(img.shape) != (size[1], size[0], 4) or not bool(
            torch.isfinite(img).all()):
        raise AssertionError(f"{label}: shape {tuple(img.shape)} or "
                             "non-finite values")
    diff = float((img - ref).abs().max())
    hit_share = float((img[..., :3].amax(-1) > 0.0).float().mean())
    if diff > atol or hit_share <= 0.05:
        raise AssertionError(f"{label}: max abs diff {diff} > {atol} or hit "
                             f"share {hit_share}")
    return diff


def _march_checks(label, scene, geom, data, cfg, waves):
    """The fused march (``bvh_march``, one launch) against the loop of
    torch ops over K1 (``shading.march_steps``) on each round's rays,
    for the point light (``max_t [R]``) and the directional one (+inf),
    within ``MARCH_ULPS`` float32 steps; the first round's point-light
    march timed, kernel and loop, with its byte bound.  ``waves``: the
    rounds' queues (``engine.radiance``'s ``on_round``)."""
    from raytracer_tpu_torch import raymath as rm
    from raytracer_tpu_torch.probe_kernels import float32_steps
    from raytracer_tpu_torch.render import cuda_engine as ce
    from raytracer_tpu_torch.render.shading import march_steps

    cast = ce.make_cuda_cast(data, cfg, plain=False)
    kt, steps = scene.materials.kt, cfg.shadow_steps
    rec = {"ulps": 0, "max_abs_err": 0.0, "marches": []}
    with torch.no_grad():
        for i, w in enumerate(waves):
            hk = ce.bvh_cast(torch.where(w.active[:, None], w.o,
                                         1e30).contiguous(),
                             w.d.contiguous(), data)
            active = w.active & hk.valid
            pos = w.o + torch.where(hk.valid, hk.t, 1.0)[:, None] * w.d
            disp = scene.lights.point_pos[0] - pos
            lights = (("point", rm.normalize(disp), rm.norm(disp),
                       scene.lights.point_col[0]),
                      ("directional", rm.normalize(
                          -scene.lights.dir_dir[0]), float("inf"),
                       scene.lights.dir_col[0]))
            for light, dirn, max_t, col in lights:
                args = (pos.contiguous(), dirn.contiguous(), max_t, col,
                        active)
                n = ce.bvh_march.launches
                rv_k = cast.march(*args, kt, steps)
                rv_p, plain_ms = _timed(lambda: march_steps(
                    cast, geom, scene.materials, *args, steps, False))
                ulps = float32_steps(rv_k, rv_p)
                if ce.bvh_march.launches - n != 1 or ulps > MARCH_ULPS:
                    raise AssertionError(
                        f"{label} round {i} {light}: bvh_march "
                        f"{ulps} float32 steps off the loop "
                        f"({ce.bvh_march.launches - n} launches)")
                rec["ulps"] = max(rec["ulps"], ulps)
                rec["max_abs_err"] = max(rec["max_abs_err"], float(
                    (rv_k - rv_p).abs().max()))
                rec["marches"].append({
                    "round": i, "light": light, "lanes": pos.shape[0],
                    "active": int(active.sum()), "ulps": ulps,
                    "values_off": int((rv_k != rv_p).sum())})
                if i == 0 and light == "point":
                    def fused():
                        return cast.march(*args, kt, steps)
                    rec["ms"] = _ms(fused)
                    rec["device_ms"] = _device_ms(fused)
                    rec["plain_ms"] = plain_ms
                    rec["bound"] = _bound(_nbytes(*args[:3], active,
                                                  rv_k), 0)
                    rec["bound"]["rays"] = pos.shape[0]
    print(f"{label}: bvh_march == loop within {rec['ulps']} float32 "
          f"steps on {len(rec['marches'])} marches (values off: "
          f"{[m['values_off'] for m in rec['marches']]}; active lanes "
          f"{[m['active'] for m in rec['marches']]} of "
          f"{rec['bound']['rays']}); round 0 point light "
          f"{rec['ms']:.4f} ms (device {rec['device_ms']:.4f}; the "
          f"loop {rec['plain_ms']:.3f} ms once), bound "
          f"{rec['bound']['bound_ms']:.4f} ms "
          f"({rec['bound']['bytes']} B)")
    return rec


def _shade_bytes(w, rs, shaded, in_medium, n_query, refractive):
    """The least bytes of round ``w``'s ``shade_rays`` and ``shade_phong``
    launches (``rs``: ``shade_rays``' outputs; ``shaded`` and
    ``in_medium``: the lanes shaded, and of them those inside a medium;
    ``refractive``: a glass world, whose rays' attenuation is read):
    each input read once and each output written once; ``shade_phong``
    reads a lane's hit beyond its flag only where the lane is shaded, one
    blocker flag a light, or the march's light."""
    R = w.o.shape[0]
    rays = R * (12 + 12 + 1 + 1 + 4) + _nbytes(rs.hit_pos, rs.h_valid,
                                               rs.ldir, rs.ldist)
    if rs.qorig is not None:
        rays += _nbytes(rs.qorig)
    if refractive:  # atten in, atten_eff out
        rays += R * (16 + 1) + in_medium * 4 + _nbytes(rs.atten_eff)
    per_light = 1 if rs.qorig is not None else 16
    phong = R * (1 + 16) + shaded * (12 + 12 + 4 + 12 + 16
                                     + per_light * n_query)
    return rays, phong


def _shade_checks(label, scene, cfg, waves):
    """The round's shading kernels (``fused_shading.shade_rays`` and
    ``shade_phong``, around the shadow queries) against the torch ops of
    ``engine.process_round`` on each round's queue, the same cast for
    both: contributions and children's attenuation within ``SHADE_ULPS``
    float32 steps, the children's rays, flags and pixels equal, the
    counters reset just before the kernels' round and moved once each;
    round 0's two launches timed beside their byte bounds, and its round
    (cast, shading, queries) through the kernels and, once, through the
    torch ops.  ``waves``: the rounds' queues (``radiance``'s
    ``on_round``)."""
    from raytracer_tpu_torch.probe_kernels import float32_steps
    from raytracer_tpu_torch.render import engine as eng
    from raytracer_tpu_torch.render import fused_shading as fs
    from raytracer_tpu_torch.render.geometry import expand_geometry

    geom = expand_geometry(scene)
    cast = eng.make_cast(scene, geom, cfg)
    plain = cfg.replace(engine="torch")  # the torch ops on the same cast
    n_query = (scene.lights.point_pos.shape[0]
               + scene.lights.dir_dir.shape[0])
    rec = {"ulps": 0, "contrib_abs_err": 0.0, "atten_abs_err": 0.0,
           "rounds": []}
    with torch.no_grad():
        for i, w in enumerate(waves):
            spawn = i < len(waves) - 1
            fs.shade_rays.launches = fs.shade_phong.launches = 0
            contrib, kids = eng.process_round(scene, geom, cast, cfg, w,
                                              spawn)
            torch.cuda.synchronize()
            n = (fs.shade_rays.launches, fs.shade_phong.launches)
            contrib_p, kids_p = eng.process_round(scene, geom, cast, plain,
                                                  w, spawn)
            torch.cuda.synchronize()
            moved = (fs.shade_rays.launches, fs.shade_phong.launches) != n
            ulps = float32_steps(contrib, contrib_p)
            same = [True]
            if spawn:
                ulps = max(ulps, float32_steps(kids.atten, kids_p.atten))
                same = [torch.equal(getattr(kids, f), getattr(kids_p, f))
                        for f in ("o", "d", "in_obj", "active", "pixel")]
                rec["atten_abs_err"] = max(rec["atten_abs_err"], float(
                    (kids.atten - kids_p.atten).abs().max()))
            if (n != (1, 1) or moved or ulps > SHADE_ULPS or not all(same)
                    or not float(contrib_p.abs().max()) > 0.0):
                raise AssertionError(
                    f"{label} round {i}: the shading kernels {ulps} float32 "
                    f"steps off the torch ops, children equal {same}, "
                    f"launches {n}, the torch ops' launched them: {moved}")
            rec["ulps"] = max(rec["ulps"], ulps)
            rec["contrib_abs_err"] = max(rec["contrib_abs_err"], float(
                (contrib - contrib_p).abs().max()))
            rec["rounds"].append({
                "lanes": w.o.shape[0], "ulps": ulps,
                "values_off": int((contrib != contrib_p).sum())})
            if i:
                continue
            # round 0's launches, as shade_round makes them
            hit = cast(torch.where(w.active[:, None], w.o, 1e30), w.d)
            how = fs.mode(scene, cfg, cast)
            sc = fs.scene_arg(scene, w.o.device)

            def rays():
                return fs.shade_rays(
                    sc, w.o, w.d, w.atten, w.in_obj, w.active, hit.valid,
                    hit.t, hit.mat, queries=how != "march",
                    refractive=cfg.any_refractive)

            rs = rays()
            shadow = fs.shadow_queries(scene, geom, cast, cfg, rs, how)

            def phong():
                return fs.shade_phong(sc, w.d, hit.normal, hit.mat,
                                      rs.h_valid, rs.hit_pos, rs.atten_eff,
                                      shadow, march=how == "march")

            shaded = int(rs.h_valid.sum())
            b_rays, b_phong = _shade_bytes(
                w, rs, shaded, int((rs.h_valid & w.in_obj).sum()), n_query,
                cfg.any_refractive)
            rec.update(
                mode=how, lanes=w.o.shape[0], shaded=shaded,
                rays_ms=_ms(rays), rays_device_ms=_device_ms(rays),
                phong_ms=_ms(phong), phong_device_ms=_device_ms(phong),
                round_ms=_ms(lambda: eng.process_round(
                    scene, geom, cast, cfg, w, False)),
                round_plain_ms=_timed(lambda: eng.process_round(
                    scene, geom, cast, plain, w, False))[1],
                rays_bound=_bound(b_rays, 0), phong_bound=_bound(b_phong, 0))
            rec["rays_bound"]["rays"] = rec["phong_bound"]["rays"] = rec[
                "lanes"]
    print(f"{label}: shade_rays/shade_phong == the torch ops within "
          f"{rec['ulps']} float32 steps on {len(rec['rounds'])} rounds "
          f"({rec['mode']}; values off: "
          f"{[r['values_off'] for r in rec['rounds']]}); round 0, "
          f"{rec['shaded']} of {rec['lanes']} lanes shaded: shade_rays "
          f"{rec['rays_ms']:.4f} ms (device {rec['rays_device_ms']:.4f}, "
          f"bound {rec['rays_bound']['bound_ms']:.4f}, "
          f"{rec['rays_bound']['bytes']} B), shade_phong "
          f"{rec['phong_ms']:.4f} ms (device {rec['phong_device_ms']:.4f}, "
          f"bound {rec['phong_bound']['bound_ms']:.4f}, "
          f"{rec['phong_bound']['bytes']} B); the round {rec['round_ms']:.3f}"
          f" ms through the kernels, {rec['round_plain_ms']:.3f} ms through "
          "the torch ops once")
    return rec


def _bounces(dev, smi):
    """Phases 19-22: the bounce rounds.  terrain8_stress (reflective: the
    pixel-aligned stream, K1 and K2 in every round) and terrain8_mixed
    (reflective and refractive: the compacted 2x stream, the transmissive
    shadow march through K1) at both sizes, their 1080p steps, and the
    synthetic worlds on every cast.  Returns the numbers for the report."""
    import raytracer_tpu_torch as rtt
    from raytracer_tpu_torch import raymath as rm
    from raytracer_tpu_torch import synth, tree
    from raytracer_tpu_torch.builder import scale_camera
    from raytracer_tpu_torch.diff import (grad_of, make_loss_fn,
                                          trainable_params)
    from raytracer_tpu_torch.render import cuda_engine as ce
    from raytracer_tpu_torch.render import cull
    from raytracer_tpu_torch.render import engine as eng
    from raytracer_tpu_torch.render.geometry import expand_geometry
    from raytracer_tpu_torch.render.shading import shadow_rays

    from raytracer_tpu_torch.render import fused_shading as fs

    out = {"worlds": {}, "steps": {}, "synth": {}, "march": {}, "shade": {}}
    main, big = SIZES[0], SIZES[-1]
    inf = float("inf")

    def world(path):
        w = rtt.generate(path)
        scene = rtt.to_device(w.scene, dev)
        cfg = w.config.replace(engine="cuda")
        cams = {s: rtt.to_device(scale_camera(w.camera, s[0],
                                              w.config.width), dev)
                for s in SIZES}
        return scene, cfg, cams

    def rounds(scene, cam, cfg):
        """Each round's queue (``radiance``'s ``on_round``) and the drop
        count of one frame's rays."""
        geom = expand_geometry(scene)
        ro, rd, _, _ = eng._frame_rays_blocked(cam, cfg)
        waves = []
        _, dropped = eng.radiance(scene, geom, eng.make_cast(scene, geom, cfg),
                                  cfg, ro, rd,
                                  on_round=lambda r, st: waves.append(st))
        return waves, int(dropped)

    def cast_rays(w):
        return (torch.where(w.active[:, None], w.o, 1e30).contiguous(),
                w.d.contiguous())

    def k1_equal(label, o, d, data):
        hk = ce.bvh_cast(o, d, data)
        _compare_hits(label, hk, ce.bvh_cast_reference(o, d, data))
        return hk

    # ---- phases 19-20: the two bounce terrains ------------------------------
    # the mixed frame marches in the fused kernel, its step (under grad) in
    # the loop of K1 casts
    used_of = {"terrain8_stress": ("bvh_cast", "bvh_occlude2"),
               "terrain8_mixed": ("bvh_cast", "bvh_march")}
    step_used_of = {"terrain8_stress": ("bvh_cast", "bvh_occlude2"),
                    "terrain8_mixed": ("bvh_cast",)}
    for name, path in (("terrain8_stress", WORLD_STRESS),
                       ("terrain8_mixed", WORLD_MIXED)):
        scene, cfg, cams = world(path)
        rec = out["worlds"][name] = {"instances": scene.inst_pos.shape[0],
                                     "triangles": scene.wtri_tri.shape[0]}
        mixed = cfg.any_refractive
        if not cfg.any_reflective or cfg.recurse_depth != 2:
            raise AssertionError(f"{name}: not a reflective depth-2 world")
        geom = expand_geometry(scene)
        data = ce.prepare_cast(scene, geom, cfg)
        if data.nodes is None:
            raise AssertionError(f"{name} must take the LBVH walk")
        print(f"{name}: {rec['instances']} instances, {rec['triangles']} "
              f"world triangles, depth {cfg.recurse_depth}, "
              f"{'compacted 2x stream, march' if mixed else 'aligned stream'}")
        for s in SIZES:
            key = f"{s[0]}x{s[1]}"
            c = cfg.replace(width=s[0], height=s[1])
            fs.shade_rays.launches = fs.shade_phong.launches = 0
            (img, stats), counts = _counted(
                f"{name} {key}", lambda: eng.render_frame_with_stats(
                    scene, cams[s], c), used_of[name])
            shade_n = (fs.shade_rays.launches, fs.shade_phong.launches)
            waves, dropped = rounds(scene, cams[s], c)
            live = [int(w.active.sum()) for w in waves]
            if int(stats["dropped"]) != 0 or dropped != 0:
                raise AssertionError(f"{name} {key}: dropped "
                                     f"{int(stats['dropped'])}")
            if shade_n != (len(waves), len(waves)):
                raise AssertionError(f"{name} {key}: the shading kernels "
                                     f"launched {shade_n} times in "
                                     f"{len(waves)} rounds")
            r = rec[key] = {"launches": counts, "live_rays": live,
                            "queue": [w.active.shape[0] for w in waves],
                            "dropped": 0, "shade_launches": shade_n}
            out["shade"][f"{name} {key}"] = _shade_checks(
                f"{name} {key}", scene, c, waves)
            out["shade"][f"{name} {key}"]["frame_launches"] = {
                "shade_rays": shade_n[0], "shade_phong": shade_n[1]}
            if mixed:
                out["march"][key] = _march_checks(f"{name} {key}", scene,
                                                  geom, data, c, waves)
                out["march"][key]["frame_launches"] = counts["bvh_march"]
            if s == main:
                t0 = time.perf_counter()
                ref = eng.render_frame(scene, cams[s], c.replace(
                    engine="torch"))
                torch.cuda.synchronize()
                r["frame_ms_torch_once"] = (time.perf_counter() - t0) * 1e3
                r["max_abs_diff"] = _frame_checks(f"{name} {key}", img, ref, s)
                img0 = eng.render_frame(scene, cams[s],
                                        c.replace(recurse_depth=0))
                r["bounce_pixels"] = int(
                    ((img - img0).abs().amax(-1) > 1e-3).sum())
                # every kernel on every round's rays
                for i, w in enumerate(waves):
                    o, d = cast_rays(w)
                    hk = (k1_equal(f"{name} round {i}", o, d, data) if i
                          else ce.bvh_cast(o, d, data))
                    h_valid = w.active & hk.valid
                    pos = w.o + torch.where(hk.valid, hk.t, 1.0)[:, None] * w.d
                    if not mixed:
                        q = shadow_rays(scene, pos, h_valid)
                        q = (q[0], q[1], q[2], q[3], q[4].contiguous(),
                             torch.full_like(q[2], inf))
                        bk = ce.bvh_occlude2(*q, data)
                        bp = ce.bvh_occlude2_reference(*q, data)
                        for k in range(2):
                            if not torch.equal(bk[k], bp[k]):
                                raise AssertionError(
                                    f"{name} round {i}: K2 query {k + 1} "
                                    "differs from plain")
                        print(f"{name} round {i}: {live[i]} live rays; K1 "
                              f"{'== plain, ' if i else ''}K2 == plain "
                              f"(blocked {int(bk[0].sum())} + "
                              f"{int(bk[1].sum())})")
                        continue
                    inside = w.active & w.in_obj
                    nd = rm.dot(hk.normal, w.d)
                    exits = inside & hk.valid & (nd > 0.0)
                    # the point light's march: K1 on its first two steps
                    disp = scene.lights.point_pos[0] - pos
                    dist, dirn = rm.norm(disp), rm.normalize(disp)
                    cur = (torch.where(h_valid[:, None], pos, 1e30)
                           + rm.THRESHOLD * dirn).contiguous()
                    alive, left, marched = h_valid, dist, []
                    for step in range(2):
                        hm = k1_equal(f"{name} round {i} march {step}", cur,
                                      dirn.contiguous(), data)
                        t_m = torch.where(hm.valid, hm.t, 1.0)
                        glass = (scene.materials.kt[hm.mat.long()]
                                 > 0.0).any(-1)
                        alive = alive & hm.valid & ~(t_m > left) & glass
                        cur = torch.where(alive[:, None],
                                          cur + t_m[:, None] * dirn, cur)
                        left = torch.where(alive, left - t_m, left)
                        marched.append(int(alive.sum()))
                    r.setdefault("rounds", []).append({
                        "live": live[i], "inside": int(inside.sum()),
                        "exit_face": int(exits.sum()),
                        "march_through_glass": marched})
                    print(f"{name} round {i}: {live[i]} live rays, "
                          f"{int(inside.sum())} start inside a glass box, "
                          f"{int(exits.sum())} of them take the exit face; "
                          f"K1 {'== plain; ' if i else ''}march steps 0-1 "
                          f"K1 == plain, {marched} rays walk on through "
                          "glass")
                if not mixed:
                    (img_pl, _), _ = _counted(
                        f"{name} per light", lambda: eng.render_frame_with_stats(
                            scene, cams[s], c.replace(fused_shadows=False)),
                        ("bvh_cast", "bvh_occlude"))
                    if not torch.equal(img_pl, img):
                        raise AssertionError(f"{name}: fused_shadows=False "
                                             "frame differs from the fused")
                    r["per_light_equal"] = True
            r["frame_ms_cuda"] = _ms(lambda: eng.render_frame(scene, cams[s],
                                                              c))
            prof = _profile(lambda: eng.render_frame(scene, cams[s], c), smi,
                            label=f"{name} frame {key}")
            r.update({k: prof[k] for k in ("device_busy_ms", "idle_share",
                                           "kernels_per_step")})
            print(f"{name} {key} [{smi}]: frame {r['frame_ms_cuda']:.3f} ms "
                  f"(median of {REPS}), live rays per round {live} of "
                  f"{r['queue']}, dropped 0, launches {counts}"
                  + (f", cuda == torch engine (max abs diff "
                     f"{r['max_abs_diff']:.3g}; torch frame "
                     f"{r['frame_ms_torch_once']:.1f} ms once), "
                     f"{r['bounce_pixels']} pixels changed by the bounces"
                     if s == main else ""))

        # ---- phase 21: the 1080p step ---------------------------------------
        target0 = torch.zeros(big[1], big[0], 4, device=dev)
        cb = cfg.replace(width=big[0], height=big[1])

        def step(engine):
            params = trainable_params(scene, cams[big])
            loss = make_loss_fn(scene, cams[big], cb.replace(engine=engine),
                                target0)(params)
            return loss.detach(), grad_of(loss, params)

        (loss_c, g_c), counts = _counted(f"{name} step", lambda: step("cuda"),
                                         step_used_of[name])
        loss_t, g_t = step("torch")
        err = 0.0
        for (key, a), b in zip(tree.leaves_with_paths(g_c), tree.leaves(g_t)):
            if not bool(torch.isfinite(a).all()):
                raise AssertionError(f"{name} step grad {key} not finite")
            torch.testing.assert_close(
                a, b, rtol=RTOL_GRAD, atol=ATOL_GRAD,
                msg=lambda m, key=key: f"{name} grad {key}: {m}")
            err = max(err, float((a - b).abs().max()))
        mats = g_c["materials"]
        kr = float(mats.kr.abs().max())
        kt = float(mats.kt.abs().max())
        if kr == 0.0 or (mixed and kt == 0.0):
            raise AssertionError(f"{name} step: kr/kt grads zero")
        ms = _ms(lambda: step("cuda"), reps=STEP_REPS)
        out["steps"][name] = {"launches": counts, "grad_max_abs_err": err,
                              "loss": float(loss_c), "step_ms": ms,
                              "mrays_per_s": big[0] * big[1] / ms / 1e3,
                              "max_abs_grad_kr": kr, "max_abs_grad_kt": kt}
        print(f"{name} step {big[0]}x{big[1]} [{smi}]: loss "
              f"{float(loss_c):.6f} (torch {float(loss_t):.6f}), grads cuda "
              f"== torch engine (max abs {err:.3g}; max |g| kr {kr:.3g}, kt "
              f"{kt:.3g}), launches {counts}; {ms:.3f} ms (median of "
              f"{STEP_REPS}), "
              f"{out['steps'][name]['mrays_per_s']:.2f} Mrays/s")

    # ---- phase 22: the synthetic worlds at their own 128x96 -----------------
    def synth_world(scene_np, cam_np, cfg):
        return (rtt.to_device(scene_np, dev), rtt.to_device(cam_np, dev),
                cfg.replace(engine="cuda"))

    def both(label, scene, cam, cfg, used):
        size = (cfg.width, cfg.height)
        (img, stats), counts = _counted(label, lambda: eng.render_frame_with_stats(
            scene, cam, cfg), used)
        ref = eng.render_frame(scene, cam, cfg.replace(engine="torch"))
        diff = _frame_checks(label, img, ref, size)
        print(f"{label}: cuda == torch engine (max abs diff {diff:.3g}), "
              f"dropped {int(stats['dropped'])}, launches {counts}")
        out["synth"][label] = {"max_abs_diff": diff, "launches": counts,
                               "dropped": int(stats["dropped"])}
        return img

    scene, cam, cfg = synth_world(*synth.make_mixed_world(depth=3))
    dense = both("mixed world, cull", scene, cam, cfg, ("cull_cast",))
    geom = expand_geometry(scene)
    data = ce.prepare_cast(scene, geom, cfg)
    waves, _ = rounds(scene, cam, cfg)
    tile = cull.tile_rows_of(cfg) * cull.LANES
    for i, w in enumerate(waves[1:], 1):
        o, d = cast_rays(w)
        lay = cull.CullLayout.of(o.shape[0], cfg.pallas_ray_chunk, tile)
        o_p, d_p = lay.pad_rays(o, d, 1.0e30)
        cand, info = cull.tile_candidates(o_p, d_p, tile,
                                          data.tables.inst_f32,
                                          cull.MAX_CAND)
        _compare_hits(f"mixed world round {i}", cull.cull_cast(
            o_p, d_p, cand, info, tile, data.tables), cull.cull_cast_reference(
                o_p, d_p, cand, info, tile, data.tables))
    print(f"mixed world: K4 == plain on rounds 1-{len(waves) - 1} "
          f"({[int(w.active.sum()) for w in waves]} live rays per round)")
    _, st = eng.render_frame_with_stats(scene, cam,
                                        cfg.replace(queue_factor=0.02))
    n_drop = int(st["dropped"])
    if n_drop <= 0:
        raise AssertionError("queue_factor=0.02 dropped nothing")
    caps = eng.auto_tile_caps(scene, cam, cfg)
    run = {k: v for k, v in caps.items() if k != "static_tile_cap"}
    img, st = eng.render_frame_with_stats(scene, cam, cfg.replace(**run))
    d_caps = float((img - dense).abs().max())
    if int(st["dropped"]) != 0 or d_caps > ATOL_FRAME:
        raise AssertionError(f"auto_tile_caps {caps}: dropped "
                             f"{int(st['dropped'])}, frame diff {d_caps}")
    print(f"mixed world: queue_factor=0.02 drops {n_drop} children; "
          f"auto_tile_caps {caps} -> the dense frame (max abs diff "
          f"{d_caps:.3g}, dropped 0)")
    out["synth"].update({"queue_0.02_dropped": n_drop, "auto_tile_caps": caps,
                         "auto_caps_max_abs_diff": d_caps})
    scene, cam, cfg = synth_world(*synth.make_sphere_world())
    both("sphere world, cull", scene, cam, cfg,
         ("cull_cast", "cull_occlude"))
    both("sphere world, MXU", scene, cam, cfg.replace(pallas_kernel="mxu"),
         ("mxu_cast",))
    scene, cam, cfg = synth_world(*synth.make_big_world(4096))
    walk = both("big world 4096, walk", scene, cam, cfg,
                ("bvh_cast", "bvh_occlude"))
    (forced, _), counts = _counted(
        "big world 4096, cull", lambda: eng.render_frame_with_stats(
            scene, cam, cfg.replace(pallas_traversal="cull")),
        ("cull_cast", "cull_occlude"))
    d_big = float((forced - walk).abs().max())
    if d_big > ATOL_FRAME:
        raise AssertionError(f"big world: cull vs walk frame {d_big}")
    print(f"big world 4096: the forced cull's frame == the walk's (max abs "
          f"diff {d_big:.3g}), launches {counts}")
    out["synth"]["big_cull_vs_walk"] = d_big
    return out


def _spp(dev, smi):
    """Phases 23-26: spp > 1.  The sweep's frames, kept tiles, chunk sums
    and gradients at 128x96 against the ``"torch"`` engine; K1/K2 on a
    jittered sample's rays and K4/K5 on a kept-tile batch against their
    plain versions; the backward's recompute launching no any-hit query;
    then the JAX package's heavy-spp shapes at full width, timed.  Returns
    the numbers for the report."""
    import raytracer_tpu_torch as rtt
    from raytracer_tpu_torch import synth, tree
    from raytracer_tpu_torch.builder import scale_camera
    from raytracer_tpu_torch.diff import (grad_of, make_loss_fn,
                                          make_spp_grad_fn, trainable_params)
    from raytracer_tpu_torch.render import cuda_engine as ce
    from raytracer_tpu_torch.render import cull
    from raytracer_tpu_torch.render import engine as eng
    from raytracer_tpu_torch.render.geometry import expand_geometry
    from raytracer_tpu_torch.render.shading import shadow_rays

    out = {"small": {}, "static": {}, "sums": {}, "grads": {}, "kernels": {},
           "recompute": {}, "cells": {}}
    small, main = SPP_SMALL, SIZES[0]
    spp = 4
    inf = float("inf")

    def world(path, size, zoom=1, **change):
        w = rtt.generate(path)
        cam = rtt.to_device(scale_camera(w.camera, size[0],
                                         zoom * w.config.width), dev)
        return (rtt.to_device(w.scene, dev), cam, w.config.replace(
            engine="cuda", width=size[0], height=size[1], **change))

    def mixed(size, zoom=1):
        s, c, cfg = synth.make_mixed_world(depth=3)
        return (rtt.to_device(s, dev), rtt.to_device(scale_camera(
            c, size[0], zoom * cfg.width), dev), cfg.replace(
                engine="cuda", width=size[0], height=size[1]))

    def frames(label, scene, cam, cfg, used, atol=ATOL_FRAME):
        """The cuda frame (counters reset just before) against the torch
        engine's; both drop counts.  Returns (img, dropped, counts, diff)."""
        (img, st), counts = _counted(label, lambda: eng.render_frame_with_stats(
            scene, cam, cfg), used)
        ref, st_ref = eng.render_frame_with_stats(scene, cam, cfg.replace(
            engine="torch"))
        if tuple(img.shape) != (cfg.height, cfg.width, 4) or not bool(
                torch.isfinite(img).all()):
            raise AssertionError(f"{label}: shape or non-finite values")
        diff = float((img - ref).abs().max())
        if diff > atol or int(st["dropped"]) != int(st_ref["dropped"]):
            raise AssertionError(f"{label}: max abs diff {diff}, dropped "
                                 f"{int(st['dropped'])} / torch engine "
                                 f"{int(st_ref['dropped'])}")
        return img, int(st["dropped"]), counts, diff

    # ---- phase 23: correctness at 128x96, spp 4 ----------------------------
    walk = ("bvh_cast", "bvh_occlude2")
    cull_used = ("cull_cast", "cull_occlude")
    small_worlds = {
        "terrain8 walk": (world(WORLD, small), walk),
        "terrain6 cull": (world(WORLD6, small), cull_used),
        "terrain6 MXU": (world(WORLD6, small, pallas_kernel="mxu"),
                         ("mxu_cast",)),
        "mixed synth (cull, both child streams)": (mixed(small),
                                                   ("cull_cast",)),
    }
    for label, ((scene, cam, cfg), used) in small_worlds.items():
        c = cfg.replace(spp=spp)
        img, dropped, counts, diff = frames(f"{label} spp {spp}", scene,
                                            cam, c, used)
        one = eng.render_frame(scene, cam, cfg)
        if dropped != 0 or float((img - one).abs().max()) < 1e-3:
            raise AssertionError(f"{label}: dropped {dropped}, or the "
                                 "samples left the spp-1 frame as it was")
        _, starved, _, d_st = frames(f"{label} starved", scene, cam,
                                     c.replace(static_tile_cap=1e-9), used)
        if starved <= 0:
            raise AssertionError(f"{label}: a starved cap dropped nothing")
        out["small"][label] = {"max_abs_diff": diff, "launches": counts,
                               "starved_dropped": starved,
                               "starved_max_abs_diff": d_st}
        print(f"spp {spp} {label} {small[0]}x{small[1]}: cuda == torch "
              f"engine (max abs diff {diff:.3g}), dropped 0, launches "
              f"{counts}; static_tile_cap=1e-9 drops {starved} == the torch "
              f"engine's (frames within {d_st:.3g})")

    # kept tiles at auto_tile_caps' cap, where the cap keeps fewer tiles
    # than the frame has: terrain8 and terrain6 at 640x480 (spp 2), the
    # mixed world in a 192x16 strip, its cluster at half size (spp 4)
    static_worlds = {
        f"terrain8 walk {main[0]}x{main[1]} spp 2": (
            world(WORLD, main, spp=2), walk),
        f"terrain6 cull {main[0]}x{main[1]} spp 2": (
            world(WORLD6, main, spp=2), cull_used),
        f"terrain6 MXU {main[0]}x{main[1]} spp 2": (
            world(WORLD6, main, spp=2, pallas_kernel="mxu"), ("mxu_cast",)),
        "mixed synth 192x16 strip spp 4": (
            (lambda s, c, cfg: (s, c, cfg.replace(spp=spp)))(
                *mixed((192, 16), zoom=2)), ("cull_cast",)),
    }
    for label, ((scene, cam, cfg), used) in static_worlds.items():
        cap = eng.auto_tile_caps(scene, cam, cfg)["static_tile_cap"]
        if not 0.0 < cap < 1.0:
            raise AssertionError(f"{label}: auto static_tile_cap {cap}")
        img, dropped, counts, diff = frames(
            f"{label} static_tile_cap {cap:.4f}", scene, cam,
            cfg.replace(static_tile_cap=cap), used)
        dense = eng.render_frame(scene, cam, cfg)
        d_dense = float((img - dense).abs().max())
        if dropped != 0 or d_dense > ATOL_FRAME:
            raise AssertionError(f"{label}: dropped {dropped}, the kept "
                                 f"tiles' frame {d_dense} from the dense")
        out["static"][label] = {"cap": cap, "max_abs_diff": diff,
                                "vs_dense": d_dense, "launches": counts}
        print(f"{label}: auto static_tile_cap {cap:.4f}: cuda == torch "
              f"engine (max abs diff {diff:.3g}), == the uncapped frame "
              f"({d_dense:.3g}), dropped 0, launches {counts}")

    # render_frame(spp) against render_frame_sum over chunks of the grid
    for label in ("terrain8 walk", "mixed synth (cull, both child streams)"):
        (scene, cam, cfg), _ = small_worlds[label]
        img = eng.render_frame(scene, cam, cfg.replace(spp=spp))
        offs, _ = eng.spp_jitter_grid(spp, cfg.width, cfg.height, dev)
        rec = {}
        for chunk in (1, 2):
            acc = torch.zeros_like(img)
            for i in range(0, spp, chunk):
                acc = acc + eng.render_frame_sum(scene, cam, cfg,
                                                 offs[i:i + chunk])
            rec[chunk] = float((acc / spp - img).abs().max())
        # one-sample chunks add in render_frame's order: bit for bit where
        # no atomic sum takes part (the aligned walk); two-sample chunks add
        # in another order (ulps)
        exact = label == "terrain8 walk"
        if (exact and rec[1] != 0.0) or max(rec.values()) > 1e-6:
            raise AssertionError(f"{label}: chunk sums differ from the spp "
                                 f"frame by {rec}")
        out["sums"][label] = rec
        print(f"{label}: render_frame(spp={spp}) == the sum of "
              f"render_frame_sum chunks / {spp}: 1-sample chunks max abs "
              f"diff {rec[1]:.3g}{' (bit for bit)' if exact else ''}, "
              f"2-sample chunks {rec[2]:.3g}")

    # make_spp_grad_fn, whole and chunked, against the torch engine
    (scene, cam, cfg), _ = small_worlds["terrain8 walk"]
    cfg = cfg.replace(early_exit=False)
    target = torch.zeros(small[1], small[0], 4, device=dev)
    for vertices in (False, True):
        c = cfg.replace(edge_aware_grads=vertices)

        def run(engine, chunk):
            p = trainable_params(scene, cam, include_vertices=vertices)
            return make_spp_grad_fn(scene, cam, c.replace(engine=engine),
                                    spp, spp_chunk=chunk)(p, target)

        loss_t, g_t = run("torch", None)
        for chunk in ((None, 2) if vertices else (None, 1, 2)):
            loss_c, g_c = run("cuda", chunk)
            err = 0.0
            for (key, a), b in zip(tree.leaves_with_paths(g_c),
                                   tree.leaves(g_t)):
                if not bool(torch.isfinite(a).all()):
                    raise AssertionError(f"spp grad {key} not finite")
                atol = (ATOL_GRAD * float(b.abs().max()) if key == VERTS
                        else ATOL_GRAD)
                torch.testing.assert_close(
                    a, b, rtol=RTOL_GRAD, atol=atol,
                    msg=lambda m, key=key: f"spp grad {key}: {m}")
                err = max(err, float((a - b).abs().max()))
            if float(g_c["cam_pos"].abs().max()) == 0.0 or (
                    vertices and float(g_c["verts"].abs().max()) == 0.0):
                raise AssertionError("spp grads: camera or vertex grads 0")
            name = f"{'vertices ' if vertices else ''}spp_chunk={chunk}"
            out["grads"][name] = {"loss": float(loss_c),
                                  "loss_torch": float(loss_t),
                                  "max_abs_err": err}
            print(f"make_spp_grad_fn terrain8 {small[0]}x{small[1]} spp "
                  f"{spp} {name}: loss {float(loss_c):.6f} (torch engine "
                  f"{float(loss_t):.6f}), grads == torch engine (max abs "
                  f"{err:.3g})")

    # ---- phase 24: the kernels on this path's rays --------------------------
    scene, cam, cfg = world(WORLD_STRESS, main)
    geom = expand_geometry(scene)
    data = ce.prepare_cast(scene, geom, cfg)
    offs, shift = eng.spp_jitter_grid(spp, main[0], main[1], dev)
    jitter = (offs[1] + shift) % 1.0
    ro, rd, _, _ = eng._frame_rays_blocked(cam, cfg, jitter)
    waves = []
    eng.radiance(scene, geom, eng.make_cast(scene, geom, cfg), cfg, ro, rd,
                 on_round=lambda r, st: waves.append(st))
    for i, w in enumerate(waves[:2]):
        o = torch.where(w.active[:, None], w.o, 1e30).contiguous()
        d = w.d.contiguous()
        hk = ce.bvh_cast(o, d, data)
        _compare_hits(f"K1 stress jittered round {i}", hk,
                      ce.bvh_cast_reference(o, d, data))
        h_valid = w.active & hk.valid
        pos = w.o + torch.where(hk.valid, hk.t, 1.0)[:, None] * w.d
        q = shadow_rays(scene, pos, h_valid)
        q = (q[0], q[1], q[2], q[3], q[4].contiguous(),
             torch.full_like(q[2], inf))
        bk = ce.bvh_occlude2(*q, data)
        bp = ce.bvh_occlude2_reference(*q, data)
        for k in range(2):
            if not torch.equal(bk[k], bp[k]):
                raise AssertionError(f"K2 stress jittered round {i}: query "
                                     f"{k + 1} differs from plain")
        out["kernels"][f"stress_round_{i}"] = {
            "live": int(w.active.sum()), "hits": int(h_valid.sum()),
            "blocked": [int(bk[0].sum()), int(bk[1].sum())]}
        print(f"terrain8_stress {main[0]}x{main[1]} jittered sample round "
              f"{i}: {int(w.active.sum())} live rays; K1 == plain, K2 == "
              f"plain (blocked {int(bk[0].sum())} + {int(bk[1].sum())})")
    scene, cam, cfg = world(WORLD6, main)
    geom = expand_geometry(scene)
    data = ce.prepare_cast(scene, geom, cfg)
    cap = eng.auto_tile_caps(scene, cam, cfg)["static_tile_cap"]
    lane, _ = eng._static_tile_lanes(eng.make_cast(scene, geom, cfg), cam,
                                     cfg.replace(static_tile_cap=cap))
    ro, rd, _, _ = eng._frame_rays_blocked(cam, cfg, jitter)

    def take(x):
        return x.reshape(-1, 1024, 3)[lane].reshape(-1, 3).contiguous()

    ro, rd = take(ro), take(rd)
    tile = cull.tile_rows_of(cfg) * cull.LANES

    def lists(o, d):
        lay = cull.CullLayout.of(o.shape[0], cfg.pallas_ray_chunk, tile)
        o_p, d_p = lay.pad_rays(o, d, 1.0e30)
        return (lay, o_p, d_p) + cull.tile_candidates(
            o_p, d_p, tile, data.tables.inst_f32, cull.MAX_CAND)

    lay, o_p, d_p, cand, info = lists(ro, rd)
    hk = cull.cull_cast(o_p, d_p, cand, info, tile, data.tables)
    _compare_hits("K4 terrain6 kept tiles", hk, cull.cull_cast_reference(
        o_p, d_p, cand, info, tile, data.tables))
    valid = lay.unpad(hk.valid)
    t = torch.where(valid, lay.unpad(hk.t), 1.0)
    o1, d1, dist, o2, d2 = shadow_rays(scene, ro + t[:, None] * rd, valid)
    blocked = []
    for qname, (o, d, mt) in (("point", (o1, d1, dist)),
                              ("directional", (o2, d2.contiguous(),
                                               torch.full_like(dist, inf)))):
        lay_q, o_p, d_p, cand, info = lists(o, d)
        mt_p = lay_q.pad(mt, 0.0)
        bk = cull.cull_occlude(o_p, d_p, mt_p, cand, info, tile, data.tables)
        if not torch.equal(bk, cull.cull_occlude_reference(
                o_p, d_p, mt_p, cand, info, tile, data.tables)):
            raise AssertionError(f"K5 terrain6 kept tiles {qname}: differs "
                                 "from plain")
        blocked.append(int(bk.sum()))
    out["kernels"]["terrain6_kept_tiles"] = {
        "cap": cap, "tiles": int(lane.numel()),
        "hits": int(valid.sum()), "blocked": blocked}
    print(f"terrain6 {main[0]}x{main[1]} jittered sample on the kept tiles "
          f"({lane.numel()} of {(main[0] // 32) * (main[1] // 32)}, cap "
          f"{cap:.4f}): {int(valid.sum())} hits; K4 == plain, K5 == plain "
          f"(blocked {blocked[0]} + {blocked[1]})")

    # ---- phase 25: the backward's recompute launches no any-hit query -------
    cases = {
        "terrain8 walk (K2)": (world(WORLD, small), "bvh_cast"),
        "terrain8 per light (K3)": (world(WORLD, small, fused_shadows=False),
                                    "bvh_cast"),
        "terrain6 cull (K5)": (world(WORLD6, small), "cull_cast"),
        f"terrain8_stress {main[0]}x{main[1]} kept tiles (K2, 3 rounds)": (
            world(WORLD_STRESS, main), "bvh_cast"),
    }
    wrappers = _kernel_wrappers()
    any_hit = ("bvh_occlude2", "bvh_occlude", "cull_occlude")
    for label, ((scene, cam, cfg), cast) in cases.items():
        cfg = cfg.replace(spp=spp, early_exit=False)
        if "kept tiles" in label:
            cfg = cfg.replace(static_tile_cap=eng.auto_tile_caps(
                scene, cam, cfg)["static_tile_cap"])
        for k in wrappers.values():
            k.launches = 0
        geom = expand_geometry(scene)
        eng._spp_lane(scene, geom, eng.prepare_cast(scene, geom, cfg), cam,
                      cfg)
        torch.cuda.synchronize()
        probe = wrappers[cast].launches
        for k in wrappers.values():
            k.launches = 0
        params = trainable_params(scene, cam)
        loss = make_loss_fn(scene, cam, cfg, torch.zeros(
            cfg.height, cfg.width, 4, device=dev))(params)
        torch.cuda.synchronize()
        fwd = {n: k.launches for n, k in wrappers.items()}
        grads = grad_of(loss, params)
        torch.cuda.synchronize()
        bwd = {n: k.launches - fwd[n] for n, k in wrappers.items()}
        if (any(bwd[n] for n in any_hit) or not any(fwd[n] for n in any_hit)
                or bwd[cast] != fwd[cast] - probe
                or not bool(torch.isfinite(grads["cam_pos"]).all())):
            raise AssertionError(f"{label}: forward launches {fwd}, "
                                 f"backward {bwd}, probe {probe}")
        out["recompute"][label] = {"forward": fwd, "backward": bwd,
                                   "probe": probe}
        print(f"recompute {label} spp {spp}: forward launches "
              f"{ {n: c for n, c in fwd.items() if c} } (probe {probe}), "
              f"backward { {n: c for n, c in bwd.items() if c} }: no "
              "any-hit query, every sample's casts again")

    # ---- phase 26: the JAX package's heavy-spp shapes, full width -----------
    for label, path, size, n_spp, kind in SPP_CELLS:
        scene, cam, cfg = world(path, size, early_exit=False)
        cap = eng.auto_tile_caps(scene, cam, cfg)["static_tile_cap"]
        cfg = cfg.replace(static_tile_cap=cap,
                          edge_aware_grads=kind == "geomgrad")
        rays = size[0] * size[1]
        target0 = torch.zeros(size[1], size[0], 4, device=dev)

        def make(s):
            if kind == "frame":
                def frame():
                    with torch.no_grad():
                        img, st = eng.render_frame_with_stats(
                            scene, cam, cfg.replace(spp=s))
                    return img, st["dropped"]
                return frame
            step = make_spp_grad_fn(scene, cam, cfg, s, with_stats=True)

            def fwd_bwd():
                p = trainable_params(scene, cam,
                                     include_vertices=kind == "geomgrad")
                loss, grads, st = step(p, target0)
                return (loss, grads), st["dropped"]
            return fwd_bwd

        run = make(n_spp)
        used = walk
        (res, dropped), counts = _counted(f"{label} warm-up", run, used)
        if int(dropped) != 0:
            raise AssertionError(f"{label}: dropped {int(dropped)}")
        if kind == "frame":
            ok = (tuple(res.shape) == (size[1], size[0], 4)
                  and bool(torch.isfinite(res).all())
                  and float((res[..., :3].amax(-1) > 0).float().mean())
                  > 0.05)
        else:
            loss, grads = res
            ok = math.isfinite(float(loss)) and all(
                bool(torch.isfinite(g).all()) for g in tree.leaves(grads))
            ok = ok and float(grads["cam_pos"].abs().max()) > 0.0
            if kind == "geomgrad":
                ok = ok and float(grads["verts"].abs().max()) > 0.0
        if not ok:
            raise AssertionError(f"{label}: non-finite, empty or zero "
                                 "result")
        torch.cuda.synchronize()
        # the step's own peak: over what earlier phases left allocated
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        times = []
        for _ in range(1):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        peak = torch.cuda.max_memory_allocated(dev) - base
        run_ref = make(SPP_REF)
        base_ref = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        run_ref()
        torch.cuda.synchronize()
        peak_ref = torch.cuda.max_memory_allocated(dev) - base_ref
        if peak > 1.25 * peak_ref:
            raise AssertionError(f"{label}: peak memory {peak} at spp "
                                 f"{n_spp} > 1.25 x {peak_ref} at spp "
                                 f"{SPP_REF}")
        prof = _profile(run_ref, smi, steps=1, warmup=False,
                        label=f"{label} at spp {SPP_REF}")
        ms = min(times)
        rec = {"spp": n_spp, "size": list(size), "static_tile_cap": cap,
               "ms": ms,
               "mrays_per_s": rays * n_spp / ms / 1e3, "dropped": 0,
               "launches": counts, "peak_bytes": peak,
               "allocated_before_bytes": base,
               f"peak_bytes_spp{SPP_REF}": peak_ref,
               "peak_ratio": peak / peak_ref,
               f"profile_spp{SPP_REF}": prof}
        out["cells"][label] = rec
        print(f"{label} [{smi}]: {ms:.3f} ms (one timed run after one "
              f"warm-up, CUDA events), "
              f"{rec['mrays_per_s']:.3f} Mrays/s, dropped 0, kept-tile cap "
              f"{cap:.4f}, launches {counts}, peak memory {peak / 2**20:.1f} "
              f"MiB over the {base / 2**20:.1f} MiB allocated before "
              f"({rec['peak_ratio']:.3f} x spp {SPP_REF}'s "
              f"{peak_ref / 2**20:.1f} MiB)")
    return out


# ---- phases 27-30: the distribution layer (raytracer_tpu_torch/dist.py) ----
# The ranks are processes that share the one card over gloo (NCCL takes one
# rank a card); their functions below run in each rank, launched by
# dist.launch, and the parent compares what they return with its own
# single-process results.

def _launch_counters():
    """Every launch counter of the kernels line: ``{name: (fn, attr)}``."""
    from raytracer_tpu_torch.render import cuda_engine as ce
    from raytracer_tpu_torch.render import cull, mxu

    return {"bvh_cast": (ce.bvh_cast, "launches"),
            "bvh_occlude2": (ce.bvh_occlude2, "launches"),
            "bvh_occlude": (ce.bvh_occlude, "launches"),
            "cull_cast": (cull.cull_cast, "launches"),
            "cull_occlude": (cull.cull_occlude, "launches"),
            "mxu_cast": (mxu.mxu_cast, "launches"),
            "bvh_cast_exact_uv": (ce.bvh_cast, "exact_uv_launches"),
            "cull_cast_exact_uv": (cull.cull_cast, "exact_uv_launches"),
            "bvh_visit_counts": (ce.bvh_visit_counts, "launches")}


def _dist_world(path, size, dev, **change):
    """``(scene, camera, cfg)`` of a world at ``size`` (the full field of
    view), ``engine="cuda"``."""
    import raytracer_tpu_torch as rtt
    from raytracer_tpu_torch.builder import scale_camera

    w = rtt.generate(path)
    return (rtt.to_device(w.scene, dev),
            rtt.to_device(scale_camera(w.camera, size[0], w.config.width),
                          dev),
            w.config.replace(width=size[0], height=size[1], engine="cuda",
                             **change))


def _digest(x):
    import hashlib

    return hashlib.sha256(x.detach().cpu().numpy().tobytes()).hexdigest()


def _rank_run(label, run, rec, reps=3):
    """In a rank: ``run()`` once with every launch counter set to 0 just
    before and read just after, then its ms (median of ``reps``, CUDA
    events) and its wall seconds the first time into ``rec[label]``."""
    counters = _launch_counters()
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    t0 = time.perf_counter()
    res = run()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
    rec[label] = {"launches": counts, "first_s": first_s,
                  "ms": _ms(run, reps=reps, warmup=False)}
    return res


def _rank_dist2(device):
    """Phases 27-30 in one of 2 ranks on the card: terrain8's row-sharded
    1080p frames (contiguous, cyclic, spp 4); on the 1x2 mesh the
    geometry-sharded 1080p frames of terrain8 (cull shards) and
    terrain8_stress (walk shards), the ring cast at 640x480 and the
    geometry-sharded step with vertices; then dryrun_multichip(2) at
    1080p."""
    from raytracer_tpu_torch import dist
    from raytracer_tpu_torch.diff import trainable_params
    from raytracer_tpu_torch.render.geometry import camera_rays

    rank = torch.distributed.get_rank()
    out = {}

    def keep(rec, label, x):  # rank 0 returns x, every rank its digest
        rec[label]["digest"] = _digest(x)
        if rank == 0:
            rec[label]["value"] = x.detach().cpu()

    # ---- phase 27: row sharding ----
    t0, rec = time.perf_counter(), {}
    scene, cam, cfg = _dist_world(WORLD, DIST_BIG, device)
    mesh = dist.make_mesh()
    for label, c, balance in (
            ("contiguous", cfg, "contiguous"), ("cyclic", cfg, "cyclic"),
            (f"spp{DIST_SPP}", cfg.replace(spp=DIST_SPP), "contiguous")):
        run = dist.make_sharded_render(scene, cam, c, mesh, balance)
        keep(rec, label, _rank_run(label, run, rec))
    rec["seconds"] = time.perf_counter() - t0
    out["27"] = rec

    # ---- phase 28: geometry sharding on the 1x2 mesh ----
    t0, rec = time.perf_counter(), {}
    mesh2 = dist.make_mesh2d(1, 2)
    for label, path in (("terrain8", WORLD), ("terrain8_stress",
                                              WORLD_STRESS)):
        scene, cam, cfg = _dist_world(path, DIST_BIG, device)
        run = dist.make_geom_sharded_render(scene, cam, cfg, mesh2)
        keep(rec, label, _rank_run(label, run, rec))
    scene, cam, cfg = _dist_world(WORLD, DIST_SMALL, device)
    shard = dist.take_shard(dist.split_scene_by_instances(scene, 2),
                            mesh2.index(dist.GEOM_AXIS), device)
    ro, rd = camera_rays(cam, *DIST_SMALL)
    ring = dist.make_ring_geom_cast(scene, cfg, shard, mesh2)
    hit = _rank_run("ring", lambda: ring(ro.reshape(-1, 3),
                                         rd.reshape(-1, 3)), rec)
    keep(rec, "ring", torch.cat([hit.t[:, None], hit.normal,
                                 hit.valid[:, None].float(),
                                 hit.mat[:, None].float()], 1))
    rec["seconds"] = time.perf_counter() - t0
    out["28"] = rec

    # ---- phase 29: the geometry-sharded step ----
    t0, rec = time.perf_counter(), {}
    scene, cam, cfg = _dist_world(WORLD, DIST_SMALL, device,
                                  early_exit=False, edge_aware_grads=True)
    step = dist.make_geom_sharded_grad_fn(scene, cam, cfg, mesh2)
    target = torch.zeros(DIST_SMALL[1], DIST_SMALL[0], 4, device=device)
    loss, grads = _rank_run("step", lambda: step(trainable_params(
        scene, cam, include_vertices=True), target), rec)
    rec["step"].update(loss=float(loss), grads=dist.flat_tree(grads))
    rec["seconds"] = time.perf_counter() - t0
    rec["staged"] = sorted(mesh.staged | mesh2.staged)
    out["29"] = rec

    # ---- phase 30: dryrun_multichip(2) at 1080p ----
    t0, rec = time.perf_counter(), {}
    loss, grads, _ = _rank_run(
        "dryrun", lambda: dist.dryrun_multichip(2, *DIST_BIG, device), rec,
        reps=2)
    rec["dryrun"].update(loss=float(loss), grads=dist.flat_tree(grads))
    rec["seconds"] = time.perf_counter() - t0
    out["30"] = rec
    return out


def _rank_dist4(device):
    """Phase 28 in one of 4 ranks on the card: terrain8's geometry-sharded
    640x480 frame on the 2x2 mesh."""
    from raytracer_tpu_torch import dist

    t0, rec = time.perf_counter(), {}
    scene, cam, cfg = _dist_world(WORLD, DIST_SMALL, device)
    run = dist.make_geom_sharded_render(scene, cam, cfg,
                                        dist.make_mesh2d(2, 2))
    frame = _rank_run("terrain8 2x2", run, rec)
    rec["terrain8 2x2"]["digest"] = _digest(frame)
    if torch.distributed.get_rank() == 0:
        rec["terrain8 2x2"]["value"] = frame.cpu()
    rec["seconds"] = time.perf_counter() - t0
    return rec


def _equal_input(x, y):
    """Equal query inputs: tensors of one shape, dtype and value; a number
    stands for a tensor filled with it (the casts' ``max_t`` takes
    either)."""
    if not isinstance(x, torch.Tensor):
        x, y = y, x
    if not isinstance(x, torch.Tensor):
        return x == y
    if not isinstance(y, torch.Tensor):
        return bool((x == y).all())
    return x.shape == y.shape and x.dtype == y.dtype and torch.equal(x, y)


class _KeptCast:
    """A plain cast (``make_cast(..., engine="torch")``) that keeps each
    answer beside its inputs and gives it again for equal inputs: the
    reference frame's walks then serve the kernels' comparison on the same
    rays (``_same_as_plain``), so each plain walk runs once.  ``cast`` is
    the plain ``Cast`` with its queries answering through the kept ones;
    inputs that differ are walked anew; ``reused`` counts the answers given
    again."""

    def __init__(self, cast):
        self.kept, self.reused = [], 0

        def kept(name, fn):
            return None if fn is None else (
                lambda *a: self._answer(name, fn, a))

        self.cast = dataclasses.replace(
            cast, closest=kept("cast", cast.closest),
            occlude=kept("occlude", cast.occlude),
            occlude2=kept("occlude2", cast.occlude2))

    def _answer(self, name, fn, args):
        for kname, kargs, res in self.kept:
            if kname == name and len(kargs) == len(args) and all(
                    _equal_input(x, y) for x, y in zip(kargs, args)):
                self.reused += 1
                return res
        res = fn(*args)
        self.kept.append((name, args, res))
        return res


def _plain_frame(scene, cam, cfg):
    """``render_frame`` with ``engine="torch"`` (one sample) through a
    :class:`_KeptCast`: ``(frame, kept_cast)``."""
    from raytracer_tpu_torch.render import engine as eng
    from raytracer_tpu_torch.render.geometry import expand_geometry

    cfg = cfg.replace(engine="torch")
    if cfg.spp != 1:
        raise ValueError("_plain_frame renders one sample")
    geom = expand_geometry(scene)
    kept = _KeptCast(eng.make_cast(scene, geom, cfg))
    with torch.no_grad():
        img, _ = eng._render_one_stats(scene, geom, kept.cast, cam, cfg,
                                       None)
    return img, kept


def _same_as_plain(label, scene, cfg, o, d, fused, plain=None):
    """The cast of ``scene`` under ``cfg`` through the kernels and through
    their plain versions on the rays ``(o, d)`` (launches here are
    comparisons, not the main path's): every hit output identical; then the
    two lights' shadow queries of those hits, through ``occlude2`` (K2)
    where ``fused``, else ``occlude`` per light, identical masks; the MXU
    cast, whose ``occlude`` is its closest hit's, casts the shadow rays for
    their closest hits, every output identical.  ``plain``: the plain cast to
    take (a :class:`_KeptCast` of the reference frame), else a new one."""
    from raytracer_tpu_torch.render.engine import make_cast
    from raytracer_tpu_torch.render.geometry import expand_geometry
    from raytracer_tpu_torch.render.shading import shadow_rays

    geom = expand_geometry(scene)
    ck = make_cast(scene, geom, cfg.replace(engine="cuda"))
    cp = plain.cast if plain is not None else make_cast(
        scene, geom, cfg.replace(engine="torch"))
    with torch.no_grad():
        hk = ck(o, d)
        _compare_hits(label, hk, cp(o, d))
        t = torch.where(hk.valid, hk.t, 1.0)
        o1, d1, dist1, o2, d2 = shadow_rays(scene, o + t[:, None] * d,
                                            hk.valid)
        q = (o1, d1, dist1, o2, d2.contiguous(),
             torch.full_like(dist1, float("inf")))
        if cfg.pallas_kernel == "mxu":
            for k, (so, sd) in enumerate(((o1, d1), (o2, q[4]))):
                _compare_hits(f"{label}: shadow rays {k}", ck(so, sd),
                              cp(so, sd))
            print(f"{label}: {int(hk.valid.sum())} hits of {o.shape[0]} "
                  "rays, their two lights' shadow rays: every output "
                  f"identical to plain (closest hits{_reused(plain)})")
            return
        if fused:
            bk, bp = ck.occlude2(*q), cp.occlude2(*q)
        else:
            bk = (ck.occlude(*q[:3]), ck.occlude(*q[3:]))
            bp = (cp.occlude(*q[:3]), cp.occlude(*q[3:]))
        torch.cuda.synchronize()
    for k, (a, b) in enumerate(zip(bk, bp)):
        if not torch.equal(a, b):
            raise AssertionError(f"{label}: shadow query {k} differs on "
                                 f"{int((a != b).sum())} rays")
    blocked = [int((b & hk.valid).sum()) for b in bk]
    print(f"{label}: {int(hk.valid.sum())} hits of {o.shape[0]} rays, "
          f"blocked among them {blocked}: every output identical to plain "
          f"({'occlude2' if fused else 'occlude per light'}"
          f"{_reused(plain)})")


def _reused(plain):
    """``_same_as_plain``'s note of the plain answers a :class:`_KeptCast`
    gave again."""
    if plain is None:
        return ""
    return f"; {plain.reused} plain answers the reference frame's"


def _round_rays(scene, cam, cfg, dist):
    """The rays of each round of the geometry-sharded frame, in its row
    order: the merged cast gives the whole scene's hits, so the rounds
    (``radiance``'s ``on_round``) of the whole scene's cast are the ones
    every shard casts; inactive rays parked at 1e30."""
    from raytracer_tpu_torch.render.engine import make_cast, radiance
    from raytracer_tpu_torch.render.geometry import expand_geometry

    geom = expand_geometry(scene)
    ro, rd = dist._padded_rays(cam, cfg, cfg.height)
    waves = []
    with torch.no_grad():
        radiance(scene, geom, make_cast(scene, geom, cfg), cfg,
                 ro.reshape(-1, 3), rd.reshape(-1, 3),
                 on_round=lambda r, st: waves.append(st))
    return [(torch.where(w.active[:, None], w.o, 1e30).contiguous(),
             w.d.contiguous()) for w in waves]


def _nccl_one_rank(dev):
    """A one-rank NCCL group: it initializes, and its all_reduce and
    all_gather run on the card."""
    import torch.distributed as tdist
    from raytracer_tpu_torch import dist

    dist.initialize_distributed(f"tcp://127.0.0.1:{dist.free_port()}", 1, 0,
                                "nccl", device="cuda")
    try:
        x = torch.arange(16.0, device=dev)
        y = x.clone()
        tdist.all_reduce(y)
        out = [torch.empty_like(x)]
        tdist.all_gather(out, x)
        torch.cuda.synchronize()
        backend = tdist.get_backend()
    finally:
        tdist.destroy_process_group()
    if not (backend == "nccl" and torch.equal(y, x) and torch.equal(out[0], x)
            and y.is_cuda and out[0].is_cuda):
        raise AssertionError("the one-rank NCCL group's collectives")
    print(f"NCCL one-rank group: backend {backend}, all_reduce and "
          f"all_gather on {y.device}: ok")
    return {"backend": backend}


def _dist_grads(label, got, want, loss, want_loss):
    """Sharded grads (flat, CPU) against the single process's at rtol 1e-4
    / atol 1e-6 (``verts``: 1e-6 max|g|).  Returns the max abs diff."""
    from raytracer_tpu_torch import dist

    want = dist.flat_tree(want)
    if sorted(got) != sorted(want):
        raise AssertionError(f"{label}: leaves {sorted(got)}")
    if not math.isclose(loss, want_loss, rel_tol=RTOL_GRAD):
        raise AssertionError(f"{label}: loss {loss} / single {want_loss}")
    worst = 0.0
    for key, g in got.items():
        ref = want[key]
        atol = ATOL_GRAD if key != VERTS else 1e-6 * float(ref.abs().max())
        if not (torch.isfinite(g).all() and torch.allclose(
                g, ref, rtol=RTOL_GRAD, atol=atol)):
            raise AssertionError(f"{label}: {key} max abs diff "
                                 f"{float((g - ref).abs().max())}")
        worst = max(worst, float((g - ref).abs().max()))
    for key in ("['cam_pos']", VERTS):
        if key in got and float(got[key].abs().max()) == 0.0:
            raise AssertionError(f"{label}: {key} grads are zero")
    return worst


def _dist(dev, smi):
    """Phases 27-30: the distribution layer, its ranks sharing the one card
    over gloo (NCCL takes one rank a card: a one-rank NCCL group shows the
    backend).  Returns the numbers for the report."""
    import raytracer_tpu_torch as rtt
    from raytracer_tpu_torch import dist
    from raytracer_tpu_torch.diff import (grad_of, make_loss_fn,
                                          trainable_params)
    from raytracer_tpu_torch.render.engine import render_frame

    out = {"nccl": _nccl_one_rank(dev)}
    t0 = time.perf_counter()
    r2 = [r["result"] for r in dist.launch(
        "chip_smoke:_rank_dist2", 2, backend="gloo", device="cuda",
        timeout=DIST_TIMEOUT, pythonpath=[ROOT])]
    out["launch2_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    r4 = [r["result"] for r in dist.launch(
        "chip_smoke:_rank_dist4", 4, backend="gloo", device="cuda",
        timeout=DIST_TIMEOUT, pythonpath=[ROOT])]
    out["launch4_s"] = time.perf_counter() - t0
    note = "ranks share one card"
    print(f"dist launches [{smi}]: 2 ranks {out['launch2_s']:.1f} s, 4 ranks "
          f"{out['launch4_s']:.1f} s (gloo, {note}); staged through the "
          f"host by the port: {r2[0]['29']['staged'] or 'none'} (gloo's "
          "CUDA all_gather and all_reduce copy through host memory inside "
          "gloo)")
    big, small = DIST_BIG, DIST_SMALL
    bkey, skey = f"{big[0]}x{big[1]}", f"{small[0]}x{small[1]}"

    def rank_rec(ranks, phase, label):
        """Rank 0's record of ``label``; every rank's digest must agree."""
        recs = [r[phase][label] if phase else r[label] for r in ranks]
        if len({rec["digest"] for rec in recs}) != 1:
            raise AssertionError(f"{label}: the ranks' results differ")
        return recs[0], [rec["ms"] for rec in recs]

    def launches_of(ranks, phase, label, used):
        """The ranks' launch counts of ``label``, summed: in every rank each
        counter of ``used`` moved, and no other."""
        total = {}
        for r in ranks:
            counts = (r[phase] if phase else r)[label]["launches"]
            for name, n in counts.items():
                if (n > 0) != (name in used):
                    raise AssertionError(
                        f"{label}: {name} launched {n} times in a rank "
                        f"(expected {'some' if name in used else 0})")
                total[name] = total.get(name, 0) + n
        return {k: v for k, v in total.items() if v}

    def timed(fn, reps=3):
        fn()
        return _ms(fn, reps=reps, warmup=False)

    dist_launches = {}

    # ---- phase 27: row sharding ---------------------------------------------
    t_p = time.perf_counter()
    scene, cam, cfg = _dist_world(WORLD, big, dev)
    single = {"contiguous": render_frame(scene, cam, cfg),
              f"spp{DIST_SPP}": render_frame(scene, cam,
                                             cfg.replace(spp=DIST_SPP))}
    single["cyclic"] = single["contiguous"]
    single_ms = {"frame": timed(lambda: render_frame(scene, cam, cfg)),
                 "spp": timed(lambda: render_frame(
                     scene, cam, cfg.replace(spp=DIST_SPP)))}
    rec27 = {}
    for label in ("contiguous", "cyclic", f"spp{DIST_SPP}"):
        rec, ms = rank_rec(r2, "27", label)
        img = rec["value"].to(dev)
        diff = _frame_checks(f"row-sharded {label}", img, single[label], big)
        if label != f"spp{DIST_SPP}" and not torch.equal(img, single[label]):
            raise AssertionError(f"row-sharded {label}: not bit for bit")
        counts = launches_of(r2, "27", label, ("bvh_cast", "bvh_occlude2"))
        dist_launches[f"27 {label}"] = counts
        s_ms = single_ms["spp" if label.startswith("spp") else "frame"]
        rec27[label] = {"max_abs_diff": diff, "rank_ms": ms,
                        "single_ms": s_ms, "launches": counts}
        print(f"phase 27 terrain8 {bkey} {label} over 2 ranks [{smi}]: max "
              f"abs diff {diff} from the single-process frame"
              f"{' (bit for bit)' if diff == 0.0 else ''}; per-rank ms "
              f"{[round(m, 3) for m in ms]} ({note}), single process "
              f"{s_ms:.3f} ms; launches (both ranks) {counts}")
    hp = dist.pad_to_multiple(big[1], 2 * dist.BAND)
    ro, rd = dist._padded_rays(cam, cfg, hp)
    rows = hp // 2
    _same_as_plain(f"K1/K2 on rank 1's rows ({rows}x{big[0]}, the "
                   "terrain's half)", scene, cfg, ro[rows:].reshape(-1, 3),
                   rd[rows:].reshape(-1, 3), fused=True)
    rec27["seconds"] = time.perf_counter() - t_p + r2[0]["27"]["seconds"]
    out["27"] = rec27
    print(f"phase 27: {rec27['seconds']:.1f} s (ranks "
          f"{r2[0]['27']['seconds']:.1f} s)")
    frame8_big = single["contiguous"]

    # ---- phase 28: geometry sharding ----------------------------------------
    t_p = time.perf_counter()
    rec28 = {}
    cases = {"terrain8": (WORLD, ("cull_cast", "cull_occlude")),
             "terrain8_stress": (WORLD_STRESS, ("bvh_cast", "bvh_occlude"))}
    for label, (path, used) in cases.items():
        scene, cam, cfg = _dist_world(path, big, dev)
        ref = frame8_big if label == "terrain8" else render_frame(scene, cam,
                                                                  cfg)
        s_ms = timed(lambda: render_frame(scene, cam, cfg))
        rec, ms = rank_rec(r2, "28", label)
        diff = _frame_checks(f"geometry-sharded {label}", rec["value"].to(
            dev), ref, big)
        counts = launches_of(r2, "28", label, used)
        dist_launches[f"28 {label} 1x2"] = counts
        rec28[label] = {"max_abs_diff": diff, "rank_ms": ms,
                        "single_ms": s_ms, "launches": counts}
        print(f"phase 28 {label} {bkey} on 1x2 [{smi}]: max abs diff {diff} "
              f"from the single-process frame; per-rank ms "
              f"{[round(m, 3) for m in ms]} ({note}), single process "
              f"{s_ms:.3f} ms; launches (both ranks) {counts}")
        shards = dist.split_scene_by_instances(scene, 2)
        for i, (o, d) in enumerate(_round_rays(scene, cam, cfg, dist)):
            for g in range(2):
                local = dist._local_scene(scene, dist.take_shard(shards, g,
                                                                 dev))
                _same_as_plain(
                    f"{'K4/K5' if label == 'terrain8' else 'K1/K3'} on "
                    f"{label}'s shard {g} ({local.inst_pos.shape[0]} "
                    f"instances), round {i}", local, cfg, o, d, fused=False)
    scene, cam, cfg = _dist_world(WORLD, small, dev)
    ref = render_frame(scene, cam, cfg)
    rec, ms = rank_rec(r4, None, "terrain8 2x2")
    diff = _frame_checks("geometry-sharded terrain8 2x2", rec["value"].to(
        dev), ref, small)
    counts = launches_of(r4, None, "terrain8 2x2",
                         ("cull_cast", "cull_occlude"))
    dist_launches["28 terrain8 2x2"] = counts
    rec28["terrain8 2x2"] = {
        "max_abs_diff": diff, "rank_ms": ms, "launches": counts,
        "single_ms": timed(lambda: render_frame(scene, cam, cfg))}
    print(f"phase 28 terrain8 {skey} on 2x2 [{smi}]: max abs diff {diff}; "
          f"per-rank ms {[round(m, 3) for m in ms]} (4 ranks, {note}), "
          f"single process {rec28['terrain8 2x2']['single_ms']:.3f} ms; "
          f"launches (4 ranks) {counts}")
    from raytracer_tpu_torch.render.engine import make_cast
    from raytracer_tpu_torch.render.geometry import (camera_rays,
                                                     expand_geometry)
    ro, rd = camera_rays(cam, *small)
    with torch.no_grad():
        want = make_cast(scene, expand_geometry(scene), cfg)(
            ro.reshape(-1, 3), rd.reshape(-1, 3))
    rec, ms = rank_rec(r2, "28", "ring")
    got = rec["value"].to(dev)
    valid = got[:, 4] > 0.5
    both = want.valid
    if not (torch.equal(valid, both) and torch.equal(
            got[:, 5][both].to(torch.int32), want.mat[both])
            and torch.allclose(got[:, 0][both], want.t[both], rtol=1e-5,
                               atol=1e-5)
            and torch.allclose(got[:, 1:4][both], want.normal[both],
                               atol=1e-5)):
        raise AssertionError("ring cast: hits differ from the full cast")
    counts = launches_of(r2, "28", "ring", ("cull_cast",))
    dist_launches["28 ring"] = counts
    rec28["ring"] = {"hits": int(both.sum()), "rank_ms": ms,
                     "launches": counts}
    print(f"phase 28 ring cast {skey}, 2 geom shards [{smi}]: "
          f"{int(both.sum())} hits equal to the full cast's (valid, mat "
          f"exact; t, normal 1e-5); per-rank ms {[round(m, 3) for m in ms]}; "
          f"launches {counts}")
    rec28["seconds"] = (time.perf_counter() - t_p + r2[0]["28"]["seconds"]
                        + r4[0]["seconds"])
    out["28"] = rec28
    print(f"phase 28: {rec28['seconds']:.1f} s (ranks "
          f"{r2[0]['28']['seconds']:.1f} s on 1x2, {r4[0]['seconds']:.1f} s "
          "on 2x2)")

    # ---- phase 29: the geometry-sharded step --------------------------------
    t_p = time.perf_counter()
    scene, cam, cfg = _dist_world(WORLD, small, dev, early_exit=False,
                                  edge_aware_grads=True)
    target = torch.zeros(small[1], small[0], 4, device=dev)

    def single_step():
        p = trainable_params(scene, cam, include_vertices=True)
        loss = make_loss_fn(scene, cam, cfg, target)(p)
        return loss.detach(), grad_of(loss, p)

    loss, grads = single_step()
    s_ms = timed(single_step)
    recs = [r["29"]["step"] for r in r2]
    diff = max(_dist_grads("geometry-sharded step", rec["grads"], grads,
                           rec["loss"], float(loss)) for rec in recs)
    counts = launches_of(r2, "29", "step", ("cull_cast", "cull_occlude",
                                            "cull_cast_exact_uv"))
    dist_launches["29 step"] = counts
    local = dist._local_scene(scene, dist.take_shard(
        dist.split_scene_by_instances(scene, 2), 0, dev))
    ro, rd = dist._padded_rays(cam, cfg, small[1])
    _same_as_plain("K4 exact_uv/K5 on terrain8's shard 0", local, cfg,
                   ro.reshape(-1, 3), rd.reshape(-1, 3), fused=False)
    out["29"] = {"max_abs_diff": diff, "rank_ms": [r["ms"] for r in recs],
                 "single_ms": s_ms, "launches": counts, "loss": float(loss),
                 "seconds": time.perf_counter() - t_p
                 + r2[0]["29"]["seconds"]}
    print(f"phase 29 geometry-sharded step {skey}, vertices, edge-aware, "
          f"1x2 [{smi}]: loss {float(loss):.6f}, grads max abs diff {diff} "
          f"from the single process; per-rank ms "
          f"{[round(r['ms'], 3) for r in recs]} ({note}), single process "
          f"{s_ms:.3f} ms; launches (both ranks) {counts}; "
          f"{out['29']['seconds']:.1f} s")

    # ---- phase 30: dryrun_multichip(2) at 1080p -----------------------------
    t_p = time.perf_counter()
    scene, cam, cfg = dist.dryrun_config(*big, dev)
    target = torch.zeros(big[1], big[0], 4, device=dev)

    def single_dry():
        p = trainable_params(scene, cam, include_camera=True,
                             include_vertices=True)
        loss = make_loss_fn(scene, cam, cfg, target)(p)
        return loss.detach(), grad_of(loss, p)

    loss, grads = single_dry()
    s_ms = timed(single_dry, reps=2)
    recs = [r["30"]["dryrun"] for r in r2]
    diff = max(_dist_grads("dryrun_multichip(2)", rec["grads"], grads,
                           rec["loss"], float(loss)) for rec in recs)
    counts = launches_of(r2, "30", "dryrun", ("bvh_cast", "bvh_occlude2",
                                              "bvh_cast_exact_uv"))
    dist_launches["30 dryrun"] = counts
    hp = dist.pad_to_multiple(big[1], 2 * dist.BAND)
    from raytracer_tpu_torch.render.engine import spp_jitter_grid
    offs, shift = spp_jitter_grid(cfg.spp, *big, dev)
    ro, rd = dist._padded_rays(cam, cfg, hp, jitter=(offs[0] + shift) % 1.0)
    rows = hp // 2
    _same_as_plain(f"K1 exact_uv/K2 on rank 1's rows of sample 0 ({rows}x"
                   f"{big[0]})", scene, cfg, ro[rows:].reshape(-1, 3),
                   rd[rows:].reshape(-1, 3), fused=True)
    g = recs[0]["grads"]
    l1 = {"vert_grad_l1": float(g[VERTS].abs().sum()),
          "cam_grad_l1": float(g["['cam_pos']"].abs().sum()
                               + g["['cam_rot']"].abs().sum())}
    out["30"] = {"loss": recs[0]["loss"], **l1, "max_abs_diff": diff,
                 "rank_ms": [r["ms"] for r in recs], "single_ms": s_ms,
                 "launches": counts, "seconds": time.perf_counter() - t_p
                 + r2[0]["30"]["seconds"]}
    print(f"phase 30 dryrun_multichip(2) terrain8 {bkey} spp 2 [{smi}]: loss "
          f"{recs[0]['loss']:.6f}, vert_grad_l1 {l1['vert_grad_l1']:.6f}, "
          f"cam_grad_l1 {l1['cam_grad_l1']:.6f}, grads max abs diff {diff} "
          f"from the single process; per-rank ms (the whole call) "
          f"{[round(r['ms'], 3) for r in recs]} ({note}), single-process "
          f"step {s_ms:.3f} ms; launches (both ranks) {counts}; "
          f"{out['30']['seconds']:.1f} s")
    out["dist_launches"] = dist_launches
    return out


# ---- phases 31-34: the ops surface -----------------------------------------

TEX_ATLAS = 256  # texels a side of the checker atlas of phase 31


def checker_atlas(n):
    """An ``n x n`` RGBA atlas with a colour of its own in every texel (the
    textured fixture of ``tests/test_torch_texture.py``)."""
    x = np.arange(n, dtype=np.float32)[None, :].repeat(n, 0)
    y = np.arange(n, dtype=np.float32)[:, None].repeat(n, 1)
    return np.stack([x / n, y / n, (x + y) / (2 * n),
                     np.ones((n, n), np.float32)], -1)


def textured_scene(scene, mesh=-1, n=TEX_ATLAS):
    """The numpy ``scene`` with mesh ``mesh``'s triangles (the top cube
    type of a terrain) textured: triangle ``k`` of the mesh maps to its own
    63x63 rect of the checker atlas."""
    start = int(scene.mesh_tri_start[mesh])
    count = int(scene.mesh_tri_count[mesh])
    rect = np.array(scene.tri_coord_rect, np.float32)
    degenerate = np.array(scene.tri_coord_degenerate, bool)
    for k in range(count):
        rect[start + k] = [(k % 4) * 64, (k // 4) * 64, 63, 63]
        degenerate[start + k] = False
    return dataclasses.replace(scene, tri_coord_rect=rect,
                               tri_coord_degenerate=degenerate,
                               atlas=checker_atlas(n))


def _texture(dev, smi):
    """Phase 31: texture mapping.  Textured terrain8 on the walk (K1's
    template loop on the textured type, the box path on the other),
    textured terrain6 on the cull (K4's template path) and on the MXU cast
    (K6's uv), at both sizes: each frame (counters reset just before)
    against the ``"torch"`` engine's and the untextured frame; K1/K4/K6
    identical to their plain versions on the frame's primary and shadow
    rays; the 1080p step of textured terrain8 against the ``"torch"``
    engine; frame ms, and K1's and K4's ms per launch on the template path
    beside the box path's.  Returns the numbers for the report."""
    import raytracer_tpu_torch as rtt
    from raytracer_tpu_torch import tree
    from raytracer_tpu_torch.builder import scale_camera
    from raytracer_tpu_torch.diff import (grad_of, make_loss_fn,
                                          trainable_params)
    from raytracer_tpu_torch.render import cuda_engine as ce
    from raytracer_tpu_torch.render import engine as eng
    from raytracer_tpu_torch.render.geometry import expand_geometry

    out = {"frames": {}, "launches": {}, "kernels": {}}
    big = SIZES[-1]
    cells = [("terrain8 walk", WORLD, {}, ("bvh_cast", "bvh_occlude2")),
             ("terrain6 cull", WORLD6, {}, ("cull_cast", "cull_occlude")),
             ("terrain6 mxu", WORLD6, {"pallas_kernel": "mxu"},
              ("mxu_cast",))]
    worlds = {}
    for label, path, change, used in cells:
        t_cell = time.perf_counter()
        w = rtt.generate(path)
        scene = rtt.to_device(textured_scene(w.scene), dev)
        top = scene.inst_mesh == scene.mesh_tri_start.shape[0] - 1
        for s in SIZES:
            key = f"{label} {s[0]}x{s[1]}"
            cam = rtt.to_device(scale_camera(w.camera, s[0],
                                             w.config.width), dev)
            cfg = w.config.replace(width=s[0], height=s[1], engine="cuda",
                                   texture_mapping=True, **change)
            worlds[key] = (scene, cam, cfg)
            img, counts = _counted(key, lambda: eng.render_frame(
                scene, cam, cfg), used)
            ref, plain = _plain_frame(scene, cam, cfg)
            diff = _frame_checks(f"textured {key}", img, ref, s)
            flat_cfg = cfg.replace(texture_mapping=False)
            flat = eng.render_frame(scene, cam, flat_cfg)
            changed = int(((img - flat).abs().amax(-1) > 1e-3).sum())
            if changed < 100:
                raise AssertionError(f"textured {key}: only {changed} "
                                     "pixels differ from the untextured "
                                     "frame")
            ro, rd, _, _ = eng._frame_rays_blocked(cam, cfg)
            _same_as_plain(f"textured {key}", scene, cfg, ro, rd,
                           fused=True, plain=plain)
            del plain
            ms = _ms(lambda: eng.render_frame(scene, cam, cfg))
            ms_flat = _ms(lambda: eng.render_frame(scene, cam, flat_cfg))
            rec = {"max_abs_diff": diff, "changed_pixels": changed,
                   "launches": counts, "frame_ms": ms,
                   "untextured_frame_ms": ms_flat}
            if change.get("pallas_kernel") != "mxu":
                geom = expand_geometry(scene)
                tabs = ce.prepare_cast(scene, geom, cfg)
                is_box = tabs.tables.inst_i32[:, ce._II_IS_BOX] > 0
                if bool(is_box[top].any()) or not bool(is_box[~top].all()):
                    raise AssertionError(f"textured {key}: the textured "
                                         "type must leave the box fast "
                                         "path, the other keep it")
                rec["template_instances"] = int(top.sum())
            out["frames"][key] = rec
            out["launches"][key] = counts
            print(f"phase 31 textured {key} [{smi}]: cuda == torch engine "
                  f"(max abs diff {diff:.3g}), {changed} pixels differ from "
                  f"the untextured frame; launches {counts}; frame "
                  f"{ms:.3f} ms (untextured {ms_flat:.3f} ms; median of "
                  f"{REPS}, CUDA events)")
        print(f"phase 31 {label}: {time.perf_counter() - t_cell:.1f} s")

    # K1 on the textured frame's primary rays: the template path (the
    # textured type) beside the box path (the same rays, untextured tables)
    for s in SIZES:
        key = f"terrain8 walk {s[0]}x{s[1]}"
        scene, cam, cfg = worlds[key]
        geom = expand_geometry(scene)
        ro, rd, _, _ = eng._frame_rays_blocked(cam, cfg)
        rec = {}
        for tname, tcfg in (("template", cfg),
                            ("box", cfg.replace(texture_mapping=False))):
            data = ce.prepare_cast(scene, geom, tcfg)
            rec[f"{tname}_ms"] = _ms(lambda: ce.bvh_cast(ro, rd, data))
            rec[f"{tname}_device_ms"] = _device_ms(
                lambda: ce.bvh_cast(ro, rd, data))
            if s == SIZES[0]:  # the plain version counts the work
                h = ce.bvh_cast(ro, rd, data)
                rec[f"{tname}_bound"] = _bound(
                    _nbytes(ro, rd, h.t, h.wtri, h.uv, h.normal, h.mat,
                            data.tables.inst_f32, data.tables.inst_i32,
                            data.tables.tmpl, data.nodes, data.ordering),
                    _work_ops(_work(ce.bvh_cast_reference, ro, rd, data),
                              closest_hit=True))
        out["kernels"][key] = rec
        bound = ""
        if "template_bound" in rec:
            bound = (f"; bound {rec['template_bound']['bound_ms']:.5f} ms "
                     f"({rec['template_bound']['ops']} FP32 ops) / "
                     f"{rec['box_bound']['bound_ms']:.5f} ms "
                     f"({rec['box_bound']['ops']})")
        print(f"phase 31 K1 on textured {key} [{smi}]: template path "
              f"{rec['template_ms']:.4f} ms / launch (device "
              f"{rec['template_device_ms']:.4f} ms) against the box path's "
              f"{rec['box_ms']:.4f} ms (device {rec['box_device_ms']:.4f} "
              f"ms){bound}")

    # the 1080p fwd+bwd step of textured terrain8
    scene, cam, cfg = worlds[f"terrain8 walk {big[0]}x{big[1]}"]
    target0 = torch.zeros(big[1], big[0], 4, device=dev)

    def step(engine):
        params = trainable_params(scene, cam)
        loss = make_loss_fn(scene, cam, cfg.replace(engine=engine),
                            target0)(params)
        return loss.detach(), grad_of(loss, params)

    (loss_c, g_c), counts = _counted("textured terrain8 1080p step",
                                     lambda: step("cuda"),
                                     ("bvh_cast", "bvh_occlude2"))
    loss_t, g_t = step("torch")
    err = 0.0
    for (key, a), b in zip(tree.leaves_with_paths(g_c), tree.leaves(g_t)):
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"textured step grad {key} not finite")
        torch.testing.assert_close(
            a, b, rtol=RTOL_GRAD, atol=ATOL_GRAD,
            msg=lambda m, key=key: f"textured step grad {key}: {m}")
        err = max(err, float((a - b).abs().max()))
    top_mat = int(scene.tri_mat[int(scene.mesh_tri_start[-1])])
    if float(g_c["materials"].kd[top_mat].abs().max()) != 0.0:
        raise AssertionError("textured step: the textured type's kd took a "
                             "gradient")
    step_ms = _ms(lambda: step("cuda"), reps=STEP_REPS)
    out["step"] = {"loss": float(loss_c), "loss_torch": float(loss_t),
                   "max_abs_grad_diff": err, "launches": counts,
                   "ms": step_ms}
    out["launches"][f"terrain8 walk {big[0]}x{big[1]} step"] = counts
    print(f"phase 31 textured terrain8 {big[0]}x{big[1]} fwd+bwd [{smi}]: "
          f"loss {float(loss_c):.6f} (torch engine {float(loss_t):.6f}), "
          f"grads == torch engine (max abs {err:.3g}; rtol {RTOL_GRAD} atol "
          f"{ATOL_GRAD}), launches {counts}, {step_ms:.3f} ms (median of "
          f"{STEP_REPS})")
    return out


def _probe_pixels(img, img0, height, width):
    """``tests/test_mixed_wavefront.py``'s pick: six pixels whose colour
    the bounces change, spread over the frame, and two plain ones."""
    bounce = np.argwhere(np.abs(img - img0).max(axis=-1) > 1e-3)
    sel = bounce[:: max(1, len(bounce) // 6)][:6].tolist()
    return sel + [[0, 0], [height - 1, width // 2]]


def _probe(dev, smi):
    """Phase 32: the debug probe on the card.  The 1080p terrain8_mixed
    frame; at six of its bounce pixels and two plain ones, ``debug_cast``
    (K1 on 1-ray batches: the casts, the narrated marches, the shading's
    march) with the counters reset just before, its colour against the
    frame pixel at rtol/atol 1e-4, and the 1-ray cast of the pixel's
    primary ray against the same ray inside the frame's batch (every
    output identical); then one terrain8 pixel, whose fused shadow round
    runs K2 on one ray.  Returns the numbers for the report."""
    import contextlib
    import io

    import raytracer_tpu_torch as rtt
    from raytracer_tpu_torch.builder import scale_camera
    from raytracer_tpu_torch.debug import debug_cast
    from raytracer_tpu_torch.render import engine as eng
    from raytracer_tpu_torch.render.geometry import (camera_rays,
                                                     expand_geometry)

    big = SIZES[-1]
    out = {"pixels": {}, "launches": {}}
    cases = [("terrain8_mixed", WORLD_MIXED, ("bvh_cast", "bvh_march"), True),
             ("terrain8", WORLD, ("bvh_cast", "bvh_occlude2"), False)]
    for name, path, used, bounces in cases:
        w = rtt.generate(path)
        scene = rtt.to_device(w.scene, dev)
        cam = rtt.to_device(scale_camera(w.camera, big[0], w.config.width),
                            dev)
        cfg = w.config.replace(width=big[0], height=big[1], engine="cuda")
        img = eng.render_frame(scene, cam, cfg).cpu().numpy()
        lum = img[..., :3].max(-1)
        if bounces:
            img0 = eng.render_frame(scene, cam, cfg.replace(
                recurse_depth=0)).cpu().numpy()
            pixels = _probe_pixels(img, img0, big[1], big[0])
        else:
            hits = np.argwhere(lum > 0)
            pixels = [hits[len(hits) // 2].tolist()]
        geom = expand_geometry(scene)
        cast = eng.make_cast(scene, geom, cfg)
        ro, rd = camera_rays(cam, big[0], big[1])
        with torch.no_grad():
            frame_hits = cast(ro.reshape(-1, 3), rd.reshape(-1, 3))
        for y, x in pixels:
            label = f"probe {name} ({x}, {y})"
            # a pixel whose primary ray misses shades nothing: no shadow
            # query and no march
            hit = bool(frame_hits.valid[y * big[0] + x])
            said = io.StringIO()
            with contextlib.redirect_stdout(said):
                (recs, color), counts = _counted(
                    label, lambda: debug_cast(scene, cam, cfg, x, y),
                    used if hit else ("bvh_cast",))
            err = float(np.abs(color - img[y, x]).max())
            if not np.allclose(color, img[y, x], rtol=1e-4, atol=1e-4):
                raise AssertionError(f"{label}: colour {color} against the "
                                     f"frame's {img[y, x]}")
            with torch.no_grad():
                one = cast(ro[y, x][None].contiguous(),
                           rd[y, x][None].contiguous())
            i = y * big[0] + x
            for field in ("valid", "t", "wtri", "uv", "normal", "mat"):
                a = getattr(one, field)[0]
                b = getattr(frame_hits, field)[i]
                if not torch.equal(a, b):
                    raise AssertionError(f"{label}: the 1-ray cast's {field} "
                                         f"{a} differs from the frame "
                                         f"batch's {b}")
            lines = said.getvalue().splitlines()
            levels = max(r["level"] for r in recs)
            out["pixels"][label] = {"color": color.tolist(),
                                    "frame": img[y, x].tolist(),
                                    "max_abs_diff": err, "records": len(recs),
                                    "deepest_level": levels,
                                    "narration_lines": len(lines),
                                    "launches": counts}
            out["launches"][label] = counts
            print(f"phase 32 {label} [{smi}]: colour == frame pixel (max abs "
                  f"diff {err:.3g}; rtol/atol 1e-4), {len(recs)} rays to "
                  f"level {levels}, {len(lines)} narration lines, launches "
                  f"{counts}; the 1-ray cast == the frame batch's hit")
        print(f"  last narration lines: {lines[-3:]}")
    return out


def _trace_device(path):
    """Device busy ms, the traced span's ms and the kernels' names of a
    Chrome trace written by ``tracing.profile_trace``."""
    with open(path) as fh:
        events = [e for e in json.load(fh)["traceEvents"] if "dur" in e
                  and "ts" in e]
    device = [e for e in events
              if e.get("cat") in ("kernel", "gpu_memset", "gpu_memcpy")]
    span_us = (max(e["ts"] + e["dur"] for e in events)
               - min(e["ts"] for e in events))
    return (sum(e["dur"] for e in device) / 1e3, span_us / 1e3,
            {e["name"] for e in device if e.get("cat") == "kernel"})


def _ops_cli(dev, smi, tmp):
    """Phase 33: ``cli.main`` in this process: 2 training steps of terrain8
    at 1920x1080 under ``--profile-dir`` (counters reset just before; the
    trace must name K1's and K2's kernels; device busy ms and idle share
    read from it), then one ``-b --wavefront-cap 0.5 -r`` bench of
    terrain8_stress at 640x480.  Returns the numbers for the report."""
    import contextlib
    import io

    from raytracer_tpu_torch import cli

    big, main = SIZES[-1], SIZES[0]
    prof_dir = os.path.join(tmp, "profile")
    argv = ["-c", WORLD, "--width", str(big[0]), "--height", str(big[1]),
            "--train", "2", "--checkpoint", os.path.join(tmp, "prof.npz"),
            "--profile-dir", prof_dir]
    t0 = time.perf_counter()
    rc, counts = _counted("cli --profile-dir", lambda: cli.main(argv),
                          ("bvh_cast", "bvh_occlude2"))
    wall_s = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"cli --profile-dir returned {rc}")
    (trace,) = os.listdir(prof_dir)
    busy_ms, span_ms, names = _trace_device(os.path.join(prof_dir, trace))
    for kernel in ("bvh_cast_kernel", "bvh_occlude2_kernel"):
        if not any(kernel in n for n in names):
            raise AssertionError(f"the trace names no {kernel}")
    out = {"profile": {"launches": counts, "device_busy_ms": busy_ms,
                       "traced_ms": span_ms,
                       "idle_share": 1.0 - busy_ms / span_ms,
                       "kernels_named": len(names), "wall_s": wall_s}}
    print(f"phase 33 cli --train 2 --profile-dir, terrain8 {big[0]}x"
          f"{big[1]} [{smi}]: launches {counts}; trace {trace}: "
          f"{len(names)} kernel names (bvh_cast_kernel, "
          f"bvh_occlude2_kernel among them), device busy {busy_ms:.3f} ms of "
          f"{span_ms:.3f} ms traced (2 steps), idle share "
          f"{out['profile']['idle_share']:.3f}")
    argv = ["-c", WORLD_STRESS, "-b", "--wavefront-cap", "0.5", "-r",
            "--width", str(main[0]), "--height", str(main[1])]
    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        rc, counts = _counted("cli -b --wavefront-cap 0.5 -r",
                              lambda: cli.main(argv),
                              ("bvh_cast", "bvh_occlude2"))
    lines = said.getvalue().splitlines()
    times = [line for line in lines if line.startswith("Time:")]
    if rc != 0 or len(times) != 1:
        raise AssertionError(f"cli -b returned {rc}: {lines}")
    bench = json.loads(lines[-1])
    out["bench"] = {"launches": counts, "frame_ms": bench["value"],
                    "line": times[0]}
    print(f"phase 33 cli -b --wavefront-cap 0.5 -r, terrain8_stress "
          f"{main[0]}x{main[1]} [{smi}]: {times[0]} (one frame after a "
          f"warm-up, CUDA events); launches {counts}")
    return out


def _elastic(dev, smi, tmp):
    """Phase 34: ``cli.main --elastic 1 --train-until 3 --checkpoint-every
    1`` on terrain8 at 640x480 with ``RT_FAULT_AT_STEP=2``: the worker
    (a process of its own on the card) crashes with code 13 after step 2,
    the supervisor restarts it from the checkpoint, and the final
    checkpoint matches an uninterrupted run in this process at rtol 1e-4 /
    atol 1e-6 (the backward's index_add_ adds with atomics on the card).
    Returns the numbers for the report."""
    import contextlib
    import io

    from raytracer_tpu_torch import cli

    main = SIZES[0]
    t0 = time.perf_counter()
    base = ["-c", WORLD, "--width", str(main[0]), "--height", str(main[1]),
            "--checkpoint-every", "1", "--train-until", "3"]
    clean = os.path.join(tmp, "clean.npz")
    elastic = os.path.join(tmp, "elastic.npz")
    if cli.main(base + ["--checkpoint", clean]) != 0:
        raise AssertionError("the uninterrupted run failed")
    fault = {"RT_FAULT_AT_STEP": "2",
             "RT_FAULT_MARKER": os.path.join(tmp, "crashed.marker")}
    os.environ.update(fault)
    said = io.StringIO()
    try:
        with contextlib.redirect_stderr(said):
            rc = cli.main(base + ["--checkpoint", elastic, "--elastic", "1",
                                  "--hang-timeout", "120"])
    finally:
        for k in fault:
            del os.environ[k]
    err = said.getvalue()
    for needed in ('"fault_injected"', "crash rc=13", '"elastic_restart"',
                   '"checkpoint_restored"', '"elastic_done"'):
        if needed not in err:
            raise AssertionError(f"elastic run: no {needed} in its log")
    if rc != 0:
        raise AssertionError(f"elastic run returned {rc}")
    with np.load(clean) as a, np.load(elastic) as b:
        if int(a["__step__"]) != 3 or int(b["__step__"]) != 3:
            raise AssertionError("a checkpoint did not reach step 3")
        keys = sorted(k for k in a.files if k.startswith("arr_"))
        if keys != sorted(k for k in b.files if k.startswith("arr_")):
            raise AssertionError("the checkpoints hold other leaves")
        diff = 0.0
        for k in keys:
            np.testing.assert_allclose(b[k], a[k], rtol=RTOL_GRAD,
                                       atol=ATOL_GRAD, err_msg=k)
            diff = max(diff, float(np.abs(b[k] - a[k]).max()))
    seconds = time.perf_counter() - t0
    print(f"phase 34 elastic terrain8 {main[0]}x{main[1]} [{smi}]: crash "
          f"rc=13 after step 2, restarted, final checkpoint == the "
          f"uninterrupted run's (max abs diff {diff:.3g}; rtol {RTOL_GRAD} "
          f"atol {ATOL_GRAD}); {seconds:.1f} s")
    return {"max_abs_diff": diff, "seconds": seconds,
            "log_lines": len(err.splitlines())}


# ---- phases 35-37: the fly-through, the interactive loop, the viewer and
# the native library ---------------------------------------------------------
ORBIT_FRAMES = 30  # phase 35's fly-through
ORBIT_TIMED = 10  # ... of which the first are timed in parts
ORBIT_LIGHTS3_FRAMES = 10
# phase 36's probe pixels: the frame's centre (sky on terrain6 after the
# moves) and a terrain pixel below it
CLICKS = [(320, 240), (320, 360)]
NATIVE_SIZE = 1024  # phase 37's synthetic PNG: NATIVE_SIZE^2 RGBA


def _cli_lines(label, argv, used, stdin=None):
    """``cli.main(argv)`` in this process, stdout captured (``stdin``: the
    lines fed to it), launch counters reset just before.  Returns ``(lines,
    counts)``."""
    import contextlib
    import io

    from raytracer_tpu_torch import cli

    said, old_stdin = io.StringIO(), sys.stdin
    if stdin is not None:
        sys.stdin = io.StringIO(stdin)
    try:
        with contextlib.redirect_stdout(said):
            rc, counts = _counted(label, lambda: cli.main(argv), used)
    finally:
        sys.stdin = old_stdin
    lines = said.getvalue().splitlines()
    if rc != 0:
        raise AssertionError(f"{label}: cli returned {rc}: {lines[-5:]}")
    return lines, counts


def _fps_of(label, lines, n_frames):
    """The ``FPS: x`` windows of an ``--orbit`` run."""
    fps = [float(x.split()[1]) for x in lines if x.startswith("FPS: ")]
    if len(fps) != n_frames // 5 or f"wrote {n_frames} frames to" not in \
            "\n".join(lines):
        raise AssertionError(f"{label}: {len(fps)} FPS lines: {lines[-8:]}")
    return fps


def _orbit(dev, smi, tmp):
    """Phase 35: the fly-through.  ``python -m raytracer_tpu_torch.cli
    --orbit 30`` on terrain8 at 1920x1080 as a process of its own (30 PNGs,
    the FPS lines, its last frame equal to this process's render of the
    same camera); ``camera_motion.orbit_frames`` on the card: frames 0 and
    29 at 640x480 against the ``"torch"`` engine (atol 1e-5), K1 and K2
    identical to their plain versions on frame 29's primary rays and shadow
    queries; ``cli.main --orbit 30`` at 640x480 in this process (counters
    reset just before: one K1 and one K2 a frame) and ``--orbit 10`` on
    terrain8_lights3 (K1 and K3; frame 9 against the ``"torch"`` engine,
    K3 against its plain version); at both sizes, over the first 10 orbit
    cameras, the render-only ms a frame (CUDA events), the frame's u8 copy
    to the host and ``write_png`` (host clock).  Returns the numbers for
    the report."""
    import raytracer_tpu_torch as rtt
    from raytracer_tpu_torch import camera_motion as cm
    from raytracer_tpu_torch.builder import scale_camera
    from raytracer_tpu_torch.pngio import read_png, write_png
    from raytracer_tpu_torch.render import engine as eng

    main, big = SIZES[0], SIZES[-1]
    walk = ("bvh_cast", "bvh_occlude2")
    out = {"launches": {}, "fps": {}, "per_frame_ms": {}}
    n = ORBIT_FRAMES

    # the 1080p fly-through as a user runs it
    frames_dir = os.path.join(tmp, "orbit")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "raytracer_tpu_torch.cli", "-c", WORLD,
         "--orbit", str(n), "--width", str(big[0]), "--height", str(big[1]),
         "--out-dir", frames_dir], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"cli --orbit {n} exited {proc.returncode}: "
                             f"{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
    big_key = f"{big[0]}x{big[1]}"
    fps = _fps_of(f"cli --orbit {n} {big_key}", proc.stdout.splitlines(), n)
    names = sorted(os.listdir(frames_dir))
    if names != [f"frame_{i:04d}.png" for i in range(n)]:
        raise AssertionError(f"cli --orbit {n}: wrote {names}")
    out["fps"][big_key] = fps
    out["process_s"] = wall

    w = rtt.generate(WORLD)
    scene = rtt.to_device(w.scene, dev)
    cams, cfgs = {}, {}
    for s in SIZES:
        cam = rtt.to_device(scale_camera(w.camera, s[0], w.config.width), dev)
        cams[s] = list(cm.orbit_frames(cam, n))
        cfgs[s] = w.config.replace(width=s[0], height=s[1], engine="cuda")
        if cams[s][-1].rot.device != cam.rot.device:
            raise AssertionError("orbit_frames left the camera's device")
    with torch.no_grad():
        last = eng.frame_to_u8(eng.render_frame(scene, cams[big][-1],
                                                cfgs[big])).cpu().numpy()
    png = read_png(os.path.join(frames_dir, names[-1]))
    if not np.array_equal(png[..., :3], last[..., :3]):
        raise AssertionError(f"cli --orbit {big_key}: frame {n - 1} differs "
                             "from this process's render of its camera on "
                             f"{int((png[..., :3] != last[..., :3]).sum())} "
                             "values")

    # frames 0 and 29 against the "torch" engine; K1 and K2 against plain
    diffs = {}
    for i in (0, n - 1):
        with torch.no_grad():
            img = eng.render_frame(scene, cams[main][i], cfgs[main])
        ref, plain = _plain_frame(scene, cams[main][i], cfgs[main])
        diffs[i] = _frame_checks(f"orbit frame {i}", img, ref, main)
    ro, rd, _, _ = eng._frame_rays_blocked(cams[main][-1], cfgs[main])
    _same_as_plain(f"phase 35 orbit frame {n - 1} {main[0]}x{main[1]}",
                   scene, cfgs[main], ro, rd, fused=True, plain=plain)
    del plain
    out["max_abs_diff"] = max(diffs.values())

    # the CLI's fly-through in this process: launches and FPS at 640x480
    main_key = f"{main[0]}x{main[1]}"
    lines, counts = _cli_lines(
        f"orbit {main_key}", ["-c", WORLD, "--orbit", str(n), "--width",
                              str(main[0]), "--height", str(main[1]),
                              "--out-dir", os.path.join(tmp, "orbit_main")],
        walk)
    if counts != {k: n for k in walk}:
        raise AssertionError(f"orbit {main_key}: launches {counts}, not one "
                             "K1 and one K2 a frame")
    out["fps"][main_key] = _fps_of(f"orbit {main_key}", lines, n)
    out["launches"][f"orbit {main_key}"] = counts

    # terrain8_lights3: the per-light path (K3)
    m3 = ORBIT_LIGHTS3_FRAMES
    lines, counts = _cli_lines(
        f"orbit terrain8_lights3 {main_key}",
        ["-c", WORLD_LIGHTS3, "--orbit", str(m3), "--width", str(main[0]),
         "--height", str(main[1]), "--out-dir",
         os.path.join(tmp, "orbit_lights3")], ("bvh_cast", "bvh_occlude"))
    out["fps"][f"terrain8_lights3 {main_key}"] = _fps_of(
        "orbit terrain8_lights3", lines, m3)
    out["launches"][f"orbit terrain8_lights3 {main_key}"] = counts
    w3 = rtt.generate(WORLD_LIGHTS3)
    scene3 = rtt.to_device(w3.scene, dev)
    cfg3 = w3.config.replace(width=main[0], height=main[1], engine="cuda")
    *_, cam3 = cm.orbit_frames(rtt.to_device(scale_camera(
        w3.camera, main[0], w3.config.width), dev), m3)
    with torch.no_grad():
        img3 = eng.render_frame(scene3, cam3, cfg3)
        ref3 = eng.render_frame(scene3, cam3, cfg3.replace(engine="torch"))
    out["lights3_max_abs_diff"] = _frame_checks("orbit terrain8_lights3",
                                                img3, ref3, main)
    ro3, rd3, _, _ = eng._frame_rays_blocked(cam3, cfg3)
    _same_as_plain(f"phase 35 orbit terrain8_lights3 frame {m3 - 1}",
                   scene3, cfg3, ro3, rd3, fused=False)

    # where a frame's time goes: the render, the u8 copy, the PNG encode
    for s in SIZES:
        key = f"{s[0]}x{s[1]}"
        render, host, encode = [], [], []
        path = os.path.join(tmp, f"timed_{key}.png")
        for cam in cams[s][:ORBIT_TIMED]:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            with torch.no_grad():
                start.record()
                img = eng.render_frame(scene, cam, cfgs[s])
                end.record()
                end.synchronize()
                t1 = time.perf_counter()
                u8 = eng.frame_to_u8(img).cpu().numpy()
            t2 = time.perf_counter()
            write_png(path, u8[..., :3])
            t3 = time.perf_counter()
            render.append(start.elapsed_time(end))
            host.append((t2 - t1) * 1e3)
            encode.append((t3 - t2) * 1e3)
        rec = {"render_ms": statistics.median(render),
               "to_host_ms": statistics.median(host),
               "write_png_ms": statistics.median(encode),
               "fps": out["fps"][key]}
        out["per_frame_ms"][key] = rec
        print(f"phase 35 orbit terrain8 {key} [{smi}]: FPS {rec['fps']} "
              "(windows of 5 frames; "
              + ("a process of its own, " if s == big else "")
              + "render, u8 copy and PNG encode); per frame, median of "
              f"{ORBIT_TIMED}: "
              f"render {rec['render_ms']:.3f} ms (CUDA events), u8 to host "
              f"{rec['to_host_ms']:.3f} ms, write_png "
              f"{rec['write_png_ms']:.3f} ms (host clock)")
    print(f"phase 35 [{smi}]: orbit frames 0 and {n - 1} == torch engine "
          f"(max abs diff {out['max_abs_diff']:.3g}), the {big_key} "
          f"process's frame {n - 1} == this process's render, launches "
          f"{out['launches']}; terrain8_lights3 frame {m3 - 1} == torch "
          f"engine (max abs diff {out['lights3_max_abs_diff']:.3g}), FPS "
          f"{out['fps'][f'terrain8_lights3 {main_key}']}; the {big_key} "
          f"process {wall:.1f} s")
    return out


def _interactive(dev, smi, tmp):
    """Phase 36: ``cli.main --interactive`` on terrain6 at 640x480 (the
    cull: K4 and K5) in this process, fed ``w``, ``a``, ``mouse 5 -3``,
    ``click 320 240``, ``click 320 360``, ``bogus``, ``quit`` on stdin,
    counters reset just before: three frames, ``? bogus`` and
    ``Exiting...`` printed; the written frame equal to a ``"torch"``-engine
    render of the camera moved by ``camera_motion``, each probe's printed
    colour equal to that frame's pixel at 1e-4 (the second pixel a hit);
    K4 and K5 identical to their plain versions on the moved camera's
    primary rays and shadow queries; the second probe alone, counted.
    Returns the numbers for the report."""
    import contextlib
    import io

    import raytracer_tpu_torch as rtt
    from raytracer_tpu_torch import camera_motion as cm
    from raytracer_tpu_torch.builder import scale_camera
    from raytracer_tpu_torch.debug import debug_cast
    from raytracer_tpu_torch.pngio import read_png
    from raytracer_tpu_torch.render import engine as eng

    main = SIZES[0]
    key = f"{main[0]}x{main[1]}"
    cull = ("cull_cast", "cull_occlude")
    frame_path = os.path.join(tmp, "interactive.png")
    script = "w\na\nmouse 5 -3\n" + "".join(
        f"click {x} {y}\n" for x, y in CLICKS) + "bogus\nquit\n"
    lines, counts = _cli_lines(
        f"interactive terrain6 {key}",
        ["-c", WORLD6, "--interactive", "--width", str(main[0]), "--height",
         str(main[1]), "-o", frame_path], cull, stdin=script)
    frame_ms = [float(x.split()[1]) for x in lines
                if x.startswith("frame: ")]
    if len(frame_ms) != 3 or "? bogus" not in lines or \
            lines[-1] != "Exiting...":
        raise AssertionError(f"interactive: {lines[-12:]}")

    w = rtt.generate(WORLD6)
    scene = rtt.to_device(w.scene, dev)
    cfg = w.config.replace(width=main[0], height=main[1], engine="cuda")
    cam = rtt.to_device(scale_camera(w.camera, main[0], w.config.width), dev)
    moved = cm.mouse_look(cm.key_move(cm.key_move(cam, "w"), "a"), 5, -3)
    ref, plain = _plain_frame(scene, moved, cfg)
    want = eng.frame_to_u8(ref).cpu().numpy()[..., :3]
    got = read_png(frame_path)[..., :3]
    if not np.array_equal(got, want):
        raise AssertionError(f"interactive: the written frame differs from "
                             f"the torch engine's on "
                             f"{int((got != want).sum())} values")
    clicks = {}
    for x, y in CLICKS:
        (said,) = [line for line in lines
                   if line.startswith(f"pixel ({x}, {y}) final color:")]
        color = np.array(said.split("[")[1].rstrip("]").split(), np.float32)
        pixel = ref[y, x].cpu().numpy()
        if not np.allclose(color, pixel, rtol=1e-4, atol=1e-4):
            raise AssertionError(f"interactive click ({x}, {y}): colour "
                                 f"{color} against the frame's {pixel}")
        clicks[(x, y)] = {"color": color.tolist(),
                          "max_abs_diff": float(np.abs(color - pixel).max()),
                          "hit": bool(pixel[:3].max() > 0)}
    if not clicks[CLICKS[-1]]["hit"]:
        raise AssertionError(f"interactive click {CLICKS[-1]}: not a hit")
    ro, rd, _, _ = eng._frame_rays_blocked(moved, cfg)
    _same_as_plain(f"phase 36 interactive terrain6 {key}", scene, cfg, ro, rd,
                   fused=True, plain=plain)
    del plain
    with contextlib.redirect_stdout(io.StringIO()):
        (_, color2), probe_counts = _counted(
            "interactive probe", lambda: debug_cast(scene, moved, cfg,
                                                    *CLICKS[-1]), cull)
    if color2.tolist() != clicks[CLICKS[-1]]["color"]:
        raise AssertionError("the probe in this process gives another colour")
    out = {"launches": {f"interactive terrain6 {key}": counts,
                        f"probe terrain6 {CLICKS[-1]}": probe_counts},
           "frame_ms": frame_ms,
           "clicks": {f"{x},{y}": v for (x, y), v in clicks.items()}}
    print(f"phase 36 interactive terrain6 {key} [{smi}]: w, a, mouse 5 -3 "
          f"rendered in {frame_ms} ms a command (render, u8 copy, "
          f"write_png; host clock), the frame == torch engine's render of "
          f"the moved camera (u8), each click's colour == its frame pixel "
          + ", ".join(f"{c} max abs diff {v['max_abs_diff']:.3g} "
                      f"({'a hit' if v['hit'] else 'sky'})"
                      for c, v in clicks.items())
          + f"; '? bogus', 'Exiting...'; launches {counts}, the probe "
          f"{CLICKS[-1]} alone {probe_counts}")
    return out


def _native_times(tmp):
    """Phase 37's native-library timing, after the viewer's process has
    ended (host clock): a seeded NATIVE_SIZE x NATIVE_SIZE RGBA PNG (in
    ``tmp``) whose rows cycle through the filter types 0-4, read by
    ``read_png`` with the native unfilter (median of 5) and with the Python
    loop (once), the images compared; the unfilter alone natively (median
    of 5).  Returns the numbers."""
    import struct
    import zlib

    from raytracer_tpu_torch import native, pngio

    n = NATIVE_SIZE
    rng = np.random.default_rng(0)
    rows = rng.integers(0, 256, (n, 4 * n), dtype=np.uint8)
    raw = b"".join(bytes([y % 5]) + rows[y].tobytes() for y in range(n))

    def chunk(ctype, payload):
        body = ctype + payload
        return (struct.pack(">I", len(payload)) + body
                + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))

    png = os.path.join(tmp, "native.png")
    with open(png, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n"
                 + chunk(b"IHDR", struct.pack(">IIBBBBB", n, n, 8, 6, 0, 0, 0))
                 + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))

    def timed(fn, reps):
        times, res = [], None
        for _ in range(reps):
            t0 = time.perf_counter()
            res = fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return res, statistics.median(times)

    rec = {"available": native.available(), "build_log": native.build_log()}
    if rec["available"]:
        img, rec["read_png_native_ms"] = timed(lambda: pngio.read_png(png), 5)
        _, rec["unfilter_native_ms"] = timed(
            lambda: native.png_unfilter(raw, n, 4 * n, 4), 5)
        nat = native.png_unfilter
        native.png_unfilter = lambda *a: None
        try:
            img_py, rec["read_png_python_ms"] = timed(
                lambda: pngio.read_png(png), 1)
        finally:
            native.png_unfilter = nat
        rec["equal"] = bool(np.array_equal(img, img_py))
        rec["shape"] = list(img.shape)
    return rec


def _viewer_native(dev, smi, tmp):
    """Phase 37: ``python -m raytracer_tpu_torch.live_viewer -c terrain8
    --width 640 --height 480 --selftest`` on the card (``selftest OK``, its
    FPS and render ms a frame), then the native library: built and loaded
    on this machine (``native.available()``), and ``_native_times``:
    ``read_png`` equal with and without it, both times.  Returns the
    numbers for the report."""
    import socket

    from raytracer_tpu_torch import native

    main = SIZES[0]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "raytracer_tpu_torch.live_viewer", "-c", WORLD,
         "--width", str(main[0]), "--height", str(main[1]), "--port",
         str(port), "--selftest"], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    wall = time.perf_counter() - t0
    said = [x for x in proc.stdout.splitlines() if x.startswith("selftest OK")]
    if proc.returncode != 0 or not said:
        raise AssertionError(f"live_viewer --selftest exited "
                             f"{proc.returncode}: {proc.stdout[-2000:]}"
                             f"{proc.stderr[-2000:]}")
    stats = dict(kv.split("=") for kv in said[0].split()[2:])
    out = {"viewer": {k: float(v) for k, v in stats.items()},
           "viewer_process_s": wall}
    print(f"phase 37 live_viewer terrain8 {main[0]}x{main[1]} --selftest "
          f"[{smi}]: {said[0]} (FPS of the last 5-frame window of moves, "
          f"render_ms: render + u8 copy + PNG encode at level 1); the "
          f"process {wall:.1f} s")

    if not native.available():
        raise AssertionError(f"the native library did not build:\n"
                             f"{native.build_log()}")
    rec = _native_times(tmp)
    if not rec.get("available") or not rec.get("equal"):
        raise AssertionError(f"native read_png: {rec}")
    out["native"] = rec
    print(f"phase 37 native library [{smi} host]: "
          f"{os.path.basename(str(native.library_path()))} loaded; read_png "
          f"of a {rec['shape'][1]}x{rec['shape'][0]} RGBA PNG, rows cycling "
          f"filter types 0-4: native {rec['read_png_native_ms']:.3f} ms "
          f"(median of 5; the unfilter alone "
          f"{rec['unfilter_native_ms']:.3f} ms), Python "
          f"{rec['read_png_python_ms']:.1f} ms (once), images equal")
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
    plain_ms = {}  # (kernel, tables, rays): the checks' plain calls, timed
    big = SIZES[-1]
    big_key = f"{big[0]}x{big[1]}"
    ro_b, rd_b, _, _ = _frame_rays_blocked(cams[big], cfgs[big])
    rays = {f"primary {main_key}": (ro, rd),
            f"random {N_RANDOM}": (o_rand, d_rand),
            "degenerate": _degenerate(o_rand, d_rand,
                                      data.tables.inst_f32[:, :6])}
    for tname, tdata in (("box", data), ("template", data_tmpl)):
        todo = dict(rays)
        if tname == "box":
            todo[f"primary {big_key}"] = (ro_b, rd_b)
        for rname, (o, d) in todo.items():
            hk = ce.bvh_cast(o, d, tdata)
            hp, plain_ms[("k1", tname, rname)] = _timed(
                lambda: ce.bvh_cast_reference(o, d, tdata))
            errs["bvh_cast"] = max(errs["bvh_cast"], _compare_hits(
                f"K1 {tname}/{rname}", hk, hp))
            print(f"K1 {tname:8s} {rname:18s}: {int(hk.valid.sum())} hits, "
                  "every output identical to plain")

    # ---- phase 4: K2 against its plain version ------------------------------
    def shadow_queries(o, d):  # a frame's two queries, as K2's inputs
        hk = ce.bvh_cast(o, d, data)
        t_safe = torch.where(hk.valid, hk.t, 1.0)
        q = shadow_rays(scene, o + t_safe[:, None] * d, hk.valid)
        return (q[0], q[1], q[2], q[3], q[4].contiguous(),
                torch.full_like(q[2], float("inf")))

    occ_inputs = shadow_queries(ro, rd)
    o1, d1, dist = occ_inputs[:3]
    mt_rand = torch.from_numpy(np.random.default_rng(2).uniform(
        0.5, 12.0, N_RANDOM).astype(np.float32)).to(dev)
    inf_rand = torch.full_like(mt_rand, float("inf"))
    o_deg, d_deg = rays["degenerate"]
    # K2's inputs: query 1 at finite max_t, query 2 at +inf
    occ_sets = {
        f"shadow {main_key}": occ_inputs,
        f"shadow {big_key}": shadow_queries(ro_b, rd_b),
        f"random {N_RANDOM}": (o_rand, d_rand, mt_rand, o_rand,
                               (-d_rand).contiguous(), inf_rand),
        "degenerate": (o_deg, d_deg, mt_rand, o_deg, d_deg, inf_rand)}
    occ_plain = {}  # K2's plain masks, K3's plain version's too (phase 6)
    for tname, tdata in (("box", data), ("template", data_tmpl)):
        for sname, q in occ_sets.items():
            bk = ce.bvh_occlude2(*q, tdata)
            bp, plain_ms[("k2", tname, sname)] = _timed(
                lambda: ce.bvh_occlude2_reference(*q, tdata))
            occ_plain[(tname, sname)] = bp
            for k in range(2):
                if not torch.equal(bk[k], bp[k]):
                    n = int((bk[k] != bp[k]).sum())
                    raise AssertionError(f"K2 {tname}/{sname}: query {k + 1} "
                                         f"mask differs on {n} rays")
                errs["bvh_occlude2"] = max(
                    errs["bvh_occlude2"],
                    float((bk[k].float() - bp[k].float()).abs().max()))
            print(f"K2 {tname:8s} {sname:18s}: blocked {int(bk[0].sum())} "
                  f"(finite max_t) + {int(bk[1].sum())} (+inf max_t) of "
                  f"{q[0].shape[0]} rays, masks identical")

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
    torch_ms = {}  # the "torch" engine's frame: its comparison's call
    for s in SIZES:
        img = frames[s]
        ref, torch_ms[s] = _timed(lambda: render_frame(
            scene, cams[s], cfgs[s].replace(engine="torch")))
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
    walk_inputs = {}  # per size: primary rays and their shadow queries
    for s in SIZES:
        key = f"{s[0]}x{s[1]}"
        ms_cuda = _ms(lambda: render_frame(scene, cams[s], cfgs[s]))
        ms_torch = torch_ms[s]
        rays_n = s[0] * s[1]
        timing[key] = {"frame_ms_cuda": ms_cuda, "frame_ms_torch": ms_torch,
                       "primary_mrays_per_s_cuda": rays_n / ms_cuda / 1e3}
        ro_s, rd_s, _, _ = _frame_rays_blocked(cams[s], cfgs[s])
        occ = occ_sets[f"shadow {key}"]
        walk_inputs[key] = (ro_s, rd_s, occ)
        timing[key].update({
            "k1_ms": _ms(lambda: ce.bvh_cast(ro_s, rd_s, data)),
            "k1_plain_ms": plain_ms[("k1", "box", f"primary {key}")],
            "k2_ms": _ms(lambda: ce.bvh_occlude2(*occ, data)),
            "k2_plain_ms": plain_ms[("k2", "box", f"shadow {key}")],
            "k1_device_ms": _device_ms(lambda: ce.bvh_cast(ro_s, rd_s,
                                                           data)),
            "k2_device_ms": _device_ms(lambda: ce.bvh_occlude2(*occ, data)),
            "k3_device_ms": _device_ms(lambda: ce.bvh_occlude(*occ[:3],
                                                              data)),
        })
        t = timing[key]
        print(f"time {key} [{smi}]: frame cuda {t['frame_ms_cuda']:.3f} ms "
              f"/ torch {t['frame_ms_torch']:.3f} ms (once); K1 "
              f"{t['k1_ms']:.4f} ms / plain {t['k1_plain_ms']:.3f} ms; K2 "
              f"{t['k2_ms']:.4f} ms / plain {t['k2_plain_ms']:.3f} ms (median "
              f"of {REPS} / once); device "
              f"time alone K1 {t['k1_device_ms']:.4f}, K2 "
              f"{t['k2_device_ms']:.4f}, K3 {t['k3_device_ms']:.4f} ms")
    # ---- phase 6: K3 against its plain version and K2 -----------------------
    errs["bvh_occlude"] = 0.0
    for tname, tdata in (("box", data), ("template", data_tmpl)):
        for sname, q in occ_sets.items():
            pair = ce.bvh_occlude2(*q, tdata)
            for k, lname in enumerate(("finite max_t", "+inf max_t")):
                bk = ce.bvh_occlude(*q[3 * k:3 * k + 3], tdata)
                bp = occ_plain[(tname, sname)][k]
                if tname == "box" and sname == f"shadow {main_key}":
                    own, plain_ms[("k3", k)] = _timed(
                        lambda: ce.bvh_occlude_reference(*q[3 * k:3 * k + 3],
                                                         tdata))
                    if not torch.equal(own, bp):
                        raise AssertionError(
                            f"K3's plain version differs from K2's on query "
                            f"{k + 1} of {sname} on "
                            f"{int((own != bp).sum())} rays")
                torch.cuda.synchronize()
                for other, what in ((bp, "its plain version"),
                                    (pair[k], f"K2 query {k + 1}")):
                    if not torch.equal(bk, other):
                        n = int((bk != other).sum())
                        raise AssertionError(
                            f"K3 {tname}/{sname}/{lname}: mask differs from "
                            f"{what} on {n} rays")
                errs["bvh_occlude"] = max(errs["bvh_occlude"], float(
                    (bk.float() - bp.float()).abs().max()))
            print(f"K3 {tname:8s} {sname:18s}: both queries identical to "
                  "plain and to K2")

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
    (loss_t, g_t), step_ms_torch = _timed(lambda: loss_and_grads(
        "torch", trainable_params(scene, cams[big])))
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
    k3_in = (o1, d1, dist)
    timing[main_key].update({
        "k3_ms": _ms(lambda: ce.bvh_occlude(*k3_in, data)),
        "k3_plain_ms": plain_ms[("k3", 0)],
    })
    timing[big_key].update({
        "fwd_bwd_ms_cuda": step_ms, "fwd_bwd_ms_torch": step_ms_torch,
        "fwd_bwd_mrays_per_s_cuda": big[0] * big[1] / step_ms / 1e3,
    })
    t = timing[main_key]
    print(f"time {main_key} [{smi}]: K3 {t['k3_ms']:.4f} ms / plain "
          f"{t['k3_plain_ms']:.3f} ms (median of {REPS} / once)")
    t = timing[big_key]
    print(f"time {big_key} [{smi}]: fwd+bwd step cuda {step_ms:.3f} ms "
          f"({t['fwd_bwd_mrays_per_s_cuda']:.2f} Mrays/s, median of {REPS}) "
          f"/ torch engine {step_ms_torch:.3f} ms (once)")
    report["profile"] = _profile(fwd_bwd("cuda"), smi)

    # ---- bounds of K1-K3 (terrain8) at both sizes ---------------------------
    tab8 = _nbytes(data.tables.inst_f32, data.tables.inst_i32,
                   data.tables.tmpl, data.nodes, data.ordering)
    bounds_at = {}
    for key, (ro_s, rd_s, occ) in walk_inputs.items():
        h1 = ce.bvh_cast(ro_s, rd_s, data)
        b2 = ce.bvh_occlude2(*occ, data)
        b3 = ce.bvh_occlude(*occ[:3], data)
        bounds_at[key] = {
            "bvh_cast": _bound(
                _nbytes(ro_s, rd_s, h1.t, h1.wtri, h1.uv, h1.normal, h1.mat)
                + tab8, _work_ops(_work(ce.bvh_cast_reference, ro_s, rd_s,
                                        data), closest_hit=True)),
            "bvh_occlude2": _bound(
                _nbytes(*occ, *b2) + tab8,
                _work_ops(_work(ce.bvh_occlude2_reference, *occ, data),
                          closest_hit=False)),
            "bvh_occlude": _bound(
                _nbytes(*occ[:3], b3) + tab8,
                _work_ops(_work(ce.bvh_occlude_reference, *occ[:3], data),
                          closest_hit=False)),
        }
        for name, b in bounds_at[key].items():
            b["rays"] = ro_s.shape[0]
            print(f"bound {name} {key}: {b['bound_ms']:.5f} ms "
                  f"({b['bound_by']}: {b['bytes']} bytes, {b['ops']} FP32 "
                  "ops)")
    bounds = bounds_at[main_key]

    print(f"phases 1-8: {time.perf_counter() - t_start:.1f} s")
    # ---- phases 9-13: terrain6 on the cull and the MXU cast -----------------
    t_p = time.perf_counter()
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
    bounds_at[big_key].update(t6[f"bounds_{big_key}"])
    report["terrain6"] = t6
    print(f"phases 9-13: {time.perf_counter() - t_p:.1f} s")

    # ---- phases 14-18: the geometry-gradient path ---------------------------
    t_p = time.perf_counter()
    gg = _geomgrad(dev, smi, (o_rand, d_rand))
    errs.update(gg["errs"])
    launches.update({k: v for k, v in gg["launches"].items()
                     if k not in launches})
    for k in timing:
        timing[k].update(gg["timing"][k])
        bounds_at[k].update(gg["bounds"][k])
    report["geomgrad"] = gg
    print(f"phases 14-18: {time.perf_counter() - t_p:.1f} s")

    # ---- phases 19-22: the bounce rounds ------------------------------------
    t_b = time.perf_counter()
    report["bounces"] = _bounces(dev, smi)
    report["bounces"]["seconds"] = time.perf_counter() - t_b
    for k, m in report["bounces"]["march"].items():
        timing[k].update({"km_ms": m["ms"], "km_plain_ms": m["plain_ms"],
                          "km_device_ms": m["device_ms"]})
        bounds_at[k]["bvh_march"] = m["bound"]
    errs["bvh_march"] = max(m["max_abs_err"]
                            for m in report["bounces"]["march"].values())
    launches["bvh_march"] = report["bounces"]["march"][big_key][
        "frame_launches"]
    # the shading kernels' rows: terrain8_stress, 2,073,600 lanes a 1080p
    # round; the plain version is the round through the torch ops (its cast
    # and queries included), which the two kernels replace together
    shade = report["bounces"]["shade"]
    for k in timing:
        m = shade[f"terrain8_stress {k}"]
        for key, part in (("ksr", "rays"), ("ksp", "phong")):
            timing[k].update({f"{key}_ms": m[f"{part}_ms"],
                              f"{key}_device_ms": m[f"{part}_device_ms"],
                              f"{key}_plain_ms": m["round_plain_ms"]})
        bounds_at[k]["shade_rays"] = m["rays_bound"]
        bounds_at[k]["shade_phong"] = m["phong_bound"]
    errs["shade_rays"] = max(m["atten_abs_err"] for m in shade.values())
    errs["shade_phong"] = max(m["contrib_abs_err"] for m in shade.values())
    for name in ("shade_rays", "shade_phong"):
        launches[name] = shade[f"terrain8_stress {big_key}"][
            "frame_launches"][name]
    print(f"bounce phases: {report['bounces']['seconds']:.1f} s")
    # ---- phases 23-26: spp > 1 ----------------------------------------------
    t_s = time.perf_counter()
    report["spp"] = _spp(dev, smi)
    report["spp"]["seconds"] = time.perf_counter() - t_s
    print(f"spp phases: {report['spp']['seconds']:.1f} s")
    # ---- phases 27-30: the distribution layer -------------------------------
    t_d = time.perf_counter()
    report["dist"] = _dist(dev, smi)
    report["dist"]["seconds"] = time.perf_counter() - t_d
    print(f"dist phases: {report['dist']['seconds']:.1f} s")
    # ---- phases 31-34: the ops surface --------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        for key, run in (("texture", lambda: _texture(dev, smi)),
                         ("probe", lambda: _probe(dev, smi)),
                         ("cli", lambda: _ops_cli(dev, smi, tmp)),
                         ("elastic", lambda: _elastic(dev, smi, tmp))):
            t_o = time.perf_counter()
            report[key] = run()
            report[key]["phase_seconds"] = time.perf_counter() - t_o
            print(f"{key} phase: {report[key]['phase_seconds']:.1f} s")
    # ---- phases 35-37: the fly-through, the interactive loop, the viewer ----
    with tempfile.TemporaryDirectory() as tmp:
        for key, run in (("orbit", lambda: _orbit(dev, smi, tmp)),
                         ("interactive", lambda: _interactive(dev, smi, tmp)),
                         ("viewer", lambda: _viewer_native(dev, smi, tmp))):
            t_o = time.perf_counter()
            report[key] = run()
            report[key]["phase_seconds"] = time.perf_counter() - t_o
            print(f"{key} phase: {report[key]['phase_seconds']:.1f} s")
    texture_launches, ops_launches = {}, {}
    for into, paths in ((texture_launches, report["texture"]["launches"]),
                        (ops_launches, {**report["probe"]["launches"],
                                        **{f"cli {k}": v["launches"]
                                           for k, v in report["cli"].items()
                                           if isinstance(v, dict)},
                                        **report["orbit"]["launches"],
                                        **report["interactive"]["launches"]})):
        for label, counts in paths.items():
            for name, n in counts.items():
                into.setdefault(name, {})[label] = n
    dist_launches = {}
    for label, counts in report["dist"]["dist_launches"].items():
        for name, n in counts.items():
            dist_launches.setdefault(name, {})[label] = n
    spp_launches = {}
    for label, rec in report["spp"]["cells"].items():
        for name, n in rec["launches"].items():
            spp_launches.setdefault(name, {})[label] = n
    report["bounds"] = bounds_at
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
        # K1's and K4's exact_uv instantiations (the branch at
        # pallas_engine.py:559) and K1's visits_out instantiation
        ("bvh_cast_exact_uv", SOURCE, tpu + "pallas_engine.py:916", "k1x"),
        ("cull_cast_exact_uv", SOURCE_CULL, tpu + "pallas_engine.py:869",
         "k4x"),
        ("bvh_visit_counts", SOURCE, tpu + "pallas_engine.py:916", "k1v"),
        # the fused march replaces no Pallas kernel: it fuses the loop of
        # _march_shadow with K1's walk (its launches: the mixed 1080p frame)
        ("bvh_march", SOURCE, tpu + "shading.py:78", "km"),
        # the shading kernels replace no Pallas kernel: they fuse
        # illuminate's glue and phong_term (their launches: the stress
        # 1080p frame)
        ("shade_rays", SOURCE_SHADE, tpu + "shading.py:200", "ksr"),
        ("shade_phong", SOURCE_SHADE, tpu + "shading.py:185", "ksp"),
    ]
    # device ms = fixed + per_m * (rays in millions), fitted to the two sizes
    for name, _, _, key in rows:
        (t1, t2), (r1, r2) = ((timing[k][f"{key}_device_ms"] for k in timing),
                              (bounds_at[k][name]["rays"] / 1e6
                               for k in timing))
        per_m = (t2 - t1) / (r2 - r1) if r2 != r1 else float("nan")
        fit = {"fixed_ms": t1 - per_m * r1, "per_mrays_ms": per_m}
        report.setdefault("device_fit", {})[name] = fit
        print(f"{key.upper()} {name} [{smi}]: device " + " / ".join(
            f"{timing[k][f'{key}_device_ms']:.4f}" for k in timing)
            + " ms; bound " + " / ".join(
                f"{bounds_at[k][name]['bound_ms']:.5f}" for k in timing)
            + f" ms ({' / '.join(timing)}); fixed {fit['fixed_ms']:.4f} ms "
            f"+ {per_m:.4f} ms per M rays")
    # no single PyTorch call computes a closest hit or an any-hit query
    kernels_line = {"kernels": [
        {"name": name, "route": "cuda", "source": source,
         "replaces": replaces, "launches": launches[name],
         "max_abs_err": errs[name], "ms": timing[main_key][f"{key}_ms"],
         "plain_ms": timing[main_key][f"{key}_plain_ms"],
         "bound_ms": bounds[name]["bound_ms"],
         "bound_by": bounds[name]["bound_by"], "library_ms": None,
         "device_ms": timing[main_key][f"{key}_device_ms"],
         "spp_launches": spp_launches.get(name, {}),
         "dist_launches": dist_launches.get(name, {}),
         "texture_launches": texture_launches.get(name, {}),
         "ops_launches": ops_launches.get(name, {})}
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
