"""Command-line interface of the port (counterpart of ``raytracer_tpu/cli.py``:
rendering, benchmarking, the fly-through, the interactive loop, the debug
probe and training).

    python -m raytracer_tpu_torch.cli -c WORLD.json [-o out.png]
    python -m raytracer_tpu_torch.cli -c WORLD.json -b [--repeats N]
    python -m raytracer_tpu_torch.cli -c WORLD.json --orbit N [--out-dir D]
    python -m raytracer_tpu_torch.cli -c WORLD.json --interactive [-o F]
    python -m raytracer_tpu_torch.cli -c WORLD.json --debug-pixel X Y
    python -m raytracer_tpu_torch.cli -c WORLD.json --train N [--checkpoint P]
    python -m raytracer_tpu_torch.cli -c WORLD.json --train-until N \
        --elastic R [--hang-timeout S]

Flags: ``-c/--config`` world JSON, ``-o/--out`` PNG path, ``-b/--bench``
time frames (prints ``Time: <ms>`` and one JSON line: the median of the
``--repeats`` timed frames as ``value``, their minimum and 95th percentile
beside it),
``--width``/``--height`` canvas overrides (the field of view is kept),
``-d/--dim`` the candidate-list cull's tile (``tile_rows = max(8,
ceil8(d*d/128))``; the LBVH walk and the MXU cast do not read it),
``-r/--no-bvh`` sets ``use_bvh=False``, which neither engine of the port
reads (as the JAX package's accelerator engine does not),
``--wavefront-cap FRAC`` the tile-compacted rounds
(``wavefront_tile_cap``), ``-s/--reference-impl`` the plain-PyTorch
``"torch"`` engine instead of the CUDA kernels, ``--device`` (default
``cuda``; there is no fallback to the CPU when CUDA is missing),
``--debug-pixel X Y`` the single-ray probe (``debug.debug_cast``).
``--orbit N`` renders an N-frame turntable (``camera_motion.orbit_frames``,
2 degrees a frame) to ``--out-dir`` (default ``frames``) as
``frame_%04d.png``, printing ``FPS: x`` every ``SAMPLE_PERIOD`` frames (the
render, the copy to the host and the PNG encode: the reference's overlay
counts whole frames); ``--interactive`` renders to ``--out`` (default
``frame.png``) and then reads commands from stdin, one a line: ``w``,
``a``, ``s``, ``d`` move (``camera_motion.key_move``), ``mouse DX DY``
looks (``mouse_look``), ``click X Y`` runs the probe at a pixel of the
frame on the current camera without rendering again, ``quit``/``q``/``esc``
ends the loop (as does the end of stdin); a move renders the frame again
and prints ``frame: X ms (Y FPS)``, any other line prints ``? line``.
Training: ``--train N`` / ``--train-until TOTAL`` SGD steps on materials
and lights toward ``--target-png`` (or the scene rendered with ``kd *
1.3``), ``--lr``, ``--checkpoint`` (resumed when it exists) written every
``--checkpoint-every`` steps; one ``train_step`` JSON line per step on
stderr; ``--profile-dir`` traces the loop (``tracing.profile_trace``,
with the port's ``rt.*`` spans);
``--elastic R`` runs the loop in a supervised worker process restarted up
to R times on a crash or a ``--hang-timeout`` silence (``elastic.py``).
For the elastic tests, ``RT_FAULT_AT_STEP`` / ``RT_HANG_AT_STEP`` make the
worker exit with code 13 / sleep after that step, once: the file named by
``RT_FAULT_MARKER`` records that the fault happened.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="raytracer-tpu-torch",
        description="Cube-world ray tracer: PyTorch with CUDA kernels.")
    p.add_argument("-c", "--config", required=True, help="world config (json)")
    p.add_argument("-b", "--bench", action="store_true", help="benchmark mode")
    p.add_argument("-r", "--no-bvh", action="store_true",
                   help="set use_bvh=False (the reference's brute-force "
                        "flag); both of this port's engines ignore it, as "
                        "the JAX package's accelerator engine does")
    p.add_argument("-s", "--reference-impl", action="store_true",
                   help="use the plain-PyTorch engine (engine='torch')")
    p.add_argument(
        "-d", "--dim", type=int, default=None,
        help="kernel tile edge (reference -d): the cull's tile rows = d*d/128 "
             "rounded up to a multiple of 8, floor 8 (d<=32 -> 8 rows, d=64 "
             "-> 32 rows); unset = auto by frame size (48-64 rows)")
    p.add_argument("-o", "--out", default=None, help="output PNG path")
    p.add_argument("--width", type=int, default=None,
                   help="override canvas width")
    p.add_argument("--height", type=int, default=None,
                   help="override canvas height")
    p.add_argument("--debug-pixel", nargs=2, type=int, metavar=("X", "Y"),
                   help="trace one pixel verbosely (single-ray probe)")
    p.add_argument("--repeats", type=int, default=1, help="bench repetitions")
    p.add_argument(
        "--wavefront-cap", type=float, default=0.0, metavar="FRAC",
        help="tile-compacted queue discipline: run the shading, shadow and "
             "bounce rounds on only the FRAC*T ray tiles that hold a primary "
             "hit (hits beyond the cap are dropped and counted); 0 = dense "
             "rounds")
    p.add_argument(
        "--orbit", type=int, default=0, metavar="N",
        help="render an N-frame turntable fly-through to --out-dir, "
             "printing FPS every 5 frames (the reference's overlay, "
             "main.cc:106-200)")
    p.add_argument(
        "--interactive", action="store_true",
        help="stdin-driven camera loop: lines 'w|a|s|d', 'mouse DX DY', "
             "'click X Y' (debug probe), 'quit'; each move renders to --out "
             "again (the reference's SDL loop without the window)")
    p.add_argument("--out-dir", default="frames",
                   help="--orbit frame directory")
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (default: cuda)")
    p.add_argument("--train", type=int, default=0, metavar="N",
                   help="run N differentiable-rendering SGD steps on the "
                        "materials and lights")
    p.add_argument("--train-until", type=int, default=0, metavar="TOTAL",
                   help="train to absolute step TOTAL (a resumed run "
                        "computes only the steps after its checkpoint)")
    p.add_argument("--target-png", default=None,
                   help="target image for --train (default: the scene "
                        "rendered with kd * 1.3)")
    p.add_argument("--checkpoint", default="train_ckpt.npz",
                   help="checkpoint path for --train (resumed if it exists)")
    p.add_argument("--checkpoint-every", type=int, default=10,
                   help="save the --train checkpoint every K steps")
    p.add_argument("--lr", type=float, default=0.05, help="--train SGD rate")
    p.add_argument(
        "--elastic", type=int, default=0, metavar="MAX_RESTARTS",
        help="run --train under the elastic supervisor: the loop runs in a "
             "worker process whose train_step heartbeat is watched; on a "
             "crash or a hang the worker is killed (by its exact PID) and "
             "relaunched from the last checkpoint, up to MAX_RESTARTS times "
             "(use with --train-until for an absolute target)")
    p.add_argument(
        "--hang-timeout", type=float, default=300.0, metavar="S",
        help="--elastic: restart the worker if no heartbeat for S seconds")
    p.add_argument("--profile-dir", default=None,
                   help="trace the --train loop with torch.profiler and "
                        "write a Chrome trace to this directory")
    return p


SAMPLE_PERIOD = 5  # frames per FPS sample (reference main.cc:21)


class FpsWindow:
    """Frames per second over ``SAMPLE_PERIOD``-frame windows, as the
    reference's overlay counts them."""

    def __init__(self):
        self.count, self.t0 = 0, time.perf_counter()

    def tick(self):
        """Count one frame; the window's FPS when it closes, else None."""
        self.count += 1
        if self.count < SAMPLE_PERIOD:
            return None
        t1 = time.perf_counter()
        fps = self.count / (t1 - self.t0)
        self.count, self.t0 = 0, t1
        return fps


def _fps_loop(render_np, cameras, on_frame):
    """Drive ``render_np(camera) -> numpy image`` over ``cameras``, calling
    ``on_frame(i, image)`` and printing ``FPS: x`` over each
    ``SAMPLE_PERIOD``-frame window, as the reference's overlay does.
    Returns the last window's FPS (``None`` before the first)."""
    window, fps = FpsWindow(), None
    for i, cam in enumerate(cameras):
        on_frame(i, render_np(cam))
        closed = window.tick()
        if closed is not None:
            fps = closed
            print(f"FPS: {fps:.1f}", flush=True)
    return fps


def _interactive(args, scene, camera, cfg, render_np) -> int:
    """The reference's event loop (main.cc:81-208) driven by stdin lines."""
    from . import camera_motion as cm
    from .debug import debug_cast
    from .pngio import write_png

    out = args.out or "frame.png"
    cam = camera
    write_png(out, render_np(cam)[..., :3])
    print("interactive: w/a/s/d, 'mouse DX DY', 'click X Y', 'quit'; "
          f"frame -> {out}", flush=True)
    for line in sys.stdin:
        parts = line.strip().split()
        if not parts:
            continue
        if parts[0] in ("quit", "q", "esc"):
            break
        try:
            if parts[0] in ("w", "a", "s", "d"):
                cam = cm.key_move(cam, parts[0])
            elif parts[0] == "mouse" and len(parts) == 3:
                cam = cm.mouse_look(cam, float(parts[1]), float(parts[2]))
            elif parts[0] == "click" and len(parts) == 3:
                x, y = int(parts[1]), int(parts[2])
                if not (0 <= x < cfg.width and 0 <= y < cfg.height):
                    raise ValueError
                debug_cast(scene, cam, cfg, x, y)
                continue
            else:
                raise ValueError
        except ValueError:
            print(f"? {line.strip()}", flush=True)
            continue
        t0 = time.perf_counter()
        write_png(out, render_np(cam)[..., :3])
        dt = time.perf_counter() - t0
        print(f"frame: {dt * 1e3:.1f} ms ({1.0 / dt:.1f} FPS)", flush=True)
    print("Exiting...")  # main.cc:205
    return 0


def tile_rows_for_dim(dim: int) -> int:
    """``-d``: ``max(8, ceil8(dim * dim / 128))`` tile rows, as
    ``raytracer_tpu/cli.py`` maps it."""
    return max(8, (dim * dim // 128 + 7) // 8 * 8)


def _device(name: str):
    import torch

    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: CUDA is not available on this "
                           "machine (use --device cpu to render on the CPU)")
    return dev


def _train(args, scene, camera, cfg) -> int:
    """Fit the materials and lights to a target image by SGD, logging one
    ``train_step`` line per step and checkpointing every K steps
    (``raytracer_tpu/cli.py`` ``_train``), under ``profile_trace`` with
    ``--profile-dir``.  The one-shot fault injection of the elastic tests
    crashes (exit code 13) or hangs the worker right after the step
    ``RT_FAULT_AT_STEP`` / ``RT_HANG_AT_STEP``, unless the file
    ``RT_FAULT_MARKER`` exists; it creates that file first, so that the
    restarted worker runs on."""
    import contextlib
    import dataclasses
    import os

    import numpy as np
    import torch

    from . import checkpoint, diff, tracing
    from .pngio import read_png
    from .render import render_frame

    # every bounce round and march step, as the JAX loop's fori_loops take
    cfg = cfg.replace(early_exit=False)
    dev = scene.verts.device
    if args.target_png:
        rgb = read_png(args.target_png).astype(np.float32) / 255.0
        if rgb.shape[-1] == 3:
            rgb = np.concatenate(
                [rgb, np.ones(rgb.shape[:-1] + (1,), np.float32)], -1)
        target = torch.from_numpy(rgb).to(dev)
        if tuple(target.shape) != (cfg.height, cfg.width, 4):
            raise ValueError(f"target {tuple(target.shape)} != frame "
                             f"{(cfg.height, cfg.width, 4)}")
    else:
        # self-supervised fixture: the same scene with brighter diffuse
        mats = scene.materials
        bright = dataclasses.replace(mats, kd=mats.kd * 1.3)
        with torch.no_grad():
            target = render_frame(dataclasses.replace(scene, materials=bright),
                                  camera, cfg)

    params = diff.trainable_params(scene, camera, include_camera=False)
    start = 0
    if os.path.exists(args.checkpoint):
        params, start = checkpoint.load(args.checkpoint, params)
        tracing.log("checkpoint_restored", path=args.checkpoint, step=start)
    end = args.train_until if args.train_until else start + args.train
    if start >= end:
        print(f"already trained to step {start} (target {end}); nothing to do")
        return 0

    fault_at = int(os.environ.get("RT_FAULT_AT_STEP", "0") or 0)
    hang_at = int(os.environ.get("RT_HANG_AT_STEP", "0") or 0)
    marker = os.environ.get("RT_FAULT_MARKER", "")

    stats = tracing.FrameStats(width=cfg.width, height=cfg.height,
                               spp=cfg.spp)
    with (tracing.profile_trace(args.profile_dir) if args.profile_dir
          else contextlib.nullcontext()):
        for step in range(start, end):
            with stats:
                value, _, params = diff.train_step(scene, camera, cfg, target,
                                                   params, lr=args.lr)
                value = float(value)
            tracing.log("train_step", step=step, loss=value)
            if (step + 1) % args.checkpoint_every == 0 or step + 1 == end:
                checkpoint.save(args.checkpoint, params, step=step + 1)
            if (marker and step + 1 in (fault_at, hang_at)
                    and not os.path.exists(marker)):
                open(marker, "w").close()
                if step + 1 == fault_at:
                    tracing.log("fault_injected", kind="crash", step=step + 1)
                    os._exit(13)  # a preempted or killed worker
                tracing.log("fault_injected", kind="hang", step=step + 1)
                time.sleep(3600)  # a wedged worker
    print(f"trained {end - start} steps; final loss {value:.6f}; "
          f"checkpoint -> {args.checkpoint}")
    return 0


def _strip_elastic_flags(argv):
    """The worker's argv: ``argv`` without the supervisor's own flags."""
    out = []
    skip = False
    for a in argv:
        if skip:
            skip = False
            continue
        if a in ("--elastic", "--hang-timeout"):
            skip = True
            continue
        if a.startswith("--elastic=") or a.startswith("--hang-timeout="):
            continue
        out.append(a)
    return out


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.elastic > 0 and (args.train or args.train_until):
        from .elastic import run_supervised

        worker_argv = _strip_elastic_flags(
            list(argv) if argv is not None else sys.argv[1:])
        res = run_supervised(worker_argv, max_restarts=args.elastic,
                             hang_timeout_s=args.hang_timeout)
        return 0 if res.completed else 1

    import numpy as np
    import torch

    from . import generate, to_device
    from .builder import scale_camera
    from .pngio import write_png
    from .render import render_frame

    dev = _device(args.device)
    world = generate(args.config)
    cfg = world.config
    camera = world.camera
    if args.width:
        camera = scale_camera(camera, args.width, cfg.width)
        cfg = cfg.replace(width=args.width)
    if args.height:
        cfg = cfg.replace(height=args.height)
    if args.dim is not None:
        cfg = cfg.replace(tile_rows=tile_rows_for_dim(args.dim))
    cfg = cfg.replace(engine="torch" if args.reference_impl else "cuda",
                      use_bvh=not args.no_bvh,
                      wavefront_tile_cap=args.wavefront_cap)
    scene = to_device(world.scene, dev)
    camera = to_device(camera, dev)
    print(f"Loaded scene: {args.config} ({cfg.width}x{cfg.height}, "
          f"engine={cfg.engine}, device={dev})")

    if args.debug_pixel:
        from .debug import debug_cast

        x, y = args.debug_pixel
        debug_cast(scene, camera, cfg, x, y)
        return 0

    if args.train or args.train_until:
        return _train(args, scene, camera, cfg)

    if args.orbit or args.interactive:
        import os

        from . import camera_motion as cm
        from .render.engine import frame_to_u8

        def render_np(cam):
            with torch.no_grad():
                return frame_to_u8(render_frame(scene, cam, cfg)).cpu().numpy()

        if not args.orbit:
            return _interactive(args, scene, camera, cfg, render_np)
        os.makedirs(args.out_dir, exist_ok=True)

        def save(i, img):
            write_png(os.path.join(args.out_dir, f"frame_{i:04d}.png"),
                      img[..., :3])

        _fps_loop(render_np, cm.orbit_frames(camera, args.orbit), save)
        print(f"wrote {args.orbit} frames to {args.out_dir}/")
        return 0

    if args.bench:
        img = render_frame(scene, camera, cfg)  # warm-up: kernel build
        times = []
        for _ in range(max(1, args.repeats)):
            if dev.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                img = render_frame(scene, camera, cfg)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            else:
                t0 = time.perf_counter()
                img = render_frame(scene, camera, cfg)
                times.append((time.perf_counter() - t0) * 1e3)
        ms = float(np.median(times))
        rays = cfg.width * cfg.height
        print(f"Time: {ms:.3f} ms")
        print(json.dumps({
            "metric": "frame_ms",
            "value": ms,
            "unit": "ms",
            "min_ms": min(times),
            "p95_ms": float(np.percentile(times, 95)),
            "config": args.config,
            "width": cfg.width,
            "height": cfg.height,
            "engine": cfg.engine,
            "device": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu"),
            "repeats": len(times),
            "primary_mrays_per_s": rays / ms / 1e3,
        }))
    else:
        img = render_frame(scene, camera, cfg)
        out = args.out or "frame.png"
        write_png(out, img.cpu().numpy()[..., :3])
        print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
