"""Command-line interface of the port (counterpart of ``raytracer_tpu/cli.py``,
forward rendering only).

    python -m raytracer_tpu_torch.cli -c WORLD.json [-o out.png]
    python -m raytracer_tpu_torch.cli -c WORLD.json -b [--repeats N]

Flags: ``-c/--config`` world JSON, ``-o/--out`` PNG path, ``-b/--bench``
time frames (prints ``Time: <ms>`` and one JSON line), ``--repeats``,
``--width``/``--height`` canvas overrides (the field of view is kept),
``-s/--reference-impl`` the plain-PyTorch ``"torch"`` engine instead of the
CUDA kernels, ``--device`` (default ``cuda``; there is no fallback to the
CPU when CUDA is missing).
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
    p.add_argument("-s", "--reference-impl", action="store_true",
                   help="use the plain-PyTorch engine (engine='torch')")
    p.add_argument("-o", "--out", default=None, help="output PNG path")
    p.add_argument("--width", type=int, default=None,
                   help="override canvas width")
    p.add_argument("--height", type=int, default=None,
                   help="override canvas height")
    p.add_argument("--repeats", type=int, default=1, help="bench repetitions")
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (default: cuda)")
    return p


def _device(name: str):
    import torch

    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: CUDA is not available on this "
                           "machine (use --device cpu to render on the CPU)")
    return dev


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
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
    cfg = cfg.replace(engine="torch" if args.reference_impl else "cuda")
    scene = to_device(world.scene, dev)
    camera = to_device(camera, dev)
    print(f"Loaded scene: {args.config} ({cfg.width}x{cfg.height}, "
          f"engine={cfg.engine}, device={dev})")

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
        ms = min(times)
        rays = cfg.width * cfg.height
        print(f"Time: {ms:.3f} ms")
        print(json.dumps({
            "metric": "frame_ms",
            "value": ms,
            "unit": "ms",
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
