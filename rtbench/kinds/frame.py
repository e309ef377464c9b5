"""Frame cells: one viewer in a closed loop on a turntable orbit.

Each frame builds the orbit's next camera from its host values (a
viewer's camera moves every frame, so no two frames of a window share a
view or a camera object), renders it (``engine.render_frame_with_stats``),
converts it to RGBA8 (``engine.frame_to_u8``) and copies it to the host,
the image a viewer shows; its latency runs from the camera's building to
the copy's return.  A frame whose ``dropped`` count is nonzero, or that
raises, fails.

The check: a reservoir of ``check_frames`` frames of the window, and
``check_pixels`` pixels of each, drawn from the seed, against the plain
reference's pixels at the same cameras.  ``px_off_pct`` is the share of
those pixels in which some channel differs by more than one level of 255
(one level is the truncation of a value that rounds differently).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import generate, program, roofline
from ..world import load as load_world

class Run:
    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, int(seed), device
        self.traffic = tr = cell.traffic
        self.world = load_world(cell.config["world"])
        self.width, self.height, self.spp = tr["width"], tr["height"], tr["spp"]
        self.u2p = program.unit_to_pixels(self.world, self.width)
        self.start_deg = generate.orbit_start(self.seed)
        self.latency = []
        self.kept = generate.Reservoir(tr["check_frames"], self.seed)
        self.min_items = 1  # the window's least: one frame

    # ------------------------------------------------------------ program
    def setup(self) -> None:
        from raytracer_tpu_torch.render import engine

        self.engine = engine
        self.scene, self.cfg = program.load_world(
            self.cell.config["world"], self.device, self.width, self.height,
            self.spp)
        self.fails = torch.zeros((), dtype=torch.int64, device=self.device)
        for k in range(self.traffic["warmup_frames"]):
            self._frame(-1 - k)
        self.fails.zero_()
        self.errors = 0

    def view(self, i: int):
        """Frame ``i``'s camera, ``(pos, rot)`` on the host."""
        return generate.orbit_view(self.world.cam_pos, self.world.cam_rot,
                                   self.start_deg,
                                   self.traffic["deg_per_frame"], i)

    def _frame(self, i: int):
        t0 = time.perf_counter()
        pos, rot = self.view(i)
        cam = program.camera(pos, rot, self.world.cam_near, self.u2p,
                             self.device)
        img, stats = self.engine.render_frame_with_stats(self.scene, cam,
                                                         self.cfg)
        host = self.engine.frame_to_u8(img).cpu()
        t1 = time.perf_counter()
        self.fails += stats["dropped"] != 0
        return host, t1 - t0

    def item(self, i: int) -> None:
        try:
            host, dt = self._frame(i)
        except RuntimeError:
            self.errors += 1
            return
        self.latency.append(dt)
        self.kept.offer(lambda: (i, host))

    def failed(self) -> int:
        return int(self.fails) + self.errors

    def end_to_end(self, window_s: float, items: int) -> dict:
        lat = np.asarray(self.latency) * 1e3
        return {"frame_ms": window_s * 1e3 / max(items, 1),
                "frame_ms_p95": float(np.percentile(lat, 95)) if lat.size
                else float("nan")}

    def release(self) -> None:
        del self.scene, self.fails

    # -------------------------------------------------------------- yardstick
    def _view(self, ref):
        return ref.View(near=float(self.world.cam_near),
                        unit_to_pixels=float(self.u2p), width=self.width,
                        height=self.height)

    def least_cast_s(self, items, ref, device) -> float:
        """The least device time of the traced frames' queries, a frame."""
        scene = ref.make_scene(self.world, device)
        P = ref.world_params(self.world, device)
        px = torch.arange(self.width * self.height, device=device)
        lights = (self.world.point_pos.shape[0]
                  + self.world.dir_dir.shape[0])
        total = 0.0
        for i in items:
            pos, rot = self.view(i)
            P["cam_pos"] = torch.as_tensor(pos, device=device)
            P["cam_rot"] = torch.as_tensor(rot, device=device)
            offs, shift = ref.spp_jitter(self.spp, self.width, self.height,
                                         device, torch.float32)
            closest = any_hit = 0
            for s in range(self.spp):
                jit = (None if self.spp == 1 else
                       ((offs[s] + shift) % 1.0).reshape(-1, 2))
                counts = ref.live_rays(scene, P, self._view(ref), px, jit)
                c, a = roofline.frame_queries(counts[0], lights, counts[1:])
                closest, any_hit = closest + c, any_hit + a
            total += roofline.least_seconds(closest, any_hit, 1,
                                            self.world.box_lo.shape[0])
        return total / len(items)

    def outputs(self):
        """The kept frames' checked pixels: ``[(frame, px, u8 [k, 4])]``."""
        px = generate.pixels(self.seed, len(self.kept.items),
                             self.width * self.height,
                             self.traffic["check_pixels"])
        return [(i, p, host.reshape(-1, 4).numpy()[p])
                for (i, host), p in zip(self.kept.items, px)]

    def control_outputs(self, ref, device, dtype, fault=None):
        """What the reference in ``dtype`` puts in the program's place: as
        many frames as a run checks, at frames of the orbit drawn from
        the seed."""
        if fault is not None:
            raise ValueError(f"no planted fault {fault!r} for frame cells")
        g = generate.rng(self.seed, generate.STREAM_FRAMES)
        frames = g.integers(1 << 14, size=self.traffic["check_frames"])
        px = generate.pixels(self.seed, len(frames), self.width * self.height,
                             self.traffic["check_pixels"])
        return [(int(i), p, self._ref_pixels(ref, device, dtype, int(i), p))
                for i, p in zip(frames, px)]

    def _ref_pixels(self, ref, device, dtype, i, p):
        scene = ref.make_scene(self.world, device, dtype)
        P = ref.world_params(self.world, device, dtype)
        pos, rot = self.view(i)
        P["cam_pos"] = torch.as_tensor(pos, device=device).to(dtype)
        P["cam_rot"] = torch.as_tensor(rot, device=device).to(dtype)
        with torch.no_grad():
            img = ref.render_pixels(scene, P, self._view(ref),
                                    torch.as_tensor(p, device=device),
                                    self.spp)
        return ref.to_u8(img.float()).cpu().numpy()

    def compare(self, outputs, ref, device) -> dict:
        off, total = 0, 0
        for i, p, got in outputs:
            want = self._ref_pixels(ref, device, torch.float32, i, p)
            diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
            off += int((diff.max(axis=1) > 1).sum())
            total += len(p)
        # no frame to check reads as every pixel off
        return {"px_off_pct": 100.0 * off / total if total else 100.0}
