"""Train cells: the fit that ``cli --train`` runs, in a loop.

Each step is ``diff.train_step`` (the L2 loss of the frame to a target,
its gradients to the materials, lights and camera pose, and an SGD update)
and ends when its loss has been read back to the host.  A step whose loss
is not finite, or that raises, fails.

Set-up renders the target (the world with ``kd`` scaled by a factor drawn
from the seed, at a camera turned by a seeded yaw), starts the parameters
from a seeded perturbation of the world's own, warms the step up with
``warmup_steps`` steps of the window's own call from that start, and hands
the window the same start again: the window's first ``check_steps``
steps, timed and counted like the rest, are the ones checked.  The check:
the plain reference follows the same ``check_steps`` steps from the same
start, and

* ``loss_gap``: the largest relative gap of a step's loss;
* ``grad_gap``: the first gradient as the optimizer got it, ``(p0 - p1) /
  lr`` from the states on both sides, by the worst leaf: the gap of the
  leaf norms over the larger of the reference's leaf norm and its median
  leaf norm;
* ``change_gap``: the same of the change ``p3 - p0`` after the steps, over
  the leaves whose reference gradient is at least a thousandth of the
  median leaf's (the others move by round-off alone).

Both read the program's state with each value that lies within one
float32 spacing a step of the reference's taken as the reference's: the
update ``p - lr * g`` rounds, and gradients that differ in their last
bits round one value of a leaf to the neighbouring float, which in a leaf
with a small gradient (a mirror's ``ks`` of 0.78: 6e-6 in gradient units
an ulp) would read as a gap of 1e-2.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .. import generate, program, roofline
from ..world import LIGHT_KEYS, MATERIAL_KEYS
from ..world import PARAM_NAMES as NAMES
from ..world import load as load_world


def leaf(params, name: str):
    """A program parameter by the benchmark's name."""
    if "." in name:
        group, key = name.split(".")
        return getattr(params[group], key)
    return params[name]


def host_values(params) -> dict:
    return {n: leaf(params, n).detach().double().cpu().numpy() for n in NAMES}


class Run:
    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, int(seed), device
        self.traffic = tr = cell.traffic
        self.world = load_world(cell.config["world"])
        self.width, self.height, self.spp = tr["width"], tr["height"], tr["spp"]
        self.u2p = program.unit_to_pixels(self.world, self.width)
        self.pos, self.rot, self.kd_factor, self.start = generate.train_start(
            self.world.values(), self.seed, tr)
        self.steps = 0
        self.item_work = self.width * self.height * self.spp  # rays a step
        self.errors = 0
        self.bad_loss = 0
        self.min_items = tr["check_steps"]  # the window holds them

    # ------------------------------------------------------------ program
    def setup(self) -> None:
        from raytracer_tpu_torch import diff
        from raytracer_tpu_torch.render import engine

        self.diff = diff
        dev = self.device
        # every bounce round, as the CLI's training loop takes them
        self.scene, self.cfg = program.load_world(
            self.cell.config["world"], dev, self.width, self.height, self.spp,
            early_exit=False)
        self.cam = program.camera(self.pos, self.rot,
                                  self.world.cam_near, self.u2p, dev)
        mats = self.scene.materials
        with torch.no_grad():
            self.target = engine.render_frame(
                dataclasses.replace(self.scene, materials=dataclasses.replace(
                    mats, kd=mats.kd * self.kd_factor)), self.cam, self.cfg)

        def t(name):
            return torch.as_tensor(self.start[name], device=dev)

        start_scene = dataclasses.replace(
            self.scene,
            materials=dataclasses.replace(
                mats, **{k: t(f"materials.{k}") for k in MATERIAL_KEYS}),
            lights=dataclasses.replace(
                self.scene.lights, **{k: t(f"lights.{k}") for k in LIGHT_KEYS}))
        start_cam = dataclasses.replace(self.cam, pos=t("cam_pos"),
                                        rot=t("cam_rot"))
        # train_step returns new leaves and never writes its inputs, so the
        # warm-up leaves the start as it was
        start = diff.trainable_params(start_scene, start_cam)
        self.params = start
        for _ in range(self.traffic["warmup_steps"]):
            self._step()
        self.params = start
        self.states = [host_values(start)]
        self.losses = []

    def _step(self) -> float:
        value, _, self.params = self.diff.train_step(
            self.scene, self.cam, self.cfg, self.target, self.params,
            lr=self.traffic["lr"])
        return float(value)

    def item(self, i: int) -> None:
        try:
            loss = self._step()
        except RuntimeError:
            self.errors += 1
            return
        self.steps += 1
        self.bad_loss += not math.isfinite(loss)
        n = self.traffic["check_steps"]
        if i < n:
            self.losses.append(loss)
            if i == 0 or i == n - 1:
                self.states.append(host_values(self.params))

    def failed(self) -> int:
        return self.errors + self.bad_loss

    def end_to_end(self, window_s: float, items: int) -> dict:
        rays = self.steps * self.item_work
        return {"step_mrays_s": rays / window_s / 1e6}

    def release(self) -> None:
        del self.scene, self.cam, self.target, self.params

    # -------------------------------------------------------------- yardstick
    def _view(self, ref):
        return ref.View(near=float(self.world.cam_near),
                        unit_to_pixels=float(self.u2p), width=self.width,
                        height=self.height)

    def _ref_start(self, ref, device, dtype):
        return {k: torch.as_tensor(v, device=device).to(dtype)
                for k, v in self.start.items()}

    def least_cast_s(self, items, ref, device) -> float:
        """The least device time of a step's queries (its forward frame),
        counted at the start camera."""
        scene = ref.make_scene(self.world, device)
        P = self._ref_start(ref, device, torch.float32)
        px = torch.arange(self.width * self.height, device=device)
        lights = (self.world.point_pos.shape[0]
                  + self.world.dir_dir.shape[0])
        offs, shift = ref.spp_jitter(self.spp, self.width, self.height,
                                     device, torch.float32)
        closest = any_hit = 0
        for s in range(self.spp):
            jit = (None if self.spp == 1
                   else ((offs[s] + shift) % 1.0).reshape(-1, 2))
            counts = ref.live_rays(scene, P, self._view(ref), px, jit)
            c, a = roofline.frame_queries(counts[0], lights, counts[1:])
            closest, any_hit = closest + c, any_hit + a
        return roofline.least_seconds(closest, any_hit, 1,
                                      self.world.box_lo.shape[0])

    def outputs(self):
        return {"losses": np.asarray(self.losses), "states": self.states}

    def _reference(self, ref, device, dtype, **fault):
        scene = ref.make_scene(self.world, device, dtype)
        P = ref.world_params(self.world, device, dtype)
        P["cam_pos"] = torch.as_tensor(self.pos, device=device).to(dtype)
        P["cam_rot"] = torch.as_tensor(self.rot, device=device).to(dtype)
        view = self._view(ref)
        with torch.no_grad():
            target = ref.render_frame(scene, ref.kd_scaled(
                P, self.kd_factor), view, self.spp)
        losses, hist = ref.train(scene, view, self.spp, target,
                                 self._ref_start(ref, device, dtype),
                                 self.traffic["lr"],
                                 self.traffic["check_steps"], **fault)
        return {"losses": losses, "states": [hist[0], hist[1], hist[-1]]}

    def control_outputs(self, ref, device, dtype, fault=None):
        """The reference in ``dtype`` in the program's place; with
        ``fault``, in float32 with that fault planted."""
        if fault == "half_batch":
            return self._reference(ref, device, torch.float32,
                                   rows=self.height // 2)
        if fault == "answer_altered":
            return self._reference(ref, device, torch.float32,
                                   grad_scale=1.1)
        return self._reference(ref, device, dtype)

    def compare(self, outputs, ref, device) -> dict:
        n = self.traffic["check_steps"]
        if len(outputs["losses"]) < n or len(outputs["states"]) < 3:
            # a checked step raised: nothing to compare reads as wrong
            return dict.fromkeys(("loss_gap", "grad_gap", "change_gap"),
                                 math.inf)
        want = self._reference(ref, device, torch.float32)
        return gaps(outputs, want, self.traffic["lr"], n)


def snapped(got: dict, want: dict, ulps: int) -> dict:
    """``got`` with each value within ``ulps`` float32 spacings of
    ``want``'s taken as ``want``'s."""
    out = {}
    for n in NAMES:
        w = want[n]
        tol = ulps * np.spacing(np.abs(w).astype(np.float32)).astype(
            np.float64)
        out[n] = np.where(np.abs(got[n] - w) <= tol, w, got[n])
    return out


def gaps(got: dict, want: dict, lr: float, steps: int = 3) -> dict:
    """The three numbers of the check (module docstring); ``states`` hold
    ``p0``, ``p1`` and the state after ``steps`` steps."""
    lg = np.abs(np.asarray(got["losses"]) - want["losses"]) / np.maximum(
        np.abs(want["losses"]), 1e-30)
    got = dict(got, states=[got["states"][0],
                            snapped(got["states"][1], want["states"][1], 1),
                            snapped(got["states"][2], want["states"][2],
                                    steps)])

    def norms(states, a, b, scale):
        return {n: float(np.linalg.norm((states[a][n] - states[b][n]) * scale))
                for n in NAMES}

    g_got, g_want = norms(got["states"], 0, 1, 1 / lr), norms(
        want["states"], 0, 1, 1 / lr)
    c_got, c_want = norms(got["states"], 2, 0, 1.0), norms(
        want["states"], 2, 0, 1.0)
    med_g = float(np.median(list(g_want.values())))
    moving = [n for n in NAMES if g_want[n] >= 1e-3 * med_g]
    med_c = float(np.median([c_want[n] for n in moving]))

    def worst(got_n, want_n, names, med):
        return max(abs(got_n[n] - want_n[n]) / max(want_n[n], med, 1e-30)
                   for n in names)

    return {"loss_gap": float(lg.max()),
            "grad_gap": worst(g_got, g_want, NAMES, med_g),
            "change_gap": worst(c_got, c_want, moving, med_c)}
