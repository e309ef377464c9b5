"""The check that decides ``correct`` fails what it has to fail.

* the precision control (the plain reference in bfloat16 in the program's
  place) fails each cell's limits: at a size a test run holds here, and,
  on the card, at the cell's own size on three seeds (``gpu``);
* a whole run, its look for a card skipped, with the timed path broken
  underneath, comes out not correct, once for each fault a cell can have:
  a step that returns its state unchanged, half of the batch left out (the
  mean taken over the rest), an answer altered where it is produced.  One
  card: no exchange between chips to leave out.
"""

import pytest
import torch

from rtbench import control, spec
from rtbench.run import run_cell

TINY = {"frame": dict(width=40, height=30, check_frames=2, check_pixels=600,
                      warmup_frames=1),
        "train": dict(width=40, height=30)}
CELLS = ["terrain8.frame.640x480", "terrain8_stress.frame.1080p",
         "terrain8.train.1080p"]


def tiny(name: str):
    cell = spec.load_cell(name)
    cell.traffic = dict(cell.traffic, **TINY[cell.traffic["kind"]])
    if cell.traffic["kind"] == "train":
        cell.traffic["spp"] = min(cell.traffic["spp"], 2)
    return cell


def test_gaps_read_rounding_of_the_update_as_none():
    """A value one float32 spacing from the reference's, as a last-bit
    difference of the gradient rounds it, reads no gap; two spacings in
    the first step, or a gradient scaled by 1.1, read one."""
    import numpy as np

    from rtbench.kinds.train import NAMES, gaps

    rng = np.random.default_rng(3)
    p0 = {n: rng.uniform(0.1, 1.0, 4).astype(np.float32).astype(np.float64)
          for n in NAMES}
    g = {n: rng.uniform(-1e-3, 1e-3, 4) for n in NAMES}

    def step(p, scale=1.0):
        return {n: (p[n].astype(np.float32) - np.float32(1e-2 * scale)
                    * g[n].astype(np.float32)).astype(np.float64)
                for n in NAMES}

    want = {"losses": np.ones(3), "states": [p0, step(p0), step(step(p0))]}

    def moved(p, ulps):
        q = dict(p)
        q["materials.ks"] = np.nextafter(
            p["materials.ks"].astype(np.float32), np.float32(9),
            dtype=np.float32).astype(np.float64)
        if ulps == 2:
            q["materials.ks"] = np.nextafter(
                q["materials.ks"].astype(np.float32), np.float32(9),
                dtype=np.float32).astype(np.float64)
        return q

    one = dict(want, states=[p0, moved(want["states"][1], 1),
                             want["states"][2]])
    assert gaps(one, want, 1e-2) == {"loss_gap": 0.0, "grad_gap": 0.0,
                                     "change_gap": 0.0}
    two = dict(want, states=[p0, moved(want["states"][1], 2),
                             want["states"][2]])
    assert gaps(two, want, 1e-2)["grad_gap"] > 0.0
    scaled = dict(want, states=[p0, step(p0, 1.1), step(step(p0, 1.1), 1.1)])
    got = gaps(scaled, want, 1e-2)
    assert got["grad_gap"] > 0.05 and got["change_gap"] > 0.05


def fails(compared: dict) -> bool:
    return any(not v <= lim for v, lim in compared.values())


def run_tiny(name: str, seed: int = 2**31 + 5):
    res, compared = run_cell(tiny(name), seed, 0.3, False,
                             torch.device("cpu"))
    return res, compared


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_a_small_size(name):
    cell = tiny(name)
    got = control.control_numbers(cell, 2**31 + 3, torch.device("cpu"))
    limits = cell.limits["limits"]
    assert any(not got[k] <= limits[k]["limit"] for k in limits), got


@pytest.mark.parametrize("fault", ["half_batch", "answer_altered"])
@pytest.mark.parametrize("name", ["terrain8.train.1080p"])
def test_planted_faults_fail_at_a_small_size(name, fault):
    """The readings a training cell's limits are held against: each fault
    planted in the reference put in the program's place fails a number."""
    cell = tiny(name)
    got = control.control_numbers(cell, 2**31 + 3, torch.device("cpu"),
                                  fault)
    limits = cell.limits["limits"]
    assert any(not got[k] <= limits[k]["limit"] for k in limits), got


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_the_cells_size(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control at the cell's size")
    cell = spec.load_cell(name)
    limits = cell.limits["limits"]
    for seed in (4_100_000_011, 4_100_000_012, 4_100_000_013):
        got = control.control_numbers(cell, seed, torch.device("cuda", 0))
        assert any(not got[k] <= limits[k]["limit"] for k in limits), got


@pytest.mark.parametrize("name", ["terrain8.frame.640x480",
                                  "terrain8.train.1080p"])
def test_a_sound_run_is_correct(name):
    res, compared = run_tiny(name)
    assert res["correct"] and not fails(compared), compared


# --------------------------------------------------------------- frame faults

def _stale_frame(real):
    first = {}

    def render(scene, cam, cfg):
        if "frame" not in first:
            first["frame"] = real(scene, cam, cfg)
        return first["frame"]
    return render


def _half_frame(real):
    def render(scene, cam, cfg):
        img, stats = real(scene, cam, cfg)
        img = img.clone()
        img[img.shape[0] // 2:] = 0.0
        return img, stats
    return render


def _altered_u8(real):
    def to_u8(img):
        u8 = real(img)
        return torch.clamp(u8.int() + torch.tensor([6, 0, 0, 0]), 0,
                           255).to(torch.uint8)
    return to_u8


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "answer_altered"])
@pytest.mark.parametrize("name", ["terrain8.frame.640x480",
                                  "terrain8_stress.frame.1080p"])
def test_frame_faults_are_not_correct(name, fault, monkeypatch):
    from raytracer_tpu_torch.render import engine

    if fault == "answer_altered":
        monkeypatch.setattr(engine, "frame_to_u8",
                            _altered_u8(engine.frame_to_u8))
    else:
        wrap = _stale_frame if fault == "state_unchanged" else _half_frame
        monkeypatch.setattr(engine, "render_frame_with_stats",
                            wrap(engine.render_frame_with_stats))
    res, compared = run_tiny(name)
    assert not res["correct"] and fails(compared), compared


# --------------------------------------------------------------- train faults

def _unchanged_step(real):
    def step(scene, camera, cfg, target, params, lr=1e-2):
        value, grads, _ = real(scene, camera, cfg, target, params, lr)
        return value, grads, params
    return step


def _half_batch_step(real):
    from raytracer_tpu_torch import diff

    def step(scene, camera, cfg, target, params, lr=1e-2):
        img = diff.render_with_params(scene, camera, cfg, params)
        h = img.shape[0] // 2
        value = diff.l2_image_loss(img[:h], target[:h])
        grads = diff.grad_of(value, params)
        return value.detach(), grads, diff.sgd_step(params, grads, lr)
    return step


def _altered_grad_step(real):
    from raytracer_tpu_torch import diff, tree

    def step(scene, camera, cfg, target, params, lr=1e-2):
        value, grads, _ = real(scene, camera, cfg, target, params, lr)
        grads = tree.tree_map(lambda g: 1.1 * g, grads)
        return value, grads, diff.sgd_step(params, grads, lr)
    return step


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "answer_altered"])
@pytest.mark.parametrize("name", ["terrain8.train.1080p"])
def test_train_faults_are_not_correct(name, fault, monkeypatch):
    from raytracer_tpu_torch import diff

    wrap = {"state_unchanged": _unchanged_step,
            "half_batch": _half_batch_step,
            "answer_altered": _altered_grad_step}[fault]
    monkeypatch.setattr(diff, "train_step", wrap(diff.train_step))
    res, compared = run_tiny(name)
    assert not res["correct"] and fails(compared), compared



def test_a_fault_that_starts_once_warm_is_not_correct(monkeypatch):
    """The checked steps are the window's own: a step that alters its
    gradient only after the set-up's warm-up steps, as a path taken once
    warm would, is timed and caught."""
    from raytracer_tpu_torch import diff

    real, calls = diff.train_step, []
    altered = _altered_grad_step(real)

    def step(*args, **kw):
        calls.append(1)
        warm = len(calls) > tiny("terrain8.train.1080p").traffic[
            "warmup_steps"]
        return (altered if warm else real)(*args, **kw)

    monkeypatch.setattr(diff, "train_step", step)
    res, compared = run_tiny("terrain8.train.1080p")
    assert not res["correct"] and fails(compared), compared


@pytest.mark.parametrize("name", ["terrain8.frame.640x480",
                                  "terrain8.train.1080p"])
def test_a_traced_run_traces_after_the_window(name):
    """A traced run traces its items after the window's close, reads a
    training window's rate from the untraced steps before, and is judged
    like any other run."""
    cell = tiny(name)
    cell.traffic["trace_items"] = 1
    res, compared = run_cell(cell, 2**31 + 7, 0.0, True, torch.device("cpu"))
    assert res["correct"] and not fails(compared), compared
    # the window's least, the profiler's warm item and the traced one
    least = cell.traffic.get("check_steps", 1)
    assert res["attempted"] == least + 2 and res["failed"] == 0
    assert res["device"]["window_s"] > 0
    if cell.traffic["kind"] == "train":
        assert res["metrics"]["mrays_s.train"]["value"] > 0
