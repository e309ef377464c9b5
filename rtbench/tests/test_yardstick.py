"""CPU tests of the benchmark's own parts: the work counts of the
roofline, the metric readers, the seeded traffic, the plain reference
against the port's plain engine, and the files ``BENCHMARK.json`` names.

Run them with ``python -m pytest rtbench/tests -q`` (the repository's
tier-1 run collects ``tests/`` only).
"""

import json
import re
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from rtbench import generate, roofline, spec
from rtbench import trace as tr
from rtbench.reference import cubes
from rtbench.world import load as load_world

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


# ------------------------------------------------------------------ roofline

def test_roofline_counts_hand_worked():
    # 640x480, two lights, no bounce: 307,200 closest-hit and 614,400
    # any-hit queries; 380 boxes read once
    closest, any_hit = roofline.frame_queries(640 * 480, 2, [])
    assert (closest, any_hit) == (307_200, 614_400)
    nbytes = 307_200 * (24 + 32) + 614_400 * (24 + 4 + 1) + 380 * (24 + 4)
    assert nbytes == 35_031_440
    got = roofline.least_seconds(closest, any_hit, 1, 380)
    assert got == pytest.approx(nbytes / 3.35e12, rel=1e-12)
    assert got > (closest + any_hit) * 24 / 67e12  # the bytes bound it


def test_roofline_counts_bounce_rounds():
    closest, any_hit = roofline.frame_queries(100, 2, [15, 3])
    assert (closest, any_hit) == (118, 236)
    two = roofline.least_seconds(2 * closest, 2 * any_hit, 1, 10)
    one = roofline.least_seconds(closest, any_hit, 1, 10)
    assert two == pytest.approx(2 * one - 10 * 28 / 3.35e12)


# ------------------------------------------------------------ metric readers

def _stretch():
    k = tr.DeviceOp
    ops = [k("void bvh_cast_kernel<false, false>(float const*)", 100, 110,
             "kernel"),
           k("bvh_occlude2_kernel(float const*)", 120, 125, "kernel"),
           k("void at::native::elementwise_kernel<...>", 130, 160, "kernel"),
           k("Memset (Device)", 170, 171, "memset"),
           k("Memcpy DtoH (Device -> Pageable)", 180, 200, "memcpy"),
           k("void at::native::bvh_cast_kernel_like_glue()", 210, 212,
             "kernel")]
    host = [(90.0, 300.0, "rtbench.frame", 1), (160.0, 170.0, "aten::sum", 1),
            (200.0, 210.0, "aten::item", 1)]
    return tr.Stretch(start=100.0, end=300.0, items=2, ops=ops, host=host,
                      least_cast_s=3e-6)


def _reader(name):
    return spec.metric_reader(name).read


def test_readers_on_a_synthetic_trace():
    st = _stretch()
    busy = 10 + 5 + 30 + 1 + 20 + 2
    assert st.busy_s() == pytest.approx(busy * 1e-6)
    assert st.window_s == pytest.approx(200e-6)
    for kind in ("frame", "train"):
        assert _reader(f"idle_share.{kind}")(st) == pytest.approx(
            100 * (1 - busy / 200))
        # K1 and K2 answer the queries: 15 us over 2 items
        assert _reader(f"cast_roofline.{kind}")(st) == pytest.approx(
            100 * 3e-6 / 7.5e-6)
        # everything else, copies included: (68 - 15) us over 2 items, ms
        assert _reader(f"glue_device_ms.{kind}")(st) == pytest.approx(
            (busy - 15) * 1e-3 / 2)
    assert _reader("launches_per_frame")(st) == pytest.approx(5 / 2)
    assert _reader("launches_per_step")(st) == pytest.approx(5 / 2)
    # a window of 10 steps of 1e6 rays in 2 s before the stretch
    st.window_clock_s, st.window_items, st.item_work = 2.0, 10, 1e6
    assert _reader("mrays_s.train")(st) == pytest.approx(5.0)


def test_readers_find_nothing_in_an_empty_trace():
    st = tr.Stretch(start=0.0, end=10.0, items=1, ops=[], host=[])
    for m in BENCH["per_layer"]:
        assert _reader(m["name"])(st) is None


def test_breakdown_names_the_host_op_of_each_gap():
    bd = tr.breakdown(_stretch())
    assert bd["device_ops"][0] == [
        "void at::native::elementwise_kernel<...>", pytest.approx(30e-6)]
    gaps = dict((n, s) for n, s in bd["idle_gaps"])
    # gaps: 110-120, 125-130 (frame), 160-170 (sum), 171-180 (frame),
    # 200-210 (item), 212-300 (frame)
    assert gaps["aten::sum"] == pytest.approx(10e-6)
    assert gaps["aten::item"] == pytest.approx(10e-6)
    assert gaps["rtbench.frame"] == pytest.approx((10 + 5 + 9 + 88) * 1e-6)


# ------------------------------------------------------------------ traffic

def _values():
    cfg = spec.load_json(ROOT / "rtbench/configs/terrain8_stress.json")
    return load_world(cfg["world"]).values()


def test_orbit_repeats_for_a_seed_and_moves_with_it():
    pos = np.array([0.0, 18.0, -4.0], np.float32)
    rot = np.array([-0.4871745, 0.0, 0.0, -0.87330467], np.float32)
    s1, s2 = generate.orbit_start(2**31 + 7), generate.orbit_start(2**31 + 7)
    s3 = generate.orbit_start(2**31 + 8)
    assert s1 == s2 and s3 != s1 and 0.0 <= s1 < 360.0

    def path(start, step, n):
        cams = [generate.orbit_view(pos, rot, start, step, i)
                for i in range(n)]
        return (np.stack([c[0] for c in cams]),
                np.stack([c[1] for c in cams]))

    p, a = path(s1, 2.01, 2000)
    q, b = path(s2, 2.01, 2000)
    assert np.array_equal(p, q) and np.array_equal(a, b)
    # carried round the y axis: height and radius kept
    assert np.allclose(p[:, 1], 18.0)
    assert np.allclose(np.hypot(p[:, 0], p[:, 2]), 4.0, atol=1e-5)
    # unit quaternions, one 2.01-degree turn apart
    assert np.allclose(np.linalg.norm(a, axis=1), 1.0, atol=1e-6)
    cos = np.abs((a[1:] * a[:-1]).sum(1))
    assert np.allclose(cos, np.cos(np.radians(1.005)), atol=1e-6)
    # a step that does not divide 360: no camera comes back in a window's
    # frames, where 2 degrees brings each back every 180 frames
    assert len({(x.tobytes(), y.tobytes()) for x, y in zip(p, a)}) == 2000
    p2, a2 = path(s1, 2.0, 181)
    assert np.array_equal(p2[0], p2[180]) and np.array_equal(a2[0], a2[180])


def test_training_start_repeats_for_a_seed_and_moves_with_it():
    traffic = spec.load_json(ROOT / "rtbench/traffic/train.1080p.json")
    vals = _values()
    _, r1, f1, p1 = generate.train_start(vals, 3_000_000_017, traffic)
    _, r2, f2, p2 = generate.train_start(vals, 3_000_000_017, traffic)
    _, r3, f3, p3 = generate.train_start(vals, 3_000_000_018, traffic)
    assert np.array_equal(r1, r2) and f1 == f2
    assert all(np.array_equal(p1[k], p2[k]) for k in vals)
    assert not np.array_equal(r1, r3) and f1 != f3
    assert any(not np.array_equal(p1[k], p3[k]) for k in vals)
    lo, hi = traffic["kd_scale"]
    assert lo <= f1 <= hi
    for k in vals:
        if not k.startswith("cam_"):
            # zeros stay zero: an opaque world stays opaque
            assert np.array_equal(p1[k] == 0, vals[k] == 0)
            assert np.allclose(p1[k], vals[k],
                               rtol=traffic["perturb"] + 1e-6)


def test_reservoir_and_pixels_repeat_for_a_seed():
    def kept(seed):
        r = generate.Reservoir(4, seed)
        for i in range(100):
            r.offer(lambda i=i: i)
        return r.items

    assert kept(9) == kept(9) and kept(9) != kept(10)
    assert len(set(kept(9))) == 4
    px = generate.pixels(9, 3, 640 * 480, 1000)
    assert all(len(np.unique(p)) == 1000 for p in px)
    assert all(np.array_equal(a, b) for a, b in
               zip(px, generate.pixels(9, 3, 640 * 480, 1000)))


# ------------------------------------------------ reference against the port

@pytest.mark.parametrize("spp", [1, 2])
@pytest.mark.parametrize("name", ["terrain8", "terrain8_stress"])
def test_reference_frame_equals_the_ports_plain_engine(name, spp, tmp_path):
    """At 64x48 the plain reference and the port's ``"torch"`` engine give
    the same frame, at spp 1 and through the jittered sample sweep that a
    mix with ``spp`` > 1 takes (a test may import the port; the reference
    may not)."""
    from rtbench import program
    from raytracer_tpu_torch.render.engine import render_frame

    cfg = spec.load_json(ROOT / f"rtbench/configs/{name}.json")
    world = load_world(cfg["world"])
    pos, rot = generate.orbit_view(world.cam_pos, world.cam_rot,
                                   generate.orbit_start(11), 2.01, 40)
    u2p = program.unit_to_pixels(world, 64)
    scene, rcfg = program.load_world(cfg["world"], "cpu", 64, 48, spp)
    cam = program.camera(pos, rot, world.cam_near, u2p, "cpu")
    got = render_frame(scene, cam, rcfg.replace(engine="torch"))
    sc = cubes.make_scene(world, "cpu")
    P = cubes.world_params(world, "cpu")
    P["cam_pos"], P["cam_rot"] = torch.as_tensor(pos), torch.as_tensor(rot)
    want = cubes.render_frame(sc, P, cubes.View(
        float(world.cam_near), float(u2p), 64, 48), spp)
    assert float(got.sum()) > 0
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


# -------------------------------------------------------- BENCHMARK.json

def test_every_cell_resolves_to_its_files():
    for w in BENCH["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.config["reference"] and cell.reference().render_frame
        assert cell.kind().Run
        assert set(cell.limits["limits"]) and all(
            "limit" in v for v in cell.limits["limits"].values())
        e2e = [m["name"] for m in cell.end_to_end]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in e2e
            assert callable(spec.metric_reader(m["name"]).read)


def test_names_units_and_keys_follow_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for entry in BENCH["configs"] + BENCH["workloads"] + metrics:
        assert NAME.match(entry["name"]), entry["name"]
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "layer", "moves", "workloads"}
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    names = [m["name"] for m in metrics]
    assert len(names) == len(set(names))
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file() and len(c["source"]) <= 200
        assert c["file"].startswith("rtbench/")
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_a_cell_is_added_by_files_and_an_entry_alone(tmp_path):
    """A new mix and a new cell on an existing world, with no edit of any
    file that is there: a copy of the benchmark's data beside a new
    traffic file, limits file and ``BENCHMARK.json`` entry, run on the CPU
    at a tiny size."""
    from rtbench.run import run_cell

    pkg = tmp_path / "rtbench"
    for sub in ("traffic", "limits", "metrics"):
        shutil.copytree(ROOT / "rtbench" / sub, pkg / sub)
    mix = dict(spec.load_json(ROOT / "rtbench/traffic/frame.1080p.json"),
               width=40, height=30, check_frames=2, check_pixels=200,
               warmup_frames=1)
    (pkg / "traffic" / "frame.tiny.json").write_text(json.dumps(mix))
    (pkg / "limits" / "terrain8_stress.frame.tiny.json").write_text(
        json.dumps({"limits": {"px_off_pct": {"limit": 0.5}}}))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({
        "name": "terrain8_stress.frame.tiny", "config": "terrain8_stress",
        "traffic": "frame.tiny", "chips": 1, "why": "a dry run"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "terrain8_stress.frame.1080p" in m.get("workloads", []):
            m["workloads"] = m["workloads"] + ["terrain8_stress.frame.tiny"]
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    cell = spec.load_cell("terrain8_stress.frame.tiny", path, pkg)
    res, compared = run_cell(cell, 2**31 + 99, 0.5, False,
                             torch.device("cpu"))
    assert res["correct"] and res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"frame_ms", "frame_ms_p95",
                                   "peak_mem_gib", "setup_s"}
    assert compared["px_off_pct"][0] == 0.0


def test_without_a_card_there_is_no_result():
    """A run that finds no CUDA device exits non-zero and prints nothing
    on standard output: it never falls back to the CPU."""
    import os
    import subprocess
    import sys

    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", "rtbench.run", "--workload",
         "terrain8.frame.640x480", "--seed", str(2**31 + 1), "--seconds",
         "1", "--trace", "0"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    assert "no result" in out.stderr
