"""``tracing.py`` of the port against the JAX package's, on the CPU.

* ``FrameStats``: one list of step times (``time.perf_counter`` patched
  in each module) gives both classes the same ``frames``, ``total_ms``
  and ``mean_ms``, and the same ``frame`` lines.
* ``profile_trace`` writes a Chrome trace into its directory that names
  the frame's ops, logs ``profile_trace_written``, writes the trace when
  the block raises and lets the error through; ``--profile-dir`` traces
  the CLI's training loop.
"""

import json
import os

import pytest
import torch

from raytracer_tpu import tracing as jtracing

import raytracer_tpu_torch as rtt
from raytracer_tpu_torch import cli, tracing
from raytracer_tpu_torch.builder import scale_camera
from raytracer_tpu_torch.render.engine import render_frame

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TERRAIN8 = os.path.join(REPO, "raytracer_tpu_torch", "worlds",
                        "terrain8.json")


class _Clock:
    """``perf_counter`` stand-in: enter and exit times in turn."""

    def __init__(self, stamps):
        self._stamps = iter(stamps)

    def __call__(self):
        return next(self._stamps)


def _frame_lines(err):
    return [{k: v for k, v in json.loads(line).items() if k != "t"}
            for line in err.splitlines() if '"frame"' in line]


@pytest.mark.parametrize("seconds", [[0.5, 12.25, 3.0], [], [1e-3] * 7])
def test_frame_stats_total_and_mean_match_jax(monkeypatch, capsys,
                                              seconds):
    stamps = []
    t = 100.0
    for s in seconds:
        stamps += [t, t + s]
        t += s + 1.0
    stats = {}
    lines = {}
    for name, mod in (("jax", jtracing), ("port", tracing)):
        monkeypatch.setattr(mod.time, "perf_counter", _Clock(stamps))
        st = mod.FrameStats(width=64, height=48, spp=2)
        for _ in seconds:
            with st:
                pass
        stats[name] = (st.frames, st.total_ms, st.mean_ms)
        lines[name] = _frame_lines(capsys.readouterr().err)
        monkeypatch.undo()
    assert stats["port"] == stats["jax"]
    assert lines["port"] == lines["jax"]
    assert stats["port"][0] == len(seconds)
    assert stats["port"][1] == pytest.approx(1e3 * sum(seconds))


@pytest.fixture(scope="module")
def small():
    w = rtt.generate(TERRAIN8)
    scene = rtt.to_device(w.scene, "cpu")
    cam = rtt.to_device(scale_camera(w.camera, 32, w.config.width), "cpu")
    return scene, cam, w.config.replace(width=32, height=24, engine="cuda")


def _trace_names(logdir):
    files = os.listdir(logdir)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(os.path.join(logdir, files[0])) as fh:
        return {e.get("name") for e in json.load(fh)["traceEvents"]}


def test_profile_trace_writes_a_trace_of_the_frame(small, tmp_path,
                                                   capsys):
    scene, cam, cfg = small
    logdir = str(tmp_path / "trace")
    with tracing.profile_trace(logdir) as got:
        img = render_frame(scene, cam, cfg)
    assert got == logdir and img.shape == (24, 32, 4)
    names = _trace_names(logdir)
    assert {"aten::where", "aten::index", "aten::minimum"} <= names
    err = capsys.readouterr().err
    rec = [json.loads(line) for line in err.splitlines()
           if '"profile_trace_written"' in line]
    assert len(rec) == 1 and rec[0]["logdir"] == logdir


def test_profile_trace_writes_and_raises_on_error(tmp_path):
    logdir = str(tmp_path / "trace")
    with pytest.raises(ZeroDivisionError):
        with tracing.profile_trace(logdir):
            torch.ones(3) / 1
            1 / 0
    assert "aten::div" in _trace_names(logdir)


def test_cli_profile_dir_traces_the_training_loop(tmp_path, capsys):
    logdir = str(tmp_path / "prof")
    assert cli.main(["-c", TERRAIN8, "--width", "24", "--height", "16",
                     "--device", "cpu", "--train", "1", "--checkpoint",
                     str(tmp_path / "ck.npz"), "--profile-dir",
                     logdir]) == 0
    names = _trace_names(logdir)
    assert "aten::index_add_" in names  # the material rows' backward
    assert '"profile_trace_written"' in capsys.readouterr().err
