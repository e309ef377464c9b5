"""Elastic training on the port's CLI (``--elastic``, ``elastic.py``), on
the CPU: ``tests/test_train_cli.py``'s three cases with ``--device cpu`` on
terrain8 at 48x32.

* A worker that crashes after step 2 (``RT_FAULT_AT_STEP``, exit code 13)
  is restarted from its checkpoint, and the final checkpoint equals an
  uninterrupted run's bit for bit (a step is a pure function of the
  parameters, and the CPU adds in a fixed order).
* A worker that stops beating after step 1 (``RT_HANG_AT_STEP``) is killed
  after ``--hang-timeout`` (20 s) and restarted; the run completes.
* A failure that repeats (a checkpoint in a directory that does not exist)
  spends the restart budget: ``main`` returns 1 and logs
  ``elastic_gave_up``.

Each worker is a fresh ``python -m raytracer_tpu_torch.cli`` process
(about 5 s on two threads).
"""

import os

import numpy as np

from raytracer_tpu_torch import cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = ["--config", os.path.join(REPO, "raytracer_tpu_torch", "worlds",
                                  "terrain8.json"),
         "--width", "48", "--height", "32", "--device", "cpu",
         "--checkpoint-every", "1", "--lr", "0.05"]


def _params(ckpt):
    with np.load(ckpt) as data:
        return ({k: data[k] for k in data.files if k.startswith("arr_")},
                int(data["__step__"]))


def _run_clean(tmp_path, steps=4):
    ckpt = str(tmp_path / "clean.npz")
    assert cli.main(WORLD + ["--train-until", str(steps),
                             "--checkpoint", ckpt]) == 0
    return _params(ckpt)


def _small_workers(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "2")


def test_crash_recovery_matches_uninterrupted(tmp_path, capfd, monkeypatch):
    _small_workers(monkeypatch)
    want, want_step = _run_clean(tmp_path)
    capfd.readouterr()
    ckpt = str(tmp_path / "elastic.npz")
    monkeypatch.setenv("RT_FAULT_AT_STEP", "2")
    monkeypatch.setenv("RT_FAULT_MARKER", str(tmp_path / "crashed.marker"))
    rc = cli.main(WORLD + ["--train-until", "4", "--checkpoint", ckpt,
                           "--elastic", "2", "--hang-timeout", "300"])
    assert rc == 0
    assert os.path.exists(str(tmp_path / "crashed.marker"))
    err = capfd.readouterr().err
    assert '"elastic_failure"' in err and "crash rc=13" in err
    assert '"elastic_restart"' in err and '"elastic_done"' in err
    assert '"checkpoint_restored"' in err
    got, got_step = _params(ckpt)
    assert got_step == want_step == 4
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_hang_detection_and_recovery(tmp_path, capfd, monkeypatch):
    _small_workers(monkeypatch)
    ckpt = str(tmp_path / "hung.npz")
    monkeypatch.setenv("RT_HANG_AT_STEP", "1")
    monkeypatch.setenv("RT_FAULT_MARKER", str(tmp_path / "hung.marker"))
    # the worker beats every step; a 20 s silence is a hang
    rc = cli.main(WORLD + ["--train-until", "3", "--checkpoint", ckpt,
                           "--elastic", "1", "--hang-timeout", "20"])
    assert rc == 0
    err = capfd.readouterr().err
    assert '"fault_injected", "kind": "hang"' in err
    assert '"elastic_failure", "kind": "hang"' in err
    assert '"elastic_done"' in err
    _, got_step = _params(ckpt)
    assert got_step == 3


def test_restart_budget_exhaustion_surfaces(tmp_path, capfd, monkeypatch):
    """A failure that repeats fails loudly once the budget is spent: a
    checkpoint in a directory that does not exist makes every attempt
    crash at its first save, with no progress to resume."""
    _small_workers(monkeypatch)
    ckpt = str(tmp_path / "no_dir" / "loop.npz")
    rc = cli.main(WORLD + ["--train-until", "3", "--checkpoint", ckpt,
                           "--elastic", "1", "--hang-timeout", "300"])
    assert rc == 1
    err = capfd.readouterr().err
    assert err.count('"elastic_failure"') == 2  # the first and 1 restart
    assert '"elastic_gave_up"' in err


def test_strip_elastic_flags():
    argv = ["-c", "w.json", "--elastic", "2", "--train-until", "4",
            "--hang-timeout=20", "--elastic=3", "--hang-timeout", "5"]
    assert cli._strip_elastic_flags(argv) == ["-c", "w.json",
                                              "--train-until", "4"]
