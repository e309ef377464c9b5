"""Nothing the benchmark runs imports JAX or the JAX package, and the
plain reference imports nothing of the program.

Each check runs in a fresh CPU process and compares the top-level name of
every loaded module (the part before the first dot) whole: the port,
``raytracer_tpu_torch``, begins with the JAX package's name and is allowed
on the program's side only.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

HARNESS_RUN = """
import json, sys, torch
from rtbench import control, run, spec
cell = spec.load_cell("terrain8.frame.640x480")
cell.traffic = dict(cell.traffic, width=32, height=24, check_pixels=64,
                    check_frames=2, warmup_frames=1)
res, _ = run.run_cell(cell, 5, 0.2, False, torch.device("cpu"))
print(json.dumps({"tops": sorted({m.split(".")[0] for m in sys.modules}),
                  "correct": res["correct"]}))
"""

REFERENCE_ONLY = """
import json, sys
from rtbench import generate, roofline, world
from rtbench.reference import cubes
print(json.dumps({"tops": sorted({m.split(".")[0] for m in sys.modules})}))
"""


def _tops(code: str) -> dict:
    env = dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax():
    got = _tops(HARNESS_RUN)
    assert got["correct"]
    assert "raytracer_tpu_torch" in got["tops"]  # the run did drive the port
    for name in ("jax", "jaxlib", "flax", "raytracer_tpu"):
        assert name not in got["tops"]


def test_reference_loads_nothing_of_the_program():
    tops = _tops(REFERENCE_ONLY)["tops"]
    for name in ("jax", "jaxlib", "flax", "raytracer_tpu",
                 "raytracer_tpu_torch"):
        assert name not in tops


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    from rtbench.run import forbidden_modules

    before = forbidden_modules()
    assert "raytracer_tpu" not in before
    monkeypatch.setitem(sys.modules, "raytracer_tpu_torch_fake", sys)
    monkeypatch.setitem(sys.modules, "jaxlike.sub", sys)
    assert forbidden_modules() == before
    monkeypatch.setitem(sys.modules, "raytracer_tpu.render", sys)
    assert "raytracer_tpu" in forbidden_modules()
