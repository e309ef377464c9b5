"""The port's live viewer (``python -m raytracer_tpu_torch.live_viewer``)
in its ``--selftest`` on the CPU: the page, a PNG frame, a key and a mouse
move rendered again (at least two frames, a changed PNG), then one FPS
window of moves, ``selftest OK``; the process exits 0 with its render and
server threads joined."""

import os
import re
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = os.path.join(REPO, "raytracer_tpu_torch", "worlds", "terrain8.json")


def test_live_viewer_selftest():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.run(
        [sys.executable, "-m", "raytracer_tpu_torch.live_viewer", "-c", WORLD,
         "--width", "96", "--height", "64", "--device", "cpu", "--port",
         str(port), "--selftest"],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    m = re.search(r"selftest OK: frames=(\d+) fps=([\d.]+)", proc.stdout)
    assert m, proc.stdout
    assert int(m.group(1)) >= 2 and float(m.group(2)) > 0
    assert "96x64, cuda engine, cpu" in proc.stdout
