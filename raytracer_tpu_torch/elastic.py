"""Failure detection and elastic recovery for long training runs.

Counterpart of ``raytracer_tpu/elastic.py``.  A supervisor runs the
training loop (``cli._train``) in a worker process and watches the
structured heartbeat on its stderr: the ``train_step`` (and ``frame``)
JSON lines that the loop logs through ``tracing.log`` each step.  It
detects two failures:

* a crash: the worker exits with a nonzero code (a killed or preempted
  process, a failed kernel launch);
* a hang: no heartbeat for ``hang_timeout_s`` (a wedged device or a stuck
  collective).  The supervisor kills the exact PID it started, never a
  process found by a pattern.

On either it starts the worker again with the same argv.  The checkpoint
(``--checkpoint-every``) and the absolute target (``--train-until``) make
the restarted worker resume from the last saved step and end in the state
an uninterrupted run ends in; ``max_restarts`` bounds the retries, so a
failure that repeats surfaces instead of looping.  Before a worker's first
heartbeat the limit is ``startup_grace_s``: the start covers importing
torch, building the CUDA kernels on first use and the first step.

The fault injection of the tests is in ``cli._train`` (``RT_FAULT_AT_STEP``,
``RT_HANG_AT_STEP``, ``RT_FAULT_MARKER``).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

from . import tracing

# Only step progress counts as a heartbeat: start-up lines such as
# checkpoint_restored must not end the startup grace early.
HEARTBEAT_EVENTS = ("train_step", "frame")

# the directory that holds the package, so that the worker imports this copy
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclass
class SuperviseResult:
    completed: bool
    restarts: int
    failures: List[str] = field(default_factory=list)  # "crash rc=13", "hang"
    last_step: Optional[int] = None


class _HeartbeatReader(threading.Thread):
    """Drains a worker's stderr into ``sink`` and timestamps heartbeats."""

    def __init__(self, stream, sink):
        super().__init__(daemon=True)
        self._stream = stream
        self._sink = sink
        self.last_beat = time.monotonic()
        self.seen_any = False  # the first heartbeat ends the startup grace
        self.last_step: Optional[int] = None

    def run(self):
        for line in self._stream:
            print(line, end="", file=self._sink, flush=True)
            if line.startswith("{"):
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if rec.get("event") in HEARTBEAT_EVENTS:
                    self.last_beat = time.monotonic()
                    self.seen_any = True
                    if "step" in rec:
                        self.last_step = int(rec["step"])


def _worker_env() -> dict:
    env = dict(os.environ)
    path = env.get("PYTHONPATH", "")
    env["PYTHONPATH"] = _ROOT + (os.pathsep + path if path else "")
    return env


def run_supervised(worker_argv: Sequence[str], max_restarts: int = 3,
                   hang_timeout_s: float = 300.0,
                   startup_grace_s: float = 600.0,
                   poll_s: float = 0.2) -> SuperviseResult:
    """Run ``python -m raytracer_tpu_torch.cli <worker_argv>`` under
    supervision: restart it on a crash or a heartbeat silence, up to
    ``max_restarts`` times.  Returns when a worker exits 0 (``completed``)
    or the restart budget is spent."""
    cmd = [sys.executable, "-m", "raytracer_tpu_torch.cli", *worker_argv]
    env = _worker_env()
    result = SuperviseResult(completed=False, restarts=0)
    for attempt in range(max_restarts + 1):
        if attempt:
            result.restarts += 1
            tracing.log("elastic_restart", attempt=attempt,
                        failures=result.failures)
        proc = subprocess.Popen(cmd, stderr=subprocess.PIPE, text=True,
                                env=env)
        reader = _HeartbeatReader(proc.stderr, sys.stderr)
        reader.start()
        hung = False
        try:
            while True:
                rc = proc.poll()
                if rc is not None:
                    break
                limit = (hang_timeout_s if reader.seen_any
                         else max(hang_timeout_s, startup_grace_s))
                if time.monotonic() - reader.last_beat > limit:
                    hung = True
                    proc.kill()  # the exact worker PID we started
                    rc = proc.wait()
                    break
                time.sleep(poll_s)
        finally:
            if proc.poll() is None:  # the supervisor itself was interrupted
                proc.kill()
                proc.wait()
        reader.join(timeout=5.0)
        result.last_step = reader.last_step
        if not hung and rc == 0:
            result.completed = True
            tracing.log("elastic_done", restarts=result.restarts,
                        last_step=result.last_step)
            return result
        result.failures.append("hang" if hung else f"crash rc={rc}")
        tracing.log("elastic_failure", kind=result.failures[-1],
                    last_step=result.last_step)
    tracing.log("elastic_gave_up", restarts=result.restarts,
                failures=result.failures)
    return result
