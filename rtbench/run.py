"""Run one benchmark cell once and print its result line.

    python3 -m rtbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (the program's import and kernel build, the world, the cell's own
shapes warmed up) counts in ``setup_s``; then the window drives the cell's
items in a closed loop for ``--seconds`` seconds, on one core of the host
and with the set-up's objects out of the garbage collector's scans.
``--trace 1`` also profiles a few items after the window's close and
reports the per-layer metrics instead of the end-to-end ones.  After
the window the program's state is freed and the plain reference checks
what the window produced; every compared number is printed beside its
limit, on standard error and under ``compared``, the last key of the
result line.  Exits non-zero, printing no result, without enough CUDA
devices, or when JAX or the JAX package was imported.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "raytracer_tpu")
GIB = float(1 << 30)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's (``raytracer_tpu_torch`` is the port, and allowed)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit_w():
    """The card's power limit in watts, as ``nvidia-smi`` reads it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20).stdout.split()
        return float(out[0]) if out else None
    except (OSError, ValueError, subprocess.TimeoutExpired):
        return None


def pin_one_core():
    """Keep the calling thread on one core, the highest it may use, so
    the window's host work does not move between cores; the cores it had,
    or None where the host cannot say."""
    try:
        cores = os.sched_getaffinity(0)
        os.sched_setaffinity(0, {max(cores)})
        return cores
    except (AttributeError, OSError):
        return None


def _mem(device, reset: bool = False) -> int:
    import torch

    if device.type != "cuda":
        return 0
    if reset:
        torch.cuda.reset_peak_memory_stats(device)
    return int(torch.cuda.max_memory_allocated(device))


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t0: float = None):
    """One run of ``cell``: ``(result dict, compared {name: (value,
    limit)})``.  ``device`` is the program's and the reference's."""
    import torch

    from . import trace as tracing
    from .spec import metric_reader

    t0 = time.perf_counter() if t0 is None else t0
    ref = cell.reference()
    run = cell.kind().Run(cell, seed, device)
    run.setup()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t0
    setup_peak = _mem(device)
    _mem(device, reset=True)

    n_trace = cell.traffic["trace_items"] if trace else 0
    items = 0
    marks = []  # (seconds into the window, items done): the run's course
    gc.collect()  # the set-up's garbage is not the window's to collect
    gc.freeze()  # nor are its live objects the window's to scan
    cores = pin_one_core()
    w0 = time.perf_counter()
    while items < run.min_items or time.perf_counter() - w0 < seconds:
        run.item(items)
        items += 1
        now = time.perf_counter() - w0
        if not marks or now - marks[-1][0] >= 5.0:
            marks.append((now, items))
    window_s = time.perf_counter() - w0
    window_items = items
    window_peak = _mem(device)
    if trace:
        # after the window's close, so that its clock and course are an
        # untraced run's: one item warms the profiler, then the stretch
        # (items window_items + 1 .. window_items + n_trace)
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            *([torch.profiler.ProfilerActivity.CUDA]
              if device.type == "cuda" else [])])
        prof.start()
        run.item(items)
        items += 1
        with torch.profiler.record_function(tracing.SPAN):
            for _ in range(n_trace):
                run.item(items)
                items += 1
        prof.stop()
    if cores is not None:
        os.sched_setaffinity(0, cores)
    gc.unfreeze()
    if marks[-1][1] != window_items:
        marks.append((window_s, window_items))
    print("window: items a second, each stretch of ~5 s: " + " ".join(
        f"{(n1 - n0) / (t1 - t0):.3f}" for (t0, n0), (t1, n1) in
        zip(marks, marks[1:])), file=sys.stderr)

    metrics = dict(run.end_to_end(window_s, window_items))
    own = {k: v for k, v in metrics.items()
           if k not in {m["name"] for m in cell.end_to_end}}
    if own:  # the kind's own numbers that no end-to-end metric reports
        print("window: " + " ".join(f"{k} {v!r}" for k, v in own.items()),
              file=sys.stderr)
    metrics["setup_s"] = setup_s
    metrics["peak_mem_gib"] = window_peak / GIB
    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu"),
                "count": cell.chips,
                "memory_peak_bytes": max(setup_peak, window_peak),
                "power_limit_w": power_limit_w()
                if device.type == "cuda" else None}
    failed = run.failed()
    outputs = run.outputs()
    run.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    breakdown = None
    if trace:
        st = tracing.stretch_from(prof, n_trace)
        st.least_cast_s = run.least_cast_s(
            range(window_items + 1, window_items + n_trace + 1), ref, device)
        st.window_clock_s, st.window_items = window_s, window_items
        st.item_work = getattr(run, "item_work", None)
        values = {}
        for m in cell.per_layer:
            v = metric_reader(m["name"]).read(st)
            if v is not None:
                values[m["name"]] = (v, m["unit"])
        dev_info["busy_s"] = st.busy_s()
        dev_info["window_s"] = st.window_s
        breakdown = tracing.breakdown(st)
    else:
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        missing = set(units) - set(metrics)
        if missing:
            raise RuntimeError(f"{cell.name}: no value for {sorted(missing)}")
        values = {k: (metrics[k], units[k]) for k in units}

    ref.strict_fp32()
    got = run.compare(outputs, ref, device)
    limits = cell.limits["limits"]
    compared = {k: (got[k], limits[k]["limit"]) for k in limits}
    correct = (all(math.isfinite(v) and v <= lim
                   for v, lim in compared.values())
               and set(got) >= set(limits))
    result = {"correct": bool(correct), "attempted": items,
              "failed": failed,
              "metrics": {k: {"value": v, "unit": u}
                          for k, (v, u) in values.items()},
              "device": dev_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    return result, compared


def emit(result: dict, compared: dict) -> None:
    for name, (value, limit) in compared.items():
        print(f"compared {name}: {value!r} (limit {limit!r})",
              file=sys.stderr)
    line = dict(result)
    line["compared"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in compared.items()}
    sys.stderr.flush()
    print(json.dumps(line), flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from .spec import load_cell

    torch.set_num_threads(1)  # one process with few threads: a steady host
    cell = load_cell(args.workload)
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell.chips):
        print(f"rtbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              ": no result", file=sys.stderr)
        return 3
    result, compared = run_cell(cell, args.seed, args.seconds,
                                bool(args.trace), torch.device("cuda", 0), T0)
    found = forbidden_modules()
    if found:
        print(f"rtbench: loaded {', '.join(found)} (JAX or the JAX "
              "package): no result", file=sys.stderr)
        return 4
    emit(result, compared)
    return 0


if __name__ == "__main__":
    sys.exit(main())
