"""The precision control of a cell's check, and its faults' readings.

    python3 -m rtbench.control --workload <cell> --seeds <n> [<n> ...]
        [--fault half_batch|answer_altered]

The control is the plain reference put in the program's place, computed
in bfloat16, the nearest precision below the float32 that the worlds are
rendered in (TF32 would change nothing: neither the frame nor the
reference multiplies matrices).  For each seed it prints the numbers that
the cell's check compares, each beside its limit: the control has to fail
one of them.  A frame cell's control renders as many frames and pixels as
a run checks, at views drawn from the seed; a training cell's follows the
check's steps.  ``--fault`` reads a training cell's numbers with one of
the check's faults planted in the reference put in the program's place
(half of the batch left out; the gradient altered where it is produced);
a state left unchanged reads 1 by the check's measure and needs no run.
The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def control_numbers(cell, seed: int, device, fault=None) -> dict:
    import torch

    ref = cell.reference()
    ref.strict_fp32()
    run = cell.kind().Run(cell, seed, device)
    outputs = run.control_outputs(ref, device, torch.bfloat16, fault)
    return run.compare(outputs, ref, device)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--fault", choices=("half_batch", "answer_altered"))
    args = p.parse_args(argv)

    import torch

    from .spec import load_cell

    cell = load_cell(args.workload)
    if not torch.cuda.is_available():
        print("rtbench.control: no CUDA device", file=sys.stderr)
        return 3
    limits = cell.limits["limits"]
    for seed in args.seeds:
        t0 = time.perf_counter()
        got = control_numbers(cell, seed, torch.device("cuda", 0),
                              args.fault)
        fails = [k for k in limits if not got[k] <= limits[k]["limit"]]
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "fault": args.fault, "control": got,
                          "fails": fails,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
