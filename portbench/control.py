"""The readings that a cell's limits are set from, on the card, at the
cell's own size, in one process:

    python -m portbench.control --workload <cell> --seeds 1,2,... \
        [--dtype bfloat16] [--fault half_batch] [--seconds 2]

Each seed runs the cell with a short window (the numbers compared come
from the check steps and chunks, which a short window holds) and prints
one JSON line of the numbers compared.  ``--dtype bfloat16`` runs the
program's own lower-precision path, the control; ``--fault`` plants one
of :mod:`portbench.faults`.  The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
from contextlib import nullcontext

from portbench import faults, harness
from portbench.run import Ctx, set_cache_dirs


def readings(cell, seeds, dtype="float32", fault=None, seconds=2.0,
             device="cuda"):
    """``[(seed, {number: value})]`` for each seed: every number the
    cell's loop computes, compared or not."""
    out = []
    for seed in seeds:
        ctx = Ctx(cell, seed, seconds, False, device, compute_dtype=dtype)
        with faults.planted(fault) if fault else nullcontext():
            out.append((seed, harness.loop_module(cell).run(ctx)["checks"]))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--fault", default=None, choices=faults.FAULTS)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    set_cache_dirs()
    cell = harness.load_cell(args.workload)
    for seed, nums in readings(cell, [int(s) for s in args.seeds.split(",")],
                               args.dtype, args.fault, args.seconds):
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "dtype": args.dtype, "fault": args.fault,
                          "numbers": nums}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
