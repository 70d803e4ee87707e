"""Readings that the limits of a cell's comparison are set from.

    python3 -m benchmarks.calibrate --workload <cell> --seeds <a,b,...>
        [--control-seeds <c,d,e>] [--faults <name,...> --fault-seeds <f,g,h>]
        [--seconds <s>] [--out <file.jsonl>]

In one process on the card, for each seed of ``--seeds`` a sound run of
the cell (set-up, a window of ``--seconds``, the comparison); for each of
``--control-seeds`` the control, the reference with TF32 products in the
system's place, on the tracks or batches such a run compares; for each
fault of ``--faults`` (``harness/faults.py``) and each of
``--fault-seeds`` a run with the fault planted under the timed path.
Each reading is one JSON line on standard output, and in ``--out``.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from benchmarks import run as R
from benchmarks.harness import cells, faults, trace


def reading(cell, seed: int, seconds: float, device, control=False, fault=None) -> dict:
    drv = cell.driver()
    run = R.Run(cell, seed, device, False)
    t0 = time.time()
    st = drv.setup(run)
    result = drv.window(run, st, seconds, trace.Recorder(False))
    drv.release(st)
    detail = {}
    numbers = drv.check(run, st, result, control=control, detail=detail)
    return {"cell": cell.name, "seed": seed, "kind": "control" if control else fault or "sound",
            "numbers": numbers, "detail": detail, "e2e": result["e2e"],
            "attempted": result["attempted"],
            "failed": result["failed"], "seconds": time.time() - t0}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m benchmarks.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--faults", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no card", file=sys.stderr)
        return 2
    cell = cells.load_cell(args.workload)
    device = torch.device("cuda", 0)
    table = faults.TRAIN if cell.traffic["driver"] == "train" else faults.DEMIX
    seeds = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    plan = [(s, False, None) for s in seeds(args.seeds)]
    plan += [(s, True, None) for s in seeds(args.control_seeds)]
    plan += [(s, False, f) for f in args.faults.split(",") if f for s in seeds(args.fault_seeds)]
    out = open(args.out, "a") if args.out else None
    for seed, control, fault in plan:
        if fault:
            with table[fault]():
                line = reading(cell, seed, args.seconds, device, fault=fault)
        else:
            line = reading(cell, seed, args.seconds, device, control=control)
        text = json.dumps(line)
        print(text, flush=True)
        if out:
            out.write(text + "\n")
            out.flush()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
