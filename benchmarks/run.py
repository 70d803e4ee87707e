"""Run one cell of the benchmark of ``umx_tpu_torch`` once, on the card.

    python3 -m benchmarks.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell's files (``benchmarks/workloads/
<cell>.json`` and the configuration, traffic mix and driver it names) say
what runs.  Set-up builds the system from the seed and warms every shape
the cell's traffic uses; the window then measures for ``--seconds``.
With ``--trace 0`` the result carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from a ``torch.profiler`` trace
of the window and the harness's own counts.  After the window, and after
the system's state is freed, the outputs the window produced are compared
with the plain reference; ``correct`` says whether every compared number
kept within its limit.

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each compared number beside its
limit); the last lines of standard error give the same numbers.  Without
a CUDA card, with fewer cards than the cell asks for, or without the
system beside the benchmark, the run prints no result and exits with 2;
if JAX or the JAX package was loaded, with 3.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from dataclasses import dataclass
from pathlib import Path

from benchmarks.harness import device as devmod

CHECKOUT = Path(__file__).resolve().parent.parent


@dataclass
class Run:
    """One run of one cell: what the drivers read."""

    cell: object
    seed: int
    device: object
    traced: bool


@dataclass
class Reading:
    """What a per-layer metric's reader reads."""

    config: dict
    work: dict
    trace: object  # harness.trace.Trace, or None when the trace is empty
    e2e: tuple


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python3 -m benchmarks.run", description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def per_layer(cell, driver, result, trace) -> dict:
    """Every reader whose end-to-end metric this cell reports, and that
    finds something to read."""
    from benchmarks.harness import cells

    reading = Reading(cell.config, result["work"], trace, tuple(driver.E2E))
    out = {}
    for name, reader in cells.readers().items():
        if reader.MOVES not in reading.e2e:
            continue
        value = reader.read(reading)
        if value is not None:
            out[name] = {"value": value, "unit": reader.UNIT}
    return out


def judge(numbers: dict, limits: dict, attempted: int, failed: int) -> tuple[bool, dict]:
    """``correct`` and each compared number beside its limit."""
    checks = {k: {"value": v, "limit": limits.get(k)} for k, v in numbers.items()}
    ok = attempted > 0 and failed == 0 and bool(checks)
    for c in checks.values():
        ok = ok and c["limit"] is not None and math.isfinite(c["value"]) and c["value"] <= c["limit"]
    return ok, checks


def main(argv=None) -> int:
    t_start = devmod.process_start()
    args = parse(argv)
    from benchmarks.harness import cells

    try:
        cell = cells.load_cell(args.workload)
    except (FileNotFoundError, ValueError) as exc:
        print(f"bench: {exc}", file=sys.stderr)
        return 2
    devmod.cache_dirs(str(CHECKOUT))
    import torch

    try:
        devmod.require_cards(cell.chips)
    except devmod.NoCard as exc:
        print(f"bench: {exc}; no result", file=sys.stderr)
        return 2
    try:
        import umx_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"bench: the system under test is not beside the benchmark ({exc}); no result",
              file=sys.stderr)
        return 2
    print(f"bench: card {devmod.card_line()}; cell {cell.name}, seed {args.seed}, "
          f"{args.seconds:g} s, trace {args.trace}", file=sys.stderr, flush=True)
    out = execute(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), t_start)
    found = devmod.forbidden_modules()
    if found:
        print(f"bench: the process holds {', '.join(found)}; no result", file=sys.stderr)
        return 3
    report(out)
    return 0


def execute(cell, seed: int, seconds: float, traced: bool, device, t_start: float) -> dict:
    """Set up, measure, trace and compare one run of ``cell``: the result
    line's object."""
    import torch

    from benchmarks.harness import trace

    cuda = device.type == "cuda"
    run = Run(cell, seed, device, traced)
    driver = cell.driver()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    st = driver.setup(run)
    setup_s = time.time() - t_start
    recorder = trace.Recorder(traced)
    t_window = time.time()
    result = driver.window(run, st, seconds, recorder)
    t_window = time.time() - t_window
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else device.type,
           "count": cell.chips, "memory_peak_bytes": torch.cuda.max_memory_allocated(device)
           if cuda else 0}
    out = {"correct": False, "attempted": result["attempted"], "failed": result["failed"]}
    if traced:
        tr, why = recorder.summary()
        recorder.prof = None
        if tr is None:
            print(f"bench: no per-layer number from the trace: {why}", file=sys.stderr)
        else:
            dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
        out["metrics"] = per_layer(cell, driver, result, tr)
        out["device"] = dev
        if tr is not None:
            out["breakdown"] = {"device_ops": trace.top(tr.device_ops),
                                "idle_gaps": trace.top(tr.idle_by_host)}
    else:
        out["metrics"] = {k: {"value": v, "unit": driver.E2E[k]} for k, v in result["e2e"].items()}
        out["metrics"]["setup_s"] = {"value": setup_s, "unit": "s"}
        out["device"] = dev
    driver.release(st)
    t_check = time.time()
    numbers = driver.check(run, st, result)
    print(f"bench: set-up {setup_s:.2f} s, window {t_window:.2f} s, comparison "
          f"{time.time() - t_check:.2f} s", file=sys.stderr)
    out["correct"], out["checks"] = judge(numbers, cell.limits, result["attempted"],
                                          result["failed"])
    return out


def report(out: dict) -> None:
    """The metrics and the compared numbers on standard error, the compared
    numbers last, then the result line on standard output."""
    for k, v in out["metrics"].items():
        print(f"bench: {k} {v['value']!r} {v['unit']}", file=sys.stderr)
    print(f"bench: correct {out['correct']}; attempted {out['attempted']}, failed "
          f"{out['failed']}", file=sys.stderr)
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    sys.exit(main())
