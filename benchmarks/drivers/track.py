"""Driver: one client demixing one track at a time through
``Separator.demix_track``, in a closed loop (what the CLI does, minus the
WAV files).

Set-up makes the weights, a pool of ``pool_tracks`` tracks (the traffic's
fixed set of lengths, seeded noise on the host), a seeded order of the
pool and a shift seed per call, then demixes the longest track and two
others to warm every shape and the host's buffers for the stems.  The window demixes the pool in that order, over and
over; each call's wall time runs from the call to the stems on the host.
A seeded reservoir of the calls' stems, and the last stems of the pool's
longest track, are kept for the comparison.
"""

from __future__ import annotations

import gc
import sys
import time
import traceback

import numpy as np

from benchmarks.harness import checks, counts, generate, system
from benchmarks.harness.trace import span

E2E = {"track_p90_s": "s"}


def setup(run) -> dict:
    import torch
    from umx_tpu_torch.engine.separator import Separator

    cfg, tr = run.cell.config, run.cell.traffic
    sd = generate.state_dicts(cfg, run.seed, run.device)
    sep = Separator(system.params(sd, cfg, run.device), system.engine_config(cfg), run.device)
    del sd
    lengths = generate.stratified_lengths(tr["pool_tracks"], tr["length_s"], cfg["sample_rate"])
    r = generate.rng(run.seed, "pool")
    pool = generate.audio(lengths, run.seed, "pool", run.device)
    order = [int(i) for i in r.permutation(len(pool))]
    call_seeds = [int(s) for s in r.integers(0, 2**31, 4096)]
    longest = int(np.argmax(lengths))
    for i in (longest, *order[:2]):  # warm-up: the shapes, and the host's stem buffers
        sep.demix_track(pool[i], seed=call_seeds[-1])
    if run.device.type == "cuda":
        torch.cuda.synchronize()
    return {"sep": sep, "pool": pool, "order": order, "call_seeds": call_seeds,
            "longest": longest}


def window(run, st: dict, seconds: float, recorder) -> dict:
    cfg, tr = run.cell.config, run.cell.traffic
    keep_rng = generate.rng(run.seed, "keep")
    m = tr["check_tracks"] - 1
    pool, order, call_seeds = st["pool"], st["order"], st["call_seeds"]
    times, done, reservoir, longest = [], [], [], None
    attempted = failed = 0
    with recorder.window():
        t0 = time.perf_counter()
        k = 0
        while time.perf_counter() - t0 < seconds:
            i, seed = order[k % len(order)], call_seeds[k % len(call_seeds)]
            k += 1
            attempted += 1
            start = time.perf_counter()
            try:
                with span("bench.demix_track"):
                    out = st["sep"].demix_track(pool[i], seed=seed)
            except Exception:  # a failed call counts, and the loop goes on
                traceback.print_exc()
                failed += 1
                continue
            times.append(time.perf_counter() - start)
            n = len(done)
            done.append(i)
            if n < m:
                reservoir.append((i, seed, out))
            else:
                j = int(keep_rng.integers(0, n + 1))
                if j < m:
                    reservoir[j] = (i, seed, out)
            if i == st["longest"]:
                longest = (i, seed, out)
            del out
    e2e = {}
    if times:
        e2e["track_p90_s"] = float(np.percentile(times, 90))
        print(f"bench: track seconds n {len(times)}, first {[round(t, 3) for t in times[:5]]}, "
              f"median {np.median(times):.4f}, max {max(times):.4f}", file=sys.stderr)
    g = counts.geometry(cfg)
    chunks = [counts.track_chunks(pool[i].shape[1], cfg) for i in done]
    work = {"frames": sum(chunks) * g["seg_frames"], "segments": sum(chunks),
            "recurrence_calls": {1: sum(chunks) * cfg["nb_layers"]},
            "steps": g["seg_frames"], "tracks": len(done),
            "audio_s": sum(pool[i].shape[1] for i in done) / cfg["sample_rate"]}
    return {"attempted": attempted, "failed": failed, "e2e": e2e, "reservoir": reservoir,
            "longest": longest, "work": work, "times": times}


def release(st: dict) -> None:
    import torch

    st.pop("sep", None)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def check(run, st: dict, result: dict, control: bool = False, detail: dict | None = None) -> dict:
    """The compared numbers: the longest track's last stems and the
    reservoir's against the reference's."""
    picks = [result["longest"]] if result["longest"] is not None else []
    picks += [p for p in result["reservoir"] if all(p[:2] != q[:2] for q in picks)]
    if not picks:
        return {"stem_rel_l1": float("inf")}
    picks = [(st["pool"][i], seed, out) for i, seed, out in picks]
    return {"stem_rel_l1": checks.demix_gap(run, picks, control, detail)}
