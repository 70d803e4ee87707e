"""Driver: a catalogue service demixing whole albums through the fleet
runner, ``umx_tpu_torch.engine.fleet.demix_tracks``, in a closed loop.

Set-up makes the weights, a pool of albums (``albums_in_pool`` albums of
``album_tracks`` tracks each, every album the traffic's fixed set of
lengths in a seeded order, the audio seeded noise on the host) and one
shift seed per track, then demixes each album of the pool once: every
bucket's shapes, and the host's buffers for a whole album's stems, are
warm before the window (one album alone left the window's first calls
slower).  The
window calls ``demix_tracks`` on one album after another; each call's
stems come back to the host as the entry returns them.  The stems of one
seeded track of every call, and of the longest track of the last call,
are kept for the comparison.
"""

from __future__ import annotations

import gc
import sys
import time
import traceback

import numpy as np

from benchmarks.harness import checks, counts, generate, system
from benchmarks.harness.trace import span

E2E = {"demix_xrt": "audio-s/s"}


def setup(run) -> dict:
    import torch
    from umx_tpu_torch.engine.fleet import demix_tracks
    from umx_tpu_torch.engine.separator import Separator

    cfg, tr = run.cell.config, run.cell.traffic
    sd = generate.state_dicts(cfg, run.seed, run.device)
    sep = Separator(system.params(sd, cfg, run.device), system.engine_config(cfg), run.device)
    del sd
    lengths = generate.stratified_lengths(tr["album_tracks"], tr["length_s"], cfg["sample_rate"])
    r = generate.rng(run.seed, "albums")
    albums, seeds = [], []
    for a in range(tr["albums_in_pool"]):
        order = r.permutation(len(lengths))
        albums.append(generate.audio([lengths[i] for i in order], run.seed, f"album{a}",
                                     run.device))
        seeds.append([int(s) for s in r.integers(0, 2**31, len(lengths))])
    for a in range(len(albums)):  # warm-up: every bucket's shapes, every album's host buffers
        demix_tracks(sep, albums[a], seeds=seeds[a])
    if run.device.type == "cuda":
        torch.cuda.synchronize()
    return {"sep": sep, "albums": albums, "seeds": seeds}


def window(run, st: dict, seconds: float, recorder) -> dict:
    from umx_tpu_torch.engine.fleet import demix_tracks

    cfg = run.cell.config
    sr = cfg["sample_rate"]
    keep_rng = generate.rng(run.seed, "keep")
    albums, seeds = st["albums"], st["seeds"]
    calls, kept, longest = [], [], None
    attempted = failed = 0
    with recorder.window():
        t0 = time.perf_counter()
        k = 0
        while time.perf_counter() - t0 < seconds:
            a = k % len(albums)
            k += 1
            stats = {} if run.traced else None
            attempted += len(albums[a])
            try:
                with span("bench.demix_tracks"):
                    outs = demix_tracks(st["sep"], albums[a], seeds=seeds[a], stats=stats)
            except Exception:  # a failed call counts, and the loop goes on
                traceback.print_exc()
                failed += len(albums[a])
                continue
            end = time.perf_counter() - t0
            calls.append({"album": a, "end": end, "stats": stats,
                          "seconds": end - (calls[-1]["end"] if calls else 0.0)})
            pos = int(keep_rng.integers(len(outs)))
            kept.append((a, pos, outs[pos]))
            li = int(np.argmax([t.shape[1] for t in albums[a]]))
            longest = (a, li, outs[li])
            del outs
    audio_s = sum(t.shape[1] for c in calls for t in albums[c["album"]]) / sr
    print(f"bench: call seconds {[round(c['seconds'], 3) for c in calls]}", file=sys.stderr)
    e2e = {}
    if calls:
        e2e["demix_xrt"] = audio_s / calls[-1]["end"]
    return {"attempted": attempted, "failed": failed, "e2e": e2e, "kept": kept,
            "longest": longest, "work": work(cfg, [albums[c["album"]] for c in calls], calls)}


def work(cfg: dict, albums: list, calls: list) -> dict:
    """What the window's completed calls ran, counted from their shapes:
    the frames each segment ran, and the recurrence's calls as the fleet's
    buckets give them (one bucket of rows per chunk count; the fewest
    calls its bucketing allows)."""
    g = counts.geometry(cfg)
    frames = segments = 0
    rec = {}
    for album in albums:
        buckets = {}
        for t in album:
            k = counts.track_chunks(t.shape[1], cfg)
            buckets[k] = buckets.get(k, 0) + 1
            frames += k * g["seg_frames"]
            segments += k
        for k, rows in buckets.items():
            rec[rows] = rec.get(rows, 0) + k * cfg["nb_layers"]
    fleet = {}
    for c in calls:
        for key, v in (c["stats"] or {}).items():
            fleet[key] = fleet.get(key, 0) + v
    return {"frames": frames, "segments": segments, "recurrence_calls": rec,
            "steps": g["seg_frames"], "fleet": fleet if any(c["stats"] is not None
                                                             for c in calls) else None}


def release(st: dict) -> None:
    import torch

    st.pop("sep", None)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def sample(run, st: dict, result: dict) -> list:
    """The compared tracks: the longest of the last call, and up to
    ``check_tracks`` − 1 others drawn from the seed among the kept ones,
    each (track, shift seed, stems)."""
    picks = []
    if result["longest"] is not None:
        picks.append(result["longest"])
    r = generate.rng(run.seed, "sample")
    seen = {(a, p) for a, p, _ in picks}
    for i in r.permutation(len(result["kept"])):
        if len(picks) >= run.cell.traffic["check_tracks"]:
            break
        a, p, out = result["kept"][i]
        if (a, p) not in seen:
            seen.add((a, p))
            picks.append((a, p, out))
    return [(st["albums"][a][p], st["seeds"][a][p], out) for a, p, out in picks]


def check(run, st: dict, result: dict, control: bool = False, detail: dict | None = None) -> dict:
    """The compared numbers: the sampled stems against the reference's
    (``control``: the reference in TF32 in the system's place)."""
    picks = sample(run, st, result)
    if not picks:
        return {"stem_rel_l1": float("inf")}
    return {"stem_rel_l1": checks.demix_gap(run, picks, control, detail)}
