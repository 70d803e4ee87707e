"""Fleet-scale end-to-end certification of the port (counterpart of
``scripts/fleet-certify.py``): a synthetic MUSDB-shaped test set (default
50 tracks, the real MUSDB18 length distribution of ~2-7 min) through
``engine/fleet.py::demix_tracks`` with planner-picked buckets, on
``--device`` (default ``cuda``, which raises without a GPU; ``cpu`` when
asked for).  Prints ONE machine-parseable JSON line with the aggregate
x realtime for the full-set shape (BASELINE.json config 5's role: "demix
the whole test set"; reference analog: scripts/evaluate-demixed-output.py
over all tracks), with the card's name and power limit as ``device_name``.

It exercises bucketing and memory planning at realistic scale: MUSDB
lengths collapse to ~8 chunk-count buckets at the 60 s / 45 s segment
grid, buckets larger than the planner's per-dispatch cap are split into
sub-batches, and tracks beyond one program's window run windowed.

    python -m umx_tpu_torch.scripts.fleet_certify [--tracks 50] [--hidden 1024]
           [--streaming 1] [--shifts 1] [--seed 0] [--quick] [--device cuda|cpu]

Host memory of the full set: about 4 GB of input and 17 GB of stems.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from collections import Counter


def musdb_durations(n: int, rng) -> list[float]:
    """Synthetic MUSDB18-test-like track lengths: mean ~236 s, sd ~60 s,
    clipped to the real set's [~130 s, ~420 s] envelope."""
    return [float(x) for x in rng.normal(236.0, 60.0, n).clip(130.0, 420.0)]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--tracks", type=int, default=50)
    p.add_argument("--hidden", type=int, default=1024)
    p.add_argument("--streaming", type=int, default=1)
    p.add_argument("--shifts", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--segment-secs", type=float, default=60.0)
    p.add_argument(
        "--quick", action="store_true",
        help="tiny CI shape: 6 short tracks, h=64, 0.5 s segments",
    )
    p.add_argument("--device", default=None, help="torch device: cuda (default) or cpu")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import numpy as np

    from umx_tpu_torch.config import EngineConfig, ModelConfig, SegmentConfig
    from umx_tpu_torch.engine.fleet import demix_tracks
    from umx_tpu_torch.engine.separator import Separator, resolve_device
    from umx_tpu_torch.models.umx import synthetic_params
    from umx_tpu_torch.utils.profiling import card_name

    device = resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    if args.quick:
        args.tracks, args.hidden, args.segment_secs = 6, 64, 0.5
        durations = [float(x) for x in rng.uniform(1.0, 3.0, args.tracks)]
    else:
        durations = musdb_durations(args.tracks, rng)

    cfg = EngineConfig(
        model=ModelConfig(hidden_size=args.hidden),
        segment=SegmentConfig(
            segment_secs=args.segment_secs, streaming=bool(args.streaming)
        ),
        shifts=args.shifts,
    )
    sep = Separator(synthetic_params(cfg.model, seed=0, device=device), cfg, device)
    card = card_name(device)

    sr = cfg.dsp.sample_rate
    print(
        f"# backend={device.type} [{card}] tracks={args.tracks} "
        f"total_audio={sum(durations):.0f}s "
        f"lengths=[{min(durations):.0f}..{max(durations):.0f}]s",
        file=sys.stderr,
    )
    tracks = [
        (0.4 * rng.standard_normal((2, int(d * sr)))).astype(np.float32)
        for d in durations
    ]

    # bucket census (what the fleet runner will see)
    stride = cfg.segment.stride_samples(sr)
    max_shift = cfg.segment.max_shift_samples(sr)
    census = Counter(
        max(1, math.ceil((t.shape[1] + (max_shift if args.shifts else 0)) / stride))
        for t in tracks
    )
    print(f"# chunk-count buckets: {dict(sorted(census.items()))}", file=sys.stderr)

    # full warm pass: the timed pass's exact batch shapes (sub-batch
    # splitting) appear only when running the full set, and the first use
    # of each kernel builds it
    t0 = time.perf_counter()
    demix_tracks(sep, tracks, cfg)
    print(f"# warm pass (full set): {time.perf_counter() - t0:.1f}s", file=sys.stderr)

    stats: dict = {}
    t0 = time.perf_counter()
    outs = demix_tracks(sep, tracks, cfg, stats=stats)
    wall = time.perf_counter() - t0

    total_audio = sum(durations)
    for i, (t, o) in enumerate(zip(tracks, outs)):
        if o.shape != (cfg.model.n_targets, 2, t.shape[1]):
            raise RuntimeError(f"track {i}: stems of shape {o.shape}, input {t.shape}")
        if not np.isfinite(o).all():
            raise RuntimeError(f"track {i}: non-finite stems")

    xrt = total_audio / wall
    # engine x realtime excludes the host <-> device copies (upload_s and
    # download_s); end_to_end_xrt includes them
    compute_s = stats.get("compute_s", 0.0)
    name = f"xRT_{'umxl' if args.hidden >= 1024 else 'umxhq'}_fleet_musdb{args.tracks}"
    if not args.streaming:
        name += "_nostream"
    print(json.dumps({
        "metric": name,
        "value": round(total_audio / compute_s, 2) if compute_s else round(xrt, 2),
        "unit": "audio_sec_per_wall_sec",
        "vs_baseline": round((total_audio / compute_s if compute_s else xrt) / 100.0, 4),
        "tracks": args.tracks,
        "total_audio_s": round(total_audio, 1),
        "engine_s": round(compute_s, 2),
        "end_to_end_wall_s": round(wall, 2),
        "end_to_end_xrt": round(xrt, 2),
        "upload_s": round(stats.get("upload_s", 0.0), 2),
        "download_s": round(stats.get("download_s", 0.0), 2),
        "dispatches": stats.get("dispatches", 0),
        "rows": stats.get("rows", 0),
        "buckets": {str(k): v for k, v in sorted(census.items())},
        "device_name": card,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
