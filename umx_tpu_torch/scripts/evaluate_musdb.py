"""MUSDB18-HQ-style set evaluation: fleet demix + BSS-eval + the
published-style median table (counterpart of ``scripts/evaluate-musdb.py``).

Every track is demixed on one device by the port's fleet runner
(``engine/fleet.py::demix_tracks``), each result is BSS-evaluated
(museval v4 conventions, ``umx_tpu_torch/eval/bss.py``, float64 host
code), and the output is the standard "median over tracks of
median-over-windows" per stem: the number format of the MUSDB
leaderboard and the reference README tables.

    python -m umx_tpu_torch.scripts.evaluate_musdb <model.bin.gz> <musdb_root/test> \\
        [--out results.json] [--limit N] [--shifts 1] [--no-wiener] [--device cuda|cpu]

Each track directory must contain mixture.wav + bass/drums/other/
vocals.wav (the MUSDB18-HQ layout).  Several processes (one per card) may
share a set: inside a ``torch.distributed`` process group the tracks
partition round-robin and the medians are gathered over the group
(``parallel/multihost.py``).  The JAX script's multi-device mesh inside
one process is not ported yet.  Each printed row is the JAX script's
plus ``bss_s``, the seconds its scoring took.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

TARGETS = ("bass", "drums", "other", "vocals")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("model_file")
    p.add_argument("musdb_dir", type=Path, help="MUSDB18-HQ subset dir (e.g. .../test)")
    p.add_argument("--out", type=Path, default=None, help="write per-track JSON here")
    p.add_argument("--limit", type=int, default=0, help="evaluate only the first N tracks")
    p.add_argument("--shifts", type=int, default=1)
    p.add_argument("--no-wiener", action="store_true")
    p.add_argument("--segment-secs", type=float, default=60.0)
    p.add_argument("--win", type=float, default=1.0)
    p.add_argument("--flen", type=int, default=512)
    p.add_argument("--device", default=None,
                   help="torch device: cuda (default; one card per process) or cpu")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import dataclasses

    from umx_tpu_torch.config import SegmentConfig
    from umx_tpu_torch.engine.fleet import demix_tracks
    from umx_tpu_torch.engine.separator import Separator
    from umx_tpu_torch.eval.bss import bss_eval_images_framewise
    from umx_tpu_torch.io.audio import load_audio
    from umx_tpu_torch.parallel.multihost import allgather_metrics, partition_tracks

    track_dirs = sorted(
        d for d in args.musdb_dir.iterdir()
        if d.is_dir() and (d / "mixture.wav").exists()
        and all((d / f"{t}.wav").exists() for t in TARGETS)
    )
    if args.limit:
        track_dirs = track_dirs[: args.limit]
    if not track_dirs:
        print(f"no MUSDB track dirs under {args.musdb_dir}", file=sys.stderr)
        return 1

    sep = Separator.from_ggml(args.model_file, device=args.device)
    cfg = dataclasses.replace(
        sep.cfg,
        segment=SegmentConfig(segment_secs=args.segment_secs),
        shifts=args.shifts,
        use_wiener=not args.no_wiener,
    )

    owned = partition_tracks(len(track_dirs))
    print(f"# {len(track_dirs)} tracks, this process owns {len(owned)}", file=sys.stderr)

    per_track: list[dict] = []
    win = int(args.win * 44100)
    t_all = time.perf_counter()
    for i in owned:
        d = track_dirs[i]
        mix = load_audio(str(d / "mixture.wav"))
        t0 = time.perf_counter()
        stems = demix_tracks(sep, [mix], cfg)[0]
        demix_s = time.perf_counter() - t0
        refs = np.stack(
            [load_audio(str(d / f"{t}.wav"))[:, : mix.shape[1]] for t in TARGETS]
        ).astype(np.float64)
        n = min(refs.shape[-1], stems.shape[-1])
        t0 = time.perf_counter()
        res = bss_eval_images_framewise(
            refs[..., :n], np.asarray(stems[..., :n], np.float64),
            window=win, hop=win, flen=args.flen, mode="v4",
        )
        bss_s = time.perf_counter() - t0
        row = {"track": d.name, "demix_s": round(demix_s, 2)}
        for m in ("sdr", "isr", "sir", "sar"):
            row[m] = {
                t: round(float(np.nanmedian(res[m.upper()][j])), 3)
                for j, t in enumerate(TARGETS)
            }
        row["bss_s"] = round(bss_s, 2)
        per_track.append(row)
        print(json.dumps(row), flush=True)

    # gather each stem's per-track median across processes, then take
    # the over-tracks median (the leaderboard statistic)
    table = {}
    for m in ("sdr", "isr", "sir", "sar"):
        table[m] = {}
        for j, t in enumerate(TARGETS):
            vals = allgather_metrics(
                {owned[k]: per_track[k][m][t] for k in range(len(per_track))}
            )
            table[m][t] = round(float(np.median(list(vals.values()))), 3)

    print(f"\n# {len(track_dirs)} tracks in {time.perf_counter() - t_all:.0f}s")
    print("| metric | " + " | ".join(TARGETS) + " |")
    print("|---|" + "---|" * len(TARGETS))
    for m in ("sdr", "isr", "sir", "sar"):
        print(f"| {m.upper()} | " + " | ".join(f"{table[m][t]:.3f}" for t in TARGETS) + " |")

    if args.out:
        args.out.write_text(json.dumps({"tracks": per_track, "median": table}, indent=1))
        print(f"# wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
