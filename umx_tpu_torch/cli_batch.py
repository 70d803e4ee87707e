"""Batch demixer: a directory of tracks through the fleet runner.

    python -m umx_tpu_torch.cli_batch <model file> <in_dir> <out_root>

``in_dir`` holds flat 44.1 kHz WAVs or MUSDB-style track directories with
a ``mixture.wav``; each track's stems go to
``<out_root>/<track name>/target_{0..3}.wav``.  The tracks are bucketed by
length and batched as far as the device's memory allows
(``engine/fleet.py::demix_tracks``), data-parallel over a mesh of every
card (``parallel/mesh.py::make_mesh``); a track too long for one program
runs windowed.  ``--device`` picks the device (default ``cuda``, every
card; another name, that device alone); asking for CUDA on a machine
without a usable GPU raises rather than running on the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="umx-tpu-torch-batch",
        description="Open-Unmix batch demixer (PyTorch/CUDA port): a directory of tracks",
    )
    p.add_argument("model_file", help="ggml model file (.bin or .bin.gz)")
    p.add_argument("in_dir", help="directory of 44.1 kHz WAVs (or MUSDB track dirs)")
    p.add_argument("out_root", help="output root: <out_root>/<track>/target_{0..3}.wav")
    p.add_argument("--no-wiener", action="store_true", help="skip the Wiener-EM post-filter")
    p.add_argument("--shifts", type=int, default=1, help="shift-trick passes to average")
    p.add_argument("--segment-secs", type=float, default=60.0, help="segment length (s)")
    p.add_argument(
        "--quantized-hbm", action="store_true",
        help="keep the u8/u16 weights quantized on the device",
    )
    p.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    p.add_argument("--quiet", action="store_true")
    return p


def find_tracks(in_dir: str) -> list[tuple[str, str]]:
    """(name, wav path) of every flat WAV and every directory holding a
    ``mixture.wav`` in ``in_dir``, sorted by name."""
    entries = []
    for name in sorted(os.listdir(in_dir)):
        path = os.path.join(in_dir, name)
        if os.path.isdir(path) and os.path.exists(os.path.join(path, "mixture.wav")):
            entries.append((name, os.path.join(path, "mixture.wav")))
        elif name.lower().endswith(".wav"):
            entries.append((os.path.splitext(name)[0], path))
    return entries


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    def log(*a):
        if not args.quiet:
            print(*a, flush=True)

    from umx_tpu_torch.cli import engine_config_from_args
    from umx_tpu_torch.engine.fleet import demix_tracks
    from umx_tpu_torch.engine.separator import Separator, resolve_device
    from umx_tpu_torch.io.audio import load_audio, write_audio
    from umx_tpu_torch.parallel.mesh import make_mesh

    device = resolve_device(args.device)
    sep = Separator.from_ggml(args.model_file, engine_config_from_args(args), device,
                              quantized_hbm=args.quantized_hbm)
    cfg = sep.cfg

    entries = find_tracks(args.in_dir)
    if not entries:
        print(f"no WAVs found in {args.in_dir}", file=sys.stderr)
        return 1

    log(f"{len(entries)} tracks; loading audio")
    tracks = [load_audio(path, cfg.dsp.sample_rate) for _, path in entries]
    total_secs = sum(t.shape[1] for t in tracks) / cfg.dsp.sample_rate

    mesh = make_mesh() if args.device == "cuda" else make_mesh(devices=[device])
    log(f"mesh: {dict(mesh.shape)} over {len(mesh.devices.flat)} device(s)")

    stats: dict = {}
    t0 = time.perf_counter()
    outs = demix_tracks(sep, tracks, stats=stats, mesh=mesh)
    wall = time.perf_counter() - t0
    log(f"demixed {total_secs:.0f}s of audio in {wall:.1f}s "
        f"({total_secs / wall:.0f}x realtime aggregate) on {device}; "
        f"{stats.get('dispatches', 0)} dispatches, {stats.get('rows', 0)} rows, "
        f"{stats.get('windowed_tracks', 0)} windowed")

    for (name, _), stems in zip(entries, outs):
        out_dir = os.path.join(args.out_root, name)
        os.makedirs(out_dir, exist_ok=True)
        for i in range(stems.shape[0]):
            write_audio(os.path.join(out_dir, f"target_{i}.wav"), stems[i], cfg.dsp.sample_rate)
        log(f"wrote {out_dir}/target_{{0..3}}.wav")
    return 0


if __name__ == "__main__":
    sys.exit(main())
