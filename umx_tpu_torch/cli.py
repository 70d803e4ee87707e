"""Command-line demixer: ``python -m umx_tpu_torch.cli <model file> <wav
file> <out dir>`` writes ``target_0.wav`` … ``target_3.wav`` (bass,
drums, other, vocals).

``--device`` picks the device (default ``cuda``); asking for CUDA on a
machine without a usable GPU raises rather than running on the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="umx-tpu-torch",
        description="Open-Unmix 4-stem music demixer (PyTorch/CUDA port)",
    )
    p.add_argument("model_file", help="ggml model file (.bin or .bin.gz)")
    p.add_argument("wav_file", help="input 44.1 kHz WAV (mono or stereo)")
    p.add_argument("out_dir", help="output directory for target_{0..3}.wav")
    p.add_argument("--no-wiener", action="store_true", help="skip the Wiener-EM post-filter")
    p.add_argument("--wiener-iters", type=int, default=1, help="Wiener EM iterations")
    p.add_argument("--no-streaming", action="store_true", help="reset LSTM state per segment")
    p.add_argument(
        "--shifts", type=int, default=1,
        help="Demucs shift-trick passes to average (0 disables; reference supports only 1)",
    )
    p.add_argument("--seed", type=int, default=0, help="PRNG seed for the shift trick")
    p.add_argument("--segment-secs", type=float, default=60.0, help="segment length (s)")
    p.add_argument("--overlap", type=float, default=0.25, help="segment overlap fraction")
    p.add_argument(
        "--input-scaling",
        choices=("openunmix", "umxcpp"),
        default="openunmix",
        help="input normalization convention: upstream openunmix "
        "(x+mean)*scale or the reference C++'s x*scale+mean deviation",
    )
    p.add_argument(
        "--wiener-psd",
        choices=("correct", "umxcpp"),
        default="correct",
        help="source PSD: standard |y|^2 (fused kernels) or the reference's "
        "(re+im)^2 quirk (einsum path)",
    )
    p.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    p.add_argument(
        "--timings", action="store_true", help="print a per-stage wall-clock table"
    )
    p.add_argument("--quiet", action="store_true")
    return p


def main(argv=None) -> int:
    try:
        return _main(argv)
    except FileNotFoundError as e:
        print(f"umx-tpu-torch: file not found: {e.filename or e}", file=sys.stderr)
        return 1
    except ValueError as e:
        print(f"umx-tpu-torch: {e}", file=sys.stderr)
        return 1


def _main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    def log(*a):
        if not args.quiet:
            print(*a, flush=True)

    import torch

    from umx_tpu_torch.config import EngineConfig, ModelConfig, SegmentConfig, WienerConfig
    from umx_tpu_torch.engine.separator import Separator, resolve_device
    from umx_tpu_torch.io.audio import load_audio, write_audio

    device = resolve_device(args.device)
    cfg = EngineConfig(
        model=ModelConfig(input_scaling=args.input_scaling),
        segment=SegmentConfig(
            segment_secs=args.segment_secs,
            overlap=args.overlap,
            streaming=not args.no_streaming,
        ),
        wiener=WienerConfig(iterations=args.wiener_iters, psd=args.wiener_psd),
        use_wiener=not args.no_wiener,
        shifts=args.shifts,
    )

    totals: dict[str, float] = {}

    def timed(name, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        totals[name] = time.perf_counter() - t
        return out

    t0 = time.perf_counter()
    audio = timed("load_audio", load_audio, args.wav_file, cfg.dsp.sample_rate)
    secs = audio.shape[1] / cfg.dsp.sample_rate
    log(f"Loaded {args.wav_file}: {audio.shape[1]} samples ({secs:.1f} s)")

    sep = timed("load_model", Separator.from_ggml, args.model_file, cfg, device)
    log(f"Loaded model {args.model_file} (hidden_size={sep.cfg.model.hidden_size}) "
        f"onto {device} in {totals['load_model']:.2f} s")

    stems = timed("demix", sep.demix_track, audio, args.seed)
    dt = totals["demix"]
    log(f"Demixed in {dt:.2f} s ({secs / dt:.1f}x realtime)")

    os.makedirs(args.out_dir, exist_ok=True)

    def write_all():
        for i in range(stems.shape[0]):
            path = os.path.join(args.out_dir, f"target_{i}.wav")
            write_audio(path, stems[i], cfg.dsp.sample_rate)
            log(f"Wrote {path}")

    timed("write_stems", write_all)
    log(f"Total {time.perf_counter() - t0:.2f} s")
    if args.timings:
        print(f"{'stage':<16} {'seconds':>9}")
        for name, total in totals.items():
            print(f"{name:<16} {total:>9.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
