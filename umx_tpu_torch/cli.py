"""Command-line demixer: ``python -m umx_tpu_torch.cli <model file> <wav
file> <out dir>`` writes ``target_0.wav`` … ``target_3.wav`` (bass,
drums, other, vocals).

``--device`` picks the device (default ``cuda``); asking for CUDA on a
machine without a usable GPU raises rather than running on the CPU.
``--quantized-hbm`` keeps the u8/u16 weights quantized on the device,
``--window-chunks`` sets the window of a long track (0 = the memory
planner decides, -1 = never, N = N chunks), ``--lstm-impl`` picks the
recurrence kernel, ``--wiener-impl`` the Wiener path and
``--stream-impl`` the streaming schedule; ``--mask-dtype``,
``--stems-stack-dtype`` and ``--wiener-out-dtype`` pick their seams'
storage dtypes ("auto", the default: bfloat16 on the GPU, float32 on the
CPU, as the JAX package resolves it).  ``--resample`` converts another sample rate instead
of rejecting it, and ``--host-loop`` runs one call per segment and prints
the progress after each.  The flags set is the JAX CLI's, plus
``--device``: its precision flags (``--matmul-precision``,
``--dft-precision``, ``--idft-precision``, ``--iframes-dtype``) are
accepted with their choices and compute, as the JAX package does off a
TPU, what the defaults compute (float32 matmuls without TF32, cuFFT or the
ct2 kernel), and its one XLA-only value (``--istft-algo ct2_xla``) is
refused by name.  ``--lstm-impl scan`` is the JAX CLI's portable float32
recurrence, here the float32 recurrence kernel (any model width).
:func:`engine_config_from_args` builds the ``EngineConfig`` for this
entry point and for ``cli_batch``.
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
        "--chunk-batch", type=int, default=0,
        help="non-streaming segment-group width (0 = auto: the memory planner "
        "picks the widest group that fits the device)",
    )
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
    p.add_argument(
        "--istft-algo",
        choices=("auto", "dense", "ct2"),
        default="auto",
        help="inverse-transform algorithm (auto = dense torch.istft; ct2 = the "
        "fused Cooley-Tukey iSTFT kernel)",
    )
    p.add_argument(
        "--window-chunks", type=int, default=0,
        help="chunks per window of a long track (0 = auto: one program while the memory "
        "planner says the track fits; -1 = never window; N = windows of N chunks)",
    )
    p.add_argument(
        "--lstm-impl",
        choices=("auto", "scan", "pallas_merged", "pallas"),
        default="auto",
        help="BLSTM recurrence kernel: the merged kernel (auto, pallas_merged; bf16 W_hh, "
        "hidden <= 1024), the per-target kernel (pallas), or scan = the portable float32 "
        "recurrence (f32 h and W_hh, any width)",
    )
    p.add_argument(
        "--wiener-impl",
        choices=("auto", "einsum", "pallas"),
        default="auto",
        help="Wiener-EM implementation (auto = pallas = the fused two-pass kernels; einsum = "
        "the whole-segment einsum chain; --wiener-psd umxcpp runs einsum and refuses pallas)",
    )
    p.add_argument(
        "--stream-impl",
        choices=("scan", "groups", "pipelined"),
        default="scan",
        help="streaming track schedule (scan = one segment call per chunk; groups = the "
        "state-free halves over chunk groups, only the recurrence chained; pipelined = 3 "
        "layer-stages of different chunks per merged-kernel call); the same arithmetic",
    )
    for flag, what in (
        ("--mask-dtype", "the network's masks at the seam before the Wiener passes, which read "
         "them as stored (bfloat16 halves both passes' mask reads)"),
        ("--stems-stack-dtype", "the stacked weighted chunk outputs feeding overlap-add "
         "(which accumulates in float32); bfloat16 halves the stack's memory"),
        ("--wiener-out-dtype", "the fused Wiener path's output planes, which its last pass "
         "writes (bfloat16 halves that write; the einsum path gives float32)"),
    ):
        p.add_argument(flag, choices=("auto", "float32", "bfloat16"), default="auto",
                       help=f"storage dtype of {what}; auto = bfloat16 on the GPU, float32 on "
                       "the CPU")
    for flag, choices in (("--matmul-precision", ("default", "high", "highest")),
                          ("--dft-precision", ("auto", "default", "high", "highest")),
                          ("--idft-precision", ("auto", "default", "high", "highest")),
                          ("--iframes-dtype", ("auto", "float32", "bfloat16"))):
        p.add_argument(flag, choices=choices, default=choices[0],
                       help="the JAX CLI's TPU precision knob: every choice computes what the "
                       "default does here (float32 matmuls without TF32; cuFFT or the ct2 "
                       "kernel, which store no iDFT frames)")
    p.add_argument(
        "--quantized-hbm", action="store_true",
        help="keep the u8/u16 weights quantized on the device (dequantization fused "
        "into the matmuls)",
    )
    p.add_argument(
        "--host-loop",
        action="store_true",
        help="dispatch one call per segment (per-segment progress) "
        "instead of the fused whole-track program",
    )
    p.add_argument(
        "--resample",
        action="store_true",
        help="resample non-44.1 kHz inputs instead of rejecting them",
    )
    p.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    p.add_argument(
        "--timings", action="store_true", help="print a per-stage wall-clock table"
    )
    p.add_argument("--quiet", action="store_true")
    return p


def engine_config_from_args(args):
    """The ``EngineConfig`` of a parsed command line.  Shared by this CLI
    and ``cli_batch``; a flag that an entry point does not offer takes the
    config's default."""
    from umx_tpu_torch.config import (
        DSPConfig, EngineConfig, ModelConfig, SegmentConfig, WienerConfig,
    )

    d = EngineConfig()

    def arg(name, default):
        return getattr(args, name, default)

    return EngineConfig(
        dsp=DSPConfig(istft_algo=arg("istft_algo", d.dsp.istft_algo)),
        model=ModelConfig(input_scaling=arg("input_scaling", d.model.input_scaling),
                          lstm_impl=arg("lstm_impl", d.model.lstm_impl)),
        segment=SegmentConfig(
            segment_secs=arg("segment_secs", d.segment.segment_secs),
            overlap=arg("overlap", d.segment.overlap),
            streaming=not arg("no_streaming", not d.segment.streaming),
            chunk_batch=arg("chunk_batch", d.segment.chunk_batch),
            window_chunks=arg("window_chunks", d.segment.window_chunks),
        ),
        wiener=WienerConfig(iterations=arg("wiener_iters", d.wiener.iterations),
                            psd=arg("wiener_psd", d.wiener.psd),
                            impl=arg("wiener_impl", d.wiener.impl),
                            out_dtype=arg("wiener_out_dtype", d.wiener.out_dtype)),
        use_wiener=not arg("no_wiener", not d.use_wiener),
        shifts=arg("shifts", d.shifts),
        mask_dtype=arg("mask_dtype", d.mask_dtype),
        stems_stack_dtype=arg("stems_stack_dtype", d.stems_stack_dtype),
        stream_impl=arg("stream_impl", d.stream_impl),
    )


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
    if args.wiener_psd == "umxcpp" and args.wiener_impl == "pallas":
        print("umx-tpu-torch: --wiener-psd umxcpp requires --wiener-impl einsum "
              "(the fused kernels implement the correct-PSD semantics only)", file=sys.stderr)
        return 2

    def log(*a):
        if not args.quiet:
            print(*a, flush=True)

    from umx_tpu_torch.engine.separator import Separator, resolve_device
    from umx_tpu_torch.io.audio import load_audio, write_audio

    device = resolve_device(args.device)
    cfg = engine_config_from_args(args)

    from umx_tpu_torch.utils.profiling import StageTimer, block_until_ready

    timer = StageTimer()
    t0 = time.perf_counter()
    with timer.stage("load_audio"):
        audio = load_audio(args.wav_file, cfg.dsp.sample_rate, args.resample)
    secs = audio.shape[1] / cfg.dsp.sample_rate
    log(f"Loaded {args.wav_file}: {audio.shape[1]} samples ({secs:.1f} s)")

    with timer.stage("load_model"):
        sep = Separator.from_ggml(args.model_file, cfg, device, args.quantized_hbm)
        block_until_ready(sep.params.fc1_w)  # the weights' copies end in this stage
    log(f"Loaded model {args.model_file} (hidden_size={sep.cfg.model.hidden_size}"
        f"{', quantized weights' if args.quantized_hbm else ''}) "
        f"onto {device} in {timer.totals['load_model']:.2f} s")

    progress = None
    if args.host_loop and not args.quiet:
        progress = lambda f: log(f"  demix {f * 100:.0f}%")  # noqa: E731
    with timer.stage("demix"):  # demix_track returns host arrays: the device is done
        stems = sep.demix_track(audio, args.seed, progress, not args.host_loop)
    dt = timer.totals["demix"]
    log(f"Demixed in {dt:.2f} s ({secs / dt:.1f}x realtime)")

    os.makedirs(args.out_dir, exist_ok=True)
    with timer.stage("write_stems"):
        for i in range(stems.shape[0]):
            path = os.path.join(args.out_dir, f"target_{i}.wav")
            write_audio(path, stems[i], cfg.dsp.sample_rate)
            log(f"Wrote {path}")
    log(f"Total {time.perf_counter() - t0:.2f} s")
    if args.timings:
        print(timer.report())
    return 0


if __name__ == "__main__":
    sys.exit(main())
