"""Figures for the two subsystems the demix figures do not cover: the
trainer (steps/s) and the streaming demixer (per-push latency,
segment-boundary latency); counterpart of ``scripts/profile-train-stream.py``.

    python -m umx_tpu_torch.scripts.profile_train_stream [--hidden 512] [--steps 12]
           [--batch 4] [--seq-len 256] [--stream-secs 120] [--device cuda|cpu]

On the GPU it prints the card's name and power limit, and the MFU
against the H100 SXM's published float32 peak (67 TFLOP/s outside the
tensor cores): the trainer's projections run in float32 with TF32 off,
its recurrence kernels on bf16 operands (``--lstm-impl scan``: in
float32).  On the CPU the MFU is not measured.
"""

from __future__ import annotations

import argparse
import sys
import time

from umx_tpu_torch.utils.profiling import card_name

# NVIDIA's data sheet, H100 SXM, float32 outside the tensor cores, at 700 W
H100_F32_FLOPS = 67e12


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--hidden", type=int, default=512)
    p.add_argument("--steps", type=int, default=12)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--seq-len", type=int, default=256)
    p.add_argument("--stream-secs", type=float, default=120.0)
    p.add_argument("--segment-secs", type=float, default=60.0)
    p.add_argument(
        "--lstm-impl", default="auto", choices=("auto", "scan", "pallas_merged"),
        help="recurrence of the trainer and the streaming demixer: the merged "
        "kernels (auto, pallas_merged; auto takes the float32 ones where the "
        "width is no multiple of 8) or the float32 recurrence (scan)",
    )
    p.add_argument("--skip-stream", action="store_true")
    p.add_argument("--device", default=None, help="torch device: cuda (default) or cpu")
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from umx_tpu_torch.config import DSPConfig, EngineConfig, ModelConfig, SegmentConfig
    from umx_tpu_torch.engine.separator import resolve_device
    from umx_tpu_torch.models.umx import synthetic_params
    from umx_tpu_torch.train import (
        TrainConfig,
        init_train_state,
        make_batch_from_audio,
        make_train_step,
    )

    device = resolve_device(args.device)
    card = card_name(device)
    print(f"# device: {device} [{card}]", file=sys.stderr)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    # ---- trainer ------------------------------------------------------------
    mcfg = ModelConfig(hidden_size=args.hidden, lstm_impl=args.lstm_impl)
    tcfg = TrainConfig(seq_len=args.seq_len)
    dsp = DSPConfig()
    rng = np.random.default_rng(0)
    n = dsp.hop * (args.seq_len - 1)
    mix = rng.standard_normal((args.batch, 2, n)).astype(np.float32) * 0.1
    targets = rng.standard_normal((args.batch, 4, 2, n)).astype(np.float32) * 0.05
    batch = make_batch_from_audio(mix, targets, mcfg, dsp, args.seq_len, device)

    state = init_train_state(synthetic_params(mcfg, seed=0, device=device), tcfg)
    step = make_train_step(mcfg)
    t0 = time.perf_counter()
    state, loss = step(state, batch)
    first = float(loss)
    print(f"# train first step (kernel build and load included): "
          f"{time.perf_counter() - t0:.1f}s", file=sys.stderr)

    losses = [first]
    sync()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        state, loss = step(state, batch)
        losses.append(float(loss))  # scalar fetch = per-step barrier
    wall = time.perf_counter() - t0
    sps = args.steps / wall
    audio_sps = sps * args.batch * n / dsp.sample_rate
    # matmul-FLOPs model: every matmul weight is applied once per frame
    # per direction-instance, so fwd FLOPs ~= 2 * B * T * sum(matmul
    # weight sizes); a training step ~= 3x fwd (forward + input-grad +
    # weight-grad matmuls)
    h, g = mcfg.hidden_size, mcfg.lstm_hidden
    mat = mcfg.n_targets * (
        mcfg.n_features * h
        + 2 * (h * 4 * g + 2 * (2 * g * 4 * g)) + 2 * 3 * (g * 4 * g)
        + 2 * h * h + h * mcfg.n_outputs
    )
    flops_step = 3 * 2 * args.batch * args.seq_len * mat
    if device.type == "cuda":
        mfu = f"MFU {100 * flops_step * sps / H100_F32_FLOPS:.1f}% of 67 TFLOP/s float32"
    else:
        mfu = "MFU not measured (cpu)"
    print(
        f"train[h={args.hidden} B={args.batch} T={args.seq_len} "
        f"impl={args.lstm_impl}]: "
        f"{sps:.2f} steps/s ({wall / args.steps * 1000:.0f} ms/step, "
        f"{audio_sps:.0f} audio-sec/s, {mfu}), "
        f"loss {losses[0]:.4f} -> {losses[-1]:.4f}  [{card}]"
    )
    if not (losses[-1] < losses[0] and np.isfinite(losses).all()):
        raise RuntimeError(f"training on one batch did not lower its loss: {losses}")
    result = {"device": card, "train_steps_per_s": sps, "train_losses": losses}
    if args.skip_stream:
        return result

    # ---- streaming ----------------------------------------------------------
    from umx_tpu_torch.engine.streaming import StreamingDemixer

    # UMX-L, as the JAX script streams whatever --hidden trains
    ecfg = EngineConfig(model=ModelConfig(lstm_impl=args.lstm_impl),
                        segment=SegmentConfig(segment_secs=args.segment_secs))
    sd = StreamingDemixer(synthetic_params(ecfg.model, seed=0, device=device), ecfg, device)
    sr = ecfg.dsp.sample_rate
    chunk = rng.uniform(-0.5, 0.5, (2, sr)).astype(np.float32)  # 1 s pushes

    lat_idle, lat_boundary = [], []
    total = int(args.stream_secs)
    t_all = time.perf_counter()
    for _ in range(total):
        t0 = time.perf_counter()
        out = sd.push(chunk)  # the stems come back as host arrays: a barrier
        dt = time.perf_counter() - t0
        (lat_boundary if out.shape[-1] else lat_idle).append(dt)
    sd.flush()
    wall = time.perf_counter() - t_all
    med = lambda v: sorted(v)[len(v) // 2] * 1000 if v else float("nan")  # noqa: E731
    first_push = lat_boundary[0] if lat_boundary else float("nan")
    steady = lat_boundary[1:]
    print(
        f"stream[seg={args.segment_secs:.0f}s, 1s pushes]: "
        f"idle push p50 {med(lat_idle):.1f} ms ({len(lat_idle)}x), "
        f"segment-boundary push p50 {med(steady):.1f} ms ({len(steady)}x; "
        f"first: {first_push:.1f} s), "
        f"sustained {args.stream_secs / wall:.1f}x realtime  [{card}]"
    )
    result.update(idle_push_p50_ms=med(lat_idle), boundary_push_p50_ms=med(steady),
                  stream_x_realtime=args.stream_secs / wall)
    return result


if __name__ == "__main__":
    main()
    sys.exit(0)
