#!/usr/bin/env python3
"""Where the demix runs and a training step of the PyTorch/CUDA port spend
the card's time.

    python3 chip_profile.py

Builds the kernels, writes the synthetic UMX-L weights, the 100 s track
and the five catalogue tracks of ``chip_smoke.py`` (three of 100 s, one of
40 s, one of 400 s), and profiles under ``torch.profiler`` one warm run
each of the streaming demix of the 100 s track (``Separator.demix_track``,
dense weights, shifts 1) and of the catalogue (``demix_tracks`` with
quantized weights and ``window_chunks=4``): device time by kind of work
(the recurrence kernels, the Wiener passes, copies, matrix products, FFTs,
the rest) as shares of the wall time, and the idle share.  Then one warm
training step (``make_train_step``, UMX-L, batch 16 x 256 frames of
synthetic stems) the same way, with the largest kernels of "other" by
name.  Then the trainer's loss and gradients at a small width (hidden 48, batch 3 x 12
frames), five times on the card against once on the CPU: the worst
max|g_card - g_cpu| / max|g_cpu| per parameter.  A measurement aid, not a
check: it holds nothing against a reference.  Needs one CUDA GPU and
exits non-zero without one.
"""

from __future__ import annotations

import subprocess
import sys
import tempfile
import time

import chip_smoke as S


# device work by kernel name: the port's own kernels, then the libraries'
# (K4 is K1's kernel instantiated with the residual flag: it goes first)
KINDS = (("K4 lstm_merged_train_fwd", ("lstm_resident_kernel<1, true", "lstm_resident_kernel<2, true",
                                       "lstm_resident_kernel<1, (bool)1",
                                       "lstm_resident_kernel<2, (bool)1")),
         ("K1 lstm_merged", ("lstm_resident_kernel",)),
         ("K5 lstm_merged_bwd_step", ("lstm_bwd_resident_kernel",)),
         ("K6 lstm_merged_dw", ("lstm_dw_kernel",)),
         ("K9 lstm_pertarget", ("lstm_pertarget_kernel",)),
         # ("::apply_kernel", not "apply_kernel": AdamW's multi_tensor_apply_kernel is not K3)
         ("K2+K3 wiener", ("wiener_reduce_kernel", "::apply_kernel",
                           "void apply_kernel")),
         ("stems copy to host", ("Memcpy DtoH",)),
         ("audio copy to device", ("Memcpy HtoD",)),
         ("matrix products", ("gemm", "gemv", "cutlass", "cublas")),
         ("FFTs", ("fft",)))


def profile_run(what: str, audio_secs: float, run, smi: str, others: int = 0):
    """One warm ``run()`` under ``torch.profiler``: the card's time by kind
    of device work, beside the run's wall time; with ``others`` the largest
    kernels counted under "other", by name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    totals = dict.fromkeys([k for k, _ in KINDS] + ["other"], 0.0)
    other = []
    for e in prof.key_averages():
        # kernels and copies only: an annotation's range on the device's
        # timeline ("Optimizer.step#AdamW.step"; a kernel's name has its
        # argument list) would count its kernels twice
        if e.device_type != DeviceType.CUDA or ("#" in e.key and "(" not in e.key):
            continue
        ms = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0)) / 1e3
        kind = next((k for k, keys in KINDS if any(x in e.key for x in keys)), "other")
        totals[kind] += ms
        if kind == "other":
            other.append((ms, e.count, e.key))
    busy = sum(totals.values())
    S.require(busy > 0, "the profiler saw no device time")
    print(f"{what} (warm, {audio_secs:.0f} s of audio): wall {wall_ms:.1f} ms under the "
          f"profiler, device busy {busy:.1f} ms ({100 * busy / wall_ms:.1f} %), idle "
          f"{100 - 100 * busy / wall_ms:.1f} %  [{smi}]")
    for kind, ms in sorted(totals.items(), key=lambda kv: -kv[1]):
        if ms > 0:
            print(f"  {kind}: {ms:.1f} ms ({100 * ms / wall_ms:.1f} % of the wall)")
    for ms, count, key in sorted(other, reverse=True)[:others]:
        print(f"    other: {ms:.2f} ms in {count} launches: {key[:110]}")
    return totals, wall_ms


def profile_training(tmp: str, smi: str):
    """One warm training step at UMX-L width, batch 16 x 256 frames."""
    import os

    from umx_tpu_torch.config import DSPConfig, ModelConfig
    from umx_tpu_torch.data import StemDataset
    from umx_tpu_torch.models.umx import synthetic_params
    from umx_tpu_torch.train import (
        TrainConfig, init_train_state, make_batch_from_audio, make_train_step,
    )

    root = os.path.join(tmp, "stems_train")
    S.write_stem_dir(root)
    mcfg, tcfg = ModelConfig(hidden_size=1024), TrainConfig()
    train = StemDataset(root, excerpt_samples=DSPConfig().hop * (tcfg.seq_len - 1), split="train",
                        seed=0)
    batch = make_batch_from_audio(*train.sample(S.B_TRAIN), mcfg, DSPConfig(), tcfg.seq_len, "cuda")
    state = [init_train_state(synthetic_params(mcfg, seed=0, device="cuda"), tcfg)]
    step = make_train_step(mcfg)

    def run():
        state[0], loss = step(state[0], batch)
        float(loss)

    run()  # the optimizer's state is made in the first step
    profile_run(f"training step profile (UMX-L, batch {S.B_TRAIN} x {tcfg.seq_len} frames, AdamW)",
                S.B_TRAIN * tcfg.seq_len * DSPConfig().hop / S.SR, run, smi, others=8)


def grad_ratios(runs: int, smi: str):
    """``mask_loss`` and its gradients on the card (the recurrence's
    forward, reverse sweep and weight-gradient kernels) against the CPU's
    plain versions, same weights and batch, ``runs`` times: per parameter
    the worst ratio max|g_card - g_cpu| / max|g_cpu|."""
    import dataclasses

    import numpy as np
    import torch

    from umx_tpu_torch.config import ModelConfig
    from umx_tpu_torch.models.umx import UMXParams, synthetic_params
    from umx_tpu_torch.train import FROZEN, mask_loss

    cfg = ModelConfig(hidden_size=48)
    rng = np.random.default_rng(4)
    batch = {
        "x": rng.uniform(0, 1, (3, 12, cfg.n_features)),
        "mix_mag": rng.uniform(0, 1, (3, 2, 12, cfg.n_bins)),
        "target_mag": rng.uniform(0, 1, (3, 4, 2, 12, cfg.n_bins)),
    }
    names = [f.name for f in dataclasses.fields(UMXParams) if f.name not in FROZEN]

    def loss_and_grads(device):
        p = synthetic_params(cfg, seed=4, device=device)
        for n in names:
            getattr(p, n).requires_grad_(True)
        b = {k: torch.tensor(v, dtype=torch.float32, device=device) for k, v in batch.items()}
        loss = mask_loss(p, b, cfg)
        loss.backward()
        return loss.item(), {n: getattr(p, n).grad.cpu() for n in names}

    l_cpu, g_cpu = loss_and_grads("cpu")
    worst, worst_loss, same = dict.fromkeys(names, 0.0), 0.0, True
    first = None
    for _ in range(runs):
        l_gpu, g_gpu = loss_and_grads("cuda")
        worst_loss = max(worst_loss, abs(l_gpu - l_cpu) / abs(l_cpu))
        for n in names:
            ratio = float((g_gpu[n] - g_cpu[n]).abs().max() / g_cpu[n].abs().max())
            worst[n] = max(worst[n], ratio)
        first = g_gpu if first is None else first
        same = same and all(torch.equal(g_gpu[n], first[n]) for n in names)
    print(f"loss and gradients, card vs CPU, hidden 48, batch 3 x 12 frames, {runs} runs: worst "
          f"|loss_card - loss_cpu| / |loss_cpu| {worst_loss:.3g}; card gradients bit-identical over "
          f"the runs: {same}  [{smi}]")
    for n, ratio in sorted(worst.items(), key=lambda kv: -kv[1]):
        print(f"  {n}: worst max|g_card - g_cpu| / max|g_cpu| {ratio:.3g}")
    return worst


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_profile: torch.cuda.is_available() is false; this needs a GPU",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}")

    from umx_tpu_torch.config import EngineConfig, SegmentConfig
    from umx_tpu_torch.engine.separator import Separator

    from umx_tpu_torch.engine.fleet import demix_tracks

    with tempfile.TemporaryDirectory(prefix="umx_profile_") as tmp:
        model, _, mix = S.write_inputs(tmp)
        _, tracks = S.write_catalogue(tmp)
        dense = Separator.from_ggml(model)
        profile_run("streaming profile (demix_track, dense weights, shifts 1)", S.TRACK_SECS,
                    lambda: dense.demix_track(mix, seed=0), smi)
        del dense
        cfg = EngineConfig(segment=SegmentConfig(window_chunks=S.WINDOW_CHUNKS))
        sep = Separator.from_ggml(model, cfg, "cuda", quantized_hbm=True)
        audio = list(tracks.values())
        profile_run(f"catalogue profile (demix_tracks, window_chunks {S.WINDOW_CHUNKS}, quantized)",
                    sum(S.CATALOGUE_SECS), lambda: demix_tracks(sep, audio), smi)
        del sep
        profile_training(tmp, smi)
    grad_ratios(5, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
