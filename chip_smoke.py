#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``umx_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises (exit code 1, no result line) on failure:

1. build the CUDA kernels from ``umx_tpu_torch/csrc`` (nvcc, sm_90a);
2. the BLSTM recurrence kernel against its plain PyTorch version at the
   UMX-L segment shape (R = 8 chains, B = 1, G = 512, T = 2584);
3. the Wiener-EM reduce/apply kernels against their plain versions at
   S = 4, T = 2584, F = 2049, for 1 and 2 EM iterations;
4. the main path: synthetic UMX-L weights (hidden 1024, seed 0) written
   as a ggml file, a synthetic 100 s stereo WAV, and the port's CLI run
   on it in-process on ``cuda`` (3 chunks of 60 s, so the LSTM state is
   carried twice); the stems are checked, and every kernel's launch
   counter must have moved during that run.  Then the GPU path is held
   against the port's CPU path (plain versions) on a short input;
5. timings: each kernel against its plain version (CUDA events, after
   warm-up), and the warm demix time of the 100 s track.

Prints the card's name and power limit, a JSON line with the kernels,
and last ``{"ok": true, "device": {...}}``.  Needs one CUDA GPU; exits
non-zero without one.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

SR = 44100
TRACK_SECS = 100.0
# UMX-L segment shapes: 60 s -> 2584 STFT frames, 2049 bins
T_SEG, F_BINS, N_SRC = 2584, 2049, 4
R_CHAINS, G_HIDDEN = 8, 512


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` runs (one warm-up)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def check_lstm(dev):
    """Phase 2: K1 against its plain version at the UMX-L layer shape."""
    import torch

    from umx_tpu_torch.ops import lstm_cuda

    g = torch.Generator(device=dev).manual_seed(0)
    RB, G4 = R_CHAINS, 4 * G_HIDDEN
    xp = torch.randn((T_SEG, RB, G4), generator=g, device=dev)
    whh = (torch.randn((R_CHAINS, G_HIDDEN, G4), generator=g, device=dev)
           / G_HIDDEN**0.5).to(torch.bfloat16)
    h0 = 0.5 * torch.randn((RB, G_HIDDEN), generator=g, device=dev)
    c0 = 0.5 * torch.randn((RB, G_HIDDEN), generator=g, device=dev)

    out_k = lstm_cuda.lstm_merged(xp, whh, h0, c0, 1)
    torch.cuda.synchronize()
    out_p = lstm_cuda.lstm_merged_plain(xp, whh, h0, c0, 1)
    torch.cuda.synchronize()
    errs = {n: max_err(a, b) for n, a, b in zip(("hs", "hT", "cT"), out_k, out_p)}
    print(f"lstm_merged vs plain (T={T_SEG}, R={R_CHAINS}, B=1, G={G_HIDDEN}): "
          f"max|err| hs {errs['hs']:.3g} hT {errs['hT']:.3g} cT {errs['cT']:.3g}")
    # Both round h to bf16 before the product; an f32 last-bit difference
    # in a sum can flip one bf16 rounding, a ~4e-3 relative step in one
    # operand, which the contractive recurrence damps: 5e-3 absolute on
    # h (|h| < 1) and c bounds that.
    require(max(errs.values()) <= 5e-3, f"lstm_merged disagrees with plain: {errs}")
    args = (xp, whh, h0, c0, 1)
    return args, max(errs.values())


def check_wiener(dev):
    """Phase 3: K2 + K3 against their plain versions, 1 and 2 iterations."""
    import torch

    from umx_tpu_torch.config import WienerConfig
    from umx_tpu_torch.ops import wiener_cuda as W

    g = torch.Generator(device=dev).manual_seed(1)
    xre = 30 * torch.randn((2, T_SEG, F_BINS), generator=g, device=dev)
    xim = 30 * torch.randn((2, T_SEG, F_BINS), generator=g, device=dev)
    masks = torch.rand((N_SRC, T_SEG, 2 * F_BINS), generator=g, device=dev)
    for iterations in (1, 2):
        cfg = WienerConfig(iterations=iterations)
        yk = W.wiener_planes_from_masks(xre, xim, masks, cfg)
        torch.cuda.synchronize()
        # the same inputs on the CPU, where the wrapper runs the plain versions
        yp = W.wiener_planes_from_masks(xre.cpu(), xim.cpu(), masks.cpu(), cfg)
        yk = (yk[0].cpu(), yk[1].cpu())
        scale = max(float(yp[0].abs().max()), float(yp[1].abs().max()))
        err = max(max_err(yk[0], yp[0]), max_err(yk[1], yp[1])) / scale
        print(f"wiener reduce+apply vs plain, {iterations} iteration(s) "
              f"(S={N_SRC}, T={T_SEG}, F={F_BINS}): max|err|/max|y| {err:.3g}")
        # same f32 operations per element, other summation order in the
        # time sums (and FMA contraction): 1e-4 of max|y|
        require(err <= 1e-4, f"wiener kernels disagree with plain: {err}")
    # each pass alone, on the same inputs: absolute errors for the report
    inv = W.inv_max_abs(xre, xim, 10.0)
    racc = W.wiener_reduce("masks", xre, xim, masks, None, inv)
    racc_p = W.wiener_reduce_plain("masks", xre, xim, masks, inv)
    require(torch.equal(racc, W.wiener_reduce("masks", xre, xim, masks, None, inv)),
            "wiener_reduce is not bit-stable from run to run")
    y_k = W.wiener_apply("masks", xre, xim, masks, None, racc_p, inv, 1e-10)
    y_p = W.wiener_apply_plain("masks", xre, xim, masks, None, racc_p, inv, 1e-10)
    torch.cuda.synchronize()
    errs = {
        "wiener_reduce": max_err(racc, racc_p),
        "wiener_apply": max(max_err(y_k[0], y_p[0]), max_err(y_k[1], y_p[1])),
    }
    print(f"wiener passes alone: max|err| reduce {errs['wiener_reduce']:.3g} "
          f"(max|racc| {float(racc_p.abs().max()):.3g}), apply {errs['wiener_apply']:.3g}")
    return (xre, xim, masks, inv, racc), errs


def write_inputs(tmp: str):
    """Synthetic UMX-L ggml weights and a 100 s stereo mix."""
    from scipy.io import wavfile

    from umx_tpu_torch.config import ModelConfig
    from umx_tpu_torch.io.ggml import write_ggml
    from umx_tpu_torch.models.umx import synthetic_state_dicts

    model = os.path.join(tmp, "umxl_synthetic.bin")
    write_ggml(model, 1024, synthetic_state_dicts(ModelConfig(hidden_size=1024), seed=0))
    t = np.arange(int(TRACK_SECS * SR)) / SR
    rng = np.random.default_rng(0)
    mix = np.stack([
        0.3 * np.sin(2 * np.pi * 110 * t) + 0.2 * np.sin(2 * np.pi * 440 * t)
        + 0.05 * rng.standard_normal(t.size),
        0.3 * np.sin(2 * np.pi * 165 * t) + 0.2 * np.sin(2 * np.pi * 660 * t)
        + 0.05 * rng.standard_normal(t.size),
    ]).astype(np.float32)
    wav = os.path.join(tmp, "mix.wav")
    wavfile.write(wav, SR, np.ascontiguousarray(mix.T))
    return model, wav, mix


def main_path(tmp: str, model: str, wav: str, mix):
    """Phase 4: the CLI on cuda, with the kernels' launch counters."""
    from scipy.io import wavfile

    from umx_tpu_torch import cli
    from umx_tpu_torch.ops import lstm_cuda, wiener_cuda

    counters = {
        "lstm_merged": lstm_cuda.lstm_merged,
        "wiener_reduce": wiener_cuda.wiener_reduce,
        "wiener_apply": wiener_cuda.wiener_apply,
    }
    for fn in counters.values():
        fn.launches = 0
    out = os.path.join(tmp, "stems")
    t0 = time.perf_counter()
    rc = cli.main([model, wav, out, "--timings"])
    cli_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    require(rc == 0, f"CLI exited {rc}")
    print(f"main path (CLI, {TRACK_SECS:.0f} s track, UMX-L): {cli_s:.3f} s wall; "
          f"kernel runs {launches}")
    for name, n in launches.items():
        require(n > 0, f"kernel {name} was not launched on the main path")

    stems = []
    for i in range(4):
        rate, data = wavfile.read(os.path.join(out, f"target_{i}.wav"))
        require(rate == SR and data.shape == (mix.shape[1], 2) and data.dtype == np.float32,
                f"target_{i}.wav: rate {rate}, shape {data.shape}, dtype {data.dtype}")
        require(bool(np.isfinite(data).all()), f"target_{i}.wav has non-finite samples")
        stems.append(data.T)
    corr = float(np.corrcoef(np.sum(stems, axis=0).ravel(), mix.ravel())[0, 1])
    print(f"corr(sum of stems, mix) = {corr:.6f}")
    require(corr >= 0.99, f"stems do not sum to the mix (corr {corr})")
    return launches


def gpu_vs_cpu(model: str, mix):
    """Phase 4b: the GPU path against the port's CPU path (plain
    versions of every kernel) on 5 s of the mix with 2 s segments."""
    import torch

    from umx_tpu_torch.config import EngineConfig, SegmentConfig
    from umx_tpu_torch.engine.separator import Separator

    cfg = EngineConfig(segment=SegmentConfig(segment_secs=2.0))
    short = mix[:, : 5 * SR]
    gpu = Separator.from_ggml(model, cfg, "cuda").demix_track(short, seed=0)
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    cpu = Separator.from_ggml(model, cfg, "cpu").demix_track(short, seed=0)
    err = float(np.max(np.abs(gpu - cpu)) / np.max(np.abs(cpu)))
    print(f"GPU vs CPU port, 5 s at UMX-L width: max|err|/max|stem| {err:.3g}")
    # bf16 operands in the recurrence and cuFFT/cuBLAS summation order;
    # the same a-priori cap as the CPU tests' slice comparison class
    require(bool(np.isfinite(gpu).all()) and err <= 2e-3, f"GPU and CPU paths disagree: {err}")
    return err


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a GPU",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}")

    from umx_tpu_torch import _build
    from umx_tpu_torch.ops import lstm_cuda, wiener_cuda

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    build_s = time.perf_counter() - t0
    print(f"kernel build: {build_s:.2f} s -> {os.path.relpath(lib_path)}")
    log = lib_path.with_name(lib_path.name + ".log")
    if log.is_file():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")

    lstm_args, lstm_err = check_lstm(dev)
    wiener_args, wiener_errs = check_wiener(dev)

    with tempfile.TemporaryDirectory(prefix="umx_smoke_") as tmp:
        model, wav, mix = write_inputs(tmp)
        launches = main_path(tmp, model, wav, mix)
        cpu_err = gpu_vs_cpu(model, mix)

        from umx_tpu_torch.engine.separator import Separator

        sep = Separator.from_ggml(model, device="cuda")
        sep.demix_track(mix, seed=0)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sep.demix_track(mix, seed=0)
        torch.cuda.synchronize()
        demix_s = time.perf_counter() - t0
    print(f"demix {TRACK_SECS:.0f} s track (warm, UMX-L, shifts 1): {demix_s:.3f} s, "
          f"{TRACK_SECS / demix_s:.1f}x realtime  [{smi}]")

    # Phase 5: kernel vs plain times at the UMX-L segment shape
    xre, xim, masks, inv, racc = wiener_args
    W = wiener_cuda
    times = {
        "lstm_merged": (
            cuda_ms(lambda: lstm_cuda.lstm_merged(*lstm_args), 5),
            cuda_ms(lambda: lstm_cuda.lstm_merged_plain(*lstm_args), 2),
        ),
        "wiener_reduce": (
            cuda_ms(lambda: W.wiener_reduce("masks", xre, xim, masks, None, inv), 20),
            cuda_ms(lambda: W.wiener_reduce_plain("masks", xre, xim, masks, inv), 20),
        ),
        "wiener_apply": (
            cuda_ms(lambda: W.wiener_apply("masks", xre, xim, masks, None, racc, inv, 1e-10), 20),
            cuda_ms(lambda: W.wiener_apply_plain("masks", xre, xim, masks, None, racc, inv, 1e-10), 20),
        ),
    }
    for name, (k, p) in times.items():
        print(f"{name}: kernel {k:.4f} ms, plain {p:.4f} ms  [{smi}]")

    meta = {
        "lstm_merged": ("umx_tpu_torch/csrc/lstm_merged.cu",
                        "umx_tpu/ops/lstm_pallas.py:158", lstm_err),
        "wiener_reduce": ("umx_tpu_torch/csrc/wiener.cu",
                          "umx_tpu/ops/wiener_pallas.py:89", wiener_errs["wiener_reduce"]),
        "wiener_apply": ("umx_tpu_torch/csrc/wiener.cu",
                         "umx_tpu/ops/wiener_pallas.py:128", wiener_errs["wiener_apply"]),
    }
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": err,
         "ms": times[name][0], "plain_ms": times[name][1]}
        for name, (src, rep, err) in meta.items()
    ]
    print(json.dumps({"kernels": kernels, "build_s": build_s, "demix_s": demix_s,
                      "gpu_vs_cpu_rel_err": cpu_err}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
