#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``umx_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises (exit code 1, no result line) on failure:

1. build the CUDA kernels from ``umx_tpu_torch/csrc`` (one nvcc per
   source, in parallel; sm_90a);
2. the BLSTM recurrence kernel K1 against its plain PyTorch version at
   the UMX-L segment shape (R = 8 chains, B = 1, G = 512, T = 2584), and
   at the UMX-L training shape (B = 16, T = 256);
3. the Wiener-EM reduce/apply kernels against their plain versions at
   S = 4, T = 2584, F = 2049, for 1 and 2 EM iterations;
4. the demix path: synthetic UMX-L weights (hidden 1024, seed 0) written
   as a ggml file, a synthetic 100 s stereo WAV, and the port's CLI run
   on it in-process on ``cuda`` (3 chunks of 60 s, so the LSTM state is
   carried twice); the stems are checked, and every kernel's launch
   counter must have moved during that run.  Then the GPU path is held
   against the port's CPU path (plain versions) on a short input;
5. the training kernels K4 (forward with residuals), K5 (reverse step)
   and K6 (weight gradient) against their plain versions at the UMX-L
   training shape (T = 256, R = 8, B = 16, G = 512), and K6 bit-stable;
6. the training path: synthetic stems on disk, ``data.train_loop`` for 8
   steps at batch 16 × 256 frames at UMX-L width with a validation split
   (finite losses, frozen BatchNorm statistics, K1/K4/K5/K6 launched),
   five steps on one fixed batch that must lower its loss, and the
   trained weights exported as ggml and demixed through the CLI;
7. the overlap-add kernel K7 (bit-equal and bit-stable) and the
   Cooley-Tukey iSTFT kernel K8 against their plain versions (100 s UMX-L
   track: 3 chunks of 60 s, M = 8 and 16 rows; 8 rows x 2584 frames and a
   ragged 37);
8. the batched whole-track path: the CLI with ``--no-streaming --shifts 2
   --istft-algo ct2`` on the 100 s track, and a ``Separator`` with
   ``ola_impl="pallas"``, the ct2 iSTFT, non-streaming chunk groups at the
   planner's width and two batched shift passes; stems checked, K1 (at
   more than one row per chain), K2, K3, K7 and K8 launched.  The shapes
   at which that path ran K1 (rows per chain x frames) and K8 (rows x
   frames) are recorded during the run, and each kernel is then held
   against its plain version at each of them; then the GPU against the
   CPU for that config on a short input;
9. memory-planner anchors: the measured peak of the non-streaming and
   batched-shift programs beside the planner's estimate, which must bound
   it;
10. timings: each kernel against its plain version (CUDA events, after
    warm-up), the warm demix times of the 100 s track, and train steps/s.

Prints the card's name and power limit, a JSON line with the kernels,
and last ``{"ok": true, "device": {...}}``.  Needs one CUDA GPU; exits
non-zero without one.
"""

from __future__ import annotations

import contextlib
import json
import math
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
# UMX-L training shape: batch 16 x 256 frames (TrainConfig's seq_len)
B_TRAIN, T_TRAIN = 16, 256
TRAIN_STEPS = 8
# the batched whole-track path on the 100 s track: 3 chunks of 60 s at a
# 45 s stride; overlap-add rows M = T# x 2 channels x shift rows
N_CHUNKS, SEG, STRIDE = 3, 2_646_000, 1_984_500
# the iSTFT kernel's rows at one segment row (T# x 2 channels); the
# batched path's own rows are recorded when it runs
ISTFT_ROWS = 8


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


def lstm_inputs(dev, T, B, seed):
    """Random K1 inputs at R = 8 chains, G = 512 (the UMX-L layer)."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    RB, G4 = R_CHAINS * B, 4 * G_HIDDEN
    xp = torch.randn((T, RB, G4), generator=g, device=dev)
    whh = (torch.randn((R_CHAINS, G_HIDDEN, G4), generator=g, device=dev)
           / G_HIDDEN**0.5).to(torch.bfloat16)
    h0 = 0.5 * torch.randn((RB, G_HIDDEN), generator=g, device=dev)
    c0 = 0.5 * torch.randn((RB, G_HIDDEN), generator=g, device=dev)
    return xp, whh, h0, c0, B


def check_lstm(dev, T, B, seed):
    """Phase 2: K1 against its plain version at R = 8, G = 512."""
    import torch

    from umx_tpu_torch.ops import lstm_cuda

    args = lstm_inputs(dev, T, B, seed)
    out_k = lstm_cuda.lstm_merged(*args)
    torch.cuda.synchronize()
    out_p = lstm_cuda.lstm_merged_plain(*args)
    torch.cuda.synchronize()
    errs = {n: max_err(a, b) for n, a, b in zip(("hs", "hT", "cT"), out_k, out_p)}
    print(f"lstm_merged vs plain (T={T}, R={R_CHAINS}, B={B}, G={G_HIDDEN}): "
          f"max|err| hs {errs['hs']:.3g} hT {errs['hT']:.3g} cT {errs['cT']:.3g}")
    # Both round h to bf16 before the product; an f32 last-bit difference
    # in a sum can flip one bf16 rounding, a ~4e-3 relative step in one
    # operand, which the contractive recurrence damps: 5e-3 absolute on
    # h (|h| < 1) and c bounds that.
    require(max(errs.values()) <= 5e-3, f"lstm_merged disagrees with plain: {errs}")
    return args, max(errs.values())


def check_train_kernels(dev):
    """Phase 5: K4, K5 and K6 against their plain versions at the UMX-L
    training shape, random inputs and cotangents."""
    import torch

    from umx_tpu_torch.ops import lstm_cuda as L

    xp, whh, h0, c0, B = lstm_inputs(dev, T_TRAIN, B_TRAIN, seed=7)
    g = torch.Generator(device=dev).manual_seed(8)
    RB, G = R_CHAINS * B, G_HIDDEN
    dhs = torch.randn((T_TRAIN, RB, G), generator=g, device=dev)
    dhT = torch.randn((RB, G), generator=g, device=dev)
    dcT = torch.randn((RB, G), generator=g, device=dev)

    fwd_k = L.lstm_merged_train_fwd(xp, whh, h0, c0, B)
    fwd_p = L.lstm_merged_train_fwd_plain(xp, whh, h0, c0, B)
    fwd_errs = {n: max_err(a, b) for n, a, b in
                zip(("hs", "hT", "cT", "gates", "cs"), fwd_k, fwd_p)}
    print(f"lstm_merged_train_fwd vs plain (T={T_TRAIN}, R={R_CHAINS}, B={B}, G={G}): "
          + " ".join(f"{n} {e:.3g}" for n, e in fwd_errs.items()))
    # the same argument as K1: 5e-3 absolute on h, c and the activated gates
    require(max(fwd_errs.values()) <= 5e-3, f"lstm_merged_train_fwd disagrees: {fwd_errs}")

    hs, _, _, gates, cs = fwd_p  # the same residuals into both backwards
    dxp_k, dh0_k, dc0_k = L.lstm_merged_bwd_step(gates, cs, c0, whh, dhs, dhT, dcT, B)
    dw_k = L.lstm_merged_dw(hs, h0, dxp_k, B)
    dxp_p, dw_p, dh0_p, dc0_p = L.lstm_merged_bwd_plain(gates, cs, hs, h0, c0, whh, dhs, dhT,
                                                        dcT, B)
    rel = {n: max_err(k, p) / float(p.abs().max()) for n, k, p in
           (("dxp", dxp_k, dxp_p), ("dW", dw_k, dw_p), ("dh0", dh0_k, dh0_p), ("dc0", dc0_k, dc0_p))}
    print("lstm backward vs plain, max|err|/max|ref|: "
          + " ".join(f"{n} {e:.3g}" for n, e in rel.items()))
    # Where f32 sums differ in order the bf16 rounding of a gate cotangent
    # flips and the reverse chain carries it on: the plain version on the
    # card and on the CPU differ by as much (up to 1.9e-3 of max|ref| at
    # this width, measured on an H100), so the bound is 5e-3.
    require(max(rel.values()) <= 5e-3, f"lstm backward disagrees with plain: {rel}")
    dw_alone = max_err(L.lstm_merged_dw(hs, h0, dxp_p, B), dw_p) / float(dw_p.abs().max())
    require(dw_alone <= 1e-5, f"lstm_merged_dw disagrees with plain on the same dxp: {dw_alone}")
    require(torch.equal(dw_k, L.lstm_merged_dw(hs, h0, dxp_k, B)),
            "lstm_merged_dw is not bit-stable from run to run")
    print(f"lstm_merged_dw on the plain dxp: max|err|/max|ref| {dw_alone:.3g}; bit-stable")
    errs = {
        "lstm_merged_train_fwd": max(fwd_errs.values()),
        "lstm_merged_bwd_step": max(max_err(dxp_k, dxp_p), max_err(dh0_k, dh0_p),
                                    max_err(dc0_k, dc0_p)),
        "lstm_merged_dw": max_err(dw_k, dw_p),
    }
    args = {
        "lstm_merged_train_fwd": (xp, whh, h0, c0, B),
        "lstm_merged_bwd_step": (gates, cs, c0, whh, dhs, dhT, dcT, B),
        "lstm_merged_dw": (hs, h0, dxp_p, B),
    }
    return args, errs


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


def check_ola(dev):
    """Phase 7: K7 against its plain version at the 100 s track's shape,
    one and two shift rows (M = 8, 16): bit-equal and bit-stable."""
    import torch

    from umx_tpu_torch.ops import ola, ola_cuda

    g = torch.Generator(device=dev).manual_seed(3)
    args, worst = {}, 0.0
    for M in (8, 16):
        ys = torch.randn((N_CHUNKS, M, SEG), generator=g, device=dev)
        L = N_CHUNKS * STRIDE + SEG - STRIDE
        inv_sw = 1.0 / (torch.rand(L, generator=g, device=dev) + 0.5)
        out = ola_cuda.ola_normalized(ys, inv_sw, STRIDE)
        torch.cuda.synchronize()
        plain = ola.ola_normalized_plain(ys, inv_sw, STRIDE)
        err = max_err(out, plain)
        require(torch.equal(out, plain), f"ola_normalized is not bit-equal to plain at M = {M}: "
                f"max|err| {err}")
        worst = max(worst, err)
        require(torch.equal(out, ola_cuda.ola_normalized(ys, inv_sw, STRIDE)),
                "ola_normalized is not bit-stable from run to run")
        print(f"ola_normalized vs plain (n_chunks={N_CHUNKS}, M={M}, seg={SEG}, stride={STRIDE}): "
              "bit-equal, bit-stable")
        args[M] = (ys, inv_sw, STRIDE)
    return args, worst


def check_istft_ct(dev, shapes, seed: int):
    """K8 against its plain version (cuFFT irfft + the same overlap-add)
    at each (rows, frames) of ``shapes``, unit-normal planes, and against
    a float64 CPU reference on its first 8 rows (rows are independent).
    Returns ({shape: kernel args}, worst max|err| vs plain)."""
    import torch

    from umx_tpu_torch.ops import istft_ct, istft_ct_cuda
    from umx_tpu_torch.ops.stft import hann_window

    g = torch.Generator(device=dev).manual_seed(seed)
    w = hann_window(4096, dev)
    args, worst = {}, 0.0
    for rows, T in shapes:
        re = torch.randn((rows, T, F_BINS), generator=g, device=dev)
        im = torch.randn((rows, T, F_BINS), generator=g, device=dev)
        out = istft_ct_cuda.istft_ct2(re, im, 4096, 1024, w)
        torch.cuda.synchronize()
        plain = istft_ct.istft_ct2_plain(re, im, 4096, 1024, w)
        err, sig = max_err(out, plain), float(plain.abs().max())
        f64 = istft_ct.istft_ct2_plain(re[:8].cpu().double(), im[:8].cpu().double(), 4096, 1024,
                                       w.cpu().double())
        err64 = float((out[:8].cpu().double() - f64).abs().max())
        plain64 = float((plain[:8].cpu().double() - f64).abs().max())
        del plain, f64
        print(f"istft_ct2 vs plain (rows={rows}, T={T}, F={F_BINS}): max|err| {err:.3g}; "
              f"vs float64 on {min(rows, 8)} rows {err64:.3g} (plain vs float64 {plain64:.3g}); "
              f"max|sig| {sig:.3g}")
        # f32 sums over 2049 bins in other orders: ~1e-7 against float64,
        # measured; 1e-5 absolute is the JAX package's own bound between
        # its CT forms on unit-normal planes
        require(err <= 1e-5 and err64 <= 1e-5, f"istft_ct2 disagrees: {err}, {err64}")
        require(torch.equal(out, istft_ct_cuda.istft_ct2(re, im, 4096, 1024, w)),
                "istft_ct2 is not bit-stable from run to run")
        worst = max(worst, err)
        args[(rows, T)] = (re, im, 4096, 1024, w)
        del out
    return args, worst


@contextlib.contextmanager
def recording(module, name: str, shape_of, seen: set):
    """For the block, ``module.name`` is a wrapper that adds
    ``shape_of(*args)`` of every call to ``seen`` and then calls it."""
    real = getattr(module, name)

    def spy(*args, **kw):
        seen.add(shape_of(*args, **kw))
        return real(*args, **kw)

    setattr(module, name, spy)
    try:
        yield
    finally:
        setattr(module, name, real)


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


def check_stems(out: str, mix, min_corr: float = 0.99):
    """The CLI's output: 4 finite 44.1 kHz stereo f32 WAVs that sum to the
    mix (Wiener-EM partitions it).  Returns the stems (4, 2, n)."""
    from scipy.io import wavfile

    stems = []
    for i in range(4):
        rate, data = wavfile.read(os.path.join(out, f"target_{i}.wav"))
        require(rate == SR and data.shape == (mix.shape[1], 2) and data.dtype == np.float32,
                f"target_{i}.wav: rate {rate}, shape {data.shape}, dtype {data.dtype}")
        require(bool(np.isfinite(data).all()), f"target_{i}.wav has non-finite samples")
        stems.append(data.T)
    corr = float(np.corrcoef(np.sum(stems, axis=0).ravel(), mix.ravel())[0, 1])
    print(f"corr(sum of stems, mix) = {corr:.6f}")
    require(corr >= min_corr, f"stems do not sum to the mix (corr {corr})")
    return np.stack(stems)


def stem_correlation(est, ref) -> float:
    """Mean over the 4 stems of corr(estimate, true stem)."""
    return float(np.mean([np.corrcoef(e.ravel(), r.ravel())[0, 1] for e, r in zip(est, ref)]))


def reset_counts(counters: dict) -> None:
    for fn in counters.values():
        fn.launches = 0


def main_path(tmp: str, model: str, wav: str, mix, counters: dict, smi: str):
    """Phase 4: the CLI on cuda, with the kernels' launch counters."""
    from umx_tpu_torch import cli

    reset_counts(counters)
    out = os.path.join(tmp, "stems")
    t0 = time.perf_counter()
    rc = cli.main([model, wav, out, "--quiet"])
    cli_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    require(rc == 0, f"CLI exited {rc}")
    print(f"demix path (CLI, {TRACK_SECS:.0f} s track, UMX-L): {cli_s:.3f} s wall  [{smi}]; "
          f"kernel runs {launches}")
    for name in ("lstm_merged", "wiener_reduce", "wiener_apply"):
        require(launches[name] > 0, f"kernel {name} was not launched on the demix path")
    check_stems(out, mix)
    return launches


def batched_config(**seg):
    """The batched whole-track config: non-streaming chunk groups at the
    planner's width, two batched shift passes, the ct2 iSTFT and the
    overlap-add kernel."""
    from umx_tpu_torch.config import DSPConfig, EngineConfig, SegmentConfig

    return EngineConfig(dsp=DSPConfig(istft_algo="ct2"),
                        segment=SegmentConfig(streaming=False, chunk_batch=0, **seg),
                        shifts=2, ola_impl="pallas")


def batched_path(tmp: str, model: str, wav: str, mix, counters: dict, smi: str):
    """Phase 8: the CLI and a Separator on the batched whole-track path,
    each with the launch counters set to 0 just before and read just
    after.  The shapes the path gives K1 ((rows per chain, frames), from
    the layer call that launches it) and K8 ((rows, frames), from the
    segment forward's iSTFT call, which launches it) are recorded around
    those calls and returned."""
    from umx_tpu_torch import cli
    from umx_tpu_torch.engine import separator
    from umx_tpu_torch.models import umx

    k1_shapes, k8_shapes = set(), set()
    with recording(umx, "lstm_layer_merged_batched", lambda x, *a: (x.shape[0], x.shape[2]),
                   k1_shapes), \
         recording(separator, "istft_planes",
                   lambda re, *a: (math.prod(re.shape[:-2]), re.shape[-2]), k8_shapes):
        reset_counts(counters)
        out = os.path.join(tmp, "stems_batched")
        t0 = time.perf_counter()
        rc = cli.main([model, wav, out, "--no-streaming", "--shifts", "2", "--istft-algo", "ct2",
                       "--quiet"])
        cli_s = time.perf_counter() - t0
        cli_launches = {name: fn.launches for name, fn in counters.items()}
        require(rc == 0, f"CLI exited {rc}")
        cli_rows = sorted({b for b, _ in k1_shapes})
        print(f"batched path (CLI --no-streaming --shifts 2 --istft-algo ct2, {TRACK_SECS:.0f} s, "
              f"UMX-L): {cli_s:.3f} s wall  [{smi}]; kernel runs {cli_launches}; K1 rows per "
              f"chain {cli_rows}")
        for name in ("lstm_merged", "wiener_reduce", "wiener_apply", "istft_ct2"):
            require(cli_launches[name] > 0, f"kernel {name} was not launched by the batched CLI")
        require(max(cli_rows) > 1, f"K1 ran at one row per chain: {cli_rows}")
        check_stems(out, mix)

        sep = separator.Separator.from_ggml(model, batched_config(), "cuda")
        k1_sep = set()
        with recording(umx, "lstm_layer_merged_batched",
                       lambda x, *a: (x.shape[0], x.shape[2]), k1_sep):
            reset_counts(counters)
            stems = sep.demix_track(mix, seed=0)
            launches = {name: fn.launches for name, fn in counters.items()}
    rows = sorted({b for b, _ in k1_sep})
    print(f"batched path (Separator, ola_impl pallas, ct2, chunk groups, 2 shift rows): kernel "
          f"runs {launches}; K1 rows per chain {rows}")
    print(f"batched path shapes: K1 (rows per chain, frames) {sorted(k1_shapes)}, "
          f"K8 (rows, frames) {sorted(k8_shapes)}")
    for name in ("lstm_merged", "wiener_reduce", "wiener_apply", "ola_normalized", "istft_ct2"):
        require(launches[name] > 0, f"kernel {name} was not launched on the batched path")
    require(max(rows) > 1, f"K1 ran at one row per chain: {rows}")
    require(stems.shape == (4, *mix.shape) and bool(np.isfinite(stems).all()),
            f"stems {stems.shape}")
    corr = float(np.corrcoef(stems.sum(axis=0).ravel(), mix.ravel())[0, 1])
    print(f"corr(sum of stems, mix) = {corr:.6f}")
    require(corr >= 0.99, f"stems do not sum to the mix (corr {corr})")
    return launches, max(rows), sep, sorted(k1_shapes), sorted(k8_shapes)


def batched_gpu_vs_cpu(model: str, mix):
    """Phase 8: the batched config on the GPU against the port's CPU path
    on 5 s of the mix with 2 s segments."""
    import torch

    from umx_tpu_torch.engine.separator import Separator

    cfg = batched_config(segment_secs=2.0)
    short = mix[:, : 5 * SR]
    gpu = Separator.from_ggml(model, cfg, "cuda").demix_track(short, seed=0)
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    cpu = Separator.from_ggml(model, cfg, "cpu").demix_track(short, seed=0)
    err = float(np.max(np.abs(gpu - cpu)) / np.max(np.abs(cpu)))
    print(f"GPU vs CPU port, batched path, 5 s at UMX-L width: max|err|/max|stem| {err:.3g}")
    require(bool(np.isfinite(gpu).all()) and err <= 2e-3, f"GPU and CPU paths disagree: {err}")
    return err


def planner_anchors(sep, mix, smi: str):
    """Phase 9: measured peak device memory of the non-streaming and the
    batched-shift programs on the 100 s track, beside the planner's
    estimate, which must bound it.  The peak is taken above what is
    resident before the run (the parameters, and the earlier phases'
    test tensors), plus the parameters: the program's footprint with
    only its weights resident, which is what the estimate models."""
    import dataclasses

    import torch

    from umx_tpu_torch.config import DSPConfig, SegmentConfig
    from umx_tpu_torch.engine import memory
    from umx_tpu_torch.engine.fleet import resolve_batched_width

    cfg0, params = sep.cfg, sep.params
    length, max_shift = mix.shape[1], cfg0.segment.max_shift_samples(SR)
    seg, stride = cfg0.segment.segment_samples(SR), cfg0.segment.stride_samples(SR)
    rows = []
    for algo in ("auto", "ct2"):
        for streaming, width, shifts in ((False, 1, 0), (False, 2, 0), (False, 3, 0),
                                         (False, 0, 2), (True, 0, 2)):
            cfg = dataclasses.replace(
                cfg0, dsp=DSPConfig(istft_algo=algo), shifts=shifts,
                segment=SegmentConfig(streaming=streaming, chunk_batch=width))
            sep.cfg = cfg
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            sep.demix_track(mix, seed=0)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base + memory.params_hbm_bytes(cfg, params)
            if shifts > 1:
                n_chunks = -(-(length + max_shift) // stride)
                secs = ((n_chunks - 1) * stride + seg) / SR
                if streaming:
                    est = memory.fused_track_hbm_bytes(cfg, 2, (length + max_shift) / SR, params)
                else:
                    width = resolve_batched_width(cfg, n_chunks, seg, stride, batch=2,
                                                  params=params, device="cuda")
                    est = memory.parallel_track_hbm_bytes(cfg, width, secs, params, batch=2)
            else:
                est = memory.parallel_track_hbm_bytes(cfg, width, length / SR, params)
            total = est["total"]
            print(f"planner anchor istft {algo}, {'streaming' if streaming else 'non-streaming'}, "
                  f"width {width}, shifts {shifts}: peak {peak} B, estimate {total} B "
                  f"({total / peak:.3f}x)  [{smi}]")
            require(total >= peak, f"the planner's estimate {total} is below the peak {peak}")
            rows.append({"istft": algo, "streaming": streaming, "width": width,
                         "shifts": shifts, "peak": peak, "estimate": total})
    sep.cfg = cfg0
    return rows


def write_stem_dir(root: str, n_tracks: int = 4, secs: float = 12.0):
    """Synthetic MUSDB-style stems: per track, band-limited noise per
    stem (bass, drums, other, vocals in rising bands), float32 WAVs."""
    from scipy.io import wavfile

    from umx_tpu_torch.config import TARGETS

    bands = [(40, 300), (300, 1200), (1200, 4000), (4000, 12000)]
    rng = np.random.default_rng(0)
    n = int(secs * SR)
    freqs = np.fft.rfftfreq(n, 1 / SR)
    for k in range(n_tracks):
        d = os.path.join(root, f"track_{k}")
        os.makedirs(d)
        for name, (lo, hi) in zip(TARGETS, bands):
            spec = np.fft.rfft(rng.standard_normal((2, n)).astype(np.float32), axis=-1)
            spec[:, (freqs < lo) | (freqs >= hi)] = 0
            x = np.fft.irfft(spec, n, axis=-1).astype(np.float32)
            x = x / (np.abs(x).max() + 1e-9) * 0.5
            wavfile.write(os.path.join(d, f"{name}.wav"), SR, np.ascontiguousarray(x.T))


def training_path(tmp: str, counters: dict, smi: str):
    """Phase 6: train_loop at UMX-L width on cuda, then a fixed batch, then
    export and demix through the CLI."""
    import torch
    from scipy.io import wavfile

    from umx_tpu_torch import cli
    from umx_tpu_torch.config import DSPConfig, ModelConfig
    from umx_tpu_torch.data import StemDataset, train_loop
    from umx_tpu_torch.models.umx import synthetic_params
    from umx_tpu_torch.train import (
        FROZEN, TrainConfig, export_ggml, init_train_state, make_batch_from_audio,
        make_train_step,
    )

    root = os.path.join(tmp, "stems_train")
    write_stem_dir(root)
    mcfg, tcfg = ModelConfig(hidden_size=1024), TrainConfig()
    excerpt = DSPConfig().hop * (tcfg.seq_len - 1)  # 256 frames, ~5.9 s
    train = StemDataset(root, excerpt_samples=excerpt, split="train", seed=0)
    valid = StemDataset(root, excerpt_samples=excerpt, split="valid", seed=0)
    params0 = synthetic_params(mcfg, seed=0, device="cuda")

    reset_counts(counters)
    t0 = time.perf_counter()
    state, hist = train_loop(train, mcfg, tcfg, steps=TRAIN_STEPS, batch_size=B_TRAIN,
                             params=params0, device="cuda", log_every=0,
                             valid_dataset=valid, valid_every=4)
    train_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    print(f"training path (train_loop, UMX-L, batch {B_TRAIN} x {tcfg.seq_len} frames, "
          f"{TRAIN_STEPS} steps, 2 validations): {train_s:.3f} s wall  [{smi}]; "
          f"kernel runs {launches}")
    print(f"train losses {[round(x, 6) for x in hist]}; valid {hist.valid}")
    require(len(hist) == TRAIN_STEPS and bool(np.isfinite(hist).all()), f"losses: {list(hist)}")
    require(len(hist.valid) == 2 and all(np.isfinite(v) for _, v in hist.valid),
            f"validation losses: {hist.valid}")
    for name in FROZEN:
        require(torch.equal(getattr(state.params, name), getattr(params0, name)),
                f"BatchNorm statistic {name} moved during training")
    require(not torch.equal(state.params.fc1_w, params0.fc1_w), "fc1_w did not train")
    for name in ("lstm_merged", "lstm_merged_train_fwd", "lstm_merged_bwd_step", "lstm_merged_dw"):
        require(launches[name] > 0, f"kernel {name} was not launched on the training path")

    # five steps on one fixed batch lower its loss; steps 2-5 are timed
    mix, targets = train.sample(B_TRAIN)
    batch = make_batch_from_audio(mix, targets, mcfg, DSPConfig(), tcfg.seq_len, "cuda")
    fixed = init_train_state(params0, tcfg)
    step = make_train_step(mcfg)
    losses = []
    for i in range(5):
        if i == 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        fixed, loss = step(fixed, batch)
        losses.append(float(loss))
    steps_per_s = 4 / (time.perf_counter() - t0)
    print(f"fixed batch, 5 steps: losses {[round(x, 6) for x in losses]}")
    require(bool(np.isfinite(losses).all()) and losses[-1] < losses[0],
            f"5 steps on one batch did not lower its loss: {losses}")

    # the trained and the initial weights, exported as ggml, demix 10 s of
    # the held-out track through the CLI
    true = valid._load_stems(valid.tracks[0])[:, :, : 10 * SR]
    mix10 = true.sum(axis=0)
    wav = os.path.join(tmp, "mix10.wav")
    wavfile.write(wav, SR, np.ascontiguousarray(mix10.T))
    sep = {}
    for name, p in (("trained", state.params), ("initial", params0)):
        model = os.path.join(tmp, f"{name}.bin")
        export_ggml(p, model, mcfg)
        out = os.path.join(tmp, f"stems_{name}")
        require(cli.main([model, wav, out, "--quiet"]) == 0, f"CLI on the {name} model failed")
        print(f"CLI demix of 10 s of a held-out track with the exported {name} weights:")
        # Wiener-EM gives back the mix only where some target's mask is
        # nonzero; a model trained on band-separated stems has all four
        # ReLU masks at zero in some bins (0.980 measured at UMX-L on an
        # H100, against 0.999 for the initial weights): 0.95 still catches
        # a lost stem or a broken transform
        sep[name] = stem_correlation(check_stems(out, mix10, min_corr=0.95), true)
    print(f"mean corr(stem estimate, true stem): trained {sep['trained']:.4f}, "
          f"initial {sep['initial']:.4f}")
    require(sep["trained"] > sep["initial"], f"training did not improve the separation: {sep}")
    return launches, steps_per_s


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
    from umx_tpu_torch.ops import istft_ct, istft_ct_cuda, lstm_cuda, ola, ola_cuda, wiener_cuda

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    build_s = time.perf_counter() - t0
    print(f"kernel build: {build_s:.2f} s -> {os.path.relpath(lib_path)}  [{smi}]")
    log = lib_path.with_name(lib_path.name + ".log")
    if log.is_file():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")

    lstm_args, lstm_err = check_lstm(dev, T_SEG, 1, seed=0)
    lstm16_args, lstm16_err = check_lstm(dev, T_TRAIN, B_TRAIN, seed=16)  # batches above 12 rows
    wiener_args, wiener_errs = check_wiener(dev)
    ola_args, ola_err = check_ola(dev)
    _, istft_err = check_istft_ct(dev, [(ISTFT_ROWS, T_SEG), (3, 37)], seed=4)

    counters = {
        "lstm_merged": lstm_cuda.lstm_merged,
        "wiener_reduce": wiener_cuda.wiener_reduce,
        "wiener_apply": wiener_cuda.wiener_apply,
        "lstm_merged_train_fwd": lstm_cuda.lstm_merged_train_fwd,
        "lstm_merged_bwd_step": lstm_cuda.lstm_merged_bwd_step,
        "lstm_merged_dw": lstm_cuda.lstm_merged_dw,
        "ola_normalized": ola_cuda.ola_normalized,
        "istft_ct2": istft_ct_cuda.istft_ct2,
    }
    with tempfile.TemporaryDirectory(prefix="umx_smoke_") as tmp:
        model, wav, mix = write_inputs(tmp)
        launches = main_path(tmp, model, wav, mix, counters, smi)
        cpu_err = gpu_vs_cpu(model, mix)

        from umx_tpu_torch.engine.separator import Separator

        sep = Separator.from_ggml(model, device="cuda")
        sep.demix_track(mix, seed=0)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sep.demix_track(mix, seed=0)
        torch.cuda.synchronize()
        demix_s = time.perf_counter() - t0
        del sep
        print(f"demix {TRACK_SECS:.0f} s track (warm, UMX-L, shifts 1): {demix_s:.3f} s, "
              f"{TRACK_SECS / demix_s:.1f}x realtime  [{smi}]")

        batched_launches, k1_rows, bsep, k1_shapes, k8_shapes = batched_path(
            tmp, model, wav, mix, counters, smi)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bsep.demix_track(mix, seed=0)
        torch.cuda.synchronize()
        batched_s = time.perf_counter() - t0
        print(f"demix {TRACK_SECS:.0f} s track (warm, UMX-L, non-streaming chunk groups, "
              f"2 batched shifts, ct2 iSTFT, overlap-add kernel): {batched_s:.3f} s, "
              f"{TRACK_SECS / batched_s:.1f}x realtime  [{smi}]")
        anchors = planner_anchors(bsep, mix, smi)
        del bsep
        batched_err = batched_gpu_vs_cpu(model, mix)

        # K1 and K8 against their plain versions at the shapes the batched
        # path ran them at (after its counts were read)
        path_lstm_args = {}
        for B, T in k1_shapes:
            path_lstm_args[B, T], err = check_lstm(dev, T, B, seed=100 + B)
            lstm_err = max(lstm_err, err)
        istft_args, err = check_istft_ct(dev, k8_shapes, seed=5)
        istft_err = max(istft_err, err)

        train_args, train_errs = check_train_kernels(dev)
        train_launches, steps_per_s = training_path(tmp, counters, smi)
    print(f"train steps/s (warm, UMX-L, batch {B_TRAIN} x {T_TRAIN} frames, AdamW): "
          f"{steps_per_s:.3f}  [{smi}]")

    # Phase 10: kernel vs plain times: K1-K3 at the UMX-L segment shape, the
    # training kernels (and K1 again) at the training shape, K7-K8 at the
    # batched whole-track path's shapes
    xre, xim, masks, inv, racc = wiener_args
    W = wiener_cuda
    L = lstm_cuda
    times = {
        "lstm_merged": (
            cuda_ms(lambda: L.lstm_merged(*lstm_args), 5),
            cuda_ms(lambda: L.lstm_merged_plain(*lstm_args), 2),
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
    for name, fn, plain in (
        ("lstm_merged_train_fwd", L.lstm_merged_train_fwd, L.lstm_merged_train_fwd_plain),
        ("lstm_merged_bwd_step", L.lstm_merged_bwd_step, L.lstm_merged_bwd_step_plain),
        ("lstm_merged_dw", L.lstm_merged_dw, L.lstm_merged_dw_plain),
    ):
        times[name] = (cuda_ms(lambda: fn(*train_args[name]), 5),
                       cuda_ms(lambda: plain(*train_args[name]), 2))
    times["ola_normalized"] = (cuda_ms(lambda: ola_cuda.ola_normalized(*ola_args[8]), 20),
                               cuda_ms(lambda: ola.ola_normalized_plain(*ola_args[8]), 20))
    ola16 = (cuda_ms(lambda: ola_cuda.ola_normalized(*ola_args[16]), 20),
             cuda_ms(lambda: ola.ola_normalized_plain(*ola_args[16]), 20))
    k8_shape = max(istft_args, key=math.prod)
    k8_args = istft_args[k8_shape]
    times["istft_ct2"] = (cuda_ms(lambda: istft_ct_cuda.istft_ct2(*k8_args), 10),
                          cuda_ms(lambda: istft_ct.istft_ct2_plain(*k8_args), 10))
    k1_path = {bt: (cuda_ms(lambda: L.lstm_merged(*a), 5),
                    cuda_ms(lambda: L.lstm_merged_plain(*a), 2))
               for bt, a in path_lstm_args.items()}
    k1_train = (cuda_ms(lambda: L.lstm_merged(*lstm16_args), 5),
                cuda_ms(lambda: L.lstm_merged_plain(*lstm16_args), 2))
    for name, (k, p) in times.items():
        print(f"{name}: kernel {k:.4f} ms, plain {p:.4f} ms  [{smi}]")
    print(f"lstm_merged at the training shape (T={T_TRAIN}, B={B_TRAIN}): kernel "
          f"{k1_train[0]:.4f} ms, plain {k1_train[1]:.4f} ms  [{smi}]")
    print(f"ola_normalized at M=16 (two shift rows): kernel {ola16[0]:.4f} ms, plain "
          f"{ola16[1]:.4f} ms  [{smi}]")
    for (B, T), (k, p) in k1_path.items():
        print(f"lstm_merged at the batched path's shape (T={T}, B={B}): kernel {k:.4f} ms, "
              f"plain {p:.4f} ms  [{smi}]")
    print(f"istft_ct2 timed at the batched path's shape (rows={k8_shape[0]}, T={k8_shape[1]})")

    meta = {
        "lstm_merged": ("umx_tpu_torch/csrc/lstm_merged.cu",
                        "umx_tpu/ops/lstm_pallas.py:158", max(lstm_err, lstm16_err)),
        "wiener_reduce": ("umx_tpu_torch/csrc/wiener.cu",
                          "umx_tpu/ops/wiener_pallas.py:89", wiener_errs["wiener_reduce"]),
        "wiener_apply": ("umx_tpu_torch/csrc/wiener.cu",
                         "umx_tpu/ops/wiener_pallas.py:128", wiener_errs["wiener_apply"]),
        "lstm_merged_train_fwd": ("umx_tpu_torch/csrc/lstm_merged.cu",
                                  "umx_tpu/ops/lstm_pallas.py:323",
                                  train_errs["lstm_merged_train_fwd"]),
        "lstm_merged_bwd_step": ("umx_tpu_torch/csrc/lstm_train.cu",
                                 "umx_tpu/ops/lstm_pallas.py:397",
                                 train_errs["lstm_merged_bwd_step"]),
        "lstm_merged_dw": ("umx_tpu_torch/csrc/lstm_train.cu",
                           "umx_tpu/ops/lstm_pallas.py:397", train_errs["lstm_merged_dw"]),
        "ola_normalized": ("umx_tpu_torch/csrc/ola.cu", "umx_tpu/ops/ola_pallas.py:61", ola_err),
        "istft_ct2": ("umx_tpu_torch/csrc/istft_ct.cu", "umx_tpu/ops/istft_ct.py:270", istft_err),
    }
    # each kernel's launches on its own path: K1-K3 the demix, K4-K6
    # training, K7-K8 the batched whole-track demix
    path_launches = {**launches, **{k: train_launches[k] for k in
                                    ("lstm_merged_train_fwd", "lstm_merged_bwd_step",
                                     "lstm_merged_dw")},
                     **{k: batched_launches[k] for k in ("ola_normalized", "istft_ct2")}}
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": path_launches[name], "max_abs_err": err,
         "ms": times[name][0], "plain_ms": times[name][1]}
        for name, (src, rep, err) in meta.items()
    ]
    print(json.dumps({"kernels": kernels, "build_s": build_s, "demix_s": demix_s,
                      "gpu_vs_cpu_rel_err": cpu_err, "train_steps_per_s": steps_per_s,
                      "train_path_launches": train_launches, "batched_demix_s": batched_s,
                      "batched_path_launches": batched_launches, "batched_k1_rows": k1_rows,
                      "batched_gpu_vs_cpu_rel_err": batched_err, "planner_anchors": anchors,
                      "batched_k1_shapes": k1_shapes, "batched_k8_shapes": k8_shapes}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
