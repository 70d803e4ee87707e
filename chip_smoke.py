#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``umx_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises (exit code 1, no result line) on failure:

1. build the CUDA kernels from ``umx_tpu_torch/csrc`` (one nvcc per
   source, in parallel; sm_90a);
2. the BLSTM recurrence kernel K1 (one resident launch per layer)
   against its plain PyTorch version at the UMX-L segment shape (R = 8
   chains, B = 1, G = 512, T = 2584) and at the UMX-L training shape
   (B = 16, T = 256), with the form that ran (blocks per chain, blocks the
   card holds at once, chain groups, row groups); at G = 256; at 20 rows
   per chain (beyond one launch's 16: two row groups); rows bit-equal
   whatever runs beside them; a width above 512 refused;
3. the Wiener-EM reduce/apply kernels against their plain versions at
   S = 4, T = 2584, F = 2049, for 1 and 2 EM iterations;
4. the demix path: synthetic UMX-L weights (hidden 1024, seed 0) written
   as a ggml file, a synthetic 100 s stereo WAV, and the port's CLI run
   on it in-process on ``cuda`` (3 chunks of 60 s, so the LSTM state is
   carried twice); the stems are checked, and every kernel's launch
   counter must have moved during that run.  Then the GPU path is held
   against the port's CPU path (plain versions) on a short input; the CLI
   with ``--host-loop`` on the same track (one segment call per chunk: its
   progress lines, K1 for 3 layers a chunk and K2/K3 once a chunk, stems
   within 2e-3 of the fused run's and summing to the mix), its wall time
   beside the fused run's; and a 30 s 48 kHz WAV through the CLI with
   ``--resample``;
5. the training kernels K4 (forward with residuals), K5 (reverse sweep)
   and K6 (weight gradient) against their plain versions at the UMX-L
   training shape (T = 256, R = 8, B = 16, G = 512), and K6 bit-stable;
   K4 and K5, each one resident launch per layer: K4's hs/hT/cT bit-equal
   to K1's, both at 20 rows per chain and a ragged T (two row groups), at
   96 rows, at G = 256, rows bit-equal whatever runs beside them, a width
   above 512 refused, their forms printed (one wave at UMX-L);
6. the training path: synthetic stems on disk, ``data.train_loop`` for 8
   steps at batch 16 × 256 frames at UMX-L width with a validation split
   (finite losses, frozen BatchNorm statistics, K1/K4/K5/K6 launched),
   five steps on one fixed batch that must lower its loss, warm steps/s
   at batch 32 (two row groups per kernel), and the trained weights
   exported as ggml and demixed through the CLI;
7. the overlap-add kernel K7 (bit-equal and bit-stable, its form: blocks
   and the samples a lane moves at a time) and the
   Cooley-Tukey iSTFT kernel K8 (one launch, the overlap-add inside it)
   against their plain versions (100 s UMX-L track: 3 chunks of 60 s,
   M = 8 and 16 rows; 8 rows x 2584 frames, and shapes whose runs end
   inside a row or that are shorter than the overlap-add ring: 3 and 5
   rows x 37 frames, 1 row x 3 frames), bit-stable;
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
10. the per-target recurrence kernel K9 against its plain version and
    against K1 at T = 2584, G = 512 and G = 256, bit-stable, with the
    cluster form that ran (blocks per cluster, clusters the card holds at
    once, waves: as few as the card allows), timed beside K1;
    the Wiener passes in mode "mags" (and "y") against their plain
    versions at S = 4, T = 2584, F = 2049; K2's reduce one kernel launch a
    call in each mode (``torch.profiler``'s device events);
11. the catalogue path: five synthetic tracks (three of 100 s, one of
    40 s, one of 400 s) demixed by ``python -m umx_tpu_torch.cli_batch
    --quantized-hbm`` in a subprocess with its defaults, every stem
    directory checked; then ``demix_tracks`` in process with
    ``window_chunks=4`` (the 400 s track takes the windowed route), its
    launch counts read, its stems held against the subprocess's, the
    shapes it gave K1 (three rows per chain in the bucket of 100 s tracks)
    and K2/K3 recorded and each kernel held against its plain version
    there, and that bucket with dense weights held against the tracks one
    by one and against the CPU; one
    ``Separator`` with ``lstm_impl="pallas"`` on the 400 s track (K9
    launched 3 layers x chunks times) against the K1 run and against the
    CPU on a 100 s cut; ``wiener_filter_planes`` on a real segment against
    ``wiener_filter_masks``; the window and fleet planners' estimates
    beside the measured peaks;
12. timings: each kernel against its plain version and, where one
    PyTorch call computes the same function, that call (CUDA events,
    after warm-up), each beside its bound (bytes over 3.35 TB/s or
    operations over the peak rate, whichever is larger), the warm demix
    times of the 100 s track (fused, and the streaming one also through
    the host loop), and train steps/s; K6 must be no slower
    than ``torch.bmm`` on the same operands, K8 no slower than
    ``torch.istft``, K4 at most twice K1 at the same shape, K4, K5, K8, K9,
    K7 (M = 8 and 16) and K2's reduce in mode mags faster than their
    earlier forms, and the reduce in modes masks and y no more than 5 %
    slower than its earlier form (K7 and the reduce timed as the median of
    5 rounds) (K9 beside K1 at one row per chain is
    printed, not gated).
13. (run right after phase 4, on its ggml file and 100 s WAV) the HTTP
    service (``umx_tpu_torch.serve``) on cuda with its default flags
    (60 s segments, max_batch 4, Wiener 1 iteration): /healthz, /info
    (max_batch is the memory planner's cap), /warmup, /stats/reset; three
    concurrent /demix requests of the WAV (seeds 0, 1, 2) that the segment
    batcher must coalesce (fewer device calls than jobs, K1 at two or more
    rows per chain), each response's stems checked and held within 1e-5 of
    the same seed run alone (the host loop without the batcher), the
    shapes K1 ran at recorded and K1 held against its plain version there;
    one request alone; a streaming session (10 s pushes, X-Stems-Samples 0
    until one segment is in, the stems within 1e-5 of the offline demix);
    a FLAC body (encoded here; skipped with its reason if the native IO
    library cannot be built); the batched segment call's measured peak at
    B = 1 and the served width beside ``segment_batch_hbm_bytes``, which
    must bound it.  Wall times, aggregate x realtime, busy fraction,
    average batch fill and the session's time per segment are printed.
14. (run right after phase 6, on its exported trained and initial UMX-L
    models) evaluation: ``umx_tpu_torch.scripts.evaluate_musdb`` with no
    ``--device`` on 3 synthetic MUSDB-style tracks of 20 s, once per model
    (K1, K2 and K3 launched, every median finite, the trained model's
    mean median SDR above the initial's; per-track demix and scoring
    seconds and both tables printed); ``evaluate_demixed_output`` on the
    first 4 s of phase 6's held-out stems in v4 and in v3 (the v3 solves on the card, held
    within 0.1 dB SDR and 0.3 dB SIR of ``accelerator="numpy"`` on the same
    inputs; the device-solve and host-solve seconds and the windows
    re-solved in float64 printed); ``train_umx`` at its default UMX-HQ
    width, 4 steps with a validation split (K4, K5, K6 and K1 launched,
    finite losses), its export demixed by a ``Separator`` on the card;
    ``demix_tracks_multihost`` as processes 0 and 1 of 2 against one
    ``demix_tracks`` run (within 2e-4, the difference printed); a
    ``StageTimer`` over the phase (its table printed) and a
    ``device_trace`` of one demix whose trace file must name K1
    (``lstm_resident_kernel``); ``profile_train_stream`` at small steps.
    Its figures go under ``"evaluation"`` in the JSON line.

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
# the catalogue: track lengths in seconds; at 60 s segments and a 45 s
# stride (plus the 0.5 s shift pad) 3, 3, 3, 1 and 9 chunks
CATALOGUE_SECS = (100.0, 100.0, 100.0, 40.0, 400.0)
WINDOW_CHUNKS = 4
# published peaks of the H100 SXM: device memory rate, dense bf16 tensor
# cores, float32 outside them
HBM_BYTES_PER_S, PEAK_OPS = 3.35e12, {"bf16": 989e12, "f32": 67e12}
# This script's figures on an H100 80GB HBM3 at 700 W before each kernel
# took its present form, printed beside the new ones: the demix times, K1
# and K6 from before the recurrence became one resident launch per layer and
# the weight gradient moved to the tensor cores (K1 then one grid launch per
# step, K6 a CUDA-core GEMM); K4, K5 and the training rate from before K4
# and K5 became resident launches too (then one grid per step each); K9 from
# when a chain's cluster had 16 blocks with W_hh in shared memory (two waves
# for 8 chains), K8 from when it wrote its frames to device memory and a
# second launch overlap-added them (48 rows x 2584 frames), K7 from when a
# thread wrote one sample of one row (M = 8 and 16 rows), K2's reduce from
# when it was two launches (a partial-sum pass, then their sum), by mode
EARLIER = {"demix_s": 0.319, "batched_demix_s": 0.294, "catalogue_demix_s": 2.706,
           "train_steps_per_s": 7.250, "lstm_merged_ms": {1: 19.9261, 3: 24.6960, 6: 41.5486,
                                                          16: 8.1123},
           "lstm_merged_dw_ms": 3.9927, "lstm_merged_train_fwd_ms": 8.7091,
           "lstm_merged_bwd_step_ms": 11.5000, "lstm_layer_pertarget_ms": 12.9396,
           "istft_ct2_ms": 7.3161, "ola_normalized_ms": {8: 0.3108, 16: 0.6176},
           "wiener_reduce_ms": {"masks": 0.1137, "y": 0.1369, "mags": 0.1703}}
# K2's reduce in modes masks and y may be no slower than its earlier form
# by more than this share (the same loop; the measurement's spread)
REDUCE_SLACK = 1.05
ISTFT_EARLIER_SHAPE = (48, T_SEG)  # the shape of EARLIER["istft_ct2_ms"]
B_TRAIN_WIDE = 32  # a second training batch: two row groups per resident kernel


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


# rounds of the timings that a gate holds against an earlier form's figure
GATE_ROUNDS = 5
spreads = {}  # name -> (fastest, slowest) round of cuda_ms_median


def cuda_ms_median(name: str, fn, reps: int) -> float:
    """Median over GATE_ROUNDS rounds of :func:`cuda_ms` (``reps`` runs
    each), for the timings that a gate holds against a recorded figure: a
    stray slow round moves a kernel of a tenth of a millisecond by 10 % or
    more.  The rounds' range goes to ``spreads[name]``."""
    rounds = sorted(cuda_ms(fn, reps) for _ in range(GATE_ROUNDS))
    spreads[name] = (rounds[0], rounds[-1])
    return rounds[GATE_ROUNDS // 2]


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound_ms(n_bytes: float, ops: float, kind: str):
    """The least time the card could take: every input byte read and every
    output byte written once at the memory rate, or the operations at the
    peak rate of their type, whichever is larger -> (ms, "bytes" | "operations")."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def lstm_bound(T, rows, G, inputs, extra_out: int = 0):
    """Bound of one recurrence layer over ``rows`` = chains x batch rows:
    the inputs, hs + hT + cT (and ``extra_out`` bytes) out, 2*T*rows*G*4G
    operations on bf16 operands."""
    out = (T + 2) * rows * G * 4 + extra_out
    return bound_ms(nbytes(*inputs) + out, 2.0 * T * rows * G * 4 * G, "bf16")


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
          f"max|err| hs {errs['hs']:.3g} hT {errs['hT']:.3g} cT {errs['cT']:.3g}; form (blocks per "
          f"chain, blocks held at once, chain groups, row groups) {lstm_cuda.lstm_merged.form}")
    # Both round h to bf16 before the product; an f32 last-bit difference
    # in a sum can flip one bf16 rounding, a ~4e-3 relative step in one
    # operand, which the contractive recurrence damps: 5e-3 absolute on
    # h (|h| < 1) and c bounds that.
    require(max(errs.values()) <= 5e-3, f"lstm_merged disagrees with plain: {errs}")
    return args, max(errs.values())


def check_lstm_resident(dev):
    """Phase 2: what the resident form of K1 has to hold beyond the paths'
    shapes: UMX-HQ's width, rows beyond one launch, rows that do not
    depend on their neighbours, one wave at UMX-L, and the refusal."""
    import torch

    from umx_tpu_torch.ops import lstm_cuda as L

    def inputs(T, B, G, seed):
        return train_inputs(dev, T, B, G, seed)[0]

    worst = 0.0
    for T, B, G in ((T_SEG, 1, 256), (300, 20, G_HIDDEN)):
        args = inputs(T, B, G, seed=T + B)
        out_k = L.lstm_merged(*args)
        torch.cuda.synchronize()
        form = L.lstm_merged.form
        err = max(max_err(a, b) for a, b in zip(out_k, L.lstm_merged_plain(*args)))
        print(f"lstm_merged vs plain (T={T}, R={R_CHAINS}, B={B}, G={G}): max|err| {err:.3g}; "
              f"form {form}")
        require(err <= 5e-3, f"lstm_merged disagrees with plain at B={B}, G={G}: {err}")
        require(form[3] == -(-B // L.RESIDENT_ROWS), f"row groups {form} at B = {B}")
        worst = max(worst, err)
    blocks, held, chain_groups, _ = L.lstm_merged.form
    print(f"lstm_merged form at UMX-L: {blocks} blocks per chain, {R_CHAINS * blocks} blocks for "
          f"{R_CHAINS} chains, {held} held at once by the card, {chain_groups} wave(s)")
    require(chain_groups == 1, f"UMX-L's {R_CHAINS} chains do not run in one wave: {L.lstm_merged.form}")
    # a row alone, the fleet bucket's 3 and the batched path's 6 against
    # the same rows inside the 20 (both n-tiles and the second row group)
    xp, whh, h0, c0, B = args
    for picks in ([7], [2, 9, 17], [0, 1, 5, 8, 13, 19]):
        rows = torch.tensor([r * B + b for r in range(R_CHAINS) for b in picks], device=dev)
        sub = L.lstm_merged(xp[:, rows].contiguous(), whh, h0[rows].contiguous(),
                            c0[rows].contiguous(), len(picks))
        require(all(torch.equal(s, o) for s, o in
                    zip(sub, (out_k[0][:, rows], out_k[1][rows], out_k[2][rows]))),
                f"rows {picks} of lstm_merged depend on the rows beside them")
    print("lstm_merged rows alone, in 3 and in 6 are bit-equal to the same rows among 20")
    before = L.lstm_merged.launches
    try:
        L.lstm_merged(*inputs(2, 1, 520, seed=1))
    except RuntimeError as e:
        print(f"lstm_merged refuses G = 520: {e}")
    else:
        raise RuntimeError("lstm_merged took G = 520")
    require(L.lstm_merged.launches == before, "a refused call was counted as a launch")
    return worst


def train_inputs(dev, T, B, G, seed):
    """Random inputs of K4 and cotangents of K5 at R = 8 chains:
    ((xp, whh, h0, c0, B), (dhs, dhT, dcT))."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    RB = R_CHAINS * B
    xp = torch.randn((T, RB, 4 * G), generator=g, device=dev)
    whh = (torch.randn((R_CHAINS, G, 4 * G), generator=g, device=dev) / G**0.5).to(torch.bfloat16)
    h0 = 0.5 * torch.randn((RB, G), generator=g, device=dev)
    c0 = 0.5 * torch.randn((RB, G), generator=g, device=dev)
    cts = tuple(torch.randn(shape, generator=g, device=dev)
                for shape in ((T, RB, G), (RB, G), (RB, G)))
    return (xp, whh, h0, c0, B), cts


def rel_err(a, b) -> float:
    return max_err(a, b) / float(b.abs().max())


def check_train_resident(dev):
    """Phase 5: what the resident forms of K4 and K5 have to hold beyond
    the training shape: K4's hs/hT/cT are K1's bits, rows beyond one launch
    and beyond the 81 that K4's earlier form could hold, UMX-HQ's width, a
    ragged T, rows that do not depend on their neighbours, and the refusal."""
    import torch

    from umx_tpu_torch.ops import lstm_cuda as L

    def sub(x, rows):
        return (x[:, rows] if x.dim() == 3 else x[rows]).contiguous()

    for T, B, G in ((37, 20, G_HIDDEN), (5, 96, G_HIDDEN), (131, 3, 256)):
        fwd_in, cts = train_inputs(dev, T, B, G, seed=T + B)
        xp, whh, h0, c0, _ = fwd_in
        k1 = L.lstm_merged(*fwd_in)
        fwd_k = L.lstm_merged_train_fwd(*fwd_in)
        torch.cuda.synchronize()
        require(all(torch.equal(a, b) for a, b in zip(fwd_k[:3], k1)),
                f"lstm_merged_train_fwd's hs/hT/cT are not lstm_merged's bits at B={B}, G={G}")
        fwd_p = L.lstm_merged_train_fwd_plain(*fwd_in)
        ferr = max(max_err(a, b) for a, b in zip(fwd_k, fwd_p))
        gates, cs = fwd_p[3], fwd_p[4]
        bwd_k = L.lstm_merged_bwd_step(gates, cs, c0, whh, *cts, B)
        torch.cuda.synchronize()
        bwd_p = L.lstm_merged_bwd_step_plain(gates, cs, c0, whh, *cts, B)
        berr = max(rel_err(a, b) for a, b in zip(bwd_k, bwd_p))
        print(f"K4/K5 vs plain (T={T}, R={R_CHAINS}, B={B}, G={G}): forward max|err| {ferr:.3g} "
              f"(hs/hT/cT bit-equal to lstm_merged), sweep max|err|/max|ref| {berr:.3g}; forms "
              f"{L.lstm_merged_train_fwd.form} {L.lstm_merged_bwd_step.form}")
        require(ferr <= 5e-3 and berr <= 5e-3,
                f"K4/K5 disagree with plain at B={B}, G={G}: {ferr}, {berr}")
        for fn in (L.lstm_merged_train_fwd, L.lstm_merged_bwd_step):
            require(fn.form[3] == -(-B // L.RESIDENT_ROWS), f"row groups {fn.form} at B = {B}")
        if B != 20:
            continue
        # a row alone, 3 and 6 rows against the same rows inside the 20
        # (both n-tiles and the second row group); the sweep on K4's own residuals
        gates, cs = fwd_k[3], fwd_k[4]
        bwd_k = L.lstm_merged_bwd_step(gates, cs, c0, whh, *cts, B)
        for picks in ([7], [2, 9, 17], [0, 1, 5, 8, 13, 19]):
            rows = torch.tensor([r * B + b for r in range(R_CHAINS) for b in picks], device=dev)
            n = len(picks)
            f_sub = L.lstm_merged_train_fwd(sub(xp, rows), whh, sub(h0, rows), sub(c0, rows), n)
            b_sub = L.lstm_merged_bwd_step(sub(gates, rows), sub(cs, rows), sub(c0, rows), whh,
                                           *(sub(c, rows) for c in cts), n)
            require(all(torch.equal(s, sub(o, rows)) for s, o in zip(f_sub, fwd_k)),
                    f"rows {picks} of lstm_merged_train_fwd depend on the rows beside them")
            require(all(torch.equal(s, sub(o, rows)) for s, o in zip(b_sub, bwd_k)),
                    f"rows {picks} of lstm_merged_bwd_step depend on the rows beside them")
        print("K4 and K5 rows alone, in 3 and in 6 are bit-equal to the same rows among 20")
    before = (L.lstm_merged_train_fwd.launches, L.lstm_merged_bwd_step.launches)
    (xp, whh, h0, c0, _), cts = train_inputs(dev, 2, 1, 520, seed=1)
    for name, call in (
        ("lstm_merged_train_fwd", lambda: L.lstm_merged_train_fwd(xp, whh, h0, c0, 1)),
        ("lstm_merged_bwd_step", lambda: L.lstm_merged_bwd_step(
            torch.zeros_like(xp), cts[0], c0, whh, *cts, 1)),
    ):
        try:
            call()
        except RuntimeError as e:
            print(f"{name} refuses G = 520: {e}")
        else:
            raise RuntimeError(f"{name} took G = 520")
    require((L.lstm_merged_train_fwd.launches, L.lstm_merged_bwd_step.launches) == before,
            "a refused call was counted as a launch")


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
    require(all(torch.equal(a, b) for a, b in zip(fwd_k[:3], L.lstm_merged(xp, whh, h0, c0, B))),
            "lstm_merged_train_fwd's hs/hT/cT are not lstm_merged's bits at the training shape")

    hs, _, _, gates, cs = fwd_p  # the same residuals into both backwards
    dxp_k, dh0_k, dc0_k = L.lstm_merged_bwd_step(gates, cs, c0, whh, dhs, dhT, dcT, B)
    dw_k = L.lstm_merged_dw(hs, h0, dxp_k, B)
    dxp_p, dw_p, dh0_p, dc0_p = L.lstm_merged_bwd_plain(gates, cs, hs, h0, c0, whh, dhs, dhT,
                                                        dcT, B)
    rel = {n: rel_err(k, p) for n, k, p in
           (("dxp", dxp_k, dxp_p), ("dW", dw_k, dw_p), ("dh0", dh0_k, dh0_p), ("dc0", dc0_k, dc0_p))}
    print("lstm backward vs plain, max|err|/max|ref|: "
          + " ".join(f"{n} {e:.3g}" for n, e in rel.items()))
    for name, fn in (("lstm_merged_train_fwd", L.lstm_merged_train_fwd),
                     ("lstm_merged_bwd_step", L.lstm_merged_bwd_step)):
        blocks, held, chain_groups, _ = fn.form
        print(f"{name} form at UMX-L: {blocks} blocks per chain, {R_CHAINS * blocks} blocks for "
              f"{R_CHAINS} chains, {held} held at once by the card, {chain_groups} wave(s)")
        require(chain_groups == 1, f"UMX-L's {R_CHAINS} chains do not run {name} in one wave: "
                f"{fn.form}")
    # Where f32 sums differ in order the bf16 rounding of a gate cotangent
    # flips and the reverse chain carries it on: the plain version on the
    # card and on the CPU differ by as much (up to 1.9e-3 of max|ref| at
    # this width, measured on an H100), so the bound is 5e-3.
    require(max(rel.values()) <= 5e-3, f"lstm backward disagrees with plain: {rel}")
    dw_alone = rel_err(L.lstm_merged_dw(hs, h0, dxp_p, B), dw_p)
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
              f"bit-equal, bit-stable; form (blocks, samples a lane moves at a time) "
              f"{ola_cuda.ola_normalized.form}")
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
              f"max|sig| {sig:.3g}; (runs per row, hops per run) {istft_ct_cuda.istft_ct2.form}")
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


def check_pertarget(dev, T, G, seed, smi):
    """Phase 10: K9 against its plain version and against K1 on the same
    values (T# = 4, D = 2), then both timed."""
    import torch

    from umx_tpu_torch.ops import lstm_cuda as L

    g = torch.Generator(device=dev).manual_seed(seed)
    x_proj = torch.randn((4, T, 2, 4 * G), generator=g, device=dev)
    whh = (torch.randn((4, 2, G, 4 * G), generator=g, device=dev) / G**0.5).to(torch.bfloat16)
    h0 = 0.5 * torch.randn((4, 2, G), generator=g, device=dev)
    c0 = 0.5 * torch.randn((4, 2, G), generator=g, device=dev)
    args = (x_proj, whh, h0, c0)
    out_k = L.lstm_layer_pertarget(*args)
    torch.cuda.synchronize()
    form = L.lstm_layer_pertarget.form
    require(all(torch.equal(a, b) for a, b in zip(out_k, L.lstm_layer_pertarget(*args))),
            f"lstm_layer_pertarget is not bit-stable from run to run at G = {G}")
    placeable = L._pertarget_placeable(torch.cuda.current_device(), G, 8)
    fewest = min(-(-8 // n) for cl, n in placeable.items()
                 if L.pertarget_units_per_block(G, cl) <= L.PERTARGET_MAX_UNITS)
    out_p = L.lstm_pertarget_plain(*args)
    errs = {n: max_err(a, b) for n, a, b in zip(("hs", "hT", "cT"), out_k, out_p)}
    # the merged kernel on the same values, rows chain-major
    k1_args = (x_proj.permute(1, 0, 2, 3).reshape(T, 8, 4 * G).contiguous(),
               whh.reshape(8, G, 4 * G), h0.reshape(8, G), c0.reshape(8, G), 1)
    hs1 = L.lstm_merged(*k1_args)[0].view(T, 4, 2, G).permute(1, 0, 2, 3)
    vs_k1 = max_err(out_k[0], hs1)
    print(f"lstm_layer_pertarget vs plain (T={T}, T#=4, D=2, G={G}): max|err| hs "
          f"{errs['hs']:.3g} hT {errs['hT']:.3g} cT {errs['cT']:.3g}; vs lstm_merged hs "
          f"{vs_k1:.3g}; bit-stable; form (blocks per cluster, clusters at once, waves) {form} "
          f"among the clusters the card holds at once by size {placeable}")
    require(form[2] == fewest, f"lstm_layer_pertarget ran {form[2]} wave(s) at G = {G} where the "
            f"card allows {fewest}: {placeable}")
    # the same contract and the same argument as K1: 5e-3 absolute
    require(max(errs.values()) <= 5e-3, f"lstm_layer_pertarget disagrees with plain: {errs}")
    require(vs_k1 <= 5e-3, f"lstm_layer_pertarget disagrees with lstm_merged: {vs_k1}")
    ms = cuda_ms(lambda: L.lstm_layer_pertarget(*args), 5)
    k1_ms = cuda_ms(lambda: L.lstm_merged(*k1_args), 5)
    print(f"lstm_layer_pertarget at T={T}, G={G}: {ms:.4f} ms per layer; lstm_merged on the "
          f"same values {k1_ms:.4f} ms  [{smi}]")
    return args, max(errs.values()), form, ms, k1_ms


def check_wiener_modes(dev, xre, xim, masks):
    """Phase 10: K2/K3 in mode "mags" (and the later iterations' mode "y")
    against their plain versions, on the Wiener check's x with a patch of
    exact zeros and the magnitudes mask * |x|."""
    import torch

    from umx_tpu_torch.config import WienerConfig
    from umx_tpu_torch.ops import wiener_cuda as W
    from umx_tpu_torch.ops.stft import masks_to_planes

    xre, xim = xre.clone(), xim.clone()
    xre[0, 3, 5:40] = 0.0
    xim[0, 3, 5:40] = 0.0  # |x| = 0: the unit phasor is 1 + 0i
    mags = (masks_to_planes(masks, F_BINS) * torch.sqrt(xre * xre + xim * xim)[None]).contiguous()
    for iterations in (1, 2):
        cfg = WienerConfig(iterations=iterations)
        yk = W.wiener_planes_from_mags(xre, xim, mags, cfg)
        torch.cuda.synchronize()
        yp = W.wiener_planes_from_mags(xre.cpu(), xim.cpu(), mags.cpu(), cfg)
        scale = max(float(yp[0].abs().max()), float(yp[1].abs().max()))
        err = max(max_err(yk[0].cpu(), yp[0]), max_err(yk[1].cpu(), yp[1])) / scale
        print(f"wiener reduce+apply, mode mags, vs plain, {iterations} iteration(s) "
              f"(S={N_SRC}, T={T_SEG}, F={F_BINS}): max|err|/max|y| {err:.3g}")
        # as the masks mode, plus rsqrtf against torch.rsqrt in the last place
        require(bool(torch.isfinite(yk[0]).all()) and err <= 1e-4,
                f"wiener mags kernels disagree with plain: {err}")
    inv = W.inv_max_abs(xre, xim, 10.0)
    args, errs = {}, {}
    # mode y reads the first iteration's estimates in the working frame
    y1 = W.wiener_planes_from_mags(xre, xim, mags, WienerConfig())
    yre_s, yim_s = y1[0] * inv, y1[1] * inv
    for mode, first, second in (("mags", mags, None), ("y", yre_s, yim_s)):
        racc = W.wiener_reduce(mode, xre, xim, first, second, inv)
        a_re, a_im, m = (first, second, None) if mode == "y" else (xre, xim, first)
        racc_p = W.wiener_reduce_plain(mode, a_re, a_im, m, inv)
        y_k = W.wiener_apply(mode, xre, xim, first, second, racc_p, inv, 1e-10)
        y_p = W.wiener_apply_plain(mode, xre, xim, first, second, racc_p, inv, 1e-10)
        torch.cuda.synchronize()
        e_r, e_a = max_err(racc, racc_p), max(max_err(y_k[0], y_p[0]), max_err(y_k[1], y_p[1]))
        r_scale, y_scale = float(racc_p.abs().max()), float(y_p[0].abs().max())
        print(f"wiener passes alone, mode {mode}: max|err| reduce {e_r:.3g} (max|racc| "
              f"{r_scale:.3g}), apply {e_a:.3g} (max|y| {y_scale:.3g})")
        # relative bounds: the time sums in another order (reduce), the same
        # f32 operations with FMA contraction and rsqrtf (apply)
        require(e_r <= 1e-5 * r_scale and e_a <= 1e-4 * y_scale,
                f"wiener mode {mode} disagrees with plain: reduce {e_r}, apply {e_a}")
        errs[f"wiener_reduce_{mode}"], errs[f"wiener_apply_{mode}"] = e_r, e_a
        args[mode] = (xre, xim, first, second, inv, racc_p, (a_re, a_im, m))
    return args, errs


def device_kernels(fn):
    """The names of the kernels that ``fn()`` launched on the card
    (``torch.profiler``'s device events)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]


def check_reduce_launches(wiener_args, mode_args):
    """Phase 10: a call of K2's reduce is one kernel launch on the card, in
    each input mode, at the UMX-L segment shape."""
    from umx_tpu_torch.ops import wiener_cuda as W

    xre, xim, masks, inv, _ = wiener_args
    calls = {"masks": (xre, xim, masks, None, inv)}
    calls.update({mode: a[:5] for mode, a in mode_args.items()})
    for mode, args in calls.items():
        names = device_kernels(lambda: W.wiener_reduce(mode, *args))
        require(len(names) == 1 and "wiener_reduce_kernel" in names[0],
                f"wiener_reduce in mode {mode} launched {names}, not one reduce kernel")
    print(f"wiener_reduce: one launch a call in modes {sorted(calls)}")


def synth_mix(secs: float, seed: int):
    """A synthetic stereo mix: two tones per channel in noise."""
    t = np.arange(int(secs * SR)) / SR
    rng = np.random.default_rng(seed)
    f = 110.0 * (1 + 0.25 * seed)
    return np.stack([
        0.3 * np.sin(2 * np.pi * f * t) + 0.2 * np.sin(2 * np.pi * 4 * f * t)
        + 0.05 * rng.standard_normal(t.size),
        0.3 * np.sin(2 * np.pi * 1.5 * f * t) + 0.2 * np.sin(2 * np.pi * 6 * f * t)
        + 0.05 * rng.standard_normal(t.size),
    ]).astype(np.float32)


def write_catalogue(tmp: str):
    """Five tracks on disk: flat WAVs, and the 40 s one as a MUSDB-style
    directory with a ``mixture.wav``.  Returns (dir, {name: audio})."""
    from scipy.io import wavfile

    root = os.path.join(tmp, "catalogue")
    os.makedirs(root)
    tracks = {}
    for k, secs in enumerate(CATALOGUE_SECS):
        name = f"track{k}_{secs:.0f}s"
        tracks[name] = synth_mix(secs, seed=k)
        if secs == 40.0:
            os.makedirs(os.path.join(root, name))
            path = os.path.join(root, name, "mixture.wav")
        else:
            path = os.path.join(root, name + ".wav")
        wavfile.write(path, SR, np.ascontiguousarray(tracks[name].T))
    return root, tracks


def catalogue_path(tmp: str, model: str, counters: dict, smi: str):
    """Phase 11: the batch CLI in a subprocess, then ``demix_tracks`` in
    process with a forced window, launch counts around it and the shapes
    it gives K1 ((rows per chain, frames)) and K2/K3 ((frames, bins))
    recorded; then the bucket of 100 s tracks with dense weights against
    the same tracks one by one and against the CPU."""
    import torch

    from umx_tpu_torch.config import EngineConfig, SegmentConfig
    from umx_tpu_torch.engine.fleet import demix_tracks
    from umx_tpu_torch.engine.memory import params_hbm_bytes
    from umx_tpu_torch.engine.separator import Separator
    from umx_tpu_torch.models import umx
    from umx_tpu_torch.ops import wiener

    root, tracks = write_catalogue(tmp)
    total = sum(CATALOGUE_SECS)
    out_root = os.path.join(tmp, "catalogue_stems")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "umx_tpu_torch.cli_batch", model, root, out_root, "--quantized-hbm"],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True, timeout=900)
    cli_s = time.perf_counter() - t0
    require(proc.returncode == 0, f"cli_batch exited {proc.returncode}:\n{proc.stderr[-3000:]}")
    for line in proc.stdout.splitlines():
        if line.startswith("demixed"):
            print(f"catalogue path (cli_batch --quantized-hbm, subprocess, UMX-L, {len(tracks)} "
                  f"tracks, {total:.0f} s): {line}; process wall {cli_s:.3f} s  [{smi}]")
    cli_stems = {}
    for name, audio in tracks.items():
        print(f"{name}: ", end="")
        cli_stems[name] = check_stems(os.path.join(out_root, name), audio)

    cfg = EngineConfig(segment=SegmentConfig(window_chunks=WINDOW_CHUNKS))
    sep = Separator.from_ggml(model, cfg, "cuda", quantized_hbm=True)
    print(f"quantized parameters resident: {params_hbm_bytes(sep.cfg, sep.params)} B")
    audio = list(tracks.values())
    stats: dict = {}
    k1_shapes, k23_shapes = set(), set()
    with recording(umx, "lstm_layer_merged_batched", lambda x, *a: (x.shape[0], x.shape[2]),
                   k1_shapes), \
         recording(wiener, "wiener_planes_from_masks", lambda xre, *a: tuple(xre.shape[1:]),
                   k23_shapes):
        reset_counts(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = demix_tracks(sep, audio, stats=stats)
        torch.cuda.synchronize()
        fleet_s = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
    print(f"catalogue path (demix_tracks, window_chunks {WINDOW_CHUNKS}, quantized weights): "
          f"{fleet_s:.3f} s wall, {total / fleet_s:.1f}x realtime aggregate (earlier form "
          f"{EARLIER['catalogue_demix_s']} s)  [{smi}]; stats "
          f"{ {k: round(v, 4) if isinstance(v, float) else v for k, v in stats.items()} }; "
          f"kernel runs {launches}")
    print(f"catalogue path shapes: K1 (rows per chain, frames) {sorted(k1_shapes)}, "
          f"K2/K3 (frames, bins) {sorted(k23_shapes)}")
    require(stats.get("windowed_tracks") == 1,
            f"the 400 s track did not take the windowed route: {stats}")
    require(max(b for b, _ in k1_shapes) == 3,
            f"the three 100 s tracks did not run as one bucket of 3 rows: {sorted(k1_shapes)}")
    # phase 3 holds K2 and K3 against their plain versions at this shape
    require(k23_shapes == {(T_SEG, F_BINS)}, f"K2/K3 ran at other shapes: {sorted(k23_shapes)}")
    for name in ("lstm_merged", "wiener_reduce", "wiener_apply"):
        require(launches[name] > 0, f"kernel {name} was not launched on the catalogue path")
    worst, equal = 0.0, True
    for (name, ref), out in zip(cli_stems.items(), outs):
        require(out.shape == ref.shape and bool(np.isfinite(out).all()), f"{name}: {out.shape}")
        worst = max(worst, float(np.max(np.abs(out - ref)) / np.max(np.abs(ref))))
        equal = equal and bool(np.array_equal(out, ref))
    print(f"demix_tracks (400 s track windowed) vs cli_batch (planner's choice): "
          f"max|err|/max|stem| {worst:.3g}; bit-equal: {equal}")
    # the same programs on the same rows; windowed sums the same two
    # addends per sample as the single program
    require(worst <= 1e-5, f"windowed and single-program stems disagree: {worst}")

    # The two runs above share the kernel at 3 rows per chain, so neither
    # holds it to anything else.  With dense weights (no activation is
    # rounded, so the f32 class applies) the bucket of three 100 s tracks,
    # K1 at B = 3, against each track alone, K1 at B = 1.
    dense = Separator.from_ggml(model, cfg, "cuda")
    bucket, seeds, rows = audio[:3], [0, 1, 2], set()
    with recording(umx, "lstm_layer_merged_batched", lambda x, *a: x.shape[0], rows):
        together = demix_tracks(dense, bucket, seeds=seeds)
    require(rows == {3}, f"the dense bucket ran K1 at {sorted(rows)} rows per chain")
    bucket_err = max(
        float(np.max(np.abs(out - alone)) / np.max(np.abs(alone)))
        for out, alone in zip(together, (dense.demix_track(a, seed=k) for a, k in zip(bucket, seeds))))
    print(f"fleet bucket of 3 x 100 s, dense weights (K1 at 3 rows per chain) vs the tracks one "
          f"by one (1 row): max|err|/max|stem| {bucket_err:.3g}; bit-equal: {bucket_err == 0.0}")
    # a row of K1 has the same order of summation at every B, and so has
    # every other product of the path
    require(bucket_err == 0.0, f"the bucket and the single tracks are not bit-equal: {bucket_err}")
    # and the bucket's first track against the port's CPU path (plain versions)
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    t0 = time.perf_counter()
    cpu = Separator.from_ggml(model, cfg, "cpu").demix_track(bucket[0], seed=seeds[0])
    cpu_err = float(np.max(np.abs(together[0] - cpu)) / np.max(np.abs(cpu)))
    print(f"GPU vs CPU port, first track of that bucket, 100 s at UMX-L: max|err|/max|stem| "
          f"{cpu_err:.3g} (CPU run {time.perf_counter() - t0:.1f} s)")
    # bf16 operands in the recurrence and cuFFT/cuBLAS summation order, as phase 4
    require(cpu_err <= 2e-3, f"the bucket on the GPU and the CPU path disagree: {cpu_err}")
    return sep, tracks, launches, stats, fleet_s, sorted(k1_shapes), max(bucket_err, cpu_err)


def pertarget_path(sep, model: str, long_track, counters: dict, smi: str):
    """Phase 11: K9 on a path.  The 400 s track windowed with
    ``lstm_impl="pallas"`` and quantized weights: launch count, against
    the K1 run of the same track, and against the CPU on a 100 s cut."""
    import dataclasses

    import torch

    from umx_tpu_torch.config import ModelConfig
    from umx_tpu_torch.engine.separator import Separator
    from umx_tpu_torch.models import umx
    from umx_tpu_torch.ops import lstm_cuda

    cfg9 = dataclasses.replace(sep.cfg, model=ModelConfig(lstm_impl="pallas"))
    sep9 = Separator(sep.params, cfg9, "cuda")
    _, stride, n_chunks, _ = sep9._geometry(long_track.shape[1] + sep.cfg.segment.max_shift_samples(SR))
    chunks_run = -(-n_chunks // WINDOW_CHUNKS) * WINDOW_CHUNKS
    sep9.demix_track(long_track, seed=0)  # warm-up
    k9_shapes = set()
    with recording(umx, "lstm_layer_pertarget_batched",
                   lambda x, *a: (x.shape[0], x.shape[2], x.shape[-1] // 4), k9_shapes):
        reset_counts(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s9 = sep9.demix_track(long_track, seed=0)
        torch.cuda.synchronize()
        k9_s = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
    # phase 10 holds K9 against its plain version at this shape
    require(k9_shapes == {(1, T_SEG, G_HIDDEN)},
            f"K9 ran at other (batch, frames, G) than phase 10 checks: {sorted(k9_shapes)}")
    t0 = time.perf_counter()
    s1 = sep.demix_track(long_track, seed=0)
    torch.cuda.synchronize()
    k1_s = time.perf_counter() - t0
    secs = long_track.shape[1] / SR

    def rel(a, b):
        return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))

    def energy_db(a, b):
        return float(20 * np.log10(np.linalg.norm(a - b) / np.linalg.norm(b)))

    # Two runs of the quantized path are not held to the dense path's f32
    # class.  The quantized network rounds its activations to bf16 before
    # every product (and takes offset * rowsum from the unrounded ones), and
    # the state streams over all of the track's chunks, so a last-bit
    # difference flips roundings and the stems move by bf16 noise: the K1
    # path against itself on the track scaled by 1 + 1e-6 is printed beside
    # each comparison.  The gate is on the error's energy, 30 dB below the
    # stems': the order at which the quantized mode itself departs from the
    # dense model.
    nudged = long_track * np.float32(1 + 1e-6)
    s1n = sep.demix_track(nudged, seed=0)
    err, err_db = rel(s9, s1), energy_db(s9, s1)
    print(f"per-target path ({secs:.0f} s track, windows of {WINDOW_CHUNKS}, quantized weights, "
          f"lstm_impl pallas): {k9_s:.3f} s = {secs / k9_s:.1f}x realtime against {k1_s:.3f} s = "
          f"{secs / k1_s:.1f}x with lstm_impl auto  [{smi}]; kernel runs {launches}; form "
          f"{lstm_cuda.lstm_layer_pertarget.form}; K9 vs K1 stems max|err|/max|stem| {err:.3g}, "
          f"error energy {err_db:.1f} dB; the K1 path against itself on the track x (1 + 1e-6): "
          f"{rel(s1n, s1):.3g}, {energy_db(s1n, s1):.1f} dB")
    require(launches["lstm_layer_pertarget"] == 3 * chunks_run and launches["lstm_merged"] == 0,
            f"K9 launches {launches['lstm_layer_pertarget']} != 3 layers x {chunks_run} chunks")
    require(bool(np.isfinite(s9).all()) and err_db <= -30.0,
            f"K9 and K1 paths disagree: error energy {err_db} dB")
    del s1n

    # the same two kernels with dense weights, where no activation is
    # rounded: the class of the GPU against the CPU
    dense = Separator.from_ggml(model, sep.cfg, "cuda")
    d1 = dense.demix_track(long_track, seed=0)
    d9 = Separator(dense.params, cfg9, "cuda").demix_track(long_track, seed=0)
    d_err = rel(d9, d1)
    print(f"the same with dense weights: K9 vs K1 stems max|err|/max|stem| {d_err:.3g}; the K1 "
          f"path against itself on the track x (1 + 1e-6): "
          f"{rel(dense.demix_track(nudged, seed=0), d1):.3g}")
    require(d_err <= 2e-3, f"dense K9 and K1 paths disagree: {d_err}")
    del dense, d1, d9

    cut = long_track[:, : int(100 * SR)]
    cfgc = dataclasses.replace(cfg9, segment=dataclasses.replace(cfg9.segment, window_chunks=2))
    gpu = Separator(sep.params, cfgc, "cuda").demix_track(cut, seed=0)
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    t0 = time.perf_counter()
    cpu = Separator.from_ggml(model, cfgc, "cpu", quantized_hbm=True).demix_track(cut, seed=0)
    err_cpu, cpu_db = rel(gpu, cpu), energy_db(gpu, cpu)
    print(f"GPU vs CPU port, catalogue slice (quantized, lstm_impl pallas, windows of 2), 100 s at "
          f"UMX-L: max|err|/max|stem| {err_cpu:.3g}, error energy {cpu_db:.1f} dB "
          f"(CPU run {time.perf_counter() - t0:.1f} s)")
    require(bool(np.isfinite(gpu).all()) and cpu_db <= -30.0,
            f"GPU and CPU disagree: error energy {cpu_db} dB")
    return launches, k9_s, k1_s, err, err_cpu


def planes_entry(sep, track):
    """Phase 11: ``wiener_filter_planes`` (modes "mags", then "y") on a real
    segment's x and target magnitudes, against ``wiener_filter_masks`` on
    the masks that gave them: one estimate through two entries."""
    import torch

    from umx_tpu_torch.config import WienerConfig
    from umx_tpu_torch.engine.separator import apply_masks
    from umx_tpu_torch.models.umx import (
        init_lstm_state, umx_post, umx_pre, umx_recurrence_batched,
    )
    from umx_tpu_torch.ops import wiener_cuda as W
    from umx_tpu_torch.ops.stft import crop_stack, stft_planes
    from umx_tpu_torch.ops.wiener import wiener_filter_masks, wiener_filter_planes

    cfg, mcfg = sep.cfg, sep.cfg.model
    with torch.inference_mode():
        audio = torch.from_numpy(track[:, :SEG]).to("cuda")[None]
        re, im = stft_planes(audio, cfg.dsp)
        mag = torch.sqrt(re * re + im * im)
        x1 = umx_pre(sep.params, crop_stack(mag, mcfg.nb_bins_cropped), mcfg)
        lstm_out, _ = umx_recurrence_batched(sep.params, x1, init_lstm_state(mcfg, "cuda", 1), mcfg)
        masks = umx_post(sep.params, x1, lstm_out, mcfg)
        mags = apply_masks(masks, mag, mcfg.n_bins)[0].contiguous()
        wcfg = WienerConfig(iterations=2)
        for fn in (W.wiener_reduce, W.wiener_apply):
            fn.mode_launches = dict.fromkeys(fn.mode_launches, 0)
        yp = wiener_filter_planes(re[0], im[0], mags, wcfg)
        torch.cuda.synchronize()
        counts = {f"{n}_{m}": fn.mode_launches[m] for n, fn in
                  (("wiener_reduce", W.wiener_reduce), ("wiener_apply", W.wiener_apply))
                  for m in ("mags", "y")}
        ym = wiener_filter_masks(re[0], im[0], masks[0], mcfg.n_bins, wcfg)
    scale = float(ym[0].abs().max())
    err = max(max_err(yp[0], ym[0]), max_err(yp[1], ym[1])) / scale
    print(f"wiener_filter_planes vs wiener_filter_masks on a real segment, 2 iterations: "
          f"max|err|/max|y| {err:.3g}; kernel runs by mode {counts}")
    for name, n in counts.items():
        require(n == 1, f"{name} ran {n} times through wiener_filter_planes")
    # mask * x against (mask * |x|) * (x * rsqrt(|x|^2)): a few f32 roundings
    # per element, carried through two EM iterations
    require(err <= 1e-4, f"the planes and masks entries disagree: {err}")
    return counts, err


def catalogue_anchors(sep, tracks, smi: str):
    """Phase 11: the window and fleet planners' estimates beside the
    measured peaks (taken as in phase 9), which they must bound."""
    import dataclasses

    import torch

    from umx_tpu_torch.config import SegmentConfig
    from umx_tpu_torch.engine import memory
    from umx_tpu_torch.engine.fleet import demix_tracks, resolve_batched_width

    cfg0, params = sep.cfg, sep.params
    audio = list(tracks.values())
    capacity = memory.device_hbm_bytes("cuda")
    seg, stride = cfg0.segment.segment_samples(SR), cfg0.segment.stride_samples(SR)
    rows = []

    def measure(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fn()
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - base + memory.params_hbm_bytes(cfg0, params)

    def report(what, peak, est):
        print(f"planner anchor {what}: peak {peak} B, estimate {est} B ({est / peak:.3f}x)  [{smi}]")
        require(est >= peak, f"the planner's estimate {est} is below the peak {peak} ({what})")
        rows.append({"what": what, "peak": peak, "estimate": est})

    for streaming in (True, False):
        cfg = dataclasses.replace(cfg0, shifts=0, segment=SegmentConfig(
            streaming=streaming, window_chunks=WINDOW_CHUNKS))
        s = type(sep)(params, cfg, "cuda")
        peak = measure(lambda: s.demix(audio[-1]))
        est = memory.window_hbm_bytes(cfg, WINDOW_CHUNKS, capacity, params=params)
        report(f"window of {WINDOW_CHUNKS} chunks, {'streaming' if streaming else 'non-streaming'}, "
               "host input", peak, est)
        # the three 100 s tracks as one bucket of the fleet runner
        fcfg = dataclasses.replace(cfg, shifts=1)
        n_chunks = -(-(audio[0].shape[1] + fcfg.segment.max_shift_samples(SR)) // stride)
        secs = ((n_chunks - 1) * stride + seg) / SR
        cap = memory.suggest_max_fleet_batch(fcfg, secs, params=params, device="cuda")
        require(cap >= 3, f"the fleet planner caps a 100 s bucket at {cap} tracks on this card")
        peak = measure(lambda: demix_tracks(params, audio[:3], fcfg))
        if streaming:
            est = memory.fused_track_hbm_bytes(fcfg, 3, secs, params)["total"]
        else:
            width = resolve_batched_width(fcfg, n_chunks, seg, stride, batch=3, params=params,
                                          device="cuda")
            est = memory.parallel_track_hbm_bytes(fcfg, width, secs, params, batch=3)["total"]
        report(f"fleet bucket of 3 x 100 s, {'streaming' if streaming else 'non-streaming'} "
               f"(planner's cap {cap})", peak, est)
    return rows


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
    return launches, out, cli_s


def host_loop_path(tmp: str, model: str, wav: str, mix, counters: dict, fused_out: str,
                   smi: str):
    """Phase 4c: the CLI with ``--host-loop`` on the 100 s track, with the
    launch counters set to 0 just before and read just after: one segment
    call per chunk, its progress printed after each, K1 for 3 layers a
    chunk and K2/K3 once a chunk; the stems against the fused run's
    (``fused_out``, phase 4) and the mix.  Returns (launches, wall s)."""
    import io

    from umx_tpu_torch import cli
    from umx_tpu_torch.config import EngineConfig

    cfg = EngineConfig()
    stride = cfg.segment.stride_samples(SR)
    n_chunks = math.ceil((mix.shape[1] + cfg.segment.max_shift_samples(SR)) / stride)
    out = os.path.join(tmp, "stems_host_loop")
    printed = io.StringIO()
    reset_counts(counters)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        rc = cli.main([model, wav, out, "--host-loop"])
    cli_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    require(rc == 0, f"CLI --host-loop exited {rc}")
    progress = [ln.strip() for ln in printed.getvalue().splitlines() if ln.strip().startswith("demix ")]
    want = [f"demix {(i + 1) / n_chunks * 100:.0f}%" for i in range(n_chunks)]
    print(f"host-loop path (CLI --host-loop, {TRACK_SECS:.0f} s track, UMX-L, {n_chunks} chunks): "
          f"{cli_s:.3f} s wall  [{smi}]; progress {progress}; kernel runs {launches}")
    require(progress == want, f"the host loop printed {progress}, not {want}")
    require(launches["lstm_merged"] == 3 * n_chunks,
            f"K1 ran {launches['lstm_merged']} times on the host loop, not 3 x {n_chunks}")
    for name in ("wiener_reduce", "wiener_apply"):
        require(launches[name] == n_chunks,
                f"{name} ran {launches[name]} times on the host loop, not once a chunk ({n_chunks})")
    stems = check_stems(out, mix)
    fused = check_stems(fused_out, mix)
    err = float(np.max(np.abs(stems - fused)) / np.max(np.abs(fused)))
    print(f"host loop vs fused run (CLI, {TRACK_SECS:.0f} s): max|err|/max|stem| {err:.3g}")
    # the same kernels on the same chunks, accumulated chunk by chunk on the
    # device instead of stacked and overlap-added at once
    require(err <= 2e-3, f"the host loop's stems disagree with the fused run's: {err}")
    return launches, cli_s, err


def resample_path(tmp: str, model: str, counters: dict, smi: str):
    """Phase 4d: a 48 kHz WAV through the CLI with ``--resample`` on the
    card: polyphase-resampled to 44.1 kHz, then demixed; the stems checked
    against the resampled mix."""
    from fractions import Fraction

    from scipy.io import wavfile
    from scipy.signal import resample_poly

    rate = 48_000
    t = np.arange(int(30 * rate)) / rate
    rng = np.random.default_rng(48)
    mix48 = np.stack([0.3 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.standard_normal(t.size),
                      0.3 * np.sin(2 * np.pi * 330 * t) + 0.05 * rng.standard_normal(t.size)]
                     ).astype(np.float32)
    wav48 = os.path.join(tmp, "mix48.wav")
    wavfile.write(wav48, rate, np.ascontiguousarray(mix48.T))
    q = Fraction(SR, rate)
    mix = resample_poly(mix48.astype(np.float64), q.numerator, q.denominator, axis=1).astype(
        np.float32)
    from umx_tpu_torch import cli

    out = os.path.join(tmp, "stems_48k")
    reset_counts(counters)
    t0 = time.perf_counter()
    rc = cli.main([model, wav48, out, "--resample", "--quiet"])
    cli_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    require(rc == 0, f"CLI --resample exited {rc}")
    print(f"resample path (CLI --resample, 30 s at 48 kHz -> {mix.shape[1]} samples at 44.1 kHz): "
          f"{cli_s:.3f} s wall  [{smi}]; kernel runs {launches}")
    require(launches["lstm_merged"] > 0, "K1 was not launched on the resample path")
    check_stems(out, mix)
    return cli_s


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
            # the factor on the segment transients at which the estimate would equal the peak
            factor = memory._TRANSIENT_FACTOR["ct2" if algo == "ct2" else "dense"]
            needed = (peak - (total - int(est["seg_transients"] * factor))) / est["seg_transients"]
            print(f"planner anchor istft {algo}, {'streaming' if streaming else 'non-streaming'}, "
                  f"width {width}, shifts {shifts}: peak {peak} B, estimate {total} B "
                  f"({total / peak:.3f}x; transient factor {factor}, {needed:.3f} would meet the "
                  f"peak)  [{smi}]")
            require(total >= peak, f"the planner's estimate {total} is below the peak {peak}")
            rows.append({"istft": algo, "streaming": streaming, "width": width,
                         "shifts": shifts, "peak": peak, "estimate": total,
                         "transient_factor_needed": needed})
    sep.cfg = cfg0
    return rows


def write_stem_dir(root: str, n_tracks: int = 4, secs: float = 12.0):
    """Synthetic MUSDB-style stems: per track, band-limited noise per
    stem (bass, drums, other, vocals in rising bands) and their sum as
    mixture.wav, float32 WAVs."""
    from scipy.io import wavfile

    from umx_tpu_torch.config import TARGETS

    bands = [(40, 300), (300, 1200), (1200, 4000), (4000, 12000)]
    rng = np.random.default_rng(0)
    n = int(secs * SR)
    freqs = np.fft.rfftfreq(n, 1 / SR)
    for k in range(n_tracks):
        d = os.path.join(root, f"track_{k}")
        os.makedirs(d)
        mix = np.zeros((2, n), np.float32)
        for name, (lo, hi) in zip(TARGETS, bands):
            spec = np.fft.rfft(rng.standard_normal((2, n)).astype(np.float32), axis=-1)
            spec[:, (freqs < lo) | (freqs >= hi)] = 0
            x = np.fft.irfft(spec, n, axis=-1).astype(np.float32)
            x = x / (np.abs(x).max() + 1e-9) * 0.5
            mix += x
            wavfile.write(os.path.join(d, f"{name}.wav"), SR, np.ascontiguousarray(x.T))
        wavfile.write(os.path.join(d, "mixture.wav"), SR, np.ascontiguousarray(mix.T))


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
    # no device given: the entry point's default is the GPU
    state, hist = train_loop(train, mcfg, tcfg, steps=TRAIN_STEPS, batch_size=B_TRAIN,
                             params=params0, log_every=0, valid_dataset=valid, valid_every=4)
    require(state.params.fc1_w.is_cuda, "train_loop did not run on the GPU by default")
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

    # the same at twice the batch (two row groups per resident kernel):
    # one warm-up step, three timed; a figure, not a gate
    del batch, fixed
    mix, targets = train.sample(B_TRAIN_WIDE)
    batch = make_batch_from_audio(mix, targets, mcfg, DSPConfig(), tcfg.seq_len, "cuda")
    wide = init_train_state(params0, tcfg)
    wide_losses = []
    for i in range(4):
        if i == 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        wide, loss = step(wide, batch)
        wide_losses.append(float(loss))
    wide_steps_per_s = 3 / (time.perf_counter() - t0)
    require(bool(np.isfinite(wide_losses).all()), f"batch {B_TRAIN_WIDE} losses: {wide_losses}")
    del batch, wide

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
    held_out = {"trained": os.path.join(tmp, "trained.bin"),
                "initial": os.path.join(tmp, "initial.bin"),
                "estimates": os.path.join(tmp, "stems_trained"), "true": true}
    return launches, steps_per_s, wide_steps_per_s, held_out


EVAL_TRACKS, EVAL_SECS = 3, 20.0  # the MUSDB-style set of the evaluation phase
EVAL_TRAIN_STEPS = 4  # train_umx steps at UMX-HQ width, 2 validations
# seconds of phase 6's held-out track scored in v4 and v3: the float64
# host work of one v3 window is about 2.7 s on the host of an H100 80GB HBM3 machine
EVAL_HELD_OUT_SECS = 4


def _run_main(main, argv):
    """``main(argv)`` with its standard output captured; returns (its
    return value, the output), the output also printed."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    print(buf.getvalue().rstrip())
    return rc, buf.getvalue()


class _Timed:
    """Wraps a function with a wall-clock sum over its calls (each closed by
    a device synchronisation when ``sync``)."""

    def __init__(self, fn, sync: bool):
        self.fn, self.sync, self.s, self.calls = fn, sync, 0.0, 0

    def __call__(self, *a, **kw):
        import torch

        t0 = time.perf_counter()
        out = self.fn(*a, **kw)
        if self.sync:
            torch.cuda.synchronize()
        self.s += time.perf_counter() - t0
        self.calls += 1
        return out


def evaluation_path(tmp: str, held_out: dict, counters: dict, smi: str) -> dict:
    """Phase 14: the researcher's loop on the card.  ``evaluate_musdb`` on a
    MUSDB-style set with phase 6's trained and initial UMX-L models (K1-K3;
    finite medians; the trained model's SDR above the initial's);
    ``evaluate_demixed_output`` on phase 6's held-out stems in v4 and v3
    (the v3 solves on the card, held against the float64 host path);
    ``train_umx`` at UMX-HQ width with a validation split (K4-K6 and K1),
    its export demixed on the card; ``demix_tracks_multihost`` as process 0
    and 1 of 2 against one fleet run; a ``device_trace`` of one demix that
    must name K1; ``profile_train_stream`` at small steps.  Returns its
    figures."""
    import re

    import torch
    from scipy.io import wavfile

    from umx_tpu_torch.config import TARGETS
    from umx_tpu_torch.engine.fleet import demix_tracks
    from umx_tpu_torch.engine.separator import Separator
    from umx_tpu_torch.eval import bss
    from umx_tpu_torch.io.audio import load_audio
    from umx_tpu_torch.parallel.multihost import demix_tracks_multihost, partition_tracks
    from umx_tpu_torch.scripts import (
        evaluate_demixed_output, evaluate_musdb, profile_train_stream, train_umx,
    )
    from umx_tpu_torch.utils.profiling import StageTimer, device_trace

    timer = StageTimer()
    t_phase = time.perf_counter()
    fig: dict = {"card": smi}
    root = os.path.join(tmp, "musdb_eval")
    with timer.stage("write_set"):
        write_stem_dir(root, n_tracks=EVAL_TRACKS, secs=EVAL_SECS)

    # evaluate_musdb with both models, no device given: the card
    medians = {}
    for name in ("trained", "initial"):
        out = os.path.join(tmp, f"eval_{name}.json")
        reset_counts(counters)
        print(f"evaluate_musdb, {name} UMX-L model, {EVAL_TRACKS} tracks x {EVAL_SECS:.0f} s  "
              f"[{smi}]:")
        with timer.stage(f"evaluate_musdb_{name}"):
            rc, _ = _run_main(evaluate_musdb.main, [held_out[name], root, "--out", out])
        require(rc == 0, f"evaluate_musdb on the {name} model failed")
        launches = {k: counters[k].launches for k in ("lstm_merged", "wiener_reduce",
                                                      "wiener_apply")}
        require(all(n > 0 for n in launches.values()),
                f"evaluate_musdb did not launch K1-K3: {launches}")
        res = json.load(open(out))
        vals = [v for m in res["median"].values() for v in m.values()]
        require(len(vals) == 16 and all(np.isfinite(vals)), f"non-finite medians: {res['median']}")
        medians[name] = res["median"]
        fig[f"evaluate_musdb_{name}"] = {
            "launches": launches, "median": res["median"],
            "demix_s": [r["demix_s"] for r in res["tracks"]],
            "bss_s": [r["bss_s"] for r in res["tracks"]],
            "wall_s": timer.totals[f"evaluate_musdb_{name}"]}
        print(f"per track: demix_s {fig[f'evaluate_musdb_{name}']['demix_s']}, scoring s "
              f"{fig[f'evaluate_musdb_{name}']['bss_s']}; kernel runs {launches}")
    mean_sdr = {k: float(np.mean(list(m["sdr"].values()))) for k, m in medians.items()}
    fig["mean_median_sdr"] = mean_sdr
    print(f"mean over stems of the median SDR: trained {mean_sdr['trained']:.3f} dB, initial "
          f"{mean_sdr['initial']:.3f} dB")
    require(mean_sdr["trained"] > mean_sdr["initial"],
            f"the trained model does not score above the initial one: {mean_sdr}")

    # evaluate_demixed_output on the held-out stems: v4 (host), v3 (the
    # solves on the card) against the float64 host path on the same inputs
    track = os.path.join(tmp, "held_out_track")
    os.makedirs(track)
    for name, x in zip(TARGETS, held_out["true"]):
        wavfile.write(os.path.join(track, f"{name}.wav"), SR,
                      np.ascontiguousarray(x[:, : EVAL_HELD_OUT_SECS * SR].T))
    est_dir = held_out["estimates"]
    results = {}
    for mode in ("v4", "v3"):
        out = os.path.join(tmp, f"eval_{mode}.json")
        solve = _Timed(bss._solve_cholesky_batched, sync=True)
        bss._solve_cholesky_batched = solve
        try:
            with timer.stage(f"evaluate_demixed_output_{mode}"):
                rc, text = _run_main(evaluate_demixed_output.main,
                                     [est_dir, track, "--mode", mode, "--json", out])
        finally:
            bss._solve_cholesky_batched = solve.fn
        require(rc == 0, f"evaluate_demixed_output --mode {mode} failed")
        results[mode] = json.load(open(out))
        if mode == "v3":
            resolves = int(re.search(r"^# (\d+) windows re-solved in float64$", text,
                                     re.M).group(1))
            fig["v3_device_solve_s"], fig["v3_device_solve_calls"] = solve.s, solve.calls
            fig["v3_float64_resolves"] = resolves
    refs = np.stack([load_audio(os.path.join(track, f"{t}.wav")) for t in TARGETS])
    ests = np.stack([load_audio(os.path.join(est_dir, f"target_{i}.wav")) for i in range(4)])
    n = min(refs.shape[-1], ests.shape[-1])
    factor = _Timed(bss.cho_factor, sync=False)
    solve_h = _Timed(bss.cho_solve, sync=False)
    bss.cho_factor, bss.cho_solve = factor, solve_h
    try:
        with timer.stage("v3_numpy"):
            host = bss.bss_eval_images_framewise(refs[..., :n].astype(np.float64),
                                                 ests[..., :n].astype(np.float64),
                                                 mode="v3", accelerator="numpy")
    finally:
        bss.cho_factor, bss.cho_solve = factor.fn, solve_h.fn
    worst = {"SDR": 0.0, "SIR": 0.0}
    for j, t in enumerate(TARGETS):
        for m in worst:
            worst[m] = max(worst[m], abs(results["v3"][t][m] - float(host[f"median_{m}"][j])))
    fig.update(v3_vs_numpy_db=worst, v3_wall_s=timer.totals["evaluate_demixed_output_v3"],
               v3_numpy_wall_s=timer.totals["v3_numpy"], v3_numpy_solve_s=factor.s + solve_h.s,
               v4_wall_s=timer.totals["evaluate_demixed_output_v4"],
               held_out_v4=results["v4"], held_out_v3=results["v3"])
    print(f"v3 on the card against float64 on the host, {n / SR:.0f} s held-out track: worst "
          f"median SDR {worst['SDR']:.4f} dB, SIR {worst['SIR']:.4f} dB; device solves "
          f"{fig['v3_device_solve_s']:.3f} s ({fig['v3_device_solve_calls']} calls), "
          f"{fig['v3_float64_resolves']} windows re-solved in float64; host factor+solve "
          f"{fig['v3_numpy_solve_s']:.3f} s; whole v3 runs {fig['v3_wall_s']:.2f} s (card) and "
          f"{fig['v3_numpy_wall_s']:.2f} s (numpy); v4 {fig['v4_wall_s']:.2f} s  [{smi}]")
    require(worst["SDR"] <= 0.1 and worst["SIR"] <= 0.3,
            f"v3 on the card disagrees with the float64 host path: {worst}")

    # train_umx at its default width (UMX-HQ), a validation split; export,
    # then the port's Separator demixes with the exported model on the card
    model = os.path.join(tmp, "umxhq_trained.bin")
    reset_counts(counters)
    print(f"train_umx, UMX-HQ (hidden 512), {EVAL_TRAIN_STEPS} steps  [{smi}]:")
    with timer.stage("train_umx"):
        rc, text = _run_main(train_umx.main, [root, model, "--steps", str(EVAL_TRAIN_STEPS),
                                              "--valid-tracks", "1", "--valid-every", "2"])
    require(rc == 0, "train_umx failed")
    launches = {k: counters[k].launches for k in ("lstm_merged_train_fwd", "lstm_merged_bwd_step",
                                                  "lstm_merged_dw", "lstm_merged")}
    require(all(n > 0 for n in launches.values()), f"train_umx did not launch K4-K6 and K1: "
            f"{launches}")
    losses = [float(ln.split()[2]) for ln in text.splitlines()
              if ln.startswith(("final loss", "best valid"))]
    require(len(losses) == 2 and all(np.isfinite(losses)), f"train_umx losses: {text}")
    mix = load_audio(os.path.join(root, "track_0", "mixture.wav"))
    with timer.stage("demix_umxhq"):
        sep_hq = Separator.from_ggml(model)
        stems = sep_hq.demix_track(mix)
    require(sep_hq.device.type == "cuda" and stems.shape == (4, *mix.shape)
            and bool(np.isfinite(stems).all()), "the exported UMX-HQ model did not demix")
    fig.update(train_umx_launches=launches, train_umx_losses=losses,
               train_umx_wall_s=timer.totals["train_umx"])

    # two processes' shares against one fleet run, on the card
    sep = Separator.from_ggml(held_out["trained"])
    tracks = [load_audio(os.path.join(root, f"track_{k}", "mixture.wav"))
              for k in range(EVAL_TRACKS)]
    with timer.stage("fleet"):
        ref = demix_tracks(sep, tracks)
    union: dict = {}
    with timer.stage("multihost"):
        for pid in range(2):
            res = demix_tracks_multihost(sep, tracks, process_id=pid, process_count=2)
            require(res.owned_indices() == partition_tracks(len(tracks), pid, 2),
                    f"process {pid} demixed {res.owned_indices()}")
            union.update(res.local)
    require(sorted(union) == list(range(len(tracks))), f"union covers {sorted(union)}")
    mh_err = max(float(np.max(np.abs(union[i] - r))) for i, r in enumerate(ref))
    fig["multihost_max_abs_diff"] = mh_err
    print(f"demix_tracks_multihost, processes 0 and 1 of 2, against one fleet run: max|diff| "
          f"{mh_err:.3g}")
    require(mh_err <= 2e-4, f"multihost union differs from the fleet: {mh_err}")

    # a device trace of one demix: the trace file must name K1's kernel
    trace_dir = os.path.join(tmp, "trace")
    cut = tracks[0][:, : 10 * SR]
    out = torch.empty((4, *cut.shape), device="cuda")
    with device_trace(trace_dir) as prof:
        # block_on: the stage ends when the copy of the stems into ``out`` has
        with timer.stage("traced_demix", block_on=out):
            out.copy_(sep.demix(cut))
    files = [f for f in os.listdir(trace_dir) if f.endswith(".pt.trace.json")]
    require(len(files) == 1, f"device_trace wrote {files}")
    text = open(os.path.join(trace_dir, files[0])).read()
    require("lstm_resident_kernel" in text, "the trace names no K1 launch (lstm_resident_kernel)")
    kernel_ms = sum(e.device_time_total for e in prof.key_averages()) / 1e3
    fig["trace_device_ms"] = kernel_ms
    print(f"device_trace of one 10 s demix: {files[0]} names lstm_resident_kernel; "
          f"{kernel_ms:.3f} ms of device time  [{smi}]")

    with timer.stage("profile_train_stream"):
        prof_res = profile_train_stream.main(["--steps", "6", "--stream-secs", "30",
                                              "--segment-secs", "10"])
    fig["profile_train_stream"] = prof_res
    fig["stages"] = json.loads(timer.as_json())
    fig["wall_s"] = time.perf_counter() - t_phase
    print(timer.report())
    print(f"evaluation phase: {fig['wall_s']:.1f} s wall  [{smi}]")
    return fig


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


def flac_bytes(mix) -> bytes:
    """A FLAC file of ``mix`` (2, n) float32 as 16-bit samples: STREAMINFO,
    then frames of 4096 samples (the last one shorter) with one VERBATIM
    subframe per channel, CRC-8 headers and CRC-16 footers (the FLAC
    format specification).  The CRCs run over all frames of one length at
    once, a byte column at a time."""
    pcm = np.clip(np.round(mix * 32767.0), -32768, 32767).astype(">i2")  # (2, n)
    n = pcm.shape[1]
    bs = 4096
    streaminfo = (bs.to_bytes(2, "big") * 2 + bytes(6)
                  + ((SR << 44) | (1 << 41) | (15 << 36) | n).to_bytes(8, "big") + bytes(16))
    head = b"fLaC" + bytes([0x80]) + len(streaminfo).to_bytes(3, "big") + streaminfo

    def crc_table(poly, bits):
        top, mask = 1 << (bits - 1), (1 << bits) - 1
        table = []
        for b in range(256):
            c = b << (bits - 8)
            for _ in range(8):
                c = ((c << 1) ^ poly) & mask if c & top else (c << 1) & mask
            table.append(c)
        return np.array(table, np.uint32)

    crc8, crc16 = crc_table(0x07, 8), crc_table(0x8005, 16)

    def crcs(rows, table, bits):
        c = np.zeros(rows.shape[0], np.uint32)
        for col in rows.T:
            c = ((c << 8) & ((1 << bits) - 1)) ^ table[((c >> (bits - 8)) ^ col) & 0xFF]
        return c

    def utf8(k):  # frame numbers below 2^11 take one or two bytes
        require(k < 0x800, f"flac_bytes writes fewer than 2048 frames, not {k + 1}")
        return bytes([k]) if k < 0x80 else bytes([0xC0 | (k >> 6), 0x80 | (k & 0x3F)])

    frames = {}  # frame length -> (frame numbers, rows of bytes without the CRC-16)
    for k in range(-(-n // bs)):
        block = pcm[:, k * bs : (k + 1) * bs]
        m = block.shape[1]
        code = 0xC0 if m == bs else 0x70  # 4096, or a 16-bit (size - 1) at the header's end
        header = b"\xff\xf8" + bytes([code | 0x9, 0x18]) + utf8(k)
        if m != bs:
            header += (m - 1).to_bytes(2, "big")
        row = np.frombuffer(header + bytes(1) + b"\x02" + block[0].tobytes() + b"\x02"
                            + block[1].tobytes(), np.uint8).copy()
        row[len(header)] = crcs(row[None, : len(header)], crc8, 8)[0]
        frames.setdefault(len(row), []).append((k, row))
    out = {}
    for group in frames.values():
        rows = np.stack([r for _, r in group])
        for (k, row), c in zip(group, crcs(rows, crc16, 16)):
            out[k] = row.tobytes() + int(c).to_bytes(2, "big")
    return head + b"".join(out[k] for k in sorted(out))


def _http(url: str, body: bytes | None = None):
    """(status, headers, body) of a GET (no body) or POST."""
    import urllib.request

    req = urllib.request.Request(url, data=body, method="GET" if body is None else "POST")
    with urllib.request.urlopen(req, timeout=600) as r:
        return r.status, dict(r.headers), r.read()


def _zip_stems(payload: bytes, n: int):
    """The four stems of a /demix response: 44.1 kHz stereo float32 WAVs of
    ``n`` samples → (4, 2, n)."""
    import io
    import zipfile

    from scipy.io import wavfile

    with zipfile.ZipFile(io.BytesIO(payload)) as zf:
        names = sorted(zf.namelist())
        require(names == [f"target_{i}.wav" for i in range(4)], f"ZIP holds {names}")
        stems = []
        for name in names:
            rate, data = wavfile.read(io.BytesIO(zf.read(name)))
            require(rate == SR and data.shape == (n, 2) and data.dtype == np.float32,
                    f"{name}: rate {rate}, shape {data.shape}, dtype {data.dtype}")
            require(bool(np.isfinite(data).all()), f"{name} has non-finite samples")
            stems.append(data.T)
    return np.stack(stems)


def _partition(stems, mix, what: str) -> float:
    corr = float(np.corrcoef(stems.sum(axis=0).ravel(), mix.ravel())[0, 1])
    require(corr >= 0.99, f"{what}: the stems do not sum to the mix (corr {corr})")
    return corr


def serving_path(model: str, wav: str, mix, counters: dict, smi: str):
    """Phase 13: the HTTP service (``umx_tpu_torch.serve``) on cuda with its
    default flags (60 s segments, max_batch 4, Wiener 1 iteration), driven
    over a socket: health, info, warm-up and stats reset; three concurrent
    /demix requests of the 100 s WAV (seeds 0, 1, 2) with the launch
    counters set to 0 just before and read just after, the shapes the
    batcher gave K1 recorded, each response held against the same seed run
    alone (the host loop without the batcher); one request alone; a
    streaming session pushed in 10 s pieces against the offline demix; a
    FLAC body; the batched segment call's measured peaks at B = 1 and the
    served width beside the planner's estimate.  Returns the figures."""
    import dataclasses
    import threading

    import torch

    from umx_tpu_torch.engine import memory
    from umx_tpu_torch.engine.separator import Separator, segment_forward_batched
    from umx_tpu_torch.io import native
    from umx_tpu_torch.models import umx
    from umx_tpu_torch.serve import serve

    srv = serve(model, port=0)  # no device given: the default is the GPU
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    svc = srv.service
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        require(svc.device.type == "cuda", f"the service runs on {svc.device}")
        sep = svc.separator
        status, _, body = _http(url + "/healthz")
        require(status == 200 and json.loads(body)["status"] == "ok", f"/healthz: {status} {body}")
        cap = memory.suggest_max_segment_batch(sep.cfg, params=sep.params, device="cuda")
        info = json.loads(_http(url + "/info")[2])
        require(info["batching"]["max_batch"] == min(4, cap) == svc.batcher.max_batch,
                f"/info max_batch {info['batching']['max_batch']}, planner's cap {cap}")
        warm = json.loads(_http(url + "/warmup")[2])["warmup_s"]
        _http(url + "/demix?seed=0", open(wav, "rb").read())  # warms the request path
        body = open(wav, "rb").read()
        n = mix.shape[1]

        k1_shapes: set = set()
        served = [None] * 3
        with recording(umx, "lstm_layer_merged_batched", lambda x, *a: (x.shape[0], x.shape[2]),
                       k1_shapes):
            _http(url + "/stats/reset", b"")
            reset_counts(counters)

            def post(seed):
                served[seed] = _http(url + f"/demix?seed={seed}", body)

            threads = [threading.Thread(target=post, args=(s,)) for s in range(3)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            concurrent_s = time.perf_counter() - t0
            launches = {name: fn.launches for name, fn in counters.items()}
            info = json.loads(_http(url + "/info")[2])
        require(all(r is not None and r[0] == 200 for r in served), "a /demix request failed")
        batching, auto = info["batching"], info["autoscaling"]
        print(f"serving path (3 concurrent /demix of the {TRACK_SECS:.0f} s WAV, UMX-L, max_batch "
              f"{svc.batcher.max_batch}): {concurrent_s:.3f} s wall, "
              f"{3 * TRACK_SECS / concurrent_s:.1f}x realtime in aggregate  [{smi}]; batching "
              f"{batching}; autoscaling {auto}; kernel runs {launches}; K1 (rows per chain, "
              f"frames) {sorted(k1_shapes)}; warm-up {warm} s")
        require(batching["device_calls"] < batching["jobs"] and batching["max_batch_observed"] >= 2,
                f"the requests were not coalesced: {batching}")
        require(max(b for b, _ in k1_shapes) >= 2, f"K1 ran at one row per chain: {k1_shapes}")
        for name in ("lstm_merged", "wiener_reduce", "wiener_apply"):
            require(launches[name] > 0, f"kernel {name} was not launched on the serving path")
        require(launches["lstm_merged"] == 3 * batching["device_calls"],
                f"K1 ran {launches['lstm_merged']} times for {batching['device_calls']} calls")
        require(launches["wiener_reduce"] == batching["jobs"],
                f"K2 ran {launches['wiener_reduce']} times for {batching['jobs']} rows")

        alone_errs, bit_equal = [], []
        for seed in range(3):
            stems = _zip_stems(served[seed][2], n)
            _partition(stems, mix, f"served request, seed {seed}")
            ref = Separator(sep.params, sep.cfg, "cuda").demix_track(mix, seed, segment_fn=None,
                                                                     fused=False)
            alone_errs.append(float(np.max(np.abs(stems - ref)) / np.max(np.abs(ref))))
            bit_equal.append(bool(np.array_equal(stems, ref)))
        print(f"served stems vs the same seed run alone (host loop, no batcher): max|err|/max|stem| "
              f"{alone_errs}; bit-equal {bit_equal}")
        require(max(alone_errs) <= 1e-5, f"served stems disagree with the request alone: "
                f"{alone_errs}")

        t0 = time.perf_counter()
        one = _http(url + "/demix?seed=0", body)
        one_s = time.perf_counter() - t0
        one_stems, first = _zip_stems(one[2], n), _zip_stems(served[0][2], n)
        one_err = float(np.max(np.abs(one_stems - first)) / np.max(np.abs(first)))
        print(f"serving path, one /demix of the {TRACK_SECS:.0f} s WAV alone: {one_s:.3f} s wall, "
              f"{TRACK_SECS / one_s:.1f}x realtime  [{smi}]; against the same seed served with "
              f"others max|err|/max|stem| {one_err:.3g} (bit-equal "
              f"{bool(np.array_equal(one_stems, first))})")
        require(one_err <= 1e-5, f"the request alone disagrees with the same request served "
                f"with others: {one_err}")

        # one streaming session: 10 s pieces of float32 PCM
        sid = json.loads(_http(url + "/stream/start", b"")[2])["session"]
        piece = 10 * SR
        got, samples, call_s, emitted = [], [], [], 0
        reset_counts(counters)
        t_session = time.perf_counter()
        for s0 in range(0, n, piece):
            t0 = time.perf_counter()
            _, headers, payload = _http(url + f"/stream/push?session={sid}",
                                        np.ascontiguousarray(mix[:, s0 : s0 + piece].T).tobytes())
            m = int(headers["X-Stems-Samples"])
            samples.append(m)
            if m:
                call_s.append(time.perf_counter() - t0)
                got.append(np.frombuffer(payload, np.float32).reshape(4, 2, m))
        t0 = time.perf_counter()
        _, headers, payload = _http(url + f"/stream/close?session={sid}", b"")
        m = int(headers["X-Stems-Samples"])
        got.append(np.frombuffer(payload, np.float32).reshape(4, 2, m))
        close_s = time.perf_counter() - t0
        session_s = time.perf_counter() - t_session
        stream_launches = {name: fn.launches for name, fn in counters.items()}
        seg = sep.cfg.segment.segment_samples(SR)
        stride = sep.cfg.segment.stride_samples(SR)
        n_segments = -(-n // stride)
        per_segment_s = (sum(call_s) + close_s) / n_segments
        stream = np.concatenate(got, axis=-1)
        full = [k for k, s0 in enumerate(range(0, n, piece)) if min(s0 + piece, n) >= seg]
        require(all(m == 0 for m in samples[: full[0]]) and samples[full[0]] > 0,
                f"X-Stems-Samples {samples}: not 0 until {seg} samples were in")
        require(stream.shape == (4, 2, n), f"the session returned {stream.shape}")
        offline = Separator(sep.params, sep.cfg.replace(shifts=0), "cuda").demix(mix).cpu().numpy()
        stream_err = float(np.max(np.abs(stream - offline)) / np.max(np.abs(offline)))
        print(f"streaming session ({TRACK_SECS:.0f} s in 10 s pushes): X-Stems-Samples {samples} + "
              f"{m} at close; {session_s:.3f} s wall, {per_segment_s:.3f} s per emitted segment "
              f"({n_segments} segments)  [{smi}]; kernel runs {stream_launches}; vs the offline "
              f"demix max|err|/max|stem| {stream_err:.3g} (bit-equal "
              f"{bool(np.array_equal(stream, offline))})")
        require(stream_err <= 1e-5, f"the stream disagrees with the offline demix: {stream_err}")
        require(stream_launches["lstm_merged"] == 3 * n_segments
                and stream_launches["wiener_reduce"] == n_segments,
                f"the session's kernel runs {stream_launches} for {n_segments} segments")
        _partition(stream, mix, "streaming session")

        # a FLAC body (the port's native decoder, a host library)
        flac_note = native.build_error()
        if flac_note is None:
            q = np.clip(np.round(mix * 32767.0), -32768, 32767) / 32768.0
            t0 = time.perf_counter()
            _, _, payload = _http(url + "/demix?seed=0", flac_bytes(mix))
            flac_s = time.perf_counter() - t0
            corr = _partition(_zip_stems(payload, n), q, "FLAC body")
            flac_note = f"{flac_s:.3f} s wall with the FLAC encode, corr(sum of stems, mix) {corr:.6f}"
        else:
            flac_note = f"not run: the native IO library could not be built: {flac_note}"
        print(f"serving path, FLAC body of the {TRACK_SECS:.0f} s track: {flac_note}")

        # the planner's batched segment term against the measured peaks, for
        # the served inverse (dense) and the ct2 kernel's
        anchors = []
        for algo in ("dense", "ct2"):
            cfg = sep.cfg.replace(dsp=dataclasses.replace(sep.cfg.dsp, istft_algo=algo))
            peaks = {}
            for B in sorted({1, svc.batcher.max_batch}):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                with torch.inference_mode():
                    audio_b = torch.from_numpy(np.stack([mix[:, :seg]] * B)).to("cuda")
                    state = umx.init_lstm_state(cfg.model, "cuda", batch=B)
                    out = segment_forward_batched(sep.params, audio_b, state, cfg, seg)
                    torch.cuda.synchronize()
                    del out, audio_b, state
                peaks[B] = (torch.cuda.max_memory_allocated() - base
                            + memory.params_hbm_bytes(cfg, sep.params))
            # the per-row and fixed factors at which the estimate would meet
            # both peaks: peak - params - io - (fixed - row * fixed factor)
            # = B * row * per-row factor + row * fixed factor
            ests = {B: memory.segment_batch_hbm_bytes(cfg, B, params=sep.params) for B in peaks}
            row = ests[1]["seg_transients"]
            fixed_factor = memory._SEGMENT_FIXED_FACTOR[algo]
            rest = {B: peaks[B] - e["params"] - e["io"] - (e["fixed"] - int(row * fixed_factor))
                    for B, e in ests.items()}
            Bw = max(peaks)
            a_needed = (rest[Bw] - rest[1]) / ((Bw - 1) * row) if Bw > 1 else float("nan")
            b_needed = rest[1] / row - (a_needed if Bw > 1 else memory._SEGMENT_ROW_FACTOR[algo])
            for B, peak in peaks.items():
                est = ests[B]["total"]
                print(f"planner anchor, batched segment call, istft {algo}, B = {B}: peak {peak} B, "
                      f"estimate {est} B ({est / peak:.3f}x)  [{smi}]")
                anchors.append({"istft": algo, "batch": B, "peak": peak, "estimate": est})
            print(f"planner anchor, batched segment call, istft {algo}: per-row factor "
                  f"{a_needed:.3f} and fixed factor {b_needed:.3f} would meet both peaks (in use: "
                  f"{memory._SEGMENT_ROW_FACTOR[algo]}, {fixed_factor})")
        for a in anchors:
            require(a["estimate"] >= a["peak"], f"the planner's batched segment estimate "
                    f"{a['estimate']} is below the peak {a['peak']} at B = {a['batch']} "
                    f"(istft {a['istft']})")
    finally:
        srv.shutdown()
        srv.server_close()
        svc.batcher.close()
        thread.join(timeout=30)
    return {
        "launches": launches, "stream_launches": stream_launches, "k1_shapes": sorted(k1_shapes),
        "concurrent_s": concurrent_s, "aggregate_realtime": 3 * TRACK_SECS / concurrent_s,
        "one_request_s": one_s, "busy_fraction": auto["busy_fraction"],
        "avg_batch_fill": auto["avg_batch_fill"], "batching": batching,
        "vs_alone_rel_err": alone_errs, "vs_alone_bit_equal": bit_equal,
        "stream_s_per_segment": per_segment_s, "stream_vs_offline_rel_err": stream_err,
        "flac": flac_note, "anchors": anchors,
    }


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

    counters = {
        "lstm_layer_pertarget": lstm_cuda.lstm_layer_pertarget,
        "lstm_merged": lstm_cuda.lstm_merged,
        "wiener_reduce": wiener_cuda.wiener_reduce,
        "wiener_apply": wiener_cuda.wiener_apply,
        "lstm_merged_train_fwd": lstm_cuda.lstm_merged_train_fwd,
        "lstm_merged_bwd_step": lstm_cuda.lstm_merged_bwd_step,
        "lstm_merged_dw": lstm_cuda.lstm_merged_dw,
        "ola_normalized": ola_cuda.ola_normalized,
        "istft_ct2": istft_ct_cuda.istft_ct2,
    }
    wiener_args, wiener_errs = check_wiener(dev)
    k9_args, k9_err, k9_form, k9_ms, k9_k1_ms = check_pertarget(dev, T_SEG, G_HIDDEN, 9, smi)
    _, k9_err_hq, k9_form_hq, k9_ms_hq, k9_k1_ms_hq = check_pertarget(dev, T_SEG, 256, 10, smi)
    mode_args, mode_errs = check_wiener_modes(dev, *wiener_args[:3])
    check_reduce_launches(wiener_args, mode_args)

    lstm_args, lstm_err = check_lstm(dev, T_SEG, 1, seed=0)
    lstm16_args, lstm16_err = check_lstm(dev, T_TRAIN, B_TRAIN, seed=16)  # two n-tiles of rows
    lstm_err = max(lstm_err, check_lstm_resident(dev))
    ola_args, ola_err = check_ola(dev)
    istft8_args, istft_err = check_istft_ct(
        dev, [(ISTFT_ROWS, T_SEG), (3, 37), (5, 37), (1, 3)], seed=4)

    with tempfile.TemporaryDirectory(prefix="umx_smoke_") as tmp:
        model, wav, mix = write_inputs(tmp)
        launches, fused_out, cli_s = main_path(tmp, model, wav, mix, counters, smi)
        cpu_err = gpu_vs_cpu(model, mix)
        host_launches, host_s, host_err = host_loop_path(tmp, model, wav, mix, counters,
                                                         fused_out, smi)
        print(f"CLI wall time on the {TRACK_SECS:.0f} s track: fused {cli_s:.3f} s, host loop "
              f"{host_s:.3f} s  [{smi}]")
        resample_s = resample_path(tmp, model, counters, smi)
        serving = serving_path(model, wav, mix, counters, smi)

        from umx_tpu_torch.engine.separator import Separator

        sep = Separator.from_ggml(model)  # no device given: the default is the GPU
        require(sep.device.type == "cuda", "Separator.from_ggml did not default to the GPU")
        sep.demix_track(mix, seed=0)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sep.demix_track(mix, seed=0)
        torch.cuda.synchronize()
        demix_s = time.perf_counter() - t0
        print(f"demix {TRACK_SECS:.0f} s track (warm, UMX-L, shifts 1): {demix_s:.3f} s, "
              f"{TRACK_SECS / demix_s:.1f}x realtime (earlier form {EARLIER['demix_s']} s)  [{smi}]")
        sep.demix_track(mix, seed=0, fused=False)  # warm-up of the host loop
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sep.demix_track(mix, seed=0, fused=False)
        torch.cuda.synchronize()
        host_demix_s = time.perf_counter() - t0
        del sep
        print(f"demix {TRACK_SECS:.0f} s track (warm, UMX-L, shifts 1, host loop): "
              f"{host_demix_s:.3f} s against {demix_s:.3f} s fused  [{smi}]")

        batched_launches, k1_rows, bsep, k1_shapes, k8_shapes = batched_path(
            tmp, model, wav, mix, counters, smi)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bsep.demix_track(mix, seed=0)
        torch.cuda.synchronize()
        batched_s = time.perf_counter() - t0
        print(f"demix {TRACK_SECS:.0f} s track (warm, UMX-L, non-streaming chunk groups, "
              f"2 batched shifts, ct2 iSTFT, overlap-add kernel): {batched_s:.3f} s, "
              f"{TRACK_SECS / batched_s:.1f}x realtime (earlier form {EARLIER['batched_demix_s']} s)"
              f"  [{smi}]")
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
        istft_args = {**istft8_args, **istft_args}
        istft_err = max(istft_err, err)

        csep, tracks, cat_launches, cat_stats, cat_s, cat_k1_shapes, bucket_err = catalogue_path(
            tmp, model, counters, smi)
        # K1 against its plain version at the shapes the catalogue and the
        # serving paths ran it at
        for B, T in [*cat_k1_shapes, *serving["k1_shapes"]]:
            if (B, T) not in path_lstm_args and (B, T) != (1, T_SEG):
                path_lstm_args[B, T], err = check_lstm(dev, T, B, seed=100 + B)
                lstm_err = max(lstm_err, err)
        long_track = list(tracks.values())[-1]
        k9_launches, k9_path_s, k1_path_s, k9_vs_k1, cat_cpu_err = pertarget_path(
            csep, model, long_track, counters, smi)
        mode_launches, planes_err = planes_entry(csep, long_track)
        cat_anchors = catalogue_anchors(csep, tracks, smi)
        del csep

        train_args, train_errs = check_train_kernels(dev)
        check_train_resident(dev)
        train_launches, steps_per_s, wide_steps_per_s, held_out = training_path(tmp, counters,
                                                                                  smi)
        evaluation = evaluation_path(tmp, held_out, counters, smi)
    print(f"train steps/s (warm, UMX-L, batch {B_TRAIN} x {T_TRAIN} frames, AdamW): "
          f"{steps_per_s:.3f} (earlier form {EARLIER['train_steps_per_s']}); batch "
          f"{B_TRAIN_WIDE} x {T_TRAIN} frames: {wide_steps_per_s:.3f}  [{smi}]")

    # Phase 12: kernel, plain and library times beside each kernel's bound:
    # K1-K3 and K9 at the UMX-L segment shape, the training kernels (and K1
    # again) at the training shape, K7-K8 at the batched whole-track path's
    # shapes.  Each bound is computed from the tensors that are timed.
    xre, xim, masks, inv, racc = wiener_args
    W = wiener_cuda
    L = lstm_cuda
    y_bytes = 2 * N_SRC * 2 * T_SEG * F_BINS * 4  # the apply pass's output planes
    px = 2 * T_SEG * F_BINS  # elements of one (2, T, F) plane pair
    times = {
        "lstm_merged": (
            cuda_ms(lambda: L.lstm_merged(*lstm_args), 5),
            cuda_ms(lambda: L.lstm_merged_plain(*lstm_args), 2),
        ),
        "wiener_reduce": (
            cuda_ms_median("wiener_reduce",
                           lambda: W.wiener_reduce("masks", xre, xim, masks, None, inv), 20),
            cuda_ms(lambda: W.wiener_reduce_plain("masks", xre, xim, masks, inv), 20),
        ),
        "wiener_apply": (
            cuda_ms(lambda: W.wiener_apply("masks", xre, xim, masks, None, racc, inv, 1e-10), 20),
            cuda_ms(lambda: W.wiener_apply_plain("masks", xre, xim, masks, None, racc, inv, 1e-10), 20),
        ),
        "lstm_layer_pertarget": (
            k9_ms, cuda_ms(lambda: L.lstm_pertarget_plain(*k9_args), 2)),
    }
    # ~8 operations per element of x and ~12 per source and element
    # (reduce), ~40 + 30 per source (apply), float32 outside the tensor cores
    bounds = {
        "lstm_merged": lstm_bound(T_SEG, R_CHAINS, G_HIDDEN, lstm_args[:4]),
        "wiener_reduce": bound_ms(nbytes(xre, xim, masks, racc), px * (8 + 12 * N_SRC), "f32"),
        "wiener_apply": bound_ms(nbytes(xre, xim, masks, racc) + y_bytes,
                                 px / 2 * (40 + 30 * N_SRC), "f32"),
        "lstm_layer_pertarget": lstm_bound(T_SEG, R_CHAINS, G_HIDDEN, k9_args),
    }
    for mode, (mxre, mxim, first, second, minv, mracc, plain_in) in mode_args.items():
        times[f"wiener_reduce_{mode}"] = (
            cuda_ms_median(f"wiener_reduce_{mode}",
                           lambda: W.wiener_reduce(mode, mxre, mxim, first, second, minv), 20),
            cuda_ms(lambda: W.wiener_reduce_plain(mode, *plain_in, minv), 20))
        times[f"wiener_apply_{mode}"] = (
            cuda_ms(lambda: W.wiener_apply(mode, mxre, mxim, first, second, mracc, minv, 1e-10), 20),
            cuda_ms(lambda: W.wiener_apply_plain(mode, mxre, mxim, first, second, mracc, minv,
                                                 1e-10), 20))
        # mode mags reads x and the magnitudes; mode y reads the two y planes
        # (the apply pass x as well)
        r_in = nbytes(mxre, mxim, first) if mode == "mags" else nbytes(first, second)
        a_in = nbytes(mxre, mxim, first) + (nbytes(second) if mode == "y" else 0)
        bounds[f"wiener_reduce_{mode}"] = bound_ms(r_in + nbytes(mracc), px * (8 + 12 * N_SRC), "f32")
        bounds[f"wiener_apply_{mode}"] = bound_ms(a_in + nbytes(mracc) + y_bytes,
                                                  px / 2 * (40 + 30 * N_SRC), "f32")
    for name, fn, plain in (
        ("lstm_merged_train_fwd", L.lstm_merged_train_fwd, L.lstm_merged_train_fwd_plain),
        ("lstm_merged_bwd_step", L.lstm_merged_bwd_step, L.lstm_merged_bwd_step_plain),
        ("lstm_merged_dw", L.lstm_merged_dw, L.lstm_merged_dw_plain),
    ):
        times[name] = (cuda_ms(lambda: fn(*train_args[name]), 5),
                       cuda_ms(lambda: plain(*train_args[name]), 2))
    rows_t, train_ops = R_CHAINS * B_TRAIN, 2.0 * T_TRAIN * R_CHAINS * B_TRAIN * G_HIDDEN * 4 * G_HIDDEN
    step_elems = T_TRAIN * rows_t * G_HIDDEN * 4  # bytes of one (T, RB, G) f32 tensor
    bounds["lstm_merged_train_fwd"] = lstm_bound(
        T_TRAIN, rows_t, G_HIDDEN, train_args["lstm_merged_train_fwd"][:4],
        extra_out=5 * step_elems)  # the residuals: gates (T, RB, 4G) and cs (T, RB, G)
    # K5 reads gates, cs, c0, W_hh and the three cotangents, writes dxp, dh0, dc0
    bounds["lstm_merged_bwd_step"] = bound_ms(
        nbytes(*train_args["lstm_merged_bwd_step"][:7]) + 4 * step_elems + 2 * rows_t * G_HIDDEN * 4,
        train_ops, "bf16")
    # K6 reads hs, h0, dxp and writes dW (R, G, 4G) f32; its operands are bf16-rounded
    bounds["lstm_merged_dw"] = bound_ms(
        nbytes(*train_args["lstm_merged_dw"][:3]) + R_CHAINS * G_HIDDEN * 4 * G_HIDDEN * 4,
        train_ops, "bf16")
    times["ola_normalized"] = (cuda_ms_median("ola_normalized",
                                              lambda: ola_cuda.ola_normalized(*ola_args[8]), 20),
                               cuda_ms(lambda: ola.ola_normalized_plain(*ola_args[8]), 20))
    ola_len = N_CHUNKS * STRIDE + SEG - STRIDE
    bounds["ola_normalized"] = bound_ms(nbytes(*ola_args[8][:2]) + 8 * ola_len * 4,
                                        2.0 * 8 * ola_len, "f32")
    ola16 = (cuda_ms_median("ola_normalized_m16",
                            lambda: ola_cuda.ola_normalized(*ola_args[16]), 20),
             cuda_ms(lambda: ola.ola_normalized_plain(*ola_args[16]), 20))
    k8_shape = max(istft_args, key=math.prod)
    k8_args = istft_args[k8_shape]
    times["istft_ct2"] = (cuda_ms(lambda: istft_ct_cuda.istft_ct2(*k8_args), 10),
                          cuda_ms(lambda: istft_ct.istft_ct2_plain(*k8_args), 10))
    k8_form = istft_ct_cuda.istft_ct2.form

    def istft_bound(rows, T):
        # planes in, signal out; a 4096-point real inverse FFT is about
        # 2.5 N log2 N operations per frame, plus the window and the overlap-add
        out = rows * ((T - 1) * 1024 + 4096) * 4
        return bound_ms(2 * rows * T * F_BINS * 4 + out, rows * T * (2.5 * 4096 * 12 + 2 * 4096), "f32")

    bounds["istft_ct2"] = istft_bound(*k8_shape)

    # the one PyTorch call that computes the same function, where there is one
    def istft_library_ms(rows, T):
        re, im, _, _, win = istft_args[rows, T]
        spec = torch.complex(re, im).transpose(-1, -2).contiguous()
        spec.imag[:, 0] = 0.0
        spec.imag[:, -1] = 0.0
        return cuda_ms(lambda: torch.istft(spec, n_fft=4096, hop_length=1024, window=win,
                                           center=True, normalized=False, onesided=True,
                                           length=(T - 1) * 1024), 10)

    hs_t, h0_t, dxp_t, b_t = train_args["lstm_merged_dw"]
    hp = torch.cat([h0_t[None], hs_t[:-1]]).to(torch.bfloat16).float().view(
        T_TRAIN, R_CHAINS, b_t, G_HIDDEN).permute(1, 3, 0, 2).reshape(R_CHAINS, G_HIDDEN, -1)
    dg = dxp_t.to(torch.bfloat16).float().view(T_TRAIN, R_CHAINS, b_t, 4 * G_HIDDEN).permute(
        1, 0, 2, 3).reshape(R_CHAINS, -1, 4 * G_HIDDEN)
    library = dict.fromkeys(times)
    library["lstm_merged_dw"] = cuda_ms(lambda: torch.bmm(hp, dg), 10)
    library["istft_ct2"] = istft_library_ms(*k8_shape)
    del hp, dg
    require(times["istft_ct2"][0] <= library["istft_ct2"],
            f"istft_ct2 ({times['istft_ct2'][0]} ms) is slower than torch.istft "
            f"({library['istft_ct2']} ms) at {k8_shape}")
    if k8_shape == ISTFT_EARLIER_SHAPE:
        require(times["istft_ct2"][0] < EARLIER["istft_ct2_ms"],
                f"istft_ct2 ({times['istft_ct2'][0]} ms) is not faster than its earlier form "
                f"({EARLIER['istft_ct2_ms']} ms)")
    istft8 = (ISTFT_ROWS, T_SEG)
    if istft8 in istft_args and istft8 != k8_shape:
        k8 = (cuda_ms(lambda: istft_ct_cuda.istft_ct2(*istft_args[istft8]), 10),
              cuda_ms(lambda: istft_ct.istft_ct2_plain(*istft_args[istft8]), 10))
        k8_lib = istft_library_ms(*istft8)
        print(f"istft_ct2 at {istft8[0]} rows x {istft8[1]} frames: kernel {k8[0]:.4f} ms, plain "
              f"{k8[1]:.4f} ms, torch.istft {k8_lib:.4f} ms, bound "
              f"{istft_bound(*istft8)[0]:.4f} ms  [{smi}]")
        require(k8[0] <= k8_lib, f"istft_ct2 ({k8[0]} ms) is slower than torch.istft "
                f"({k8_lib} ms) at {istft8}")

    k1_path = {bt: (cuda_ms(lambda: L.lstm_merged(*a), 5),
                    cuda_ms(lambda: L.lstm_merged_plain(*a), 2))
               for bt, a in path_lstm_args.items()}
    k1_train = (cuda_ms(lambda: L.lstm_merged(*lstm16_args), 5),
                cuda_ms(lambda: L.lstm_merged_plain(*lstm16_args), 2))
    for name, (k, p) in times.items():
        lib = "none" if library[name] is None else f"{library[name]:.4f} ms"
        print(f"{name}: kernel {k:.4f} ms, plain {p:.4f} ms, bound {bounds[name][0]:.4f} ms by "
              f"{bounds[name][1]}, library call {lib}  [{smi}]")
    step_bytes = nbytes(lstm_args[1]) + R_CHAINS * (4 * G_HIDDEN + 2 * G_HIDDEN) * 4
    print(f"lstm_merged per step at B = 1: {times['lstm_merged'][0] / T_SEG * 1e3:.3f} us measured; "
          f"K9 {times['lstm_layer_pertarget'][0] / T_SEG * 1e3:.3f} us; one step's bytes from "
          f"device memory would take {step_bytes / HBM_BYTES_PER_S * 1e6:.3f} us, and the layer's "
          f"bound ignores that the {T_SEG} steps depend on each other")
    print(f"lstm_merged at the training shape (T={T_TRAIN}, B={B_TRAIN}): kernel "
          f"{k1_train[0]:.4f} ms (earlier form {EARLIER['lstm_merged_ms'][B_TRAIN]}), plain "
          f"{k1_train[1]:.4f} ms, bound "
          f"{lstm_bound(T_TRAIN, rows_t, G_HIDDEN, lstm16_args[:4])[0]:.4f} ms  [{smi}]")
    k1_ms, k9_now = times["lstm_merged"][0], times["lstm_layer_pertarget"][0]
    print(f"lstm_merged at one row per chain {k1_ms:.4f} ms (earlier form "
          f"{EARLIER['lstm_merged_ms'][1]}) against lstm_layer_pertarget {k9_now:.4f} ms (earlier "
          f"form {EARLIER['lstm_layer_pertarget_ms']}; form {k9_form}; "
          f"{'K9' if k9_now < k1_ms else 'K1'} is the faster at one row per chain); "
          f"lstm_merged_dw {times['lstm_merged_dw'][0]:.4f} ms (earlier form "
          f"{EARLIER['lstm_merged_dw_ms']}) against torch.bmm f32 "
          f"{library['lstm_merged_dw']:.4f} ms  [{smi}]")
    require(k9_now < EARLIER["lstm_layer_pertarget_ms"],
            f"lstm_layer_pertarget ({k9_now} ms) is not faster than its earlier form "
            f"({EARLIER['lstm_layer_pertarget_ms']} ms)")
    require(times["lstm_merged_dw"][0] <= library["lstm_merged_dw"],
            f"lstm_merged_dw ({times['lstm_merged_dw'][0]} ms) is slower than torch.bmm "
            f"({library['lstm_merged_dw']} ms)")
    k4_ms, k5_ms = times["lstm_merged_train_fwd"][0], times["lstm_merged_bwd_step"][0]
    print(f"lstm_merged_train_fwd {k4_ms:.4f} ms (earlier form "
          f"{EARLIER['lstm_merged_train_fwd_ms']}) against lstm_merged {k1_train[0]:.4f} ms at the "
          f"same shape; lstm_merged_bwd_step {k5_ms:.4f} ms (earlier form "
          f"{EARLIER['lstm_merged_bwd_step_ms']}); forms {L.lstm_merged_train_fwd.form} "
          f"{L.lstm_merged_bwd_step.form}  [{smi}]")
    require(k4_ms <= 2 * k1_train[0], f"lstm_merged_train_fwd ({k4_ms} ms) takes more than twice "
            f"lstm_merged ({k1_train[0]} ms) at the same shape")
    require(k4_ms < EARLIER["lstm_merged_train_fwd_ms"]
            and k5_ms < EARLIER["lstm_merged_bwd_step_ms"],
            f"K4 ({k4_ms} ms) or K5 ({k5_ms} ms) is not faster than its earlier form")
    ola16_bound = bound_ms(nbytes(*ola_args[16][:2]) + 16 * ola_len * 4, 2.0 * 16 * ola_len, "f32")
    print(f"ola_normalized at M=16 (two shift rows): kernel {ola16[0]:.4f} ms, plain "
          f"{ola16[1]:.4f} ms, bound {ola16_bound[0]:.4f} ms by {ola16_bound[1]}  [{smi}]")
    for M, ms, bound in ((8, times["ola_normalized"][0], bounds["ola_normalized"][0]),
                         (16, ola16[0], ola16_bound[0])):
        lo, hi = spreads["ola_normalized" if M == 8 else "ola_normalized_m16"]
        print(f"ola_normalized at M={M}: {ms:.4f} ms, median of {GATE_ROUNDS} rounds "
              f"({lo:.4f}-{hi:.4f}; earlier form {EARLIER['ola_normalized_ms'][M]}), "
              f"{bound / ms * 100:.1f} % of its bound  [{smi}]")
        require(ms < EARLIER["ola_normalized_ms"][M],
                f"ola_normalized ({ms} ms) is not faster than its earlier form at M = {M}")
    for mode, key in (("masks", "wiener_reduce"), ("y", "wiener_reduce_y"),
                      ("mags", "wiener_reduce_mags")):
        ms, earlier = times[key][0], EARLIER["wiener_reduce_ms"][mode]
        lo, hi = spreads[key]
        print(f"wiener_reduce mode {mode}: {ms:.4f} ms, median of {GATE_ROUNDS} rounds "
              f"({lo:.4f}-{hi:.4f}; earlier form {earlier}), "
              f"{bounds[key][0] / ms * 100:.1f} % of its bound  [{smi}]")
        if mode == "mags":
            require(ms < earlier, f"wiener_reduce mode mags ({ms} ms) is not faster than its "
                    f"earlier form ({earlier} ms)")
        else:
            require(ms <= earlier * REDUCE_SLACK, f"wiener_reduce mode {mode} ({ms} ms) is slower "
                    f"than its earlier form ({earlier} ms) by more than {REDUCE_SLACK}x")
    for (B, T), (k, p) in k1_path.items():
        print(f"lstm_merged at a path's shape (T={T}, B={B}): kernel {k:.4f} ms (earlier form "
              f"{EARLIER['lstm_merged_ms'].get(B)}), plain {p:.4f} ms, bound "
              f"{lstm_bound(T, R_CHAINS * B, G_HIDDEN, path_lstm_args[B, T][:4])[0]:.4f} ms  [{smi}]")
    print(f"istft_ct2 timed at the batched path's shape (rows={k8_shape[0]}, T={k8_shape[1]}): "
          f"{times['istft_ct2'][0]:.4f} ms (earlier form {EARLIER['istft_ct2_ms']} at "
          f"{ISTFT_EARLIER_SHAPE}), one launch, (runs per row, hops per run) {k8_form}")

    wsrc, wrep = "umx_tpu_torch/csrc/wiener.cu", "umx_tpu/ops/wiener_pallas.py"
    meta = {
        "lstm_merged": ("umx_tpu_torch/csrc/lstm_merged.cu",
                        "umx_tpu/ops/lstm_pallas.py:158", max(lstm_err, lstm16_err)),
        "wiener_reduce": (wsrc, f"{wrep}:89", wiener_errs["wiener_reduce"]),
        "wiener_apply": (wsrc, f"{wrep}:128", wiener_errs["wiener_apply"]),
        "wiener_reduce_y": (wsrc, f"{wrep}:148", mode_errs["wiener_reduce_y"]),
        "wiener_apply_y": (wsrc, f"{wrep}:245", mode_errs["wiener_apply_y"]),
        "wiener_reduce_mags": (wsrc, f"{wrep}:148", mode_errs["wiener_reduce_mags"]),
        "wiener_apply_mags": (wsrc, f"{wrep}:245", mode_errs["wiener_apply_mags"]),
        "lstm_layer_pertarget": ("umx_tpu_torch/csrc/lstm_pertarget.cu",
                                 "umx_tpu/ops/lstm_pallas.py:39", max(k9_err, k9_err_hq)),
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
    # training, K7-K8 the batched whole-track demix, K9 the per-target
    # catalogue run, the Wiener modes mags and y the planes entry
    path_launches = {**{k: launches[k] for k in ("lstm_merged", "wiener_reduce", "wiener_apply")},
                     **{k: train_launches[k] for k in
                        ("lstm_merged_train_fwd", "lstm_merged_bwd_step", "lstm_merged_dw")},
                     **{k: batched_launches[k] for k in ("ola_normalized", "istft_ct2")},
                     "lstm_layer_pertarget": k9_launches["lstm_layer_pertarget"],
                     **mode_launches}
    for name, n in path_launches.items():
        require(n > 0, f"kernel {name} was launched no time on its path")
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": path_launches[name], "max_abs_err": err,
         "ms": times[name][0], "plain_ms": times[name][1], "bound_ms": bounds[name][0],
         "bound_by": bounds[name][1], "library_ms": library[name]}
        for name, (src, rep, err) in meta.items()
    ]
    print(json.dumps({"kernels": kernels, "build_s": build_s, "demix_s": demix_s,
                      "gpu_vs_cpu_rel_err": cpu_err, "train_steps_per_s": steps_per_s,
                      "train_steps_per_s_batch_32": wide_steps_per_s,
                      "lstm_merged_train_fwd_form": lstm_cuda.lstm_merged_train_fwd.form,
                      "lstm_merged_bwd_step_form": lstm_cuda.lstm_merged_bwd_step.form,
                      "lstm_merged_ms_at_training_shape": k1_train[0],
                      "train_path_launches": train_launches, "batched_demix_s": batched_s,
                      "batched_path_launches": batched_launches, "batched_k1_rows": k1_rows,
                      "batched_gpu_vs_cpu_rel_err": batched_err, "planner_anchors": anchors,
                      "batched_k1_shapes": k1_shapes, "batched_k8_shapes": k8_shapes,
                      "catalogue_demix_s": cat_s, "catalogue_launches": cat_launches,
                      "catalogue_stats": cat_stats, "catalogue_anchors": cat_anchors,
                      "catalogue_k1_shapes": cat_k1_shapes,
                      "catalogue_bucket_rel_err": bucket_err,
                      "lstm_merged_form": lstm_cuda.lstm_merged.form,
                      "pertarget_form": k9_form, "pertarget_form_g256": k9_form_hq,
                      "pertarget_ms": [k9_ms, k9_ms_hq],
                      "lstm_merged_ms_at_k9_shapes": [k9_k1_ms, k9_k1_ms_hq],
                      "pertarget_path_s": k9_path_s, "merged_path_s": k1_path_s,
                      "pertarget_vs_merged_rel_err": k9_vs_k1,
                      "catalogue_gpu_vs_cpu_rel_err": cat_cpu_err,
                      "planes_vs_masks_rel_err": planes_err, "cli_s": cli_s,
                      "host_loop_cli_s": host_s, "host_loop_launches": host_launches,
                      "host_loop_demix_s": host_demix_s,
                      "host_loop_vs_fused_rel_err": host_err, "resample_cli_s": resample_s,
                      "ola_normalized_ms_m16": ola16[0], "gated_round_spreads": spreads,
                      "serving": serving, "evaluation": evaluation}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
