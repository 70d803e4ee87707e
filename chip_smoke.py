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
   whatever runs beside them; a width above 512 in the wide form;
3. the Wiener-EM reduce/apply kernels against their plain versions at
   S = 4, T = 2584, F = 2049, for 1 and 2 EM iterations; their bfloat16
   forms (K2/K3 reading bf16 masks, K3 writing bf16 planes, and the two
   mixed forms) against the plain versions on the same bf16 inputs and
   bit-equal to the float32 forms on the upcast masks (K3's bf16 planes:
   the RNE cast of its float32 ones), each timed beside its float32 form
   in turns and no slower than 1.05 times it, its bytes bound printed;
4. the demix path: synthetic UMX-L weights (hidden 1024, seed 0) written
   as a ggml file, a synthetic 100 s stereo WAV, and the port's CLI run
   on it in-process on ``cuda`` (3 chunks of 60 s, so the LSTM state is
   carried twice); the stems are checked, and every kernel's launch
   counter must have moved during that run, K2/K3 in their bf16 forms
   (the card's "auto" seams).  Then the GPU path is held against the
   port's CPU path (plain versions) on a short input with the storage
   seams pinned to float32 on both sides (K2/K3's float32 forms counted
   there), and the card's default against the CPU with the three seams
   bfloat16 by name (2e-2 of the peak, the error's RMS 2e-3); the CLI
   with ``--host-loop`` on the same track (one segment call per chunk: its
   progress lines, K1 for 3 layers a chunk and K2/K3 once a chunk, stems
   within 2e-3 of the fused run's with a float32 stems stack and summing
   to the mix), its wall time
   beside the fused run's; and a 30 s 48 kHz WAV through the CLI with
   ``--resample``;
5. the training kernels K4 (forward with residuals), K5 (reverse sweep)
   and K6 (weight gradient) against their plain versions at the UMX-L
   training shape (T = 256, R = 8, B = 16, G = 512), and K6 bit-stable,
   in its Hopper form (TMA, clusters of two, wgmma: ``csrc/lstm_dw.cu``);
   K4 and K5, each one resident launch per layer: K4's hs/hT/cT bit-equal
   to K1's, both at 20 rows per chain and a ragged T (two row groups), at
   96 rows, at G = 256, rows bit-equal whatever runs beside them, a width
   above 512 in the wide form, their forms printed (one wave at UMX-L);
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
   rows x 37 frames, 1 row x 3 frames), bit-stable; K8 at n_fft 1024,
   2048, 3072, 5120, 8192 and 16384 too (its register form, three passes
   in registers; the sizes JAX's ct2 takes beside UMX's 4096; each also
   against float64, bit-stable, and timed in turns with its mixed-radix
   form and torch.istft, faster than both: hard gates) and 32768, 65536
   and 131072 (its
   cluster form, a frame and its ring in the shared memory of a cluster of
   2, 4 and 8 blocks, above what one block's holds; bit-equal to its
   device-memory form) on 8 rows of a 60 s segment against its plain
   version and float64 (1e-5), with its radices, bit-stable;
8. the batched whole-track path: the CLI with ``--no-streaming --shifts 2
   --istft-algo ct2`` on the 100 s track, and a ``Separator`` with
   ``ola_impl="pallas"``, the ct2 iSTFT, non-streaming chunk groups at the
   planner's width and two batched shift passes; stems checked, K1 (at
   more than one row per chain), K2, K3, K7 and K8 launched.  The shapes
   at which that path ran K1 (rows per chain x frames) and K8 (rows x
   frames) are recorded during the run, and each kernel is then held
   against its plain version at each of them; then the GPU against the
   CPU for that config on a short input (float32 seams on both sides);
9. memory-planner anchors: the measured peak of the non-streaming and
   batched-shift programs beside the planner's estimate, which must bound
   it, at the card's default seams (the stack in bfloat16);
10. the per-target recurrence kernel K9 against its plain version and
    against K1 at T = 2584, G = 512 and G = 256, bit-stable, with the
    cluster form that ran (blocks per cluster, clusters the card holds at
    once, waves: as few as the card allows), timed beside K1;
    the Wiener passes in mode "mags" (and "y") against their plain
    versions at S = 4, T = 2584, F = 2049, K3's bf16 planes in both modes
    too (the RNE cast of its float32 planes, timed beside them, no slower
    than 1.05 times); K2's reduce one kernel launch a
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
    by one and (float32 seams, its first track's first 50 s) against the
    CPU; one
    ``Separator`` with ``lstm_impl="pallas"`` on the 400 s track (K9
    launched 3 layers x chunks times) against the K1 run and against the
    CPU on a 100 s cut; ``wiener_filter_planes`` on a real segment against
    ``wiener_filter_masks`` with float32 planes and at the card's default
    (bf16 planes, within one bf16 step), K2/K3's forms counted in each
    run; the window and fleet planners' estimates beside the measured
    peaks;
12. timings: each kernel against its plain version and, where one
    PyTorch call computes the same function, that call (CUDA events,
    after warm-up), each beside its bound (bytes over 3.35 TB/s or
    operations over the peak rate, whichever is larger), the warm demix
    times of the 100 s track (fused, and the streaming one also through
    the host loop), and train steps/s; K6 must be no slower
    than ``torch.bmm`` on the same operands (``torch.bmm`` of the bf16
    operands with ``out_dtype=torch.float32`` printed beside it), and at
    the UMX-L training shape no slower than the library sequence (rounding
    and chain-major copies, then that call) and faster than its mma_sync
    form, each timed in turns with it (both also at the four other shapes
    the paths give K6, ``K6_SHAPES``, with each one's bound, within 1e-5 of
    the plain version and bit-stable), K8 no slower than
    ``torch.istft``, K8 at n_fft 4096 and 48 rows at most 1.05 times its
    1.4149 ms before it took every n_fft (its other sizes timed beside
    their plain version, ``torch.istft`` and their bound; above 16384 its
    cluster form beside its device-memory form in turns, and at 32768
    faster than both and than ``torch.istft``), K4 at most twice
    K1 at the same shape, K4, K5, K8, K9,
    K7 (M = 8 and 16) and K2's reduce in mode mags faster than their
    earlier forms, and the reduce in modes masks and y no more than 5 %
    slower than its earlier form (K7 and the reduce timed as the median of
    5 rounds) (K9 beside K1 at one row per chain is
    printed, not gated).  The kernels line's K2/K3 rows are by storage
    form: the float32 forms with their launches on phase 4b's float32
    run, the bf16 forms (``WIENER_FORMS``) with the times of phases 3 and
    10 and their launches on the demix path (masks) and the planes entry
    (mags, y).  Every row carries its kernel's form; a line before the
    kernels line gives each phase's wall seconds.
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
    until one segment is in, the stems within 1e-5 of the offline demix
    with a float32 stems stack, which the session's accumulation is);
    a FLAC body (encoded here; skipped with its reason if the native IO
    library cannot be built); the batched segment call's measured peak at
    B = 1 and the served width beside ``segment_batch_hbm_bytes``, which
    must bound it.  Wall times, aggregate x realtime, busy fraction,
    average batch fill and the session's time per segment are printed.
14. (run right after phase 6, on its exported trained and initial UMX-L
    models) evaluation: ``umx_tpu_torch.scripts.evaluate_musdb`` with no
    ``--device`` on 3 synthetic MUSDB-style tracks of 12 s, once per model
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
15. (run after phase 14) oracle parity at UMX-L production shape:
    ``umx_tpu_torch.scripts.parity_fullscale`` at hidden 1024, 60 s, T 2584
    on cuda, every port variant (fp32, qhbm, pallas, pertarget, scan, ct2,
    em2, nowiener, quirk, stream2, wiener_bf16, wiener_f32 with the
    storage seams pinned to float32, and auto, the card's default bf16
    seams) against the independent oracle
    (``eval/oracle.py``) on the host CPU; each variant's kernels must have
    launched (K1-K3; K9 for pertarget, K10 for scan, K8 for ct2, K2/K3 in
    mode y for em2,
    K1 for 3 layers in each half of stream2, at T 1292, where K1 is then
    held against its plain version); every row's waveform error at least
    32.7 dB below the signal (0.1 dB of SDR), fp32 within 0.5 dB of the
    port's earlier 73.5 dB, every stem too but qhbm's,
    whose stems may lie no more than 3 dB below the TPU's same stem; each
    row printed beside the JAX package's TPU and CPU rows.  Its figures go
    under ``"parity"`` in the JSON line.
16. certification: ``convert_umx_pth_to_ggml --gzip`` on four UMX-L
    ``.pth`` files of phase 4's weights (the ggml equal to phase 4's
    file); ``e2e_test`` hermetic (``e2e OK``); ``umx_golden_inference``
    on a 20 s cut of phase 4's WAV (finite stems that sum to the mix; its
    error against the CLI's stems printed); ``fleet_certify`` on 10
    MUSDB-shaped tracks; ``serve_bench`` at its defaults (4 clients, 30 s
    tracks, max_batch 4; percentiles, x realtime, batch fill printed);
    ``longtrack_probe`` at 1800 s (planner beside ``device_hbm_bytes``,
    route, x realtime; finite stems, no drift of corr(sum of stems, mix)
    from the first tenth to the last).  K1-K3 launched by the fleet, the
    service and the long track.  Its figures go under ``"certification"``.
17. (run after phase 16; phase 11 checks ``cli_batch``'s mesh line) the
    device mesh at UMX-L width: ``make_mesh()`` must read ``{'dp': 1,
    'tp': 1}`` over the one card; then the grid's devices repeated
    (``[cuda:0] * 4``, so no copy between cards is made or timed): the
    sharded demix of four 60 s segments cut from phase 4's track at dp 4
    and at dp 2 x tp 2, each bit-equal to the unsharded batch (K1-K3
    launched; the dp audit finds no combine, the tp audit only the masks'
    gathers, at most 4), warm wall times and x realtime printed; one dp 1
    x tp 2 call with ``lstm_impl="pallas"`` (K9 at two targets, bit-equal
    to the unsharded call); ``demix_tracks`` over dp 2 on three 100 s
    tracks (a silent track pads the bucket), bit-equal to the fleet
    without a mesh; the sharded train step over dp 2 x tp 2 at batch 16 x
    256 frames, 3 steps against the unsharded step (first loss within
    1e-5, first gradients within 1e-4 of each field's max|g|, the losses
    of steps 2-3 within 1e-4, the loss after the third update within
    1e-2; K4-K6 launched); ``train_umx --mesh`` for 2 steps
    at UMX-HQ on phase 14's stems; the shapes the phase gave K1, K2/K3,
    K4-K6 and K9 recorded and each new one held against its plain version
    and timed beside its bound (K6 also beside ``torch.bmm`` f32 on the
    same operands, the library sequence and the call on pre-rounded
    operands).  Its figures go under ``"mesh"``.
18. (run after phase 17) the streaming schedules at UMX-L on the 100 s
    track (3 chunks): ``stream_impl`` "scan", "groups" and "pipelined"
    through their whole-track functions, warm, the median of 3 runs each,
    each peak beside the planner's estimate; each arm's stems and final
    state within 1e-5 of the scan's (bit-equality printed); K1's chain
    counts in the pipelined schedule (R 8, 16, 24, 16, 8: fill, steady,
    drain), K1 at R 8, 16 and 24 against its plain version with its
    forms (R 24 in chain groups), R 24 bit-equal per chain to three R 8
    launches on the same inputs and timed against them; the bfloat16
    seams (``mask_dtype``, ``wiener.out_dtype``, ``stems_stack_dtype``,
    each alone and all three) against the three pinned to float32 as dB
    below the signal, within the JAX seam tests' gates (2e-2 of the peak,
    1.5e-2 for the stack alone), and the default demix bit-equal to all
    three in bfloat16; the CLI with ``--stream-impl pipelined`` (counts set to 0
    just before and read just after; K1 at those chain counts, K2/K3 once
    a chunk, four finite stems summing to the mix).  Its figures go under
    ``"stream"``, and K1's row of the kernels line gets its launches by
    chain count on that run.
19. (run after phase 18) the float32 recurrence K10 (``lstm_impl="scan"``,
    ``csrc/lstm_scan.cu``; the JAX package's portable ``lax.scan``, no
    Pallas kernel) in each form that takes the width (W_hh resident on
    the chip, the default up to G 512; on the chip in the wide form's
    shares of 20 units, the default up to G 640; streamed from L2 each
    step, the only form above): against its plain version at T 2584, R 8
    and (G 512, B 1, 3, 6), W_hh bf16 at G 512 and 640, G 256, G 640 at B 1
    and 3 and G 18 (1e-4), rows at B 3 and 6 bit-equal to their B 1 runs,
    five more runs of each shape bit-equal to the first, each form's time
    beside its bound, the resident form faster than the streaming one at
    every shape it takes, the wide form timed beside the streaming one in
    turns and faster at every shape it takes, and four
    ``nn.LSTM`` calls (a yardstick); the CLI with
    ``--lstm-impl scan`` on the 100 s track, dense and ``--quantized-hbm``
    (counts set to 0 just before and read just after: K10 three layers a
    chunk, K1 never; stems summing to the mix); the GPU against the CPU on
    5 s with float32 seams, the CPU side in a child process with its
    instruction set, MKL path and threads pinned (dense 2e-4 of the peak;
    quantized 30 dB of error energy below the stems, as phase 11, since
    its bf16 activations flip on a last-bit change), each with K10 at the
    path's own inputs against its plain version (1e-4) and two card runs
    bit-equal; the warm streaming demix
    under "scan" beside the default, in turns; and a synthetic hidden-1280
    model (G 640: K10's wide form) through the CLI on a 20 s cut
    (finite stems, four WAVs) and against the CPU on 5 s (2e-4).  Its
    figures go under ``"scan"``, and K10's row of the kernels line gets its
    launches from the dense CLI run, the row of its wide form
    (``lstm_scan_wide``) from the hidden-1280 run.  Phase 15 runs the parity variant
    ``scan`` among the others.
20. (run after phase 19) training through the float32 recurrence: K10
    with its residual flag (``lstm_scan_train_fwd``: hs/hT/cT K10's bits,
    the residuals within 1e-4 of the plain version) and the reverse sweep
    K11 (``csrc/lstm_scan_train.cu``) in each form that takes the width
    against their plain versions (1e-4 of each output's largest entry) at
    T 256, R 8 and (G, B) = (512, 16), (512, 32), (256, 16), (640, 16),
    (18, 16), rows bit-equal to themselves alone, three repeat runs
    bit-equal, K11's resident and streaming forms bit-equal; both kernels
    in both forms (the resident one faster), the f32 dW ``torch.bmm`` and
    four ``nn.LSTM`` forward + backward calls (a yardstick) timed at the
    UMX-L training shape beside their bounds, and both kernels at G 640 in
    their wide form beside the streaming one in turns (faster), plain and
    bound;
    ``train_loop`` under ``lstm_impl="scan"`` at UMX-L, 8 steps at batch 16
    x 256 frames (counts set to 0 before and read after: K10 with residuals
    and K11 three times a step, K4-K6 and K1 never), warm steps on one
    batch under "scan" and the default in turns (steps/s; the loss under
    "scan" falls), a synthetic hidden-1280 model (G 640) trained 2 steps
    under "auto" through the wide K4/K5 and K6 and 2 under "scan" through
    the wide K10 with residuals and K11 (6 launches each); the card's first
    step under "scan"
    against the port's CPU path pinned as in phase 19, at UMX-L on 4 x 64
    frames (loss 1e-5 relative; the LSTM's gradients 2e-4 of their max|g|,
    the other fields, which pass ReLU kinks, 3 times the CPU path's own
    movement on an input 1e-6 larger, within [2e-4, 2e-3]); and a
    stress run of K10, K10 with residuals and K11, each width in its
    default form, at least 2000 launches of the resident forms
    at T 64 over B 1, 3, 6, 16, 20 and G 18, 256, 512, 640, at 8 chains
    and at one chain more than a launch holds (two chain groups), every
    other round with K1 on a second CUDA stream, each output bit-equal to
    its shape's first run; the hidden-1280 model's 5 s demix under "auto"
    through the wide K1 and never K10, bit-equal to "pallas_merged", and
    under "scan" through K10's wide form, within 2e-3 of the peak of
    "auto"'s stems.  Its figures go under ``"scan_train"``; the kernels line
    gets rows for both kernels with their launches from the ``train_loop``
    run, and rows for their wide forms (``lstm_scan_train_fwd_wide``,
    ``lstm_scan_bwd_step_wide``) with theirs from the hidden-1280 steps.

21. (run after phase 20) every width the JAX kernels take: K1 in its wide
    form (G 640: the resident kernel in a 10-warp block form, W_hh in
    registers and shared memory) and padded (G 18 to 24 by zero units) at T
    2584, R 8, B 1; K9 padded (G 18) and through the wide K1 (G 1024, where
    no cluster holds a chain: two chain groups of four); K4 and K5 wide and
    padded at the training shape: each against its plain version (5e-3),
    rows bit-equal alone, K4's hs/hT/cT K1's bits, timed beside plain and
    bound; the wide K1, K4 and K9 beside their streaming yardstick (K10's
    streaming kernel with h rounded to bf16, by name) in turns, which they
    must beat; the wide K5 in its block form (W_hh on the chip, the
    contraction split over a chain's blocks; its fields the plan's, a
    repeat bit-equal) beside its streaming yardstick (K11's streaming sweep
    with dg rounded to bf16) in turns, which it must beat; K6 at hidden 36
    (G 18, which TMA cannot stride: the Hopper form at the padded width 24)
    and 48 (G 24), its contraction split into slices, against its plain
    version (1e-5), bit-stable, in turns with its mma_sync form, the library
    sequence, the f32 ``torch.bmm`` and the call on pre-rounded operands,
    faster than the first two (hard gates).  Then, counts set to 0 just before
    and read just after each run: the CLI on phase 19's hidden-1280 model
    and its 20 s cut under ``--lstm-impl pallas_merged`` and ``--stream-impl
    pipelined`` (the wide K1, its block form and not the streaming one), and
    on a hidden-36 model under
    ``--lstm-impl pallas_merged``, ``pallas`` (padded K1, K9) and
    ``--stream-impl pipelined``, each held against the port's pinned CPU
    path on 5 s with float32 seams (2e-3 of the peak; K1/K9 at the path's
    inputs against plain, 5e-3; corr printed, not gated); hidden 2048 under
    ``pallas`` (K9's chains through the wide K1); ``train_loop`` 2 steps
    under ``"pallas_merged"`` at hidden 1280 (the wide K4/K5, both in their
    block forms; K6 in its Hopper form) and 36 (padded from end to end; K6
    in its Hopper form with slices, its mma_sync form launched no time);
    and ``umx_forward(compute="bfloat16")`` under ``"scan"`` on
    the card (K1, never K10) against the CPU at hidden 1280 and 36 (max
    2e-2 and RMS 2e-3 of the peak).  Its figures go under ``"width"``; the
    kernels line gets a row for each new form with its launches there.

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
# took its present form, printed beside the new ones: the demix times and
# K1 from before the recurrence became one resident launch per layer (then
# one grid launch per step); K6 from before its Hopper form (the mma.sync
# kernel, kept by name as "mma_sync" and timed in turns with it); K4, K5 and the training rate from before K4
# and K5 became resident launches too (then one grid per step each); K9 from
# when a chain's cluster had 16 blocks with W_hh in shared memory (two waves
# for 8 chains), K8 from when it wrote its frames to device memory and a
# second launch overlap-added them (48 rows x 2584 frames), K7 from when a
# thread wrote one sample of one row (M = 8 and 16 rows), K2's reduce from
# when it was two launches (a partial-sum pass, then their sum), by mode
EARLIER = {"demix_s": 0.319, "batched_demix_s": 0.294, "catalogue_demix_s": 2.706,
           "train_steps_per_s": 7.250, "lstm_merged_ms": {1: 19.9261, 3: 24.6960, 6: 41.5486,
                                                          16: 8.1123},
           "lstm_merged_dw_ms": 0.5787, "lstm_merged_train_fwd_ms": 8.7091,
           "lstm_merged_bwd_step_ms": 11.5000, "lstm_layer_pertarget_ms": 12.9396,
           "istft_ct2_ms": 7.3161, "ola_normalized_ms": {8: 0.3108, 16: 0.6176},
           "wiener_reduce_ms": {"masks": 0.1137, "y": 0.1369, "mags": 0.1703}}
# K2's reduce in modes masks and y may be no slower than its earlier form
# by more than this share (the same loop; the measurement's spread)
REDUCE_SLACK = 1.05
# a bfloat16 form of K2/K3 (bf16 masks read, bf16 planes written) may be no
# slower than its float32 form on the same values by more than this share
BF16_SLACK = 1.05
# the kernels line's rows of K2/K3 by storage form: name -> (wrapper, form
# of ``wiener_cuda.form``); the float32 forms keep their earlier names
WIENER_FORMS = {
    "wiener_reduce": ("wiener_reduce", "masks"),
    "wiener_apply": ("wiener_apply", "masks"),
    "wiener_reduce_bf16": ("wiener_reduce", "masks_bf16"),
    "wiener_apply_bf16": ("wiener_apply", "masks_bf16_out_bf16"),
    "wiener_reduce_y": ("wiener_reduce", "y"),
    "wiener_apply_y": ("wiener_apply", "y"),
    "wiener_apply_y_bf16": ("wiener_apply", "y_out_bf16"),
    "wiener_reduce_mags": ("wiener_reduce", "mags"),
    "wiener_apply_mags": ("wiener_apply", "mags"),
    "wiener_apply_mags_bf16": ("wiener_apply", "mags_out_bf16"),
    # the mixed forms (timed in phase 3, not rows of the kernels line)
    "wiener_apply_bf16_masks_f32_out": ("wiener_apply", "masks_bf16"),
    "wiener_apply_f32_masks_bf16_out": ("wiener_apply", "masks_out_bf16"),
}
ISTFT_EARLIER_SHAPE = (48, T_SEG)  # the shape of EARLIER["istft_ct2_ms"]
# K6's shapes on the paths, (T, R, B, G): UMX-L training (phases 5, 6),
# its batch-32 rate (phase 6), hidden 1280 under "auto" (phase 20b),
# train_umx at UMX-HQ (phase 14: batch 4), the mesh's grid cell (phase 17)
K6_SHAPES = {"umxl_train": (T_TRAIN, R_CHAINS, B_TRAIN, G_HIDDEN),
             "umxl_batch32": (T_TRAIN, R_CHAINS, 32, G_HIDDEN),
             "hidden1280": (T_TRAIN, R_CHAINS, B_TRAIN, 640),
             "umxhq_train_umx": (T_TRAIN, R_CHAINS, 4, 256),
             "mesh_cell": (T_TRAIN, 4, 8, G_HIDDEN)}
# K6 where its tiles alone leave the card nearly empty, its contraction split
# into slices: the trainer at hidden 36 (G 18, run at the padded width 24)
# and 48 (G 24, the width of the card's gradient test), T 256, R 8, B 16
K6_SMALL_SHAPES = {"hidden36": (T_TRAIN, R_CHAINS, B_TRAIN, 18),
                   "hidden48": (T_TRAIN, R_CHAINS, B_TRAIN, 24)}
# K8's 4096 form at that shape on an H100 80GB HBM3 at 700 W before the
# kernel took every n_fft; it may be no slower than this share of it now
ISTFT_4096_MS, ISTFT_4096_SLACK = 1.4149, 1.05
# K8 at n_fft beyond UMX's 4096 (JAX's ct2 takes every n_fft with
# 1024 | n_fft): the register form up to 16384, on 8 rows of a 60 s segment
ISTFT_SIZES = (1024, 2048, 3072, 5120, 8192, 16384, 32768, 65536, 131072)
# above 16384 the cluster form must beat torch.istft in the same call here
ISTFT_GATED_N_FFT = 32768
# the register form's path in the smoke: the ct2 round trip at this n_fft
ISTFT_REGISTER_PATH_N_FFT = 2048
B_TRAIN_WIDE = 32  # a second training batch: two row groups per resident kernel


_PHASE_T = [None]
PHASE_S = {}  # seconds of each part of the run, in order (printed before the kernels line)


def phase_done(name: str) -> None:
    """Book the wall seconds since the previous call (or the first call's
    start) to ``name``."""
    now = time.perf_counter()
    if _PHASE_T[0] is not None:
        PHASE_S[name] = round(now - _PHASE_T[0], 1)
    _PHASE_T[0] = now


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


def lstm_inputs(dev, T, B, seed, R=R_CHAINS, G=G_HIDDEN):
    """Random K1 inputs at R chains (8: the UMX-L layer) of width G (512
    unless given)."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    RB, G4 = R * B, 4 * G
    xp = torch.randn((T, RB, G4), generator=g, device=dev)
    whh = (torch.randn((R, G, G4), generator=g, device=dev) / G**0.5).to(torch.bfloat16)
    h0 = 0.5 * torch.randn((RB, G), generator=g, device=dev)
    c0 = 0.5 * torch.randn((RB, G), generator=g, device=dev)
    return xp, whh, h0, c0, B


def check_lstm(dev, T, B, seed, R=R_CHAINS, G=G_HIDDEN):
    """Phase 2: K1 against its plain version at R chains (8 unless given),
    G = 512 unless given."""
    import torch

    from umx_tpu_torch.ops import lstm_cuda

    args = lstm_inputs(dev, T, B, seed, R, G)
    out_k = lstm_cuda.lstm_merged(*args)
    torch.cuda.synchronize()
    out_p = lstm_cuda.lstm_merged_plain(*args)
    torch.cuda.synchronize()
    errs = {n: max_err(a, b) for n, a, b in zip(("hs", "hT", "cT"), out_k, out_p)}
    print(f"lstm_merged vs plain (T={T}, R={R}, B={B}, G={G}): "
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
    depend on their neighbours, one wave at UMX-L, and G 520 in the wide
    form."""
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
    wide = inputs(2, 1, 520, seed=1)
    err = max(max_err(a, b) for a, b in zip(L.lstm_merged(*wide), L.lstm_merged_plain(*wide)))
    print(f"lstm_merged at G = 520: form {L.lstm_merged.form}, max|err| vs plain {err:.3g}")
    require(L.lstm_merged.form[0] == "wide" and err <= 5e-3,
            f"lstm_merged at G = 520: form {L.lstm_merged.form}, max|err| {err}")
    return max(worst, err)


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
    ragged T, rows that do not depend on their neighbours, and G 520 in the
    wide form."""
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
    fwd_in, cts = train_inputs(dev, 2, 1, 520, seed=1)
    fwd_k = L.lstm_merged_train_fwd(*fwd_in)
    ferr = max(max_err(a, b) for a, b in zip(fwd_k, L.lstm_merged_train_fwd_plain(*fwd_in)))
    bwd_in = (fwd_k[3], fwd_k[4], fwd_in[3], fwd_in[1], *cts, 1)
    berr = max(rel_err(a, b) for a, b in zip(L.lstm_merged_bwd_step(*bwd_in),
                                             L.lstm_merged_bwd_step_plain(*bwd_in)))
    forms = (L.lstm_merged_train_fwd.form, L.lstm_merged_bwd_step.form)
    print(f"K4/K5 at G = 520: forms {forms}, max|err| vs plain {ferr:.3g}, {berr:.3g}")
    require(forms[0][0] == forms[1][0] == "wide" and ferr <= 5e-3 and berr <= 5e-3,
            f"K4/K5 at G = 520: forms {forms}, errors {ferr}, {berr}")


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
    require(L.lstm_merged_dw.form[0] == "wgmma",
            f"lstm_merged_dw did not run its Hopper form at UMX-L: {L.lstm_merged_dw.form}")
    print(f"lstm_merged_dw on the plain dxp: max|err|/max|ref| {dw_alone:.3g}; bit-stable; "
          f"form {L.lstm_merged_dw.form}")
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


def check_wiener(dev, smi: str):
    """Phase 3: K2 + K3 against their plain versions, 1 and 2 iterations;
    then their bfloat16 forms (bf16 masks read by both passes, bf16 planes
    written by K3) against the plain versions on the same bf16 inputs, and
    bit-equal to the float32 forms on the upcast masks (K3's bf16 planes:
    the RNE cast of its float32 ones), each timed beside its float32 form
    (gated at BF16_SLACK) and its bytes bound."""
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

    # the bfloat16 forms, on bf16 masks and their exact upcast
    m16 = masks.to(torch.bfloat16)
    m32 = m16.float()
    rows, bf16 = {}, {}
    r16 = W.wiener_reduce("masks", xre, xim, m16, None, inv)
    r32 = W.wiener_reduce("masks", xre, xim, m32, None, inv)
    rp = W.wiener_reduce_plain("masks", xre, xim, m16, inv)
    require(torch.equal(r16, r32), "the reduce on bf16 masks is not the reduce on their upcast")
    # name: (max|err| against the plain version, the same beyond one bf16
    # step of each element, scale, gate as a share of the scale)
    rows["wiener_reduce_bf16"] = (max_err(r16, rp), max_err(r16, rp), float(rp.abs().max()), 1e-5)
    for out_dt in (torch.float32, torch.bfloat16):
        a16 = W.wiener_apply("masks", xre, xim, m16, None, rp, inv, 1e-10, out_dt)
        a32 = W.wiener_apply("masks", xre, xim, m32, None, rp, inv, 1e-10, out_dt)
        require(all(torch.equal(a, b) for a, b in zip(a16, a32)),
                f"the apply on bf16 masks ({out_dt}) is not the apply on their upcast")
    f32 = W.wiener_apply("masks", xre, xim, m32, None, rp, inv, 1e-10)
    for in_dt, m in (("f32", m32), ("bf16", m16)):
        o16 = W.wiener_apply("masks", xre, xim, m, None, rp, inv, 1e-10, torch.bfloat16)
        require(all(torch.equal(b, a.to(torch.bfloat16)) for a, b in zip(f32, o16)),
                f"K3's bf16 planes ({in_dt} masks) are not the RNE cast of its f32 planes")
    p16 = W.wiener_apply_plain("masks", xre, xim, m16, None, rp, inv, 1e-10, torch.bfloat16)
    # the float32 values agree within the f32 gate; a rounding that flips
    # there moves an element by one bf16 step
    rows["wiener_apply_bf16"] = (
        max(max_err(o16[0], p16[0]), max_err(o16[1], p16[1])),
        max(bf16_step_err(o16[0], p16[0]), bf16_step_err(o16[1], p16[1])),
        float(p16[0].float().abs().max()), 1e-4)
    for name, (e, beyond, scale, gate) in rows.items():
        print(f"{name} vs plain (bf16 masks{', bf16 planes' if 'apply' in name else ''}): "
              f"max|err| {e:.3g}, {beyond:.3g} beyond one bf16 step (scale {scale:.3g}); "
              f"bit-equal to the float32 form on the upcast masks")
        require(beyond <= gate * scale, f"{name} disagrees with its plain version: {beyond}")

    # times beside the float32 forms, the bytes each form must move
    x_b, racc_b = nbytes(xre, xim), nbytes(rp)
    y32_b = 2 * N_SRC * 2 * T_SEG * F_BINS * 4
    px = 2 * T_SEG * F_BINS
    red_ops, app_ops = px * (8 + 12 * N_SRC), px / 2 * (40 + 30 * N_SRC)
    forms = {
        # name: (bf16 call, f32 call, plain call, bf16 bytes, f32 bytes, ops)
        "wiener_reduce_bf16": (
            lambda: W.wiener_reduce("masks", xre, xim, m16, None, inv),
            lambda: W.wiener_reduce("masks", xre, xim, m32, None, inv),
            lambda: W.wiener_reduce_plain("masks", xre, xim, m16, inv),
            x_b + nbytes(m16) + racc_b, x_b + nbytes(m32) + racc_b, red_ops),
        "wiener_apply_bf16": (
            lambda: W.wiener_apply("masks", xre, xim, m16, None, rp, inv, 1e-10, torch.bfloat16),
            lambda: W.wiener_apply("masks", xre, xim, m32, None, rp, inv, 1e-10),
            lambda: W.wiener_apply_plain("masks", xre, xim, m16, None, rp, inv, 1e-10,
                                         torch.bfloat16),
            x_b + nbytes(m16) + racc_b + y32_b // 2, x_b + nbytes(m32) + racc_b + y32_b,
            app_ops),
        # the two mixed forms: bf16 masks with float32 planes (the first of
        # several EM iterations), float32 masks with bf16 planes
        "wiener_apply_bf16_masks_f32_out": (
            lambda: W.wiener_apply("masks", xre, xim, m16, None, rp, inv, 1e-10),
            lambda: W.wiener_apply("masks", xre, xim, m32, None, rp, inv, 1e-10),
            lambda: W.wiener_apply_plain("masks", xre, xim, m16, None, rp, inv, 1e-10),
            x_b + nbytes(m16) + racc_b + y32_b, x_b + nbytes(m32) + racc_b + y32_b, app_ops),
        "wiener_apply_f32_masks_bf16_out": (
            lambda: W.wiener_apply("masks", xre, xim, m32, None, rp, inv, 1e-10, torch.bfloat16),
            lambda: W.wiener_apply("masks", xre, xim, m32, None, rp, inv, 1e-10),
            lambda: W.wiener_apply_plain("masks", xre, xim, m32, None, rp, inv, 1e-10,
                                         torch.bfloat16),
            x_b + nbytes(m32) + racc_b + y32_b // 2, x_b + nbytes(m32) + racc_b + y32_b,
            app_ops),
    }
    for name, (fn16, fn32, plain, b16, b32, ops) in forms.items():
        ms32, ms16 = paired_ms(fn32, fn16, 20, name)
        bound16, bound32 = bound_ms(b16, ops, "f32"), bound_ms(b32, ops, "f32")
        bf16[name] = {"ms": ms16, "f32_ms": ms32, "bound": bound16, "f32_bound_ms": bound32[0],
                      "plain_ms": cuda_ms(plain, 20),
                      "max_abs_err": rows.get(name, (None,))[0]}
        print(f"{name}: {ms16:.4f} ms against the float32 form's {ms32:.4f} ms "
              f"({ms16 / ms32:.3f}x; medians of {GATE_ROUNDS} rounds in turns), bound "
              f"{bound16[0]:.4f} ms by {bound16[1]} ({b16 / 1e6:.1f} MB; float32 form "
              f"{bound32[0]:.4f} ms, {b32 / 1e6:.1f} MB)  [{smi}]")
        require(ms16 <= BF16_SLACK * ms32, f"{name} ({ms16} ms) is slower than its float32 "
                f"form ({ms32} ms) by more than {BF16_SLACK}x")
    return (xre, xim, masks, inv, racc), errs, bf16


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


def istft_round_trip(dev, counters: dict, smi: str, n_fft: int = ISTFT_GATED_N_FFT) -> dict:
    """K8 on the path a caller runs it by: the ct2 iSTFT at ``n_fft`` (its
    cluster form at ``ISTFT_GATED_N_FFT``, its register form at
    ``ISTFT_REGISTER_PATH_N_FFT``; ``stft_planes``, then ``istft_planes``
    with ``istft_algo="ct2"``, the JAX package's DSP functions) on 8 rows
    of a 60 s segment of noise; counts set to 0 just before the inverse and
    read just after; the round trip within 1e-4 of the input's peak."""
    import torch

    from umx_tpu_torch.config import DSPConfig
    from umx_tpu_torch.ops.stft import istft_planes, stft_planes

    cfg = DSPConfig(n_fft=n_fft, hop=n_fft // 4, istft_algo="ct2")
    g = torch.Generator(device=dev).manual_seed(7)
    x = 0.3 * torch.randn((ISTFT_ROWS, SEG), generator=g, device=dev)
    re, im = stft_planes(x, cfg)
    reset_counts(counters)
    y = istft_planes(re, im, SEG, cfg)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items() if fn.launches}
    err = float((y - x).abs().max()) / float(x.abs().max())
    print(f"ct2 round trip at n_fft {cfg.n_fft} ({ISTFT_ROWS} rows x 60 s): max|x - istft(stft "
          f"x)|/max|x| {err:.3g}; kernel runs {launches}  [{smi}]")
    require(launches == {"istft_ct2": 1} and err <= 1e-4,
            f"the ct2 round trip at n_fft {cfg.n_fft}: {launches}, {err}")
    return {"launches": launches["istft_ct2"], "round_trip_rel_err": err,
            "form": counters["istft_ct2"].form}


def check_istft_sizes(dev, smi: str):
    """Phase 7: K8 at ``ISTFT_SIZES`` (up to 16384 its register form,
    :func:`time_istft_register`: three passes in registers, each held and
    timed in turns with its mixed-radix yardstick and torch.istft, and
    faster than both (hard gates); above 16384 its cluster form, bit-equal
    to its device-memory form) on 8 rows of a 60 s segment (T = 2646000 /
    hop + 1 frames), windowed, against its plain version and a float64 CPU
    reference on 2 rows, bit-stable.  Returns ({n_fft: kernel args},
    {n_fft: max|err| vs plain}, {n_fft: the register form's figures})."""
    import torch

    from umx_tpu_torch.ops import istft_ct, istft_ct_cuda
    from umx_tpu_torch.ops.stft import hann_window

    args, errs, reg = {}, {}, {}
    for n in ISTFT_SIZES:
        if n <= istft_ct_cuda.SHARED_N_FFT_MAX and istft_ct_cuda.istft_shared_form(n) == "register":
            row = time_istft_register(dev, n, smi)
            require(row["ms"] < row["mixed_radix_ms"] and row["ms"] < row["library_ms"],
                    f"istft_ct2's register form at n_fft {n} ({row['ms']} ms) is not faster than "
                    f"its mixed-radix form ({row['mixed_radix_ms']} ms) and torch.istft "
                    f"({row['library_ms']} ms) in turns")
            args[n], errs[n], reg[n] = row.pop("args"), row["max_abs_err"], row
            continue
        hop, F = n // 4, n // 2 + 1
        T = SEG // hop + 1
        g = torch.Generator(device=dev).manual_seed(n)
        re = torch.randn((ISTFT_ROWS, T, F), generator=g, device=dev)
        im = torch.randn((ISTFT_ROWS, T, F), generator=g, device=dev)
        w = hann_window(n, dev)
        out = istft_ct_cuda.istft_ct2(re, im, n, hop, w)
        torch.cuda.synchronize()
        form = istft_ct_cuda.istft_ct2.form
        plain = istft_ct.istft_ct2_plain(re, im, n, hop, w)
        err = max_err(out, plain)
        f64 = istft_ct.istft_ct2_plain(re[:2].cpu().double(), im[:2].cpu().double(), n, hop,
                                       w.cpu().double())
        err64 = float((out[:2].cpu().double() - f64).abs().max())
        where = istft_ct_cuda.istft_form(n)
        # above 16384 the cluster form's bits are the device-memory form's
        # (the same arithmetic through the same helpers)
        same = (where != "cluster" or
                torch.equal(out, istft_ct_cuda.istft_ct2(re, im, n, hop, w, _form="device")))
        print(f"istft_ct2 at n_fft {n} ({ISTFT_ROWS} rows x {T} frames), form {where} (cluster "
              f"{istft_ct_cuda.istft_cluster_size(n) if where == 'cluster' else '-'}): max|err| "
              f"vs plain {err:.3g}, vs float64 on 2 rows {err64:.3g}; bit-equal to the "
              f"device-memory form {same}; (runs per row, hops per run, radices) {form}  [{smi}]")
        require(err <= 1e-5 and err64 <= 1e-5, f"istft_ct2 at n_fft {n} disagrees: {err}, {err64}")
        require(form[2] == istft_ct_cuda.istft_radices(n), f"istft_ct2 at n_fft {n}: {form}")
        require(same, f"istft_ct2 at n_fft {n}: the cluster form is not the device-memory "
                "form's bits")
        require(torch.equal(out, istft_ct_cuda.istft_ct2(re, im, n, hop, w)),
                f"istft_ct2 at n_fft {n} is not bit-stable from run to run")
        errs[n] = err
        args[n] = (re, im, n, hop, w)
        del out, plain, f64
    return args, errs, reg


@contextlib.contextmanager
def recording(module, name: str, shape_of, seen: set):
    """For the block, ``module.name`` is a wrapper that adds
    ``shape_of(*args)`` of every call to ``seen`` (unless it is None) and
    then calls it."""
    real = getattr(module, name)

    def spy(*args, **kw):
        shape = shape_of(*args, **kw)
        if shape is not None:
            seen.add(shape)
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
    """Every wrapper's launch count to 0, and the Wiener wrappers' counts
    by storage form and K6's by form."""
    for fn in counters.values():
        fn.launches = 0
        if hasattr(fn, "form_launches"):
            fn.form_launches = dict.fromkeys(fn.form_launches, 0)


def form_counts() -> dict:
    """K2/K3's launches by storage form, under the kernels line's names
    (``WIENER_FORMS``)."""
    from umx_tpu_torch.ops import wiener_cuda

    return {name: getattr(wiener_cuda, fn).form_launches[form]
            for name, (fn, form) in WIENER_FORMS.items()}


def f32_seams(cfg):
    """``cfg`` with the three storage seams pinned to float32, for the
    gates that hold the card against the CPU's plain versions (or two
    kernels against each other): both sides then store what the CPU's
    "auto" stores, and the gate measures the kernels, not the seams."""
    import dataclasses

    return cfg.replace(mask_dtype="float32", stems_stack_dtype="float32",
                       wiener=dataclasses.replace(cfg.wiener, out_dtype="float32"))


def paired_ms(fn_a, fn_b, reps: int, name: str):
    """Median device ms of ``fn_a`` and ``fn_b`` over GATE_ROUNDS rounds of
    :func:`cuda_ms`, the two timed in turns (a, b, then b, a), for a gate
    that holds one form against another in this run; the rounds' ranges go
    to ``spreads``."""
    ra, rb = [], []
    for k in range(GATE_ROUNDS):
        order = ((ra, fn_a), (rb, fn_b)) if k % 2 == 0 else ((rb, fn_b), (ra, fn_a))
        for rounds, fn in order:
            rounds.append(cuda_ms(fn, reps))
    ra.sort()
    rb.sort()
    spreads[f"{name}_f32"] = (ra[0], ra[-1])
    spreads[name] = (rb[0], rb[-1])
    return ra[GATE_ROUNDS // 2], rb[GATE_ROUNDS // 2]


def turns_ms(fns: dict, reps: int, name: str) -> dict:
    """Median device ms of each of ``fns`` over GATE_ROUNDS rounds of
    :func:`cuda_ms`, all timed in turns (each round in another order); the
    rounds' ranges go to ``spreads``."""
    keys, got = list(fns), {k: [] for k in fns}
    for k in range(GATE_ROUNDS):
        order = keys[k % len(keys):] + keys[:k % len(keys)]
        for key in order[::-1] if k % 2 else order:
            got[key].append(cuda_ms(fns[key], reps))
    for key, v in got.items():
        v.sort()
        spreads[f"{name} {key}"] = (v[0], v[-1])
    return {key: v[GATE_ROUNDS // 2] for key, v in got.items()}


def bf16_step_err(got, want) -> float:
    """max|got - want| beyond one bfloat16 step of each element (0 where
    two bf16 values differ by at most one rounding)."""
    g, w = got.float(), want.float()
    step = 2.0 ** (g.abs().maximum(w.abs()).clamp_min(1e-30).log2().floor() - 7)
    return float(((g - w).abs() - step).clamp_min(0.0).max())


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


def check_wiener_modes(dev, xre, xim, masks, smi: str):
    """Phase 10: K2/K3 in mode "mags" (and the later iterations' mode "y")
    against their plain versions, on the Wiener check's x with a patch of
    exact zeros and the magnitudes mask * |x|; K3's bfloat16 planes in
    both modes against the plain versions and bit-equal to the RNE cast
    of its float32 planes, each timed beside its float32 form (gated at
    BF16_SLACK) and its bytes bound."""
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
    args, errs, bf16 = {}, {}, {}
    # mode y reads the first iteration's estimates in the working frame
    y1 = W.wiener_planes_from_mags(xre, xim, mags, WienerConfig())
    yre_s, yim_s = y1[0] * inv, y1[1] * inv
    y32_b = 2 * N_SRC * 2 * T_SEG * F_BINS * 4
    px = 2 * T_SEG * F_BINS
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

        # K3's bfloat16 planes in this mode
        name = f"wiener_apply_{mode}_bf16"
        b_k = W.wiener_apply(mode, xre, xim, first, second, racc_p, inv, 1e-10, torch.bfloat16)
        b_p = W.wiener_apply_plain(mode, xre, xim, first, second, racc_p, inv, 1e-10,
                                   torch.bfloat16)
        require(all(torch.equal(b, a.to(torch.bfloat16)) for a, b in zip(y_k, b_k)),
                f"{name}: K3's bf16 planes are not the RNE cast of its f32 planes")
        e_b = max(max_err(b_k[0], b_p[0]), max_err(b_k[1], b_p[1]))
        beyond = max(bf16_step_err(b_k[0], b_p[0]), bf16_step_err(b_k[1], b_p[1]))
        require(beyond <= 1e-4 * y_scale, f"{name} disagrees with its plain version: {beyond}")
        a_in = nbytes(xre, xim, first) + (nbytes(second) if mode == "y" else 0) + nbytes(racc_p)
        fn16 = (lambda f=first, sc=second, r=racc_p: W.wiener_apply(
            mode, xre, xim, f, sc, r, inv, 1e-10, torch.bfloat16))
        fn32 = (lambda f=first, sc=second, r=racc_p: W.wiener_apply(
            mode, xre, xim, f, sc, r, inv, 1e-10))
        ms32, ms16 = paired_ms(fn32, fn16, 20, name)
        ops = px / 2 * (40 + 30 * N_SRC)
        bound16, bound32 = bound_ms(a_in + y32_b // 2, ops, "f32"), bound_ms(a_in + y32_b, ops, "f32")
        bf16[name] = {"ms": ms16, "f32_ms": ms32, "bound": bound16, "f32_bound_ms": bound32[0],
                      "plain_ms": cuda_ms(lambda f=first, sc=second, r=racc_p: W.wiener_apply_plain(
                          mode, xre, xim, f, sc, r, inv, 1e-10, torch.bfloat16), 20),
                      "max_abs_err": e_b}
        print(f"{name}: vs plain max|err| {e_b:.3g}, {beyond:.3g} beyond one bf16 step (max|y| "
              f"{y_scale:.3g}); the RNE cast of the f32 form's planes, bit for bit; "
              f"{ms16:.4f} ms against the float32 form's {ms32:.4f} ms ({ms16 / ms32:.3f}x), "
              f"bound {bound16[0]:.4f} ms by {bound16[1]} (float32 form {bound32[0]:.4f} ms)"
              f"  [{smi}]")
        require(ms16 <= BF16_SLACK * ms32, f"{name} ({ms16} ms) is slower than its float32 "
                f"form ({ms32} ms) by more than {BF16_SLACK}x")
    return args, errs, bf16


# Traces of one call that device_kernels takes at most, and the pause
# before each: a trace with no device event at all is the profiler's
# failure to attach, and it has come three times in a row on the card,
# right after another trace
TRACE_ATTEMPTS, TRACE_PAUSE_S = 10, 0.5


def device_kernels(fn):
    """The names of the kernels that ``fn()`` launched on the card
    (``torch.profiler``'s device events).  Each trace starts after a pause
    from the one before; a trace with no device event at all is the
    profiler's failure to attach, not a result: ``fn`` is traced again, up
    to ``TRACE_ATTEMPTS`` times in all."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(TRACE_ATTEMPTS):
        time.sleep(TRACE_PAUSE_S)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
        if names:
            break
    return names


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


# the catalogue bucket's track held against the CPU: its first 50 s (two
# chunks at a 45 s stride), cut from the whole 100 s to keep the smoke run
# inside its time limit beside phase 21
CATALOGUE_CPU_SECS = 50.0


def catalogue_path(tmp: str, model: str, counters: dict, smi: str):
    """Phase 11: the batch CLI in a subprocess, then ``demix_tracks`` in
    process with a forced window, launch counts around it and the shapes
    it gives K1 ((rows per chain, frames)) and K2/K3 ((frames, bins))
    recorded; then the bucket of 100 s tracks with dense weights against
    the same tracks one by one (the card's default seams) and the first
    50 s of its first track against the CPU (float32 seams on both sides)."""
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
    mesh_line = "mesh: {'dp': 1, 'tp': 1} over 1 device(s)"
    require(mesh_line in proc.stdout.splitlines(),
            f"cli_batch did not log its mesh as {mesh_line!r}:\n{proc.stdout[-2000:]}")
    print(f"cli_batch: {mesh_line}")
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
    # and the first CATALOGUE_CPU_SECS of the bucket's first track (two
    # chunks: the state carried once) against the port's CPU path (plain
    # versions), the storage seams pinned to float32 on both sides
    head = bucket[0][:, : int(CATALOGUE_CPU_SECS * SR)]
    gpu32 = Separator(dense.params, f32_seams(cfg), "cuda").demix_track(head, seed=seeds[0])
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    t0 = time.perf_counter()
    cpu = Separator.from_ggml(model, f32_seams(cfg), "cpu").demix_track(head, seed=seeds[0])
    cpu_err = float(np.max(np.abs(gpu32 - cpu)) / np.max(np.abs(cpu)))
    print(f"GPU vs CPU port, first {CATALOGUE_CPU_SECS:.0f} s of that bucket's first track at "
          f"UMX-L, float32 seams: max|err|/max|stem| {cpu_err:.3g} (CPU run "
          f"{time.perf_counter() - t0:.1f} s)")
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
    # (the storage seams pinned to float32: a bf16 rounding that the two
    # kernels' last float32 bits flip would be the seam's, not theirs)
    dense = Separator.from_ggml(model, f32_seams(sep.cfg), "cuda")
    d1 = dense.demix_track(long_track, seed=0)
    d9 = Separator(dense.params, f32_seams(cfg9), "cuda").demix_track(long_track, seed=0)
    d_err = rel(d9, d1)
    print(f"the same with dense weights and float32 seams: K9 vs K1 stems max|err|/max|stem| "
          f"{d_err:.3g}; the K1 "
          f"path against itself on the track x (1 + 1e-6): "
          f"{rel(dense.demix_track(nudged, seed=0), d1):.3g}")
    require(d_err <= 2e-3, f"dense K9 and K1 paths disagree: {d_err}")
    del dense, d1, d9

    cut = long_track[:, : int(100 * SR)]
    cfgc = f32_seams(dataclasses.replace(
        cfg9, segment=dataclasses.replace(cfg9.segment, window_chunks=2)))
    gpu = Separator(sep.params, cfgc, "cuda").demix_track(cut, seed=0)
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    t0 = time.perf_counter()
    cpu = Separator.from_ggml(model, cfgc, "cpu", quantized_hbm=True).demix_track(cut, seed=0)
    err_cpu, cpu_db = rel(gpu, cpu), energy_db(gpu, cpu)
    print(f"GPU vs CPU port, catalogue slice (quantized, lstm_impl pallas, windows of 2, float32 "
          f"seams), 100 s at UMX-L: max|err|/max|stem| {err_cpu:.3g}, error energy {cpu_db:.1f} dB "
          f"(CPU run {time.perf_counter() - t0:.1f} s)")
    require(bool(np.isfinite(gpu).all()) and cpu_db <= -30.0,
            f"GPU and CPU disagree: error energy {cpu_db} dB")
    return launches, k9_s, k1_s, err, err_cpu


def planes_entry(sep, track):
    """Phase 11: ``wiener_filter_planes`` (modes "mags", then "y") on a real
    segment's x and target magnitudes, against ``wiener_filter_masks`` on
    the masks that gave them: one estimate through two entries.  Three
    runs, each with K2/K3's counts by storage form set to 0 just before
    and read just after: 2 iterations with float32 planes (the float32
    forms of modes mags and y), 2 iterations at the card's default
    (mode y's bf16 planes) and 1 iteration at the default (mode mags'
    bf16 planes).  Returns ({kernels line name: launches}, the float32
    run's error, the bf16 runs' errors beyond one bf16 step)."""
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
    runs = {  # name: (config, the forms it must launch once each)
        "float32": (WienerConfig(iterations=2, out_dtype="float32"),
                    ("wiener_reduce_mags", "wiener_apply_mags", "wiener_reduce_y",
                     "wiener_apply_y")),
        "default, 2 iterations": (WienerConfig(iterations=2), ("wiener_apply_y_bf16",)),
        "default, 1 iteration": (WienerConfig(), ("wiener_apply_mags_bf16",)),
    }
    counts, errs = {}, {}
    with torch.inference_mode():
        audio = torch.from_numpy(track[:, :SEG]).to("cuda")[None]
        re, im = stft_planes(audio, cfg.dsp)
        mag = torch.sqrt(re * re + im * im)
        x1 = umx_pre(sep.params, crop_stack(mag, mcfg.nb_bins_cropped), mcfg)
        lstm_out, _ = umx_recurrence_batched(sep.params, x1, init_lstm_state(mcfg, "cuda", 1), mcfg)
        masks = umx_post(sep.params, x1, lstm_out, mcfg)
        mags = apply_masks(masks, mag, mcfg.n_bins)[0].contiguous()
        for name, (wcfg, must) in runs.items():
            for fn in (W.wiener_reduce, W.wiener_apply):
                fn.form_launches = dict.fromkeys(fn.form_launches, 0)
            yp = wiener_filter_planes(re[0], im[0], mags, wcfg)
            torch.cuda.synchronize()
            run = {k: n for k, n in form_counts().items() if n}
            ym = wiener_filter_masks(re[0], im[0], masks[0], mcfg.n_bins, wcfg)
            for k in must:
                require(run.get(k) == 1, f"wiener_filter_planes ({name}) ran {k} "
                        f"{run.get(k, 0)} times: {run}")
                counts[k] = run[k]
            scale = float(ym[0].float().abs().max())
            if name == "float32":
                err = max(max_err(yp[0], ym[0]), max_err(yp[1], ym[1])) / scale
            else:
                # two entries' float32 values a few roundings apart: an
                # element's bf16 rounding may flip, one bf16 step
                require(yp[0].dtype == ym[0].dtype == torch.bfloat16, f"{name}: {yp[0].dtype}")
                err = max(bf16_step_err(yp[0], ym[0]), bf16_step_err(yp[1], ym[1])) / scale
            errs[name] = err
            print(f"wiener_filter_planes vs wiener_filter_masks on a real segment, {name}: "
                  f"max|err|/max|y| {err:.3g}{'' if name == 'float32' else ' beyond one bf16 step'}"
                  f"; kernel runs by form {run}")
            # mask * x against (mask * |x|) * (x * rsqrt(|x|^2)): a few f32
            # roundings per element, carried through the EM iterations
            require(err <= 1e-4, f"the planes and masks entries disagree ({name}): {err}")
    return counts, errs["float32"], errs


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
    forms = form_counts()
    require(rc == 0, f"CLI exited {rc}")
    print(f"demix path (CLI, {TRACK_SECS:.0f} s track, UMX-L): {cli_s:.3f} s wall  [{smi}]; "
          f"kernel runs {launches}; K2/K3 by storage form {forms}")
    for name in ("lstm_merged", "wiener_reduce", "wiener_apply"):
        require(launches[name] > 0, f"kernel {name} was not launched on the demix path")
    require(launches["lstm_scan"] == 0, "the default demix path launched the float32 recurrence")
    # the card's "auto" seams: K2/K3 read bf16 masks and K3 writes bf16 planes
    for name in ("wiener_reduce_bf16", "wiener_apply_bf16"):
        require(forms[name] == launches[name.removesuffix("_bf16")],
                f"the demix path ran K2/K3 in other forms than bf16: {forms}")
    check_stems(out, mix)
    return launches, forms, out, cli_s


def host_loop_path(tmp: str, model: str, wav: str, mix, counters: dict, fused_out: str,
                   smi: str):
    """Phase 4c: the CLI with ``--host-loop`` on the 100 s track, with the
    launch counters set to 0 just before and read just after: one segment
    call per chunk, its progress printed after each, K1 for 3 layers a
    chunk and K2/K3 once a chunk; the stems against the fused run's with
    the stems stack in float32 (the host loop adds each chunk's float32
    output into its track buffers; the other seams round in the same
    places on both) and the mix, and beside the default fused run
    (``fused_out``, phase 4, its stack bfloat16 on the card).  Returns
    (launches, wall s)."""
    import io

    from umx_tpu_torch import cli
    from umx_tpu_torch.config import EngineConfig

    cfg = EngineConfig()
    stride = cfg.segment.stride_samples(SR)
    n_chunks = math.ceil((mix.shape[1] + cfg.segment.max_shift_samples(SR)) / stride)
    fused32_out = os.path.join(tmp, "stems_f32_stack")
    require(cli.main([model, wav, fused32_out, "--quiet", "--stems-stack-dtype", "float32"]) == 0,
            "CLI --stems-stack-dtype float32 failed")
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
    fused = check_stems(fused32_out, mix)
    err = float(np.max(np.abs(stems - fused)) / np.max(np.abs(fused)))
    default = check_stems(fused_out, mix)
    print(f"host loop vs fused run with a float32 stems stack (CLI, {TRACK_SECS:.0f} s): "
          f"max|err|/max|stem| {err:.3g}; vs the default fused run (bf16 stack) "
          f"{float(np.max(np.abs(stems - default)) / np.max(np.abs(default))):.3g}")
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
    on 5 s of the mix with 2 s segments, the storage seams pinned to
    float32 on both sides."""
    import torch

    from umx_tpu_torch.engine.separator import Separator

    cfg = f32_seams(batched_config(segment_secs=2.0))
    short = mix[:, : 5 * SR]
    gpu = Separator.from_ggml(model, cfg, "cuda").demix_track(short, seed=0)
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    cpu = Separator.from_ggml(model, cfg, "cpu").demix_track(short, seed=0)
    err = float(np.max(np.abs(gpu - cpu)) / np.max(np.abs(cpu)))
    print(f"GPU vs CPU port, batched path, 5 s at UMX-L width, float32 seams: max|err|/max|stem| "
          f"{err:.3g}")
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
    require(launches["lstm_scan_train_fwd"] == launches["lstm_scan_bwd_step"] == 0,
            "the default trainer at UMX-L ran the float32 recurrence")
    dw_forms = dict(counters["lstm_merged_dw"].form_launches)
    require(dw_forms["wgmma"] == launches["lstm_merged_dw"],
            f"K6 did not run its Hopper form on every launch of the training path: {dw_forms}")

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


# the MUSDB-style set of the evaluation phase (12 s a track: the float64
# scoring on the host is nearly all of the phase's time)
EVAL_TRACKS, EVAL_SECS = 3, 12.0
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

    # a device trace of one demix: the trace file must name K1's kernel (a
    # trace with no device event at all is the profiler's failure to attach,
    # as in device_kernels: traced again, up to TRACE_ATTEMPTS times)
    cut = tracks[0][:, : 10 * SR]
    out = torch.empty((4, *cut.shape), device="cuda")
    for attempt in range(TRACE_ATTEMPTS):
        trace_dir = os.path.join(tmp, f"trace_{attempt}")
        time.sleep(TRACE_PAUSE_S)
        with device_trace(trace_dir) as prof:
            # block_on: the stage ends when the copy of the stems into ``out`` has
            with timer.stage("traced_demix", block_on=out):
                out.copy_(sep.demix(cut))
        files = [f for f in os.listdir(trace_dir) if f.endswith(".pt.trace.json")]
        require(len(files) == 1, f"device_trace wrote {files}")
        text = open(os.path.join(trace_dir, files[0])).read()
        if re.search(r'"cat"\s*:\s*"kernel"', text):
            break
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


def gpu_vs_cpu(model: str, mix, counters: dict, smi: str):
    """Phase 4b: the GPU path against the port's CPU path (plain
    versions of every kernel) on 5 s of the mix with 2 s segments, the
    storage seams pinned to float32 on both sides; the GPU run's launches
    by storage form (the float32 forms of K2/K3, counted with the counts
    set to 0 just before it and read just after).  Then the card's
    default (its "auto" seams: bfloat16) against the CPU with the three
    seams set to bfloat16 by name, within the seams' own gates, the
    rounding flips of the stems stack judged by the error's RMS.
    Returns (the float32 error, the form counts, the bf16 figures)."""
    import dataclasses

    import torch

    from umx_tpu_torch.config import EngineConfig, SegmentConfig
    from umx_tpu_torch.engine.separator import Separator

    cfg = EngineConfig(segment=SegmentConfig(segment_secs=2.0))
    short = mix[:, : 5 * SR]
    reset_counts(counters)
    gpu = Separator.from_ggml(model, f32_seams(cfg), "cuda").demix_track(short, seed=0)
    forms = form_counts()
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    cpu = Separator.from_ggml(model, f32_seams(cfg), "cpu").demix_track(short, seed=0)
    err = float(np.max(np.abs(gpu - cpu)) / np.max(np.abs(cpu)))
    print(f"GPU vs CPU port, 5 s at UMX-L width, float32 seams: max|err|/max|stem| {err:.3g}; "
          f"K2/K3 by storage form on the GPU run {forms}")
    # bf16 operands in the recurrence and cuFFT/cuBLAS summation order;
    # the same a-priori cap as the CPU tests' slice comparison class
    require(bool(np.isfinite(gpu).all()) and err <= 2e-3, f"GPU and CPU paths disagree: {err}")
    for name in ("wiener_reduce", "wiener_apply"):
        require(forms[name] > 0, f"the float32 seams' run launched no {name} in its f32 form")

    bf16 = cfg.replace(mask_dtype="bfloat16", stems_stack_dtype="bfloat16",
                       wiener=dataclasses.replace(cfg.wiener, out_dtype="bfloat16"))
    card = Separator.from_ggml(model, cfg, "cuda").demix_track(short, seed=0)
    cpu16 = Separator.from_ggml(model, bf16, "cpu").demix_track(short, seed=0)
    peak = float(np.max(np.abs(cpu16)))
    diff = (card - cpu16).astype(np.float64)
    fig = {"rel_err": float(np.max(np.abs(diff))) / peak,
           "rms_rel": float(np.sqrt(np.mean(diff * diff))) / peak}
    print(f"GPU default (bf16 seams) vs CPU with the three seams bfloat16 by name, 5 s: "
          f"max|err|/max|stem| {fig['rel_err']:.3g} (gate {SEAM_GATES['all three']}), RMS "
          f"{fig['rms_rel']:.3g} of the peak (gate 2e-3)  [{smi}]")
    # the dense class (2e-3) differs in the last float32 bits, so a bf16
    # rounding of the stack may flip (one bf16 step, ~4e-3 of the peak): the
    # largest error is held at the seams' gate, its RMS at the dense class
    require(bool(np.isfinite(card).all()) and fig["rel_err"] <= SEAM_GATES["all three"]
            and fig["rms_rel"] <= 2e-3, f"the card's bf16 default and the CPU's bf16 knobs "
            f"disagree: {fig}")
    return err, forms, fig


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
        # the session adds each segment's float32 output into its window, so
        # the offline run it equals keeps its stems stack in float32 (the
        # other seams round in the same places on both)
        offline = Separator(sep.params, sep.cfg.replace(shifts=0, stems_stack_dtype="float32"),
                            "cuda").demix(mix).cpu().numpy()
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


# the reference rows of the oracle-parity harness (waveform error, dB below
# the signal, then per stem bass/drums/other/vocals): the JAX package on a
# TPU v5e (PARITY_TPU_r5.json) and on the CPU (PARITY_FULLSCALE_r3.json; the
# port's ct2 beside its ct2_xla row)
PARITY_TPU = {"fp32": (45.1, [39.9, 46.4, 46.0, 44.1]), "pallas": (45.1, [39.9, 46.4, 46.0, 44.1]),
              "qhbm": (37.6, [31.0, 39.6, 39.2, 36.1]), "stream2": (44.3, [38.2, 46.0, 45.1, 43.9]),
              # PARITY_BF16_TPU.json
              "wiener_bf16": (45.8, [39.6, 47.7, 46.7, 45.1]),
              "wiener_f32": (45.8, [39.6, 47.7, 46.7, 45.1])}
PARITY_CPU = {"fp32": (119.6, [115.1, 121.2, 121.8, 116.7]),
              "qhbm": (38.2, [32.7, 39.2, 39.2, 37.5]),
              "ct2": (119.6, [115.1, 121.2, 121.8, 116.7]),
              "em2": (94.5, [103.4, 94.0, 93.1, 110.6]),
              "nowiener": (125.8, [123.6, 126.7, 127.1, 123.2]),
              "quirk": (111.9, [114.6, 118.6, 108.5, 115.7]),
              "stream2": (121.8, [116.0, 123.4, 122.9, 120.8])}
# 0.1 dB of SDR: by PARITY.md's formula, +-4.3 * 10^(-X/20) dB, an error
# X dB below the signal moves SDR by at most 0.1 dB from X = 32.7 on
PARITY_BOUND_DB = 32.7
# a quantized-weights stem may lie this far below the TPU's same stem
QHBM_STEM_SLACK_DB = 3.0
# the port's fp32 row on an H100 80GB HBM3 at 700 W before the card's
# "auto" became bfloat16 (the same program: every seam float32); the row
# with the seams pinned must stay within this much of it
PARITY_FP32_DB, PARITY_FP32_SLACK_DB = 73.5, 0.5


def parity_phase(dev, counters: dict, smi: str) -> tuple[dict, tuple, float]:
    """Phase 15: ``parity_fullscale`` at UMX-L production shape (hidden 1024,
    60 s, T 2584) on cuda, every port variant, each with its kernels'
    launches read; the oracle runs on the host CPU.  Returns (its
    figures, K1's inputs at the half-segment shape of stream2, K1's
    error there)."""
    import torch

    from umx_tpu_torch.models import umx
    from umx_tpu_torch.scripts import parity_fullscale as pf

    t_phase = time.perf_counter()
    par = pf.Parity(hidden=1024, seg_secs=60.0, device="cuda")
    require(par.n_frames == T_SEG, f"parity segment of {par.n_frames} frames, not {T_SEG}")
    # what each variant must launch beyond the Wiener and recurrence
    # kernels every dense row runs
    # K2/K3 by storage form ("form <kernels line name>"): every row but
    # auto pins the seams to float32, so its passes run the float32 forms
    k23 = ("form wiener_reduce", "form wiener_apply")
    expect = {
        "fp32": ("lstm_merged", *k23),
        "qhbm": ("lstm_merged", *k23),
        "pallas": ("lstm_merged", *k23),
        "pertarget": ("lstm_layer_pertarget", *k23),
        "scan": ("lstm_scan", *k23),
        "ct2": ("lstm_merged", "istft_ct2", *k23),
        "em2": ("lstm_merged", *k23, "form wiener_reduce_y", "form wiener_apply_y"),
        "nowiener": ("lstm_merged",),
        "quirk": ("lstm_merged",),
        "stream2": ("lstm_merged", *k23),
        "wiener_bf16": ("lstm_merged", "form wiener_reduce", "form wiener_apply_f32_masks_bf16_out"),
        "wiener_f32": ("lstm_merged", *k23),
        # the card's default seams: K2/K3 read bf16 masks, K3 writes bf16
        "auto": ("lstm_merged", "form wiener_reduce_bf16", "form wiener_apply_bf16"),
    }
    rows, launches, oracle_s, ours_s = [], {}, {}, {}
    k1_shapes: set = set()
    for v in pf.PORT_VARIANTS:
        t0 = time.perf_counter()
        waves_oracle = (par.oracle_stream2() if v == "stream2"
                        else par.oracle(**par.variant_config(v)[2]))
        oracle_s[v] = time.perf_counter() - t0
        reset_counts(counters)
        seen: set = set()
        t0 = time.perf_counter()
        with recording(umx, "lstm_layer_merged_batched", lambda x, *a: (x.shape[0], x.shape[2]),
                       seen):
            waves = par.ours(v)
        torch.cuda.synchronize()
        ours_s[v] = time.perf_counter() - t0
        n = {name: fn.launches for name, fn in counters.items() if fn.launches}
        n.update({f"form {k}": c for k, c in form_counts().items() if c})
        launches[v] = n
        missing = [k for k in expect[v] if not n.get(k)]
        require(not missing, f"parity variant {v} launched no {missing}: {n}")
        row = pf.err_row(v, waves, waves_oracle, par.seg_secs, par.hidden, par.device, par.card)
        rows.append(row)
        if v == "stream2":
            k1_shapes = seen
            require(n.get("lstm_merged") == 6 and seen == {(1, T_SEG // 2)},
                    f"stream2 ran K1 {n.get('lstm_merged')} times at {sorted(seen)}, not 3 layers "
                    f"x 2 halves at (1, {T_SEG // 2})")
        tpu, cpu = PARITY_TPU.get(v), PARITY_CPU.get(v)
        print(f"parity {v}: {row['waveform_err_db']} dB below the signal, stems "
              f"{row['per_stem_err_db']}; TPU row {tpu[0] if tpu else '-'} "
              f"{tpu[1] if tpu else ''}, CPU row {cpu[0] if cpu else '-'} "
              f"{cpu[1] if cpu else ''}; max rel err {row['waveform_max_rel_err']:.3g}; "
              f"oracle {oracle_s[v]:.1f} s (host), port {ours_s[v]:.2f} s; kernel runs {n}"
              f"  [{smi}]")
    print(json.dumps(rows))
    pf.print_table(rows)
    fp32 = next(r["waveform_err_db"] for r in rows if r["variant"] == "fp32")
    require(abs(fp32 - PARITY_FP32_DB) <= PARITY_FP32_SLACK_DB,
            f"parity fp32 (float32 seams): {fp32} dB, not within {PARITY_FP32_SLACK_DB} dB of "
            f"the port's earlier {PARITY_FP32_DB}")
    for row in rows:
        v, whole, stems = row["variant"], row["waveform_err_db"], row["per_stem_err_db"]
        require(whole >= PARITY_BOUND_DB,
                f"parity {v}: waveform error {whole} dB below the signal, bound {PARITY_BOUND_DB}")
        if v == "qhbm":
            low = [(s, t) for s, t in zip(stems, PARITY_TPU["qhbm"][1])
                   if s < t - QHBM_STEM_SLACK_DB]
            require(not low, f"parity qhbm: stems {stems} more than {QHBM_STEM_SLACK_DB} dB "
                    f"below the TPU's {PARITY_TPU['qhbm'][1]}")
            under = [s for s in stems if s < PARITY_BOUND_DB]
            if under:
                print(f"parity qhbm: stems {under} lie under {PARITY_BOUND_DB} dB (a finding, "
                      f"as the TPU's bass stem at 31.0 dB)")
        else:
            require(min(stems) >= PARITY_BOUND_DB,
                    f"parity {v}: stems {stems} dB below the signal, bound {PARITY_BOUND_DB}")
    # K1 at the half-segment shape stream2 gave it, against its plain version
    (B, T), = k1_shapes
    k1_args, k1_err = check_lstm(dev, T, B, seed=150)
    wall = time.perf_counter() - t_phase
    print(f"parity phase: {wall:.1f} s wall, oracle {sum(oracle_s.values()):.1f} s of it on the "
          f"host  [{smi}]")
    return ({"rows": rows, "launches": launches, "oracle_s": oracle_s, "port_s": ours_s,
             "wall_s": wall, "card": smi}, ((B, T), k1_args), k1_err)


CERT_FLEET_TRACKS = 10  # fleet_certify's --tracks in the smoke (its default is 50)
CERT_GOLDEN_SECS = 20.0  # the cut of phase 4's WAV that the golden inference demixes
# the long track's stems against its mix: corr over the track at least
# this, and over its first and last tenth within this of each other
LONGTRACK_MIN_CORR, LONGTRACK_DRIFT = 0.97, 0.005


def certification_phase(tmp: str, model: str, mix, counters: dict, smi: str) -> dict:
    """Phase 16: the port's certification tools on the card.  The converter
    on four UMX-L ``.pth`` files; ``e2e_test`` hermetic; the golden
    inference (host CPU) on a 20 s cut of phase 4's WAV beside the port's
    CLI on it; ``fleet_certify`` on a reduced MUSDB-shaped set;
    ``serve_bench`` at its defaults; ``longtrack_probe`` at 1800 s.
    Returns its figures."""
    import gzip

    import torch
    from scipy.io import wavfile

    from umx_tpu_torch import cli
    from umx_tpu_torch.config import ModelConfig
    from umx_tpu_torch.models.umx import synthetic_state_dicts
    from umx_tpu_torch.scripts import (
        convert_umx_pth_to_ggml as conv, e2e_test, fleet_certify, longtrack_probe, serve_bench,
        umx_golden_inference,
    )

    t_phase = time.perf_counter()
    fig: dict = {"card": smi}

    # 1. the converter: the state dicts of phase 4's model as torchhub
    # checkpoints (with the keys it skips) -> ggml, equal to phase 4's file
    t0 = time.perf_counter()
    ckpt = os.path.join(tmp, "hub")
    os.makedirs(ckpt)
    sds = synthetic_state_dicts(ModelConfig(hidden_size=1024), seed=0)
    for target, fname in conv.HUB_FILES["umxl"].items():
        sd = {k: torch.from_numpy(v) for k, v in sds[target].items()}
        sd.update({"stft.window": torch.ones(4096), "sample_rate": torch.tensor(44100.0),
                   "transform.0.window": torch.ones(4096)})
        sd.update({f"bn{i}.num_batches_tracked": torch.tensor(7) for i in (1, 2, 3)})
        torch.save(sd, os.path.join(ckpt, fname))
    del sds
    rc, _ = _run_main(conv.main, ["--model", "umxl", "--ckpt-dir", ckpt, "--gzip",
                                  os.path.join(tmp, "converted")])
    require(rc == 0, f"the converter exited {rc}")
    with gzip.open(os.path.join(tmp, "converted", "ggml-model-umxl-u8.bin.gz"), "rb") as f:
        converted = f.read()
    with open(model, "rb") as f:
        require(converted == f.read(), "the converted ggml differs from write_ggml of the same "
                "state dicts")
    fig["convert_s"] = time.perf_counter() - t0
    print(f"converter: 4 UMX-L .pth files -> ggml, {len(converted)} bytes equal to write_ggml's; "
          f"{fig['convert_s']:.1f} s")

    # 2. the end-to-end test, hermetic, on the card
    t0 = time.perf_counter()
    rc, out = _run_main(e2e_test.main, [])
    require(rc == 0 and "e2e OK" in out, "e2e_test did not print e2e OK")
    fig["e2e_s"] = time.perf_counter() - t0

    # 3. the golden inference (host CPU) on a 20 s cut, beside the port's CLI
    n = int(CERT_GOLDEN_SECS * SR)
    cut = os.path.join(tmp, "cut20.wav")
    wavfile.write(cut, SR, np.ascontiguousarray(mix[:, :n].T))
    t0 = time.perf_counter()
    rc, _ = _run_main(umx_golden_inference.main, [model, cut, os.path.join(tmp, "golden")])
    fig["golden_s"] = time.perf_counter() - t0
    require(rc == 0, f"the golden inference exited {rc}")
    golden = check_stems(os.path.join(tmp, "golden"), mix[:, :n])
    rc = cli.main([model, cut, os.path.join(tmp, "cut_cli"), "--quiet"])
    require(rc == 0, f"the CLI exited {rc} on the 20 s cut")
    ported = check_stems(os.path.join(tmp, "cut_cli"), mix[:, :n])
    sig = float(np.sum(golden.astype(np.float64) ** 2))
    err = float(np.sum((ported.astype(np.float64) - golden) ** 2))
    fig["golden_vs_cli_err_db"] = 10 * math.log10(sig / max(err, 1e-30))
    print(f"golden inference (host CPU, {fig['golden_s']:.1f} s) against the port's CLI on the "
          f"card, {CERT_GOLDEN_SECS:.0f} s cut: error {fig['golden_vs_cli_err_db']:.1f} dB below "
          f"the golden stems (printed, not gated)  [{smi}]")

    def launched(name: str) -> dict:
        n = {k: fn.launches for k, fn in counters.items() if fn.launches}
        require(all(n.get(k) for k in ("lstm_merged", "wiener_reduce", "wiener_apply")),
                f"{name} did not launch K1-K3: {n}")
        return n

    # 4. the fleet certification on a reduced MUSDB-shaped set
    reset_counts(counters)
    t0 = time.perf_counter()
    rc, out = _run_main(fleet_certify.main, ["--tracks", str(CERT_FLEET_TRACKS)])
    require(rc == 0, f"fleet_certify exited {rc}")
    fig["fleet"] = json.loads(out.strip().splitlines()[-1])
    fig["fleet"]["launches"] = launched("fleet_certify")
    fig["fleet_s"] = time.perf_counter() - t0

    # 5. serving at the bench's defaults (4 clients, 30 s tracks, max_batch
    # 4), on phase 4's model (the same synthetic UMX-L weights)
    reset_counts(counters)
    t0 = time.perf_counter()
    rc, out = _run_main(serve_bench.main, ["--model", model])
    require(rc == 0, f"serve_bench exited {rc}")
    fig["serve"] = json.loads(out.strip().splitlines()[-1])
    fig["serve"]["launches"] = launched("serve_bench")
    fig["serve_s"] = time.perf_counter() - t0
    s = fig["serve"]
    print(f"serve_bench: latency p50 {s['latency_p50_s']} s, p95 {s['latency_p95_s']} s, p99 "
          f"{s['latency_p99_s']} s; {s['aggregate_xrt']}x realtime in aggregate, "
          f"{s['device_xrt']}x on the device; avg_batch_fill "
          f"{s['autoscaling']['avg_batch_fill']}  [{smi}]")

    # 6. the 30-minute track
    reset_counts(counters)
    t0 = time.perf_counter()
    lt = longtrack_probe.probe(torch.device("cuda"))  # raises on non-finite stems
    lt["launches"] = launched("longtrack_probe")
    fig["longtrack"] = lt
    fig["longtrack_s"] = time.perf_counter() - t0
    print(f"longtrack_probe: {lt['secs']:.0f} s, {lt['chunks']} chunks, route {lt['route']}, "
          f"planner {lt['planner_gib']:.2f} GiB of device_hbm_bytes {lt['device_gib']:.2f} GiB, "
          f"{lt['xrt']:.1f}x realtime, corr(sum of stems, mix) {lt['corr']:.6f} (first tenth "
          f"{lt['corr_first_tenth']:.6f}, last {lt['corr_last_tenth']:.6f})  [{smi}]")
    require(lt["route"] == "one program" or lt["planner_gib"] > 0.9 * lt["device_gib"],
            f"the long track ran in {lt['route']} though the planner's estimate fits")
    # the synthetic weights zero every target's mask in some bins of this
    # signal, so the stems do not partition all of it: the JAX package's
    # separator gives the port's corr on it (0.97624 on 4 s at 2 s
    # segments, tests/test_torch_tools.py)
    require(lt["corr"] >= LONGTRACK_MIN_CORR,
            f"long track: corr(sum of stems, mix) {lt['corr']} under {LONGTRACK_MIN_CORR}")
    require(abs(lt["corr_first_tenth"] - lt["corr_last_tenth"]) <= LONGTRACK_DRIFT,
            f"long track: the partition drifts along the track: first tenth "
            f"{lt['corr_first_tenth']}, last {lt['corr_last_tenth']}")
    fig["wall_s"] = time.perf_counter() - t_phase
    print(f"certification phase: {fig['wall_s']:.1f} s wall  [{smi}]")
    return fig


# Phase 17: the device mesh on the one card, its devices repeated
MESH_OFFSETS = (0.0, 10.0, 20.0, 40.0)  # s: four 60 s segments cut from phase 4's track
MESH_TRAIN_STEPS = 3
# The sharded train step against the unsharded one.  Its first loss and
# gradients differ only in the order of f32 sums (the dp rows' weight
# gradients are summed per row, then added); after an update AdamW divides
# each element's step by its own gradient, so an element whose gradient is
# at the rounding level moves by up to the learning rate either way, and
# the losses drift apart with the updates: the losses of steps 2 and 3
# within 1e-4 (2.6e-7 measured at UMX-L on an H100), the loss of the
# parameters after the third update within 1e-2 (7.1e-4 measured), which
# still catches a wrong slice or a lost gradient
MESH_FIRST_LOSS_RTOL, MESH_GRAD_RTOL, MESH_LATER_LOSS_RTOL, MESH_TRAINED_RTOL = (
    1e-5, 1e-4, 1e-4, 1e-2)


def check_train_kernels_at(dev, R, B, T, seed):
    """K4, K5 and K6 against their plain versions at R chains, B rows per
    chain, T steps, G = 512 (the bounds of phase 5).  Returns ((K4 args,
    K5 args, K6 args), max|err| of each)."""
    from umx_tpu_torch.ops import lstm_cuda as L

    (xp, whh, h0, c0, _), (dhs, dhT, dcT) = train_inputs_at(dev, T, R, B, G_HIDDEN, seed)
    fwd_k = L.lstm_merged_train_fwd(xp, whh, h0, c0, B)
    fwd_p = L.lstm_merged_train_fwd_plain(xp, whh, h0, c0, B)
    fwd = max(max_err(a, b) for a, b in zip(fwd_k, fwd_p))
    hs, _, _, gates, cs = fwd_p
    dxp_k, dh0_k, dc0_k = L.lstm_merged_bwd_step(gates, cs, c0, whh, dhs, dhT, dcT, B)
    dxp_p, dw_p, dh0_p, dc0_p = L.lstm_merged_bwd_plain(gates, cs, hs, h0, c0, whh, dhs, dhT,
                                                        dcT, B)
    bwd = max(rel_err(dxp_k, dxp_p), rel_err(dh0_k, dh0_p), rel_err(dc0_k, dc0_p))
    dw = rel_err(L.lstm_merged_dw(hs, h0, dxp_p, B), dw_p)
    print(f"training kernels vs plain (T={T}, R={R}, B={B}, G={G_HIDDEN}): K4 max|err| {fwd:.3g}, "
          f"K5 max|err|/max|ref| {bwd:.3g}, K6 on the plain dxp {dw:.3g}")
    require(fwd <= 5e-3 and bwd <= 5e-3 and dw <= 1e-5,
            f"a training kernel disagrees with its plain version at R={R}, B={B}: "
            f"{fwd}, {bwd}, {dw}")
    args = ((xp, whh, h0, c0, B), (gates, cs, c0, whh, dhs, dhT, dcT, B), (hs, h0, dxp_p, B))
    return args, (fwd, bwd, dw)


def dw_bmm_ms(hs, h0, dxp, B) -> float:
    """Milliseconds of ``torch.bmm`` f32 on K6's operands (bf16-rounded
    h_{t-1} and dxp, chain-major): the one PyTorch call that computes K6's
    function."""
    import torch

    T, RB, G = hs.shape
    R = RB // B
    hp = torch.cat([h0[None], hs[:-1]]).to(torch.bfloat16).float().view(
        T, R, B, G).permute(1, 3, 0, 2).reshape(R, G, -1)
    dg = dxp.to(torch.bfloat16).float().view(T, R, B, 4 * G).permute(
        1, 0, 2, 3).reshape(R, -1, 4 * G)
    return cuda_ms(lambda: torch.bmm(hp, dg), 10)


def dw_prerounded(hs, h0, dxp, B):
    """K6's operands rounded to bf16 and laid out chain-major outside any
    timing: h_{t-1} as (R, G, T*B), dxp as (R, T*B, 4G)."""
    import torch

    T, RB, G = hs.shape
    R = RB // B
    hp = torch.cat([h0[None], hs[:-1]]).to(torch.bfloat16).view(
        T, R, B, G).permute(1, 3, 0, 2).reshape(R, G, -1)
    dg = dxp.to(torch.bfloat16).view(T, R, B, 4 * G).permute(1, 0, 2, 3).reshape(R, -1, 4 * G)
    return hp, dg


def dw_bmm_bf16_ms(hs, h0, dxp, B) -> float:
    """Milliseconds of ``torch.bmm(bf16, bf16, out_dtype=torch.float32)`` on
    K6's operands (h_{t-1} and dxp rounded to bf16, chain-major; f32 sums
    and output): K6's function as one PyTorch call on bf16 operands (the
    ``aten::bmm.dtype`` overload, which torch has for CUDA only), a
    yardstick beside the f32 call of :func:`dw_bmm_ms`."""
    import torch

    hp, dg = dw_prerounded(hs, h0, dxp, B)
    return cuda_ms(lambda: torch.bmm(hp, dg, out_dtype=torch.float32), 10)


def dw_library_sequence(hs, h0, dxp, B: int):
    """K6's function as the library computes it from K6's own f32 inputs:
    each operand rounded to bf16 and laid out chain-major in one copy
    (h_{t-1} as (R, T*B, G), dxp as (R, T*B, 4G)), then
    ``torch.bmm(bf16, bf16, out_dtype=torch.float32)`` with h_{t-1}
    transposed as a view; the yardstick K6's Hopper form is gated against,
    timed as one region."""
    import torch

    T, RB, G = hs.shape
    R = RB // B
    hp = torch.empty((R, T, B, G), dtype=torch.bfloat16, device=hs.device)
    hp[:, 0].copy_(h0.view(R, B, G))
    hp[:, 1:].copy_(hs[:-1].view(T - 1, R, B, G).permute(1, 0, 2, 3))
    dg = torch.empty((R, T, B, 4 * G), dtype=torch.bfloat16, device=hs.device)
    dg.copy_(dxp.view(T, R, B, 4 * G).permute(1, 0, 2, 3))
    return torch.bmm(hp.view(R, T * B, G).transpose(1, 2), dg.view(R, T * B, 4 * G),
                     out_dtype=torch.float32)


def dw_bound(hs, h0, dxp, B: int):
    """K6's bound: hs, h0 and dxp read and dW (R, G, 4G) f32 written once,
    or 2 R G 4G T B bf16 operations, whichever is longer."""
    T, RB, G = hs.shape
    return bound_ms(nbytes(hs, h0, dxp) + (RB // B) * G * 4 * G * 4, 2.0 * T * RB * G * 4 * G,
                    "bf16")


def dw_inputs(dev, T, R, B, G, seed):
    """Random f32 hs (tanh-sized), h0 and dxp at a K6 shape."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    hs = torch.tanh(torch.randn((T, R * B, G), generator=g, device=dev))
    h0 = torch.tanh(torch.randn((R * B, G), generator=g, device=dev))
    dxp = 0.1 * torch.randn((T, R * B, 4 * G), generator=g, device=dev)
    return hs, h0, dxp, B


def time_dw_at(dev, T, R, B, G, seed, smi: str, f32_in_turns: bool = False) -> dict:
    """K6 at one shape a path gives it: against its plain version (1e-5 of
    max|ref|) and bit-stable, then timed in turns with the library sequence,
    its mma.sync form and the one call on pre-rounded operands, beside the
    f32 torch.bmm (``f32_in_turns``: in the turns too) and its bound."""
    import torch

    from umx_tpu_torch.ops import lstm_cuda as L

    args = dw_inputs(dev, T, R, B, G, seed)
    dw = L.lstm_merged_dw(*args)
    torch.cuda.synchronize()
    form = L.lstm_merged_dw.form
    ref = L.lstm_merged_dw_plain(*args)
    err, err_lib = rel_err(dw, ref), rel_err(dw_library_sequence(*args), ref)
    mma = L.lstm_merged_dw(*args, _form="mma_sync")
    err_mma = rel_err(mma, ref)
    stable = torch.equal(dw, L.lstm_merged_dw(*args))
    # each against the same product summed in float64
    hs, h0, dxp, _ = args
    hp = torch.cat([h0[None], hs[:-1]]).to(torch.bfloat16).double().view(
        T, R, B, G).permute(1, 3, 0, 2).reshape(R, G, -1)
    dg = dxp.to(torch.bfloat16).double().view(T, R, B, 4 * G).permute(1, 0, 2, 3).reshape(
        R, -1, 4 * G)
    ref64 = torch.bmm(hp, dg)
    del hp, dg
    f64 = {name: rel_err(x.double(), ref64) for name, x in
           (("kernel", dw), ("mma_sync", mma), ("plain", ref))}
    del ref64, mma
    print(f"lstm_merged_dw T {T}, R {R}, B {B}, G {G}: max|err|/max|ref| against the float64 "
          f"sum: " + ", ".join(f"{k} {v:.3g}" for k, v in f64.items()), flush=True)
    # the mma_sync form, the yardstick, sums in the tensor cores over the
    # whole chain: its figures are printed, not held to 1e-5
    require(err <= 1e-5 and stable and form[0] == L.dw_form(G),
            f"lstm_merged_dw at T {T}, R {R}, B {B}, G {G}: form {form}, max|err|/max|ref| "
            f"{err}, bit-stable {stable}")
    hp, dg = dw_prerounded(*args)
    fns = {"ms": lambda: L.lstm_merged_dw(*args),
           "library_sequence_ms": lambda: dw_library_sequence(*args),
           "mma_sync_ms": lambda: L.lstm_merged_dw(*args, _form="mma_sync"),
           "prerounded_bmm_bf16_ms": lambda: torch.bmm(hp, dg, out_dtype=torch.float32)}
    if f32_in_turns:
        hf, df = hp.float(), dg.float()
        fns["bmm_f32_ms"] = lambda: torch.bmm(hf, df)
    t = turns_ms(fns, 10, f"lstm_merged_dw T{T}_R{R}_B{B}_G{G}")
    del hp, dg
    row = {"form": form, "plan": tuple(L.lstm_merged_dw.plan), "max_rel_err": err,
           "max_abs_err": max_err(dw, ref),
           "float64_rel_err": f64, "library_sequence_rel_err": err_lib,
           "mma_sync_rel_err": err_mma, **t,
           "plain_ms": cuda_ms(lambda: L.lstm_merged_dw_plain(*args), 2)}
    if not f32_in_turns:
        row["bmm_f32_ms"] = dw_bmm_ms(*args)
    row["bound_ms"], row["bound_by"] = dw_bound(*args)
    print(f"lstm_merged_dw T {T}, R {R}, B {B}, G {G}: form {form}, max|err|/max|ref| {err:.3g} "
          f"(mma_sync form {err_mma:.3g}); in turns: {t['ms']:.4f} ms, the library sequence "
          f"{t['library_sequence_ms']:.4f}, the mma_sync form {t['mma_sync_ms']:.4f}, "
          f"torch.bmm(bf16, bf16, out_dtype=float32) on pre-rounded operands "
          f"{t['prerounded_bmm_bf16_ms']:.4f}; plain {row['plain_ms']:.4f}, torch.bmm f32 "
          f"{row['bmm_f32_ms']:.4f}, bound {row['bound_ms']:.4f} ms by {row['bound_by']}  "
          f"[{smi}]", flush=True)
    return row


def time_istft_register(dev, n: int, smi: str) -> dict:
    """K8's register form at n_fft ``n`` on 8 rows of a 60 s segment (T =
    2646000 / hop + 1 frames), windowed: against its plain version and a
    float64 CPU reference on 2 rows (1e-5), bit-stable, its radices the
    register plan's; then in turns with its mixed-radix yardstick
    (``_form="mixed_radix"``, held to the same bounds) and torch.istft,
    beside its plain version and bound."""
    import torch

    from umx_tpu_torch.ops import istft_ct, istft_ct_cuda as K
    from umx_tpu_torch.ops.stft import hann_window

    hop, F = n // 4, n // 2 + 1
    T = SEG // hop + 1
    g = torch.Generator(device=dev).manual_seed(n)
    re = torch.randn((ISTFT_ROWS, T, F), generator=g, device=dev)
    im = torch.randn((ISTFT_ROWS, T, F), generator=g, device=dev)
    w = hann_window(n, dev)
    args = (re, im, n, hop, w)
    out = K.istft_ct2(*args)
    torch.cuda.synchronize()
    form = K.istft_ct2.form
    plain = istft_ct.istft_ct2_plain(*args)
    err = max_err(out, plain)
    f64 = istft_ct.istft_ct2_plain(re[:2].cpu().double(), im[:2].cpu().double(), n, hop,
                                   w.cpu().double())
    err64 = float((out[:2].cpu().double() - f64).abs().max())
    mr = K.istft_ct2(*args, _form="mixed_radix")
    err_mr = max_err(mr, plain)
    same = torch.equal(out, K.istft_ct2(*args))
    del f64, mr
    require(err <= 1e-5 and err64 <= 1e-5 and err_mr <= 1e-5 and same
            and form[2] == K.istft_register_plan(n),
            f"istft_ct2's register form at n_fft {n}: max|err| {err} vs plain, {err64} vs "
            f"float64, mixed-radix form {err_mr}, bit-stable {same}, form {form}")
    spec = torch.complex(re, im).transpose(-1, -2).contiguous()
    spec.imag[:, 0] = 0.0
    spec.imag[:, -1] = 0.0
    t = turns_ms({"ms": lambda: K.istft_ct2(*args),
                  "mixed_radix_ms": lambda: K.istft_ct2(*args, _form="mixed_radix"),
                  "library_ms": lambda: torch.istft(spec, n_fft=n, hop_length=hop, window=w,
                                                    center=True, normalized=False, onesided=True,
                                                    length=(T - 1) * hop)},
                 10, f"istft_ct2 register n_fft {n}")
    del spec
    row = {"rows": ISTFT_ROWS, "frames": T, "form": form, "max_abs_err": err,
           "float64_err": err64, "mixed_radix_err": err_mr, **t, "args": args,
           "plain_ms": cuda_ms(lambda: istft_ct.istft_ct2_plain(*args), 3),
           "smem": K.istft_block_layout(dev.index, n)[1]}
    row["bound_ms"], row["bound_by"] = bound_ms(
        2 * ISTFT_ROWS * T * F * 4 + ISTFT_ROWS * ((T - 1) * hop + n) * 4,
        ISTFT_ROWS * T * (2.5 * n * math.log2(n) + 2 * n), "f32")
    print(f"istft_ct2 register form at n_fft {n} ({ISTFT_ROWS} rows x {T} frames), radices "
          f"{form[2]}, runs {form[:2]}: max|err| vs plain {err:.3g}, vs float64 {err64:.3g}; "
          f"bit-stable; in turns {t['ms']:.4f} ms, mixed-radix form {t['mixed_radix_ms']:.4f}, "
          f"torch.istft {t['library_ms']:.4f}; plain {row['plain_ms']:.4f}, bound "
          f"{row['bound_ms']:.4f} ms by {row['bound_by']}  [{smi}]", flush=True)
    return row


def train_inputs_at(dev, T, R, B, G, seed):
    """:func:`train_inputs` at R chains."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    RB = R * B
    xp = torch.randn((T, RB, 4 * G), generator=g, device=dev)
    whh = (torch.randn((R, G, 4 * G), generator=g, device=dev) / G**0.5).to(torch.bfloat16)
    h0 = 0.5 * torch.randn((RB, G), generator=g, device=dev)
    c0 = 0.5 * torch.randn((RB, G), generator=g, device=dev)
    cts = tuple(torch.randn(shape, generator=g, device=dev)
                for shape in ((T, RB, G), (RB, G), (RB, G)))
    return (xp, whh, h0, c0, B), cts


def check_pertarget_at(dev, n_targets, T, G, seed):
    """K9 against its plain version at ``n_targets`` targets (a tp slice)."""
    import torch

    from umx_tpu_torch.ops import lstm_cuda as L

    g = torch.Generator(device=dev).manual_seed(seed)
    args = (torch.randn((n_targets, T, 2, 4 * G), generator=g, device=dev),
            (torch.randn((n_targets, 2, G, 4 * G), generator=g, device=dev)
             / G**0.5).to(torch.bfloat16),
            0.5 * torch.randn((n_targets, 2, G), generator=g, device=dev),
            0.5 * torch.randn((n_targets, 2, G), generator=g, device=dev))
    err = max(max_err(a, b) for a, b in
              zip(L.lstm_layer_pertarget(*args), L.lstm_pertarget_plain(*args)))
    print(f"lstm_layer_pertarget vs plain (T={T}, T#={n_targets}, D=2, G={G}): max|err| {err:.3g}; "
          f"form {L.lstm_layer_pertarget.form}")
    require(err <= 5e-3, f"lstm_layer_pertarget disagrees with plain at T#={n_targets}: {err}")
    return args, err


def mesh_phase(dev, tmp: str, model: str, mix, bucket, counters: dict, smi: str) -> dict:
    """Phase 17: the device mesh at UMX-L width on the one card, the grid's
    devices repeated (``[cuda:0] * 4``): ``make_mesh()``; the sharded
    segment demix at dp 4 (bit-equal to the unsharded batch) and dp 2 x tp
    2 (and its combine audit), one tp 2 call with the per-target kernel;
    the fleet over dp 2 (bit-equal to the fleet without a mesh); the
    sharded train step over dp 2 x tp 2 against the unsharded step;
    ``train_umx --mesh``; every kernel shape the phase gives held against
    its plain version, K1, K4-K6 and K9 there timed."""
    import dataclasses

    import torch

    from umx_tpu_torch.config import DSPConfig, ModelConfig
    from umx_tpu_torch.engine.fleet import demix_tracks
    from umx_tpu_torch.engine.separator import Separator, segment_forward_batched
    from umx_tpu_torch.models import umx
    from umx_tpu_torch.models.umx import synthetic_params
    from umx_tpu_torch.ops import lstm_cuda as L
    from umx_tpu_torch.ops import wiener
    from umx_tpu_torch.parallel.mesh import make_mesh
    from umx_tpu_torch.parallel.sharding import (
        audit_collectives, batched_lstm_state, demix_segments_batch,
    )
    from umx_tpu_torch.scripts import train_umx
    from umx_tpu_torch.train import (
        FROZEN, TrainConfig, init_train_state, make_batch_from_audio, make_eval_step,
        make_sharded_train_step, make_train_step,
    )

    t_phase = time.perf_counter()
    fig: dict = {"card": smi}
    mesh = make_mesh()
    line = f"mesh: {dict(mesh.shape)} over {len(mesh.devices.flat)} device(s)"
    print(f"mesh phase: make_mesh() -> {line}  [{smi}]")
    require(dict(mesh.shape) == {"dp": 1, "tp": 1} and len(mesh.devices.flat) == 1,
            f"make_mesh() on one card gave {line}")
    card = mesh.devices[0, 0]
    grid = [card] * 4
    print(f"the grid's devices repeat ({card} x 4): every shard runs on the one card, so no "
          f"copy between cards is made or timed")

    sep = Separator.from_ggml(model, device=card)
    cfg = sep.cfg
    n = cfg.segment.segment_samples(SR)
    batch = torch.from_numpy(np.stack([mix[:, int(o * SR) : int(o * SR) + n]
                                       for o in MESH_OFFSETS])).to(card)
    states = batched_lstm_state(cfg, len(MESH_OFFSETS), card)
    with torch.inference_mode():
        ref, ref_st = segment_forward_batched(sep.params, batch, states, cfg, n)

    k1_shapes, k23_shapes, k9_shapes, train_shapes = set(), set(), set(), set()
    spies = contextlib.ExitStack()
    def k1_or_k4(x, hh, *a):
        # the layer runs K4 (K5 + K6 backward) where a gradient is wanted, else K1
        shape = (x.shape[1] * x.shape[3], x.shape[0], x.shape[2])
        if torch.is_grad_enabled() and (x.requires_grad or hh.requires_grad):
            train_shapes.add(shape)
            return None
        return shape

    spies.enter_context(recording(umx, "lstm_layer_merged_batched", k1_or_k4, k1_shapes))
    spies.enter_context(recording(wiener, "wiener_planes_from_masks",
                                  lambda xre, xim, m, *a: (m.shape[0], *xre.shape[1:]), k23_shapes))
    spies.enter_context(recording(umx, "lstm_layer_pertarget_batched",
                                  lambda x, *a: (x.shape[1], x.shape[2], x.shape[-1] // 4),
                                  k9_shapes))
    with spies:
        # dp 4: each dp row runs one segment; bit-equal to the batch
        reset_counts(counters)
        dp_mesh = make_mesh(4, 1, grid)
        out, st = demix_segments_batch(sep.params, batch, states, cfg, dp_mesh)
        dp_launches = {k: fn.launches for k, fn in counters.items() if fn.launches}
        dp_equal = bool(torch.equal(out, ref) and torch.equal(st.h, ref_st.h)
                        and torch.equal(st.c, ref_st.c))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        demix_segments_batch(sep.params, batch, states, cfg, dp_mesh)
        torch.cuda.synchronize()
        dp_s = time.perf_counter() - t0
        audio_s = len(MESH_OFFSETS) * n / SR
        print(f"sharded demix, dp 4 x 60 s segments (UMX-L): bit-equal to the unsharded batch: "
              f"{dp_equal}; warm {dp_s:.3f} s = {audio_s / dp_s:.1f}x realtime; kernel runs "
              f"{dp_launches}  [{smi}]")
        require(dp_equal, "the dp-sharded demix is not bit-equal to the unsharded batch")
        require(all(dp_launches.get(k, 0) > 0 for k in ("lstm_merged", "wiener_reduce",
                                                        "wiener_apply")),
                f"the dp-sharded demix did not launch K1-K3: {dp_launches}")
        require(audit_collectives(sep.params, batch, states, cfg, dp_mesh) == [],
                "the dp-sharded demix combines across devices")

        # dp 2 x tp 2: each tp device runs two targets' mask network
        reset_counts(counters)
        tp_mesh = make_mesh(2, 2, grid)
        out_tp, st_tp = demix_segments_batch(sep.params, batch, states, cfg, tp_mesh, tp=True)
        tp_launches = {k: fn.launches for k, fn in counters.items() if fn.launches}
        tp_err = float((out_tp - ref).abs().max() / ref.abs().max())
        tp_equal = bool(torch.equal(out_tp, ref) and torch.equal(st_tp.h, ref_st.h))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        demix_segments_batch(sep.params, batch, states, cfg, tp_mesh, tp=True)
        torch.cuda.synchronize()
        tp_s = time.perf_counter() - t0
        audit = audit_collectives(sep.params, batch, states, cfg, tp_mesh, tp=True)
        print(f"sharded demix, dp 2 x tp 2: max|err|/max|stem| {tp_err:.3g} against the unsharded "
              f"batch, bit-equal: {tp_equal}; warm {tp_s:.3f} s = {audio_s / tp_s:.1f}x realtime; "
              f"kernel runs {tp_launches}; combines {audit}  [{smi}]")
        # each chain's and each target's arithmetic does not depend on what
        # runs beside it (bit-equal at UMX-L on an H100, measured)
        require(tp_equal, f"the tp-sharded demix is not bit-equal to the unsharded batch: "
                f"{tp_err}")
        require(audit and len(audit) <= 4 and all(a.startswith("all-gather") for a in audit),
                f"the tp-sharded demix's combines: {audit}")

        # one tp 2 call at lstm_impl="pallas": K9 at two targets
        pcfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, lstm_impl="pallas"))
        reset_counts(counters)
        one_state = batched_lstm_state(cfg, 1, card)
        with torch.inference_mode():
            pref, _ = segment_forward_batched(sep.params, batch[:1], one_state, pcfg, n)
        k9_alone = counters["lstm_layer_pertarget"].launches
        reset_counts(counters)
        pout, _ = demix_segments_batch(sep.params, batch[:1], one_state, pcfg,
                                       make_mesh(1, 2, grid), tp=True)
        k9_launches = counters["lstm_layer_pertarget"].launches
        k9_err = float((pout - pref).abs().max() / pref.abs().max())
        print(f"sharded demix, dp 1 x tp 2, lstm_impl pallas: K9 runs {k9_launches} (unsharded "
              f"{k9_alone}); max|err|/max|stem| {k9_err:.3g} against the unsharded call, "
              f"bit-equal: {k9_err == 0.0}")
        require(k9_launches == 2 * k9_alone and k9_err == 0.0,
                f"the tp call with the per-target kernel: {k9_launches} runs, err {k9_err}")

        # the fleet over dp 2: bit-equal to the fleet without a mesh
        seeds = list(range(len(bucket)))
        alone = demix_tracks(sep, bucket, seeds=seeds)
        stats: dict = {}
        reset_counts(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        together = demix_tracks(sep, bucket, seeds=seeds, stats=stats,
                                mesh=make_mesh(2, 1, grid[:2]))
        torch.cuda.synchronize()
        fleet_s = time.perf_counter() - t0
        fleet_launches = {k: fn.launches for k, fn in counters.items() if fn.launches}
        fleet_equal = all(np.array_equal(a, b) for a, b in zip(together, alone))
        print(f"fleet over dp 2 ({len(bucket)} x {bucket[0].shape[1] / SR:.0f} s): bit-equal to "
              f"the fleet without a mesh: {fleet_equal}; {fleet_s:.3f} s wall; stats "
              f"{ {k: round(v, 4) if isinstance(v, float) else v for k, v in stats.items()} }; "
              f"kernel runs {fleet_launches}  [{smi}]")
        require(fleet_equal, "the fleet over a mesh is not bit-equal to the fleet without one")
        require(stats["rows"] % 2 == 0, f"the fleet did not pad its bucket to dp: {stats}")

        # the sharded train step over dp 2 x tp 2 against the unsharded one
        mcfg, tcfg = ModelConfig(hidden_size=1024), TrainConfig()
        rng = np.random.default_rng(17)
        tlen = DSPConfig().hop * (tcfg.seq_len - 1)
        targets = (0.1 * rng.standard_normal((B_TRAIN, 4, 2, tlen))).astype(np.float32)
        tbatch = make_batch_from_audio(targets.sum(axis=1), targets, mcfg, DSPConfig(),
                                       tcfg.seq_len, card)
        del targets
        params0 = synthetic_params(mcfg, seed=0, device=card)
        ref_state, ref_step = init_train_state(params0, tcfg), make_train_step(mcfg)
        ref_losses = [float(ref_step(ref_state, tbatch)[1])]
        trained = [f.name for f in dataclasses.fields(umx.UMXParams) if f.name not in FROZEN]
        ref_grads = {k: getattr(ref_state.params, k).grad.clone() for k in trained}
        ref_losses += [float(ref_step(ref_state, tbatch)[1]) for _ in range(MESH_TRAIN_STEPS - 1)]
        step, shard_state, shard_batch = make_sharded_train_step(mcfg, tcfg, tp_mesh)
        sstate, sbatch = shard_state(init_train_state(params0, tcfg)), shard_batch(tbatch)
        reset_counts(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = [float(step(sstate, sbatch)[1])]
        grad_rel = max(
            float((torch.cat([getattr(sl, k).grad for sl in sstate.slices]) - g).abs().max()
                  / g.abs().max())
            for k, g in ref_grads.items())
        losses += [float(step(sstate, sbatch)[1]) for _ in range(MESH_TRAIN_STEPS - 1)]
        torch.cuda.synchronize()
        sharded_steps_s = MESH_TRAIN_STEPS / (time.perf_counter() - t0)
        train_launches = {k: counters[k].launches for k in
                          ("lstm_merged_train_fwd", "lstm_merged_bwd_step", "lstm_merged_dw")}
        eval_step = make_eval_step(mcfg)
        trained_ref = float(eval_step(ref_state.params, tbatch))
        eval_rel = abs(float(eval_step(sstate.params, tbatch)) - trained_ref) / trained_ref
        loss_rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
        print(f"sharded train step, dp 2 x tp 2, UMX-L, batch {B_TRAIN} x {tcfg.seq_len} frames: "
              f"losses {losses} against unsharded {ref_losses} (rel "
              f"{[f'{x:.3g}' for x in loss_rel]}); first step's gradients within {grad_rel:.3g} "
              f"of each field's max|g|; the trained parameters' loss on the batch within "
              f"{eval_rel:.3g}; "
              f"{sharded_steps_s:.3f} steps/s; kernel runs {train_launches}  [{smi}]")
        require(loss_rel[0] <= MESH_FIRST_LOSS_RTOL and grad_rel <= MESH_GRAD_RTOL
                and max(loss_rel) <= MESH_LATER_LOSS_RTOL and eval_rel <= MESH_TRAINED_RTOL,
                f"the sharded train step disagrees with the unsharded one: losses {loss_rel}, "
                f"gradients {grad_rel}, trained {eval_rel}")
        require(all(v > 0 for v in train_launches.values()),
                f"the sharded train step did not launch K4-K6: {train_launches}")
        del ref_state, sstate, sbatch, tbatch, params0

    # train_umx --mesh at its default width (UMX-HQ) on phase 14's stems
    reset_counts(counters)
    rc, text = _run_main(train_umx.main, [os.path.join(tmp, "musdb_eval"),
                                          os.path.join(tmp, "umxhq_mesh.bin"), "--steps", "2",
                                          "--mesh"])
    require(rc == 0 and "mesh: {'dp': 1, 'tp': 1}" in text and "final loss" in text,
            f"train_umx --mesh: rc {rc}\n{text}")
    require(counters["lstm_merged_train_fwd"].launches > 0, "train_umx --mesh did not launch K4")

    # every kernel shape the phase gave, against its plain version
    print(f"mesh phase shapes: K1 (chains, rows per chain, frames) {sorted(k1_shapes)}; K2/K3 "
          f"(sources, frames, bins) {sorted(k23_shapes)}; K4-K6 (chains, rows per chain, steps) "
          f"{sorted(train_shapes)}; K9 (targets, frames, G) {sorted(k9_shapes)}")
    # phase 3 holds K2 and K3 at this shape
    require(k23_shapes == {(N_SRC, T_SEG, F_BINS)}, f"K2/K3 ran at other shapes: {k23_shapes}")
    # (phases 2, 5, 10 and 11 hold the UMX-L shapes of one card's paths)
    k1_shapes -= {(R_CHAINS, 1, T_SEG), (R_CHAINS, 3, T_SEG), (R_CHAINS, B_TRAIN, T_TRAIN)}
    train_shapes -= {(R_CHAINS, B_TRAIN, T_TRAIN)}
    k9_shapes -= {(N_SRC, T_SEG, G_HIDDEN)}
    errs, timed, library, k6_yardsticks = {}, {}, {}, {}
    for R, B, T in sorted(k1_shapes):
        args, errs[f"K1 R{R} B{B} T{T}"] = check_lstm(dev, T, B, seed=200 + R + B, R=R)
        timed[f"lstm_merged R{R} B{B} T{T}"] = (
            cuda_ms(lambda: L.lstm_merged(*args), 5),
            cuda_ms(lambda: L.lstm_merged_plain(*args), 2),
            lstm_bound(T, R * B, G_HIDDEN, args[:4])[0])
    for R, B, T in sorted(train_shapes):
        (fa, ba, da), e = check_train_kernels_at(dev, R, B, T, seed=300 + R + B)
        errs[f"K4-K6 R{R} B{B} T{T}"] = max(e)
        rows = R * B
        ops = 2.0 * T * rows * G_HIDDEN * 4 * G_HIDDEN
        step_bytes = T * rows * G_HIDDEN * 4
        timed[f"lstm_merged_train_fwd R{R} B{B} T{T}"] = (
            cuda_ms(lambda: L.lstm_merged_train_fwd(*fa), 5),
            cuda_ms(lambda: L.lstm_merged_train_fwd_plain(*fa), 2),
            lstm_bound(T, rows, G_HIDDEN, fa[:4], extra_out=5 * step_bytes)[0])
        timed[f"lstm_merged_bwd_step R{R} B{B} T{T}"] = (
            cuda_ms(lambda: L.lstm_merged_bwd_step(*ba), 5),
            cuda_ms(lambda: L.lstm_merged_bwd_step_plain(*ba), 2),
            bound_ms(nbytes(*ba[:7]) + 4 * step_bytes + 2 * rows * G_HIDDEN * 4, ops, "bf16")[0])
        timed[f"lstm_merged_dw R{R} B{B} T{T}"] = (
            cuda_ms(lambda: L.lstm_merged_dw(*da), 5),
            cuda_ms(lambda: L.lstm_merged_dw_plain(*da), 2),
            bound_ms(nbytes(*da[:3]) + R * G_HIDDEN * 4 * G_HIDDEN * 4, ops, "bf16")[0])
        library[f"lstm_merged_dw R{R} B{B} T{T}"] = dw_bmm_ms(*da)
        k6_yardsticks[f"lstm_merged_dw R{R} B{B} T{T}"] = (
            cuda_ms(lambda: dw_library_sequence(*da), 5), dw_bmm_bf16_ms(*da))
    for n_t, T, G in sorted(k9_shapes):
        args, errs[f"K9 T#{n_t} T{T} G{G}"] = check_pertarget_at(dev, n_t, T, G, seed=400 + n_t)
        timed[f"lstm_layer_pertarget T#{n_t} T{T} G{G}"] = (
            cuda_ms(lambda: L.lstm_layer_pertarget(*args), 5),
            cuda_ms(lambda: L.lstm_pertarget_plain(*args), 2),
            lstm_bound(T, n_t * 2, G, args)[0])
    for name, (k, p, b) in timed.items():
        lib = f"{library[name]:.4f} ms" if name in library else "none"
        print(f"{name}: kernel {k:.4f} ms, plain {p:.4f} ms, bound {b:.4f} ms, library call "
              f"{lib}  [{smi}]")
    for name, (seq_ms, call_ms) in k6_yardsticks.items():
        print(f"{name}: the library sequence (round, chain-major copies, torch.bmm(bf16, bf16, "
              f"out_dtype=float32)) {seq_ms:.4f} ms; that call on pre-rounded operands "
              f"{call_ms:.4f} ms  [{smi}]")
    require(train_shapes and k9_shapes and k1_shapes, "the phase recorded no kernel shape")
    fig.update(
        dp_bit_equal=dp_equal, dp_demix_s=dp_s, dp_xrt=audio_s / dp_s, dp_launches=dp_launches,
        tp_rel_err=tp_err, tp_bit_equal=tp_equal, tp_demix_s=tp_s, tp_xrt=audio_s / tp_s,
        tp_launches=tp_launches, tp_combines=audit, k9_tp_rel_err=k9_err,
        k9_tp_launches=k9_launches, fleet_bit_equal=fleet_equal, fleet_s=fleet_s,
        fleet_launches=fleet_launches,
        fleet_stats=stats, train_losses=losses, train_unsharded_losses=ref_losses,
        train_grad_rel_err=grad_rel, train_eval_rel_err=eval_rel,
        sharded_steps_per_s=sharded_steps_s,
        train_launches=train_launches, k1_shapes=sorted(k1_shapes),
        train_shapes=sorted(train_shapes), k9_shapes=sorted(k9_shapes), kernel_errs=errs,
        kernel_ms={k: {"ms": v[0], "plain_ms": v[1], "bound_ms": v[2],
                       "library_ms": library.get(k)} for k, v in timed.items()},
        k6_library_sequence_ms={k: v[0] for k, v in k6_yardsticks.items()},
        k6_prerounded_bmm_bf16_ms={k: v[1] for k, v in k6_yardsticks.items()})
    fig["wall_s"] = time.perf_counter() - t_phase
    print(f"mesh phase: {fig['wall_s']:.1f} s wall  [{smi}]")
    return fig


# Phase 18: the streaming schedules and the bfloat16 seams
STREAM_ARMS = ("scan", "groups", "pipelined")
STREAM_REPS = 3  # warm runs of each schedule; the median is kept
# K1's chains in the pipelined schedule's iterations over 3 chunks: fill,
# steady, drain (8 chains a layer at UMX-L)
PIPELINED_CHAINS = [8, 16, 24, 16, 8]
# a bfloat16 seam against float32, of the float32 stems' peak: the JAX
# package's seam tests' gates (the stems stack alone rounds at most two
# addends a sample)
SEAM_GATES = {"mask_dtype": 2e-2, "wiener.out_dtype": 2e-2, "stems_stack_dtype": 1.5e-2,
              "all three": 2e-2}


@contextlib.contextmanager
def chain_counts(chains: list):
    """For the block, every merged recurrence layer the network runs (one
    K1 call) appends its chain count R = targets x directions, times the
    stages of the pipelined schedule, to ``chains``."""
    from umx_tpu_torch.models import umx

    real = umx.lstm_layer_merged_batched

    def spy(x_proj, *args):
        chains.append(x_proj.shape[1] * x_proj.shape[3])
        return real(x_proj, *args)

    umx.lstm_layer_merged_batched = spy
    try:
        yield
    finally:
        umx.lstm_layer_merged_batched = real


def stream_arms(dev, params, cfg, audio, geom: tuple, cb: int, label: str, smi: str):
    """Phase 18: the 100 s track (``geom`` = n_chunks, seg, stride) through
    ``demix_fused``, ``demix_fused_stream_groups`` (``cb`` chunks a group) and
    ``demix_fused_stream_pipelined``, each warm, the median of 3 runs, its
    own peak device memory with the parameters (as the planner counts
    them); each arm's stems and final state within 1e-5 of the scan's,
    bit-equality printed -> (walls, peaks, per-arm errors, ``run(arm)``)."""
    import statistics

    import torch

    from umx_tpu_torch.engine import separator as S
    from umx_tpu_torch.engine.memory import params_hbm_bytes
    from umx_tpu_torch.models.umx import init_lstm_state

    n_chunks, seg, stride = geom
    secs = TRACK_SECS

    def run(arm):
        state = init_lstm_state(cfg.model, dev, batch=1)
        with torch.inference_mode():
            if arm == "groups":
                return S.demix_fused_stream_groups(params, audio, state, cfg, n_chunks, seg,
                                                   stride, cb)
            if arm == "pipelined":
                return S.demix_fused_stream_pipelined(params, audio, state, cfg, n_chunks, seg,
                                                      stride)
            return S.demix_fused(params, audio, state, cfg, n_chunks, seg, stride)

    results, walls, peaks = {}, {}, {}
    p_bytes = params_hbm_bytes(cfg, params)
    for arm in STREAM_ARMS:
        run(arm)  # warm-up
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        rounds = []
        for _ in range(STREAM_REPS):
            t0 = time.perf_counter()
            out, st = run(arm)
            torch.cuda.synchronize()
            rounds.append(time.perf_counter() - t0)
        peaks[arm] = torch.cuda.max_memory_allocated() - before + p_bytes
        walls[arm] = statistics.median(rounds)
        results[arm] = (out, st)
        print(f"stream_impl {arm} ({label}): {walls[arm]:.4f} s median of {STREAM_REPS} "
              f"({min(rounds):.4f}-{max(rounds):.4f}), {secs / walls[arm]:.1f}x realtime; peak "
              f"{peaks[arm] / 2**30:.3f} GiB  [{smi}]")
    ref, ref_st = results["scan"]
    amp = float(ref.abs().max())
    errs = {}
    for arm in ("groups", "pipelined"):
        out, st = results[arm]
        err = float((out - ref).abs().max()) / amp
        st_err = max(max_err(st.h, ref_st.h), max_err(st.c, ref_st.c))
        bit = bool(torch.equal(out, ref) and torch.equal(st.h, ref_st.h)
                   and torch.equal(st.c, ref_st.c))
        print(f"stream_impl {arm} vs scan ({label}): stems max|err|/max|stem| {err:.3g}, state "
              f"max|err| {st_err:.3g}, bit-equal {bit}")
        require(err <= 1e-5 and st_err <= 1e-5,
                f"stream_impl {arm} ({label}) disagrees with the scan: stems {err}, "
                f"state {st_err}")
        errs[arm] = {"rel_err": err, "state_err": st_err, "bit_equal": bit}
    return walls, peaks, errs, run


def stream_phase(dev, model: str, wav: str, mix, counters: dict, smi: str) -> dict:
    """Phase 18: the streaming schedules (``EngineConfig.stream_impl``) at
    UMX-L on the 100 s track (3 chunks) through ``demix_fused``,
    ``demix_fused_stream_groups`` and ``demix_fused_stream_pipelined``
    (:func:`stream_arms`), the peaks beside the planner's; the same at
    UMX-HQ (seed-0 weights at hidden 512, where K1 holds 16 chains in one
    wave: the workload where the pipelined schedule gains), with K1's
    chain counts there and its forms, kernel and plain times at G 256;
    K1's chain counts in the pipelined schedule at UMX-L (8, 16, 24, 16,
    8), K1 at R 16 and R 24 against its plain version,
    its forms, and R 24 (chain groups) against three R 8 launches on the
    same inputs (bit-equal per chain, and timed); the bfloat16 seams alone
    and together against float32, as dB below the signal, within the JAX
    tests' gates; and the CLI with ``--stream-impl pipelined`` (its
    counts set to 0 just before and read just after; four finite stems
    summing to the mix)."""
    import dataclasses

    import torch

    from umx_tpu_torch import cli
    from umx_tpu_torch.engine import separator as S
    from umx_tpu_torch.engine.memory import (
        fused_track_hbm_bytes, parallel_track_hbm_bytes, suggest_chunk_batch,
    )
    from umx_tpu_torch.models.umx import synthetic_params
    from umx_tpu_torch.ops import lstm_cuda as L

    t_phase = time.perf_counter()
    fig = {"card": smi}
    sep = S.Separator.from_ggml(model)
    params, cfg = sep.params, sep.cfg
    seg, stride, n_chunks, padded = sep._geometry(mix.shape[1])
    require(n_chunks == N_CHUNKS, f"the track splits into {n_chunks} chunks, not {N_CHUNKS}")
    audio = torch.nn.functional.pad(torch.from_numpy(mix).to(dev), (0, padded - mix.shape[1]))[None]
    geom = (n_chunks, seg, stride)
    secs = mix.shape[1] / SR
    cb = min(suggest_chunk_batch(cfg, secs, params=params, device=dev), n_chunks)

    walls, peaks, fig["arms"], run = stream_arms(dev, params, cfg, audio, geom, cb, "UMX-L",
                                                       smi)
    laps = {"UMX-L": time.perf_counter() - t_phase}
    est = fused_track_hbm_bytes(cfg, 1, secs, params)["total"]
    est_groups = parallel_track_hbm_bytes(cfg, cb, secs, params)["total"]
    print(f"planner: fused_track_hbm_bytes {est / 2**30:.3f} GiB (the scan program); "
          f"parallel_track_hbm_bytes at the groups' width {cb}: {est_groups / 2**30:.3f} GiB  [{smi}]")

    # UMX-HQ (hidden 512, G 256): a chain takes 8 of K1's blocks, so one
    # wave holds 16 chains and the pipelined schedule's R 16 and R 24 run
    # as one and two chain groups, against the scan's 9 of R 8
    hq_cfg = cfg.replace(model=dataclasses.replace(cfg.model, hidden_size=512))
    hq_params = synthetic_params(hq_cfg.model, seed=0, device=dev)
    hq_cb = min(suggest_chunk_batch(hq_cfg, secs, params=hq_params, device=dev), n_chunks)
    hq_walls, hq_peaks, fig["hq_arms"], hq_run = stream_arms(dev, hq_params, hq_cfg, audio,
                                                            geom, hq_cb, "UMX-HQ", smi)
    hq_chains: list = []
    reset_counts(counters)
    with chain_counts(hq_chains):
        hq_run("pipelined")
    torch.cuda.synchronize()
    require(hq_chains == PIPELINED_CHAINS and counters["lstm_merged"].launches == len(hq_chains),
            f"the pipelined schedule ran K1 at {hq_chains} chains at UMX-HQ")
    hq_k1 = {}
    for R in (8, 16, 24):
        a, err = check_lstm(dev, T_SEG, 1, seed=600 + R, R=R, G=256)
        k = hq_k1[f"R{R}"] = {"form": L.lstm_merged.form, "max_abs_err": err,
                              "ms": cuda_ms(lambda: L.lstm_merged(*a), 5),
                              "plain_ms": cuda_ms(lambda: L.lstm_merged_plain(*a), 1),
                              "bound_ms": lstm_bound(T_SEG, R, 256, a[:4])[0],
                              "launches": hq_chains.count(R)}
        print(f"lstm_merged at R {R}, B 1, T {T_SEG}, G 256: kernel {k['ms']:.4f} ms, plain "
              f"{k['plain_ms']:.4f} ms, bound {k['bound_ms']:.4f} ms; form {k['form']}; "
              f"{k['launches']} launch(es) in the UMX-HQ pipelined run  [{smi}]")
    del a, hq_params, hq_run
    fig["hq"] = {"wall_s": hq_walls, "peak_bytes": hq_peaks, "groups_width": hq_cb, "k1": hq_k1}
    laps["UMX-HQ"] = time.perf_counter() - t_phase

    # K1's chain counts in the pipelined schedule, and its forms there
    chains: list = []
    reset_counts(counters)
    with chain_counts(chains):
        run("pipelined")
    torch.cuda.synchronize()
    require(chains == PIPELINED_CHAINS and counters["lstm_merged"].launches == len(chains),
            f"the pipelined schedule ran K1 at {chains} chains, not {PIPELINED_CHAINS}")
    args, forms, errs, timed = {}, {}, {}, {}
    for R in (8, 16, 24):
        args[R], errs[R] = check_lstm(dev, T_SEG, 1, seed=500 + R, R=R)
        forms[R] = L.lstm_merged.form
        timed[R] = (cuda_ms(lambda: L.lstm_merged(*args[R]), 5),
                    cuda_ms(lambda: L.lstm_merged_plain(*args[R]), 1),
                    lstm_bound(T_SEG, R, G_HIDDEN, args[R][:4]))
    require(forms[24][2] > forms[8][2],
            f"K1 at R 24 ran as {forms[24][2]} chain group(s), R 8 as {forms[8][2]}")
    # the same 24 chains as three R 8 launches (rows are chains at B 1)
    xp, whh, h0, c0, _ = args[24]
    starts = (0, 8, 16)
    parts = [(xp[:, r0 : r0 + 8].contiguous(), whh[r0 : r0 + 8].contiguous(),
              h0[r0 : r0 + 8].contiguous(), c0[r0 : r0 + 8].contiguous(), 1) for r0 in starts]
    full = L.lstm_merged(*args[24])
    same = all(torch.equal(full[0][:, r0 : r0 + 8], o[0]) and torch.equal(full[1][r0 : r0 + 8], o[1])
               and torch.equal(full[2][r0 : r0 + 8], o[2])
               for r0, o in zip(starts, [L.lstm_merged(*p) for p in parts]))
    require(same, "K1 at R 24 is not bit-equal per chain to three R 8 launches")
    three_ms = cuda_ms(lambda: [L.lstm_merged(*p) for p in parts], 5)
    for R in (8, 16, 24):
        k, p, (b, by) = timed[R]
        print(f"lstm_merged at R {R}, B 1, T {T_SEG}: kernel {k:.4f} ms, plain {p:.4f} ms, bound "
              f"{b:.4f} ms by {by}, library call none; form (blocks per chain, blocks held at "
              f"once, chain groups, row groups) {forms[R]}  [{smi}]")
    print(f"lstm_merged at R 24 (one call, {forms[24][2]} chain groups) {timed[24][0]:.4f} ms "
          f"against three R 8 calls on the same inputs {three_ms:.4f} ms; bit-equal per chain  "
          f"[{smi}]")
    fig["k1"] = {f"R{R}": {"ms": timed[R][0], "plain_ms": timed[R][1], "bound_ms": timed[R][2][0],
                           "form": forms[R], "max_abs_err": errs[R]} for R in (8, 16, 24)}
    fig["k1"]["three_r8_ms"] = three_ms
    laps["K1"] = time.perf_counter() - t_phase
    del args, parts, full, xp, whh, h0, c0

    # the bfloat16 seams against float32, on the same track and seed: the
    # baseline pins the three seams to float32 (the card's "auto" is
    # bfloat16), each case sets one of them, or all three, to bfloat16
    cfg32 = f32_seams(cfg)
    ref = S.Separator(params, cfg32).demix_track(mix, seed=0)
    amp = float(np.abs(ref).max())
    cases = {"mask_dtype": cfg32.replace(mask_dtype="bfloat16"),
             "wiener.out_dtype": cfg32.replace(wiener=dataclasses.replace(cfg32.wiener,
                                                                           out_dtype="bfloat16")),
             "stems_stack_dtype": cfg32.replace(stems_stack_dtype="bfloat16")}
    cases["all three"] = cases["mask_dtype"].replace(wiener=cases["wiener.out_dtype"].wiener,
                                                     stems_stack_dtype="bfloat16")
    fig["seams"] = {}
    outs = {}
    for name, c in cases.items():
        out = outs[name] = S.Separator(params, c).demix_track(mix, seed=0)
        err = float(np.abs(out - ref).max()) / amp
        db = 10.0 * math.log10(float(np.sum(ref.astype(np.float64) ** 2))
                               / max(float(np.sum((out - ref).astype(np.float64) ** 2)), 1e-30))
        print(f"bf16 {name}: {db:.1f} dB below the signal, max|err|/max|stem| {err:.3g} (gate "
              f"{SEAM_GATES[name]})")
        require(0.0 < err <= SEAM_GATES[name],
                f"bf16 {name}: max|err|/max|stem| {err}, gate {SEAM_GATES[name]}")
        fig["seams"][name] = {"db_below_signal": db, "rel_err": err}
    # the card's default is the three seams in bfloat16, bit for bit
    default = sep.demix_track(mix, seed=0)
    fig["seams"]["default_is_all_three"] = bool(np.array_equal(default, outs["all three"]))
    print(f"default (auto) seams on the card vs all three bfloat16 by name: bit-equal "
          f"{fig['seams']['default_is_all_three']}")
    require(fig["seams"]["default_is_all_three"],
            "the card's default demix is not the demix with the three seams bfloat16")
    del sep, outs
    laps["seams"] = time.perf_counter() - t_phase

    # the CLI with the pipelined schedule, its counts read around it
    out_dir = os.path.join(os.path.dirname(model), "stems_pipelined")
    chains = []
    reset_counts(counters)
    t0 = time.perf_counter()
    with chain_counts(chains):
        rc = cli.main([model, wav, out_dir, "--quiet", "--stream-impl", "pipelined"])
    cli_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    require(rc == 0, f"CLI --stream-impl pipelined exited {rc}")
    print(f"CLI --stream-impl pipelined ({TRACK_SECS:.0f} s track, UMX-L): {cli_s:.3f} s wall; "
          f"K1 chains per call {chains}; kernel runs {launches}  [{smi}]")
    require(chains == PIPELINED_CHAINS, f"the CLI's pipelined run gave K1 {chains} chains")
    for name in ("wiener_reduce", "wiener_apply"):
        require(launches[name] == N_CHUNKS, f"{name} ran {launches[name]} times, not {N_CHUNKS}")
    check_stems(out_dir, mix)
    fig.update(wall_s={arm: walls[arm] for arm in STREAM_ARMS},
               peak_bytes=peaks, planner_bytes=est, planner_groups_bytes=est_groups,
               groups_width=cb, cli_s=cli_s, cli_launches=launches,
               k1_chain_launches={str(R): chains.count(R) for R in sorted(set(chains))})
    fig["phase_s"] = time.perf_counter() - t_phase
    fig["laps_s"] = laps
    print(f"stream phase: {fig['phase_s']:.1f} s wall (at the end of each part: "
          f"{', '.join(f'{k} {v:.1f} s' for k, v in laps.items())})  [{smi}]")
    return fig


# Phase 19: the float32 recurrence K10 (lstm_impl="scan")
# K10 against its plain version at these (G, rows per chain, W_hh dtype),
# R 8 chains, T 2584: UMX-L at B 1, 3 and 6 (f32 and the quantized path's
# bf16 W_hh), UMX-HQ, a hidden-1280 model and hidden 36
SCAN_SHAPES = ((512, 1, "float32"), (512, 3, "float32"), (512, 6, "float32"),
               (512, 1, "bfloat16"), (256, 1, "float32"), (640, 1, "float32"),
               (18, 1, "float32"), (640, 3, "float32"), (640, 1, "bfloat16"))
# both sides take f32 products of unrounded h and exact weights, summed in
# another order: measured ~4e-7 on h and c, so 1e-4 catches any index fault
SCAN_ATOL = 1e-4
SCAN_REPEATS = 5  # further runs of each shape, each held to the first run's bits
SCAN_SLICE_RTOL = 2e-4  # the port against the CPU, dense, both f32 (the CPU tests' class)
# The CPU side of that comparison runs in a process of its own with its
# instruction set, MKL's code path and its thread count pinned, so that
# its last bits do not depend on the host; the input scaled by 1 + 1e-6
# shows how far the CPU path itself moves on a last-bit change (printed)
SCAN_CPU_THREADS = 8
SCAN_CPU_PINS = {"ATEN_CPU_CAPABILITY": "avx2", "MKL_CBWR": "AVX2", "CUDA_VISIBLE_DEVICES": "",
                 "OMP_NUM_THREADS": str(SCAN_CPU_THREADS), "MKL_NUM_THREADS": str(SCAN_CPU_THREADS)}
SCAN_NUDGE = 1e-6
# quantized weights round the activations to bf16 before every product, so
# the GPU and the CPU are held on the error's energy, as phase 11 holds them
SCAN_QUANT_DB = -30.0
SCAN_WIDE_HIDDEN, SCAN_WIDE_SECS = 1280, 20.0  # the model wider than UMX-L, its cut
# K10's figures at these shapes on an H100 80GB HBM3 at 700 W before W_hh
# stayed on the chip (every step read it from L2), printed beside the new ones
SCAN_EARLIER_MS = {"G512_B1": 10.8848, "G512_B3": 17.8935, "G512_B6": 24.4463,
                   "G512_B1_bf16": 12.7418, "G256_B1": 7.0232, "G640_B1": 25.1177,
                   "G18_B1": 3.3333}


def scan_forms_at(G: int) -> tuple:
    """The forms of K10 and K11 that take width G: the resident and the
    streaming one up to 512, the wide and the streaming one above, up to
    ``SCAN_WIDE_G_MAX``, the streaming one beyond."""
    from umx_tpu_torch.ops import lstm_cuda as L

    if G <= L.SCAN_RESIDENT_G_MAX:
        return ("resident", "streaming")
    return ("wide", "streaming") if G <= L.SCAN_WIDE_G_MAX else ("streaming",)


def scan_bound(T, rows, G, inputs):
    """Bound of one K10 layer: the inputs once, hs + hT + cT out, and
    2*T*rows*G*4G float32 operations on the CUDA cores."""
    out = (T + 2) * rows * G * 4
    return bound_ms(nbytes(*inputs) + out, 2.0 * T * rows * G * 4 * G, "f32")


def scan_inputs(dev, T, B, G, seed, dtype="float32"):
    """Random K10 inputs at R 8 chains of width G, W_hh in ``dtype``."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    RB = R_CHAINS * B
    xp = torch.randn((T, RB, 4 * G), generator=g, device=dev)
    whh = (torch.randn((R_CHAINS, G, 4 * G), generator=g, device=dev) / G**0.5).to(
        getattr(torch, dtype))
    h0 = 0.5 * torch.randn((RB, G), generator=g, device=dev)
    c0 = 0.5 * torch.randn((RB, G), generator=g, device=dev)
    return xp, whh, h0, c0, B


_CPU_DEMIX = """
import pickle, sys
import numpy as np, torch
torch.set_num_threads(int(sys.argv[3]))
from umx_tpu_torch.engine.separator import Separator
path, cfg, short, quantized, nudge = pickle.load(open(sys.argv[1], "rb"))
sep = Separator.from_ggml(path, cfg, "cpu", quantized_hbm=quantized)
np.save(sys.argv[2], np.stack([sep.demix_track(short, seed=0),
                               sep.demix_track(short * np.float32(1 + nudge), seed=0)]))
print(torch.backends.cpu.get_cpu_capability(), torch.get_num_threads())
"""


def pinned_cpu_demix(tmp: str, path: str, cfg, short, quantized: bool):
    """The port's CPU demix of ``short`` (and of it scaled by 1 +
    ``SCAN_NUDGE``) in a child process under ``SCAN_CPU_PINS``: (stems,
    nudged stems, the child's "capability threads")."""
    import pickle

    job, out = os.path.join(tmp, "cpu_job.pkl"), os.path.join(tmp, "cpu_out.npy")
    with open(job, "wb") as f:
        pickle.dump((path, cfg, short, quantized, SCAN_NUDGE), f)
    res = subprocess.run([sys.executable, "-c", _CPU_DEMIX, job, out, str(SCAN_CPU_THREADS)],
                         cwd=os.path.dirname(os.path.abspath(__file__)),
                         env={**os.environ, **SCAN_CPU_PINS}, capture_output=True, text=True,
                         timeout=600)
    require(res.returncode == 0, f"the pinned CPU demix exited {res.returncode}: "
                                 f"{res.stderr[-2000:]}")
    cpu, nudged = np.load(out)
    return cpu, nudged, res.stdout.strip().splitlines()[-1]


# the recurrence layer each kind of path calls (models/umx.py), its
# kernel's name on the lines, and the tolerance of that kernel against its
# plain version at the path's inputs
PATH_LAYERS = {"scan": ("lstm_layer_scan_batched", "K10", SCAN_ATOL),
               "merged": ("lstm_layer_merged_batched", "K1", 5e-3),
               "pertarget": ("lstm_layer_pertarget_batched", "K9", 5e-3)}


def layer_kernel_calls(kind: str, x_proj, hh_w, h0, c0) -> list:
    """The kernel calls a recurrence layer of ``kind`` makes at these
    batched inputs, as [(kernel, plain version, arguments)]."""
    import torch

    from umx_tpu_torch.ops import lstm_cuda as L

    if kind == "pertarget":
        whh = hh_w.to(torch.bfloat16).contiguous()
        return [(L.lstm_layer_pertarget, L.lstm_pertarget_plain,
                 (x_proj[b].float().contiguous(), whh, h0[b].float().contiguous(),
                  c0[b].float().contiguous())) for b in range(x_proj.shape[0])]
    xp, h0r, c0r = L._chain_rows(x_proj, h0, c0)
    R, G = x_proj.shape[1] * x_proj.shape[3], x_proj.shape[4] // 4
    if kind == "merged":
        whh = hh_w.to(torch.bfloat16).reshape(R, G, 4 * G).contiguous()
        return [(L.lstm_merged, L.lstm_merged_plain, (xp, whh, h0r, c0r, x_proj.shape[0]))]
    whh = hh_w.reshape(R, G, 4 * G).contiguous()
    return [(L.lstm_scan, L.lstm_scan_plain, (xp, whh, h0r, c0r, x_proj.shape[0]))]


def scan_vs_cpu(tmp: str, path: str, cfg, short, quantized: bool = False,
                kind: str = "scan") -> dict:
    """The card's demix of ``short`` against the port's CPU path (pinned,
    :func:`pinned_cpu_demix`) on the same ggml file and config:
    max|err|/max|stem|, the error's energy in dB, and the CPU path against
    itself on the nudged input.  Also the recurrence kernel of ``kind``
    (:data:`PATH_LAYERS`) at the path's own inputs (its layers of the first
    segment, captured on the way) against its plain version on the card,
    and the card's demix run twice (the same bits, or the exchange raced)."""
    from umx_tpu_torch.engine.separator import Separator
    from umx_tpu_torch.models import umx

    name, kernel, atol = PATH_LAYERS[kind]
    sep = Separator.from_ggml(path, cfg, "cuda", quantized_hbm=quantized)
    layer, seen = getattr(umx, name), []

    def spy(x_proj, hh_w, h0, c0):
        if len(seen) < cfg.model.n_lstm_layers:
            seen.extend(layer_kernel_calls(kind, x_proj, hh_w, h0, c0))
        return layer(x_proj, hh_w, h0, c0)

    setattr(umx, name, spy)
    try:
        gpu = sep.demix_track(short, seed=0)
        again = sep.demix_track(short, seed=0)
    finally:
        setattr(umx, name, layer)
    require(bool(seen), f"the {kind} path never called {name}")
    in_path = max(float((k - p).abs().max()) for fn, plain, args in seen
                  for k, p in zip(fn(*args), plain(*args)))
    whh = str(seen[0][2][1].dtype).replace("torch.", "")
    del sep, seen
    cpu, nudged, pins = pinned_cpu_demix(tmp, path, cfg, short, quantized)
    peak = float(np.max(np.abs(cpu)))
    return {"rel_err": float(np.max(np.abs(gpu - cpu))) / peak,
            "err_energy_db": float(20 * np.log10(np.linalg.norm(gpu - cpu) / np.linalg.norm(cpu))),
            "cpu_own_rel": float(np.max(np.abs(nudged - cpu))) / peak,
            "kernel": kernel, "kernel_in_path_err": in_path, "kernel_atol": atol, "whh": whh,
            "repeat_equal": bool(np.array_equal(gpu, again)), "cpu_pins": pins,
            "finite": bool(np.isfinite(gpu).all())}


def check_scan_vs_cpu(r: dict, what: str, quantized: bool = False,
                      rtol: float = SCAN_SLICE_RTOL) -> None:
    """The gates of :func:`scan_vs_cpu`'s figures ``r``."""
    require(r["finite"], f"{what}: the card's stems are not finite")
    require(r["repeat_equal"], f"{what}: two demixes of the same input on the card differ")
    require(r["kernel_in_path_err"] <= r["kernel_atol"],
            f"{what}: {r['kernel']} at the path's inputs disagrees with its plain version: "
            f"{r['kernel_in_path_err']}")
    if quantized:
        require(r["err_energy_db"] <= SCAN_QUANT_DB,
                f"{what}: GPU and CPU disagree, error energy {r['err_energy_db']} dB")
    else:
        require(r["rel_err"] <= rtol, f"{what}: GPU and CPU disagree: {r}")


def scan_cpu_line(r: dict) -> str:
    return (f"max|err|/max|stem| {r['rel_err']:.3g}, error energy {r['err_energy_db']:.1f} dB; "
            f"{r['kernel']} at the path's inputs (W_hh {r['whh']}) vs plain "
            f"{r['kernel_in_path_err']:.3g}; two card runs bit-equal {r['repeat_equal']}; the CPU "
            f"path against itself on the input x (1 + {SCAN_NUDGE:g}): {r['cpu_own_rel']:.3g}; "
            f"CPU side pinned (capability, threads) {r['cpu_pins']}")


def scan_phase(dev, tmp: str, model: str, wav: str, mix, counters: dict, smi: str):
    """Phase 19: K10 (``csrc/lstm_scan.cu``, ``lstm_impl="scan"``) against
    its plain version at ``SCAN_SHAPES``, rows at B 3 and 6 bit-equal to
    their B 1 runs, timed beside its bound and four ``nn.LSTM`` calls (a
    yardstick: they compute the ih product too); the CLI with
    ``--lstm-impl scan`` on the 100 s track, dense and ``--quantized-hbm``
    (counts set to 0 just before and read just after each: K10 three
    layers a chunk, K1 never); the GPU against the port's pinned CPU path
    on 5 s with the seams pinned to float32 (:func:`scan_vs_cpu`); the
    warm streaming demix under "scan" beside the default in turns; and a
    synthetic hidden-1280 model (G 640: K10's wide form) through the CLI
    on a 20 s cut and against the CPU on 5 s.  At G 640 the wide form is
    also timed beside the streaming one in turns and gated faster.
    Returns (its figures, K10's inputs at G 512, B 1)."""
    import dataclasses

    import torch

    from umx_tpu_torch import cli
    from umx_tpu_torch.config import EngineConfig, ModelConfig, SegmentConfig
    from umx_tpu_torch.engine.separator import Separator
    from umx_tpu_torch.io.ggml import write_ggml
    from umx_tpu_torch.models.umx import synthetic_state_dicts
    from umx_tpu_torch.ops import lstm_cuda as L

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fig = {"card": smi, "shapes": {}}
    args_main, worst = None, 0.0
    for G, B, dt in SCAN_SHAPES:
        args = scan_inputs(dev, T_SEG, B, G, seed=700 + G + B, dtype=dt)
        xp, whh, h0, c0, _ = args
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        ref = L.lstm_scan_plain(*args)
        end.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(end)
        default = L.scan_form(G, whh.dtype)
        bound = scan_bound(T_SEG, R_CHAINS * B, G, args[:4])
        key = f"G{G}_B{B}" + ("_bf16" if dt == "bfloat16" else "")
        row = {"plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1],
               "default_form": default, "forms": {}}
        # both forms where the resident one takes G, the default first
        for form in sorted(scan_forms_at(G), key=lambda f: f != default):
            out = L.lstm_scan(xp, whh, h0, c0, B, _form=form)
            torch.cuda.synchronize()
            got = L.lstm_scan.form
            err = max(max_err(a, b) for a, b in zip(out, ref))
            worst = max(worst, err)
            same = None
            if B > 1:
                same = True
                for b in range(B):
                    rows = torch.arange(R_CHAINS, device=dev) * B + b
                    one = L.lstm_scan(xp[:, rows].contiguous(), whh, h0[rows].contiguous(),
                                      c0[rows].contiguous(), 1, _form=form)
                    same &= (torch.equal(one[0], out[0][:, rows])
                             and torch.equal(one[1], out[1][rows])
                             and torch.equal(one[2], out[2][rows]))
            ms = cuda_ms(lambda: L.lstm_scan(xp, whh, h0, c0, B, _form=form), 3)
            # a race in the exchange of h would move the output between runs
            repeats = all(all(torch.equal(a, b) for a, b in zip(L.lstm_scan(xp, whh, h0, c0, B,
                                                                            _form=form), out))
                          for _ in range(SCAN_REPEATS))
            row["forms"][form] = {"ms": ms, "us_per_step": ms / T_SEG * 1e3, "max_abs_err": err,
                                  "form": got, "rows_bit_equal": same, "repeats_bit_equal": repeats}
            print(f"lstm_scan vs plain (T={T_SEG}, R={R_CHAINS}, B={B}, G={G}, W_hh {dt}), {form} "
                  f"form{' (the default)' if form == default else ''}: max|err| {err:.3g} (gate "
                  f"{SCAN_ATOL}); form (form, blocks per chain, blocks held at once, chain groups, "
                  f"row groups) {got}; rows bit-equal to B 1: {same}; {SCAN_REPEATS} more runs "
                  f"bit-equal: {repeats}; kernel {ms:.4f} ms = {ms / T_SEG * 1e3:.3f} us a step "
                  f"(before W_hh stayed on the chip {SCAN_EARLIER_MS.get(key)}), plain "
                  f"{plain_ms:.4f} ms, bound {bound[0]:.4f} ms by {bound[1]} (the steps depend on "
                  f"each other)  [{smi}]")
            require(got[0] == form, f"lstm_scan ran {got} when {form} was asked for")
            require(err <= SCAN_ATOL, f"lstm_scan ({form}) disagrees with plain at G {G}, B {B}, "
                                      f"{dt}: {err}")
            require(same is not False, f"lstm_scan ({form}) rows at B {B} are not their B 1 bits")
            require(repeats, f"lstm_scan ({form}) at G {G}, B {B}, {dt} gave other bits on "
                             f"another run")
            del out
        forms = row["forms"]
        row.update({k: forms[default][k] for k in ("ms", "us_per_step", "form", "rows_bit_equal",
                                                   "repeats_bit_equal")})
        row["max_abs_err"] = max(f["max_abs_err"] for f in forms.values())
        if "resident" in forms:
            require(forms["resident"]["ms"] < forms["streaming"]["ms"],
                    f"lstm_scan at G {G}, B {B}, {dt}: the resident form "
                    f"({forms['resident']['ms']} ms) is not faster than the streaming one "
                    f"({forms['streaming']['ms']} ms)")
        if "wide" in forms:
            # the wide form beside its streaming yardstick, in turns
            stream_ms, wide_ms = paired_ms(
                lambda: L.lstm_scan(xp, whh, h0, c0, B, _form="streaming"),
                lambda: L.lstm_scan(xp, whh, h0, c0, B), 1, f"lstm_scan {key} streaming vs wide")
            row["wide_vs_streaming"] = {"wide_ms": wide_ms, "streaming_ms": stream_ms}
            print(f"lstm_scan (T={T_SEG}, R={R_CHAINS}, B={B}, G={G}, W_hh {dt}) in turns: wide "
                  f"form {wide_ms:.4f} ms = {wide_ms / T_SEG * 1e3:.3f} us a step, streaming "
                  f"{stream_ms:.4f} ms, {stream_ms / wide_ms:.2f} x; plain {plain_ms:.4f} ms, "
                  f"bound {bound[0]:.4f} ms by {bound[1]}  [{smi}]")
            require(wide_ms < stream_ms, f"lstm_scan at G {G}, B {B}, {dt}: the wide form "
                    f"({wide_ms} ms) is not faster than the streaming one ({stream_ms} ms)")
        fig["shapes"][key] = row
        if (G, B, dt) == (G_HIDDEN, 1, "float32"):
            args_main = args
        del ref, args, xp, whh, h0, c0
    # the yardstick: four nn.LSTM(bidirectional) f32 calls at the same T and
    # G, the UMX-L layer's input width (they also compute the ih product)
    lstm = torch.nn.LSTM(2 * G_HIDDEN, G_HIDDEN, bidirectional=True).to(dev)
    x = torch.randn(T_SEG, 1, 2 * G_HIDDEN, device=dev)
    with torch.no_grad():
        fig["nn_lstm_x4_ms"] = cuda_ms(lambda: [lstm(x) for _ in range(4)], 2)
    print(f"yardstick: 4 x nn.LSTM(1024, 512, bidirectional) f32, TF32 off, T {T_SEG}: "
          f"{fig['nn_lstm_x4_ms']:.4f} ms against lstm_scan at R 8 "
          f"{fig['shapes']['G512_B1']['ms']:.4f} ms  [{smi}]")
    del lstm, x

    # the CLI on the 100 s track, dense and quantized, counts around each run
    fig["cli"] = {}
    for flags in ((), ("--quantized-hbm",)):
        name = "quantized" if flags else "dense"
        out_dir = os.path.join(tmp, f"stems_scan_{name}")
        reset_counts(counters)
        t0 = time.perf_counter()
        rc = cli.main([model, wav, out_dir, "--quiet", "--lstm-impl", "scan", *flags])
        cli_s = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        require(rc == 0, f"CLI --lstm-impl scan {' '.join(flags)} exited {rc}")
        print(f"CLI --lstm-impl scan {' '.join(flags)} ({TRACK_SECS:.0f} s track, UMX-L): "
              f"{cli_s:.3f} s wall; kernel runs {launches}  [{smi}]")
        require(launches["lstm_scan"] == 3 * N_CHUNKS and launches["lstm_merged"] == 0,
                f"the scan run launched K10 {launches['lstm_scan']} times (not 3 layers x "
                f"{N_CHUNKS} chunks) and K1 {launches['lstm_merged']} times")
        for k in ("wiener_reduce", "wiener_apply"):
            require(launches[k] > 0, f"the scan run launched no {k}")
        check_stems(out_dir, mix)
        fig["cli"][name] = {"s": cli_s, "launches": launches}

    # the GPU against the port's CPU path, 5 s with 2 s segments, float32 seams
    cfg = f32_seams(EngineConfig(model=ModelConfig(lstm_impl="scan"),
                                 segment=SegmentConfig(segment_secs=2.0)))
    short = mix[:, : 5 * SR]
    fig["gpu_vs_cpu"] = {}
    for quantized in (False, True):
        name = "quantized" if quantized else "dense"
        r = fig["gpu_vs_cpu"][name] = scan_vs_cpu(tmp, model, cfg, short, quantized)
        print(f"GPU vs CPU port, lstm_impl scan, {name} weights, 5 s at UMX-L, float32 seams: "
              f"{scan_cpu_line(r)}  [{smi}]")
        check_scan_vs_cpu(r, f"scan, {name} weights", quantized)

    # the warm streaming demix of the 100 s track, the default beside it
    seps = {"auto": Separator.from_ggml(model),
            "scan": Separator.from_ggml(model, EngineConfig(model=ModelConfig(lstm_impl="scan")))}
    walls = {k: [] for k in seps}
    for k in ("auto", "scan", "scan", "auto", "auto", "scan"):
        if not walls[k]:
            seps[k].demix_track(mix, seed=0)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        seps[k].demix_track(mix, seed=0)
        torch.cuda.synchronize()
        walls[k].append(time.perf_counter() - t0)
    fig["demix_s"] = {k: float(np.median(v)) for k, v in walls.items()}
    print(f"demix {TRACK_SECS:.0f} s track (warm, UMX-L, shifts 1), median of 3 in turns: "
          f"lstm_impl scan {fig['demix_s']['scan']:.3f} s = "
          f"{TRACK_SECS / fig['demix_s']['scan']:.1f}x realtime, auto "
          f"{fig['demix_s']['auto']:.3f} s = {TRACK_SECS / fig['demix_s']['auto']:.1f}x  [{smi}]")
    del seps

    # a model wider than UMX-L: hidden 1280, G 640, through the CLI
    wide = os.path.join(tmp, "synthetic_h1280.bin")
    write_ggml(wide, SCAN_WIDE_HIDDEN,
               synthetic_state_dicts(ModelConfig(hidden_size=SCAN_WIDE_HIDDEN), seed=0))
    from scipy.io import wavfile

    cut = mix[:, : int(SCAN_WIDE_SECS * SR)]
    cut_wav = os.path.join(tmp, "mix_20s.wav")
    wavfile.write(cut_wav, SR, np.ascontiguousarray(cut.T))
    out_dir = os.path.join(tmp, "stems_h1280")
    reset_counts(counters)
    t0 = time.perf_counter()
    rc = cli.main([wide, cut_wav, out_dir, "--quiet", "--lstm-impl", "scan"])
    wide_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    require(rc == 0, f"CLI on the hidden-{SCAN_WIDE_HIDDEN} model exited {rc}")
    print(f"CLI --lstm-impl scan, synthetic hidden {SCAN_WIDE_HIDDEN} (G "
          f"{SCAN_WIDE_HIDDEN // 2}), {SCAN_WIDE_SECS:.0f} s cut: {wide_s:.3f} s wall; kernel runs "
          f"{launches}; form {L.lstm_scan.form}  [{smi}]")
    require(launches["lstm_scan"] > 0 and launches["lstm_merged"] == 0,
            f"the hidden-{SCAN_WIDE_HIDDEN} run did not go through K10 alone: {launches}")
    require(L.lstm_scan.form[0] == "wide", f"the hidden-{SCAN_WIDE_HIDDEN} run's K10 ran in "
            f"{L.lstm_scan.form}, not the wide form")
    # finite stems, the four WAVs; how well they partition the mix depends
    # on the random weights, so it is printed beside UMX-L's on the same
    # cut and held by the GPU against the CPU below
    stems = check_stems(out_dir, cut, min_corr=0.0)
    umxl = Separator.from_ggml(model, EngineConfig(model=ModelConfig(lstm_impl="scan")))
    corr_l = float(np.corrcoef(umxl.demix_track(cut, seed=0).sum(0).ravel(), cut.ravel())[0, 1])
    corr_w = float(np.corrcoef(stems.sum(0).ravel(), cut.ravel())[0, 1])
    del umxl
    wcfg = cfg.replace(model=ModelConfig(hidden_size=SCAN_WIDE_HIDDEN, lstm_impl="scan"))
    r = scan_vs_cpu(tmp, wide, wcfg, short)
    print(f"hidden {SCAN_WIDE_HIDDEN}: corr(sum of stems, mix) {corr_w:.6f} on the "
          f"{SCAN_WIDE_SECS:.0f} s cut (UMX-L's synthetic weights on it: {corr_l:.6f}); GPU vs "
          f"CPU port, 5 s, float32 seams: {scan_cpu_line(r)}  [{smi}]")
    check_scan_vs_cpu(r, f"hidden {SCAN_WIDE_HIDDEN}")
    fig["wide"] = {"hidden": SCAN_WIDE_HIDDEN, "s": wide_s, "launches": launches,
                   "form": L.lstm_scan.form, "corr_sum_mix": corr_w, "umxl_corr_sum_mix": corr_l,
                   "gpu_vs_cpu": r}
    fig["max_abs_err"] = worst
    fig["phase_s"] = time.perf_counter() - t_phase
    print(f"scan phase: {fig['phase_s']:.1f} s wall  [{smi}]")
    return fig, args_main


# phase 20: training through the float32 recurrence (K10 with residuals, K11)
# shapes (G, B) at T 256 and R 8 chains: the UMX-L training batch, twice it
# (two row groups), UMX-HQ's width, hidden 1280's, and a width that is no
# multiple of 8
SCAN_TRAIN_SHAPES = ((G_HIDDEN, B_TRAIN), (G_HIDDEN, B_TRAIN_WIDE), (256, B_TRAIN),
                     (640, B_TRAIN), (18, B_TRAIN))
SCAN_TRAIN_REPEATS = 3
# K11 against its plain version: 1e-4 of each output's largest entry (f32
# products of the same operands, summed in another order)
SCAN_BWD_RTOL = 1e-4
# the card's first training step against the port's pinned CPU path at
# UMX-L under "scan": batch x frames (cut from the training batch's 16 x 256
# so that the CPU side takes seconds), and the gates (both float32).  The
# fields K10 with residuals, K11 and the dW product compute
# (``SCAN_TRAIN_LSTM_FIELDS``) are held to 2e-4 of their max|g|.  The
# others also pass the ReLUs of the mask network, where an element within
# an f32 rounding of a kink takes the gradient on one side and not on the
# other: each is held to 3 times how far the CPU path's own gradient moves
# on an input 1e-6 larger (``SCAN_NUDGE``), as phase 19 holds the demix,
# but to no less than 2e-4 and no more than 2e-3 of its max|g|
SCAN_TRAIN_CPU_BATCH, SCAN_TRAIN_CPU_FRAMES = 4, 64
SCAN_TRAIN_LOSS_RTOL, SCAN_TRAIN_GRAD_TOL, SCAN_TRAIN_GRAD_CAP = 1e-5, 2e-4, 2e-3
SCAN_TRAIN_LSTM_FIELDS = ("lstm_ih_w", "lstm_hh_w", "lstm_ih_b", "lstm_hh_b")
# K10 with residuals and K11 at the UMX-L training shape on an H100 80GB
# HBM3 at 700 W before W_hh stayed on the chip, printed beside the new ones
SCAN_TRAIN_EARLIER_MS = {"lstm_scan_train_fwd": 4.5161, "lstm_scan_bwd_step": 6.3962}
SCAN_TRAIN_HIDDEN = 1024  # UMX-L
SCAN_TRAIN_WIDE_G = 640  # hidden 1280: the shape timed beside UMX-L's
# the stress run of K10 and K11's tagged exchange
STRESS_T, STRESS_BS, STRESS_GS, STRESS_LAUNCHES = 64, (1, 3, 6, 16, 20), (18, 256, 512, 640), 2000


def scan_train_inputs(dev, T, B, G, seed, R=R_CHAINS):
    """Random K10 inputs at R chains (8 unless given) of width G, W_hh
    float32 (the trainer's), and the cotangents dhs, dhT, dcT of its
    outputs."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    RB = R * B
    xp = torch.randn((T, RB, 4 * G), generator=g, device=dev)
    whh = torch.randn((R, G, 4 * G), generator=g, device=dev) / G**0.5
    h0, c0 = 0.5 * torch.randn((2, RB, G), generator=g, device=dev)
    cts = (torch.randn((T, RB, G), generator=g, device=dev),
           *torch.randn((2, RB, G), generator=g, device=dev))
    return xp, whh, h0, c0, cts


def rel_to_max(got, want) -> float:
    return max_err(got, want) / max(float(want.abs().max()), 1e-30)


def scan_bwd_bound(T, rows, G, inputs):
    """Bound of one K11 sweep: gates, cs, c0, W_hh and the three cotangents
    in, dxp + dh0 + dc0 out, 2*T*rows*G*4G float32 operations."""
    out = (T * 4 + 2) * rows * G * 4
    return bound_ms(nbytes(*inputs) + out, 2.0 * T * rows * G * 4 * G, "f32")


def check_scan_train_kernels(dev, smi: str) -> dict:
    """Phase 20a: K10 with residuals (hs/hT/cT K10's bits, residuals within
    1e-4 of the plain version) and K11 against their plain versions at
    ``SCAN_TRAIN_SHAPES`` in every form that takes the width, rows
    bit-equal to themselves alone, repeat runs bit-equal; the kernels, the
    dW ``torch.bmm`` and an ``nn.LSTM`` yardstick timed at the UMX-L
    training shape; at hidden 1280's width (G 640) the wide forms beside
    the streaming ones in turns, gated faster."""
    import torch

    from umx_tpu_torch.ops import lstm_cuda as L

    fig = {"shapes": {}}
    main = wide = None
    for G, B in SCAN_TRAIN_SHAPES:
        xp, whh, h0, c0, cts = scan_train_inputs(dev, T_TRAIN, B, G, seed=900 + G + B)
        fwd_ref = L.lstm_scan_train_fwd_plain(xp, whh, h0, c0, B)
        row = {"default_form": L.scan_form(G, whh.dtype), "forms": {}}
        bwd_ref = bwd_by_form = None
        for form in scan_forms_at(G):
            fwd = L.lstm_scan_train_fwd(xp, whh, h0, c0, B, _form=form)
            fwd_form = L.lstm_scan_train_fwd.form
            k10 = L.lstm_scan(xp, whh, h0, c0, B, _form=form)
            fwd_bits = all(torch.equal(a, b) for a, b in zip(fwd[:3], k10))
            fwd_err = max(max_err(a, b) for a, b in zip(fwd, fwd_ref))
            _, _, _, gates, cs = fwd
            if bwd_ref is None:  # the residuals of every form agree within 1e-4; K11's
                # plain version runs once, on the first form's
                bwd_ref = L.lstm_scan_bwd_step_plain(gates, cs, c0, whh, *cts, B)
                bwd_in = (gates, cs)
            out = L.lstm_scan_bwd_step(*bwd_in, c0, whh, *cts, B, _form=form)
            torch.cuda.synchronize()
            err = max(rel_to_max(a, b) for a, b in zip(out, bwd_ref))
            abs_err = max(max_err(a, b) for a, b in zip(out, bwd_ref))
            alone = True
            for b in (0, B - 1):
                rows = torch.arange(R_CHAINS, device=dev) * B + b
                one = L.lstm_scan_bwd_step(
                    bwd_in[0][:, rows].contiguous(), bwd_in[1][:, rows].contiguous(),
                    c0[rows].contiguous(), whh, cts[0][:, rows].contiguous(),
                    cts[1][rows].contiguous(), cts[2][rows].contiguous(), 1, _form=form)
                alone &= (torch.equal(one[0], out[0][:, rows]) and torch.equal(one[1], out[1][rows])
                          and torch.equal(one[2], out[2][rows]))
            repeats = all(all(torch.equal(a, b) for a, b in zip(
                L.lstm_scan_bwd_step(*bwd_in, c0, whh, *cts, B, _form=form), out))
                for _ in range(SCAN_TRAIN_REPEATS))
            # K11's resident and streaming forms sum in one order: the same
            # bits on the same residuals (the wide form sums over blocks of
            # 20 units, its own order, held to plain above)
            same_bits = (bwd_by_form is None or "wide" in scan_forms_at(G)
                         or all(torch.equal(a, b) for a, b in zip(out, bwd_by_form)))
            bwd_by_form = out
            row["forms"][form] = {
                "fwd_bit_equal_k10": fwd_bits, "fwd_max_abs_err": fwd_err, "fwd_form": fwd_form,
                "bwd": {"rel_err": err, "max_abs_err": abs_err, "rows_bit_equal": alone,
                        "repeats_bit_equal": repeats, "form": L.lstm_scan_bwd_step.form,
                        "bit_equal_other_form": same_bits}}
            forms_bits = ("n/a (the wide form's own order)" if "wide" in scan_forms_at(G)
                          else same_bits)
            print(f"lstm_scan_train_fwd (T={T_TRAIN}, R={R_CHAINS}, B={B}, G={G}), {form} form: "
                  f"hs/hT/cT bit-equal to lstm_scan {fwd_bits}; max|err| vs plain {fwd_err:.3g} "
                  f"(gate {SCAN_ATOL}); form {fwd_form}; lstm_scan_bwd_step vs plain, of max|out|: "
                  f"{err:.3g} (form {L.lstm_scan_bwd_step.form}, gate {SCAN_BWD_RTOL}); rows "
                  f"bit-equal alone {alone}, {SCAN_TRAIN_REPEATS} repeats bit-equal {repeats}, the "
                  f"forms bit-equal {forms_bits}  [{smi}]")
            require(fwd_bits, f"K10 with residuals ({form}) is not K10's bits at G {G}, B {B}")
            require(fwd_err <= SCAN_ATOL, f"K10's residuals ({form}) disagree with plain at G {G}, "
                                          f"B {B}")
            require(err <= SCAN_BWD_RTOL, f"K11 ({form}) disagrees with plain at G {G}, B {B}: "
                                          f"{err}")
            require(alone, f"K11 ({form}) rows at G {G}, B {B} are not their bits alone")
            require(repeats, f"K11 ({form}) at G {G}, B {B} gave other bits on another run")
            require(same_bits, f"K11's two forms give other bits at G {G}, B {B}")
            if (G, B, form) == (G_HIDDEN, B_TRAIN, row["default_form"]):
                main = (xp, whh, h0, c0, cts, gates, cs, fwd[0], out[0])
            if (G, B, form) == (SCAN_TRAIN_WIDE_G, B_TRAIN, row["default_form"]):
                wide = (xp, whh, h0, c0, cts, gates, cs)
            del fwd, k10, one
        forms = row["forms"]
        row.update(forms[row["default_form"]])
        row["fwd_max_abs_err"] = max(f["fwd_max_abs_err"] for f in forms.values())
        row["bwd"] = dict(row["bwd"], max_abs_err=max(f["bwd"]["max_abs_err"]
                                                      for f in forms.values()))
        fig["shapes"][f"G{G}_B{B}"] = row
        del xp, whh, h0, c0, cts, fwd_ref, bwd_ref, bwd_in, bwd_by_form, out

    # timings at the UMX-L training shape
    xp, whh, h0, c0, cts, gates, cs, hs, dxp = main
    B = B_TRAIN
    fwd_args, bwd_args = (xp, whh, h0, c0, B), (gates, cs, c0, whh, *cts, B)
    t = {"lstm_scan_train_fwd": cuda_ms(lambda: L.lstm_scan_train_fwd(*fwd_args), 3),
         "lstm_scan": cuda_ms(lambda: L.lstm_scan(*fwd_args), 3)}
    t["lstm_scan_bwd_step"] = cuda_ms(lambda: L.lstm_scan_bwd_step(*bwd_args), 3)
    fig["form"] = {"lstm_scan_train_fwd": L.lstm_scan_train_fwd.form,
                   "lstm_scan_bwd_step": L.lstm_scan_bwd_step.form}
    # the streaming forms at the same shape, in the same call
    for name, fn, a in (("lstm_scan_train_fwd", L.lstm_scan_train_fwd, fwd_args),
                        ("lstm_scan", L.lstm_scan, fwd_args),
                        ("lstm_scan_bwd_step", L.lstm_scan_bwd_step, bwd_args)):
        t[f"{name}_streaming"] = cuda_ms(lambda: fn(*a, _form="streaming"), 3)
    for name in ("lstm_scan_train_fwd", "lstm_scan_bwd_step"):
        require(t[name] < t[f"{name}_streaming"],
                f"{name} at the training shape: the resident form ({t[name]} ms) is not faster "
                f"than the streaming one ({t[f'{name}_streaming']} ms)")
    t["lstm_scan_dw_bmm"] = cuda_ms(lambda: L.lstm_scan_dw(hs, h0, dxp, B), 5)
    plain = {"lstm_scan_train_fwd": cuda_ms(lambda: L.lstm_scan_train_fwd_plain(*fwd_args), 1),
             "lstm_scan_bwd_step": cuda_ms(lambda: L.lstm_scan_bwd_step_plain(*bwd_args), 1)}
    rows = R_CHAINS * B
    step_bytes = T_TRAIN * rows * G_HIDDEN * 4
    bounds = {
        "lstm_scan_train_fwd": scan_bound(T_TRAIN, rows, G_HIDDEN, fwd_args[:4]),
        "lstm_scan_bwd_step": scan_bwd_bound(T_TRAIN, rows, G_HIDDEN, bwd_args[:7]),
        "lstm_scan_dw_bmm": bound_ms(nbytes(hs, h0, dxp) + R_CHAINS * G_HIDDEN * 4 * G_HIDDEN * 4,
                                     2.0 * T_TRAIN * rows * G_HIDDEN * 4 * G_HIDDEN, "f32"),
    }
    # the residuals' bytes: gates (T, RB, 4G) and cs (T, RB, G) out
    bounds["lstm_scan_train_fwd"] = bound_ms(
        nbytes(*fwd_args[:4]) + (T_TRAIN + 2) * rows * G_HIDDEN * 4 + 5 * step_bytes,
        2.0 * T_TRAIN * rows * G_HIDDEN * 4 * G_HIDDEN, "f32")
    # the yardstick: four nn.LSTM(bidirectional) f32 calls, forward and
    # backward, at the same T, batch and G (they compute the ih product too)
    lstm = torch.nn.LSTM(2 * G_HIDDEN, G_HIDDEN, bidirectional=True).to(dev)
    x = torch.randn(T_TRAIN, B, 2 * G_HIDDEN, device=dev, requires_grad=True)
    gy = torch.randn(T_TRAIN, B, 2 * G_HIDDEN, device=dev)

    def yardstick():
        for _ in range(4):
            lstm(x)[0].backward(gy)

    t["nn_lstm_x4_fwd_bwd"] = cuda_ms(yardstick, 2)
    del lstm, x, gy
    for name, ms in t.items():
        before = (f" (before W_hh stayed on the chip {SCAN_TRAIN_EARLIER_MS[name]})"
                  if name in SCAN_TRAIN_EARLIER_MS else "")
        print(f"{name} (T={T_TRAIN}, R={R_CHAINS}, B={B}, G={G_HIDDEN}): {ms:.4f} ms = "
              f"{ms / T_TRAIN * 1e3:.3f} us a step{before}  [{smi}]")
    print(f"bounds: K10 with residuals {bounds['lstm_scan_train_fwd'][0]:.4f} ms by "
          f"{bounds['lstm_scan_train_fwd'][1]}, K11 {bounds['lstm_scan_bwd_step'][0]:.4f} ms by "
          f"{bounds['lstm_scan_bwd_step'][1]}, dW {bounds['lstm_scan_dw_bmm'][0]:.4f} ms by "
          f"{bounds['lstm_scan_dw_bmm'][1]}; plain K10 with residuals "
          f"{plain['lstm_scan_train_fwd']:.4f} ms, K11 {plain['lstm_scan_bwd_step']:.4f} ms  "
          f"[{smi}]")
    fig.update(ms=t, plain_ms=plain, bound=bounds)

    # both kernels at hidden 1280's width in their default (wide) form beside
    # the streaming one, in turns (gated faster): time, plain time and bound
    xp, whh, h0, c0, cts, gates, cs = wide
    G = SCAN_TRAIN_WIDE_G
    fwd_args, bwd_args = (xp, whh, h0, c0, B), (gates, cs, c0, whh, *cts, B)
    step_bytes = T_TRAIN * rows * G * 4
    fig["wide"] = {}
    for name, fn, plain_fn, a, bound in (
        ("lstm_scan_train_fwd", L.lstm_scan_train_fwd, L.lstm_scan_train_fwd_plain, fwd_args,
         bound_ms(nbytes(*fwd_args[:4]) + (T_TRAIN + 2) * rows * G * 4 + 5 * step_bytes,
                  2.0 * T_TRAIN * rows * G * 4 * G, "f32")),
        ("lstm_scan_bwd_step", L.lstm_scan_bwd_step, L.lstm_scan_bwd_step_plain, bwd_args,
         scan_bwd_bound(T_TRAIN, rows, G, bwd_args[:7])),
    ):
        stream_ms, ms = paired_ms(lambda: fn(*a, _form="streaming"), lambda: fn(*a), 1,
                                  f"{name} G {G} streaming vs wide")
        fn(*a)
        form = fn.form
        plain_ms = cuda_ms(lambda: plain_fn(*a), 1)
        fig["wide"][name] = {"G": G, "form": form, "ms": ms, "streaming_ms": stream_ms,
                             "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1]}
        print(f"{name} (T={T_TRAIN}, R={R_CHAINS}, B={B}, G={G}), form {form}: {ms:.4f} ms = "
              f"{ms / T_TRAIN * 1e3:.3f} us a step, the streaming form in turns "
              f"{stream_ms:.4f} ms ({stream_ms / ms:.2f} x), plain {plain_ms:.4f} ms, bound "
              f"{bound[0]:.4f} ms by {bound[1]}  [{smi}]")
        require(form[0] == "wide", f"{name} at G {G} ran {form}, not the wide form")
        require(ms < stream_ms, f"{name} at G {G}: the wide form ({ms} ms) is not faster than "
                f"the streaming one ({stream_ms} ms)")
    return fig


_CPU_TRAIN_STEP = """
import sys
import torch
torch.set_num_threads(int(sys.argv[3]))
from dataclasses import fields
from umx_tpu_torch.config import ModelConfig
from umx_tpu_torch.models.umx import UMXParams, synthetic_params
from umx_tpu_torch.train import FROZEN, mask_loss
batch = torch.load(sys.argv[1])
cfg = ModelConfig(hidden_size=int(sys.argv[4]), lstm_impl="scan")
p = synthetic_params(cfg, seed=0)
names = [f.name for f in fields(UMXParams) if f.name not in FROZEN]
for n in names:
    getattr(p, n).requires_grad_(True)
out = {}
for key, scale in (("grads", 1.0), ("nudged", 1.0 + float(sys.argv[5]))):
    for n in names:
        getattr(p, n).grad = None
    loss = mask_loss(p, {**batch, "x": batch["x"] * scale}, cfg)
    loss.backward()
    out[key] = {n: getattr(p, n).grad.clone() for n in names}
    out.setdefault("loss", loss.item())
torch.save(out, sys.argv[2])
print(torch.backends.cpu.get_cpu_capability(), torch.get_num_threads())
"""


def scan_train_vs_cpu(dev, tmp: str, smi: str) -> dict:
    """Phase 20c: the first training step's loss and gradients under "scan"
    at UMX-L, on the card against the port's CPU path in a child process
    pinned as phase 19 pins it, on the same batch (made on the CPU)."""
    from dataclasses import fields

    import torch

    from umx_tpu_torch.config import DSPConfig, ModelConfig
    from umx_tpu_torch.models.umx import UMXParams, synthetic_params
    from umx_tpu_torch.train import FROZEN, make_batch_from_audio, mask_loss

    cfg = ModelConfig(hidden_size=SCAN_TRAIN_HIDDEN, lstm_impl="scan")
    rng = np.random.default_rng(20)
    n = DSPConfig().hop * (SCAN_TRAIN_CPU_FRAMES - 1)
    mix = rng.standard_normal((SCAN_TRAIN_CPU_BATCH, 2, n)).astype(np.float32) * 0.1
    targets = rng.standard_normal((SCAN_TRAIN_CPU_BATCH, 4, 2, n)).astype(np.float32) * 0.05
    batch = make_batch_from_audio(mix, targets, cfg, DSPConfig(), SCAN_TRAIN_CPU_FRAMES, "cpu")
    job, out = os.path.join(tmp, "train_batch.pt"), os.path.join(tmp, "train_grads.pt")
    torch.save(batch, job)
    res = subprocess.run([sys.executable, "-c", _CPU_TRAIN_STEP, job, out, str(SCAN_CPU_THREADS),
                          str(cfg.hidden_size), str(SCAN_NUDGE)],
                         cwd=os.path.dirname(os.path.abspath(__file__)),
                         env={**os.environ, **SCAN_CPU_PINS}, capture_output=True, text=True,
                         timeout=600)
    require(res.returncode == 0, f"the pinned CPU train step exited {res.returncode}: "
                                 f"{res.stderr[-2000:]}")
    cpu = torch.load(out)

    p = synthetic_params(cfg, seed=0, device=dev)
    names = [f.name for f in fields(UMXParams) if f.name not in FROZEN]
    for name in names:
        getattr(p, name).requires_grad_(True)
    loss = mask_loss(p, {k: v.to(dev) for k, v in batch.items()}, cfg)
    loss.backward()
    loss_rel = abs(loss.item() - cpu["loss"]) / abs(cpu["loss"])
    errs = {name: rel_to_max(getattr(p, name).grad.cpu(), cpu["grads"][name]) for name in names}
    own = {name: rel_to_max(cpu["nudged"][name], cpu["grads"][name]) for name in names}
    gate = {name: SCAN_TRAIN_GRAD_TOL if name in SCAN_TRAIN_LSTM_FIELDS
            else min(SCAN_TRAIN_GRAD_CAP, max(SCAN_TRAIN_GRAD_TOL, 3 * own[name]))
            for name in names}
    worst = max(errs, key=lambda name: errs[name] / gate[name])
    print(f"train step under scan, card vs the pinned CPU path (UMX-L, batch "
          f"{SCAN_TRAIN_CPU_BATCH} x {SCAN_TRAIN_CPU_FRAMES} frames): loss {loss_rel:.3g} "
          f"relative (gate {SCAN_TRAIN_LOSS_RTOL}); gradients, of each field's max|g|, card vs CPU "
          f"(the CPU against itself on the input x (1 + {SCAN_NUDGE:g})): " + ", ".join(
              f"{name} {errs[name]:.3g} ({own[name]:.3g})" for name in names)
          + f"; the LSTM's fields gated at {SCAN_TRAIN_GRAD_TOL}, the others at 3 x the CPU's "
          f"own within [{SCAN_TRAIN_GRAD_TOL}, {SCAN_TRAIN_GRAD_CAP}]; nearest its gate: {worst} "
          f"({errs[worst]:.3g} of {gate[worst]:.3g}); CPU side (capability, threads) "
          f"{res.stdout.strip().splitlines()[-1]}  [{smi}]")
    require(loss_rel <= SCAN_TRAIN_LOSS_RTOL, f"the card's loss under scan is off: {loss_rel}")
    require(errs[worst] <= gate[worst], f"the card's gradient of {worst} under scan is off: "
                                        f"{errs[worst]} against a gate of {gate[worst]}")
    return {"loss_rel": loss_rel, "grad_rel": errs, "cpu_own_grad_rel": own, "grad_gate": gate,
            "cpu_pins": res.stdout.strip()}


def scan_train_path(dev, tmp: str, counters: dict, smi: str) -> dict:
    """Phase 20b: ``train_loop`` under "scan" at UMX-L (counts set to 0
    before and read after: K10 with residuals and K11 three times a step,
    K4-K6 never), steps on a fixed batch under "scan" and the default in
    turns (steps/s; the loss under "scan" falls), and a synthetic
    hidden-1280 model (G 640) trained 2 steps under "auto" (the wide K4/K5
    and K6) and 2 under "scan" (the wide K10 with residuals and K11, 6
    launches each)."""
    import torch

    from umx_tpu_torch.config import DSPConfig, ModelConfig
    from umx_tpu_torch.data import StemDataset, train_loop
    from umx_tpu_torch.models.umx import synthetic_params
    from umx_tpu_torch.train import (
        TrainConfig, init_train_state, make_batch_from_audio, make_train_step,
    )

    root = os.path.join(tmp, "stems_train")
    if not os.path.isdir(root):
        write_stem_dir(root)
    tcfg = TrainConfig(seq_len=T_TRAIN)
    excerpt = DSPConfig().hop * (tcfg.seq_len - 1)
    train = StemDataset(root, excerpt_samples=excerpt, split="train", seed=0)
    scan_cfg = ModelConfig(hidden_size=SCAN_TRAIN_HIDDEN, lstm_impl="scan")
    params0 = synthetic_params(scan_cfg, seed=0, device=dev)
    reset_counts(counters)
    t0 = time.perf_counter()
    state, hist = train_loop(train, scan_cfg, tcfg, steps=TRAIN_STEPS, batch_size=B_TRAIN,
                             params=params0, device=dev, log_every=0)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    print(f"train_loop under scan (UMX-L, batch {B_TRAIN} x {tcfg.seq_len} frames, "
          f"{TRAIN_STEPS} steps): {loop_s:.3f} s wall; losses {[round(x, 6) for x in hist]}; "
          f"kernel runs {launches}  [{smi}]")
    require(len(hist) == TRAIN_STEPS and bool(np.isfinite(hist).all()), f"losses: {list(hist)}")
    n = 3 * TRAIN_STEPS
    require(launches["lstm_scan_train_fwd"] == n and launches["lstm_scan_bwd_step"] == n,
            f"under scan K10 with residuals and K11 ran {launches['lstm_scan_train_fwd']} and "
            f"{launches['lstm_scan_bwd_step']} times, not 3 a step")
    for name in ("lstm_merged_train_fwd", "lstm_merged_bwd_step", "lstm_merged_dw", "lstm_merged"):
        require(launches[name] == 0, f"{name} ran {launches[name]} times under scan")
    require(not torch.equal(state.params.lstm_hh_w, params0.lstm_hh_w), "W_hh did not train")
    del state

    # warm steps on one fixed batch, "auto" and "scan" in turns
    mix, targets = train.sample(B_TRAIN)
    batch = make_batch_from_audio(mix, targets, scan_cfg, DSPConfig(), tcfg.seq_len, dev)
    steps = {}
    for impl in ("auto", "scan"):
        cfg = ModelConfig(hidden_size=SCAN_TRAIN_HIDDEN, lstm_impl=impl)
        steps[impl] = [make_train_step(cfg), init_train_state(params0, tcfg), [], []]
    for impl in ("auto", "scan", "scan", "auto", "auto", "scan"):
        step, st, losses, walls = steps[impl]
        if not losses:
            st, loss = step(st, batch)  # warm-up
            losses.append(float(loss))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2):
            st, loss = step(st, batch)
            losses.append(float(loss))  # a scalar fetch: a barrier each step
        walls.append(2 / (time.perf_counter() - t0))
        steps[impl][1] = st
    sps = {impl: float(np.median(v[3])) for impl, v in steps.items()}
    scan_losses = steps["scan"][2]
    print(f"train steps/s (warm, UMX-L, batch {B_TRAIN} x {tcfg.seq_len} frames, one batch, "
          f"median of 3 turns): scan {sps['scan']:.3f}, auto {sps['auto']:.3f}; losses under scan "
          f"{[round(x, 6) for x in scan_losses]}  [{smi}]")
    require(bool(np.isfinite(scan_losses).all()) and scan_losses[-1] < scan_losses[0],
            f"steps under scan on one batch did not lower its loss: {scan_losses}")
    del steps, batch

    # a model wider than UMX-L, G 640: 2 steps under "auto" (the merged
    # kernels, K4 and K5 in their wide block forms, and K6, as JAX's "auto"
    # on its accelerator) and 2 under "scan" (K10 with residuals and K11 in
    # their wide forms), the same batch and start
    from umx_tpu_torch.ops import lstm_cuda as L

    wide_cfgs = {impl: ModelConfig(hidden_size=SCAN_WIDE_HIDDEN, lstm_impl=impl)
                 for impl in ("auto", "scan")}
    mix, targets = train.sample(B_TRAIN)
    batch = make_batch_from_audio(mix, targets, wide_cfgs["auto"], DSPConfig(), tcfg.seq_len, dev)
    wide_params = synthetic_params(wide_cfgs["auto"], seed=0, device=dev)
    wide_runs = {}
    for impl, cfg in wide_cfgs.items():
        wide = init_train_state(wide_params, tcfg)
        step = make_train_step(cfg)
        reset_counts(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wide_losses = []
        for _ in range(2):
            wide, loss = step(wide, batch)
            wide_losses.append(float(loss))
        wide_s = time.perf_counter() - t0
        wide_launches = {name: fn.launches for name, fn in counters.items() if fn.launches}
        forms = ((L.lstm_merged_train_fwd.form, L.lstm_merged_bwd_step.form) if impl == "auto"
                 else (L.lstm_scan_train_fwd.form, L.lstm_scan_bwd_step.form))
        print(f"hidden {SCAN_WIDE_HIDDEN} (G {SCAN_WIDE_HIDDEN // 2}) under {impl}, 2 steps at "
              f"batch {B_TRAIN} x {tcfg.seq_len}: losses {wide_losses}, {wide_s:.3f} s; kernel "
              f"runs {wide_launches}; forms {forms}  [{smi}]")
        require(bool(np.isfinite(wide_losses).all()),
                f"hidden {SCAN_WIDE_HIDDEN} losses under {impl}: {wide_losses}")
        if impl == "auto":
            require(all(wide_launches.get(k, 0) == 6 for k in
                        ("lstm_merged_train_fwd", "lstm_merged_bwd_step", "lstm_merged_dw"))
                    and not any(wide_launches.get(k) for k in
                                ("lstm_scan_train_fwd", "lstm_scan_bwd_step")),
                    f"hidden {SCAN_WIDE_HIDDEN} under auto did not train through the wide "
                    f"K4/K5 and K6: {wide_launches}")
            require(forms[0][0] == "wide" and forms[1][0] == "wide",
                    f"hidden {SCAN_WIDE_HIDDEN} under auto: K4/K5 ran {forms}")
        else:
            require(all(wide_launches.get(k, 0) == 6 for k in
                        ("lstm_scan_train_fwd", "lstm_scan_bwd_step"))
                    and not any(wide_launches.get(k) for k in
                                ("lstm_merged_train_fwd", "lstm_merged_bwd_step",
                                 "lstm_merged_dw")),
                    f"hidden {SCAN_WIDE_HIDDEN} under scan did not train through K10 with "
                    f"residuals and K11: {wide_launches}")
            require(forms[0][0] == "wide" and forms[1][0] == "wide",
                    f"hidden {SCAN_WIDE_HIDDEN} under scan: K10r/K11 ran {forms}")
        wide_runs[impl] = {"losses": wide_losses, "s": wide_s, "launches": wide_launches,
                           "forms": forms}
        del wide, step
    del batch, wide_params
    return {"loop_s": loop_s, "losses": list(map(float, hist)), "launches": launches,
            "steps_per_s": sps, "fixed_batch_losses_scan": scan_losses,
            "wide": wide_runs["auto"], "wide_scan": wide_runs["scan"]}


def stress_scan(dev, smi: str) -> dict:
    """Phase 20d: K10, K10 with residuals and K11 launched at least
    ``STRESS_LAUNCHES`` times at T ``STRESS_T`` over ``STRESS_BS`` x
    ``STRESS_GS`` at R 8 chains and at one chain more than a launch holds
    (two chain groups), each output compared bit for bit with the first run
    of its shape; every other round runs K1 on a second CUDA stream beside
    them.  A race in the tagged exchange would move an output."""
    import torch

    from umx_tpu_torch.ops import lstm_cuda as L

    t0 = time.perf_counter()
    side = torch.cuda.Stream(device=dev)
    k1_args = lstm_inputs(dev, T_SEG, 1, seed=77, R=2, G=256)
    side.wait_stream(torch.cuda.current_stream(dev))
    cases = []
    for G in STRESS_GS:
        form = L.scan_form(G, torch.float32)  # each width in the form it runs in
        blocks = L.scan_blocks_per_chain(G, L.SCAN_WIDE_UNITS if form == "wide" else L.SCAN_UNITS)
        per = min(L._scan_capacity(dev.index, G, False, k, form)[1] // blocks
                  for k in ("K10", "K10r"))
        per_bwd = L._scan_capacity(dev.index, G, False, "K11", form)[1] // blocks
        for R in sorted({R_CHAINS, per + 1, per_bwd + 1}):
            for B in STRESS_BS:
                cases.append((G, R, B))
    kernels = ("lstm_scan", "lstm_scan_train_fwd", "lstm_scan_bwd_step")
    # at least STRESS_LAUNCHES launches of the resident forms alone
    resident_cases = sum(L.scan_form(G, torch.float32) == "resident" for G, _, _ in cases)
    rounds = -(-STRESS_LAUNCHES // (resident_cases * len(kernels)))
    launches, mismatches, beside, groups = 0, 0, 0, set()
    by_form = {f: 0 for f in L.SCAN_FORMS}
    for G, R, B in cases:
        xp, whh, h0, c0, cts = scan_train_inputs(dev, STRESS_T, B, G, seed=G + R + B, R=R)
        first = {}
        for k in range(rounds):
            if k % 2:
                with torch.cuda.stream(side):
                    L.lstm_merged(*k1_args)
                beside += 1
            outs = {"lstm_scan": L.lstm_scan(xp, whh, h0, c0, B)}
            groups.add(L.lstm_scan.form[3])
            outs["lstm_scan_train_fwd"] = L.lstm_scan_train_fwd(xp, whh, h0, c0, B)
            gates, cs = outs["lstm_scan_train_fwd"][3:]
            outs["lstm_scan_bwd_step"] = L.lstm_scan_bwd_step(gates, cs, c0, whh, *cts, B)
            groups.add(L.lstm_scan_bwd_step.form[3])
            launches += len(outs)
            by_form[L.lstm_scan_bwd_step.form[0]] += len(outs)
            if not first:
                first = outs
                continue
            for name, out in outs.items():
                mismatches += sum(not torch.equal(a, b) for a, b in zip(out, first[name]))
        torch.cuda.synchronize()
        del xp, whh, h0, c0, cts, first, outs
    side.synchronize()
    wall = time.perf_counter() - t0
    print(f"stress: {mismatches} mismatches in {launches} launches of K10, K10 with residuals "
          f"and K11 (T {STRESS_T}, B {STRESS_BS}, G {STRESS_GS}, {len(cases)} shapes, chain "
          f"groups {sorted(groups)}; {beside} rounds with K1 on a second stream; launches by "
          f"form {by_form}), {wall:.1f} s wall  [{smi}]")
    require(by_form["resident"] >= STRESS_LAUNCHES,
            f"the stress run made {by_form['resident']} launches of the resident forms")
    require(max(groups) >= 2, f"the stress run never split the chains: {groups}")
    require(mismatches == 0, f"the stress run found {mismatches} outputs off their first run's bits")
    return {"launches": launches, "launches_by_form": by_form, "mismatches": mismatches,
            "shapes": len(cases), "chain_groups": sorted(groups), "rounds_beside_k1": beside,
            "wall_s": wall}


# "scan" against "auto" at hidden 1280: the float32 recurrence against the
# one with bf16 h and W_hh operands, two functions that differ by the
# operands' rounding, so the gate is the bf16 seams' class (PERF.md section
# 2: max 2e-2 and RMS 2e-3 of the peak); the port's CPU path gives 4.1e-3
# and 2.1e-4 for the same two functions on this model and audio
SCAN_VS_BF16_MAX, SCAN_VS_BF16_RMS = 2e-2, 2e-3


def wide_auto_demix(dev, tmp: str, counters: dict, smi: str) -> dict:
    """Phase 20e: the synthetic hidden-1280 model (G 640) demixes 5 s, the
    seams pinned to float32, under the default "auto" through the wide K1
    and never K10, with the bits of "pallas_merged" (one program, as JAX's
    "auto" on its accelerator); under "scan" through K10's wide form and
    never K1, within ``SCAN_VS_BF16_MAX`` and ``SCAN_VS_BF16_RMS`` of the
    peak of "auto"'s stems."""
    from umx_tpu_torch.config import EngineConfig, ModelConfig, SegmentConfig
    from umx_tpu_torch.engine.separator import Separator
    from umx_tpu_torch.io.ggml import write_ggml
    from umx_tpu_torch.models.umx import synthetic_state_dicts
    from umx_tpu_torch.ops import lstm_cuda as L

    wide = os.path.join(tmp, "synthetic_h1280.bin")
    if not os.path.isfile(wide):  # phase 19 writes it
        write_ggml(wide, SCAN_WIDE_HIDDEN,
                   synthetic_state_dicts(ModelConfig(hidden_size=SCAN_WIDE_HIDDEN), seed=0))
    audio = synth_mix(5.0, seed=3)
    seg = SegmentConfig(segment_secs=2.0)
    out, launches, forms = {}, {}, {}
    for impl in ("auto", "pallas_merged", "scan"):
        cfg = f32_seams(EngineConfig(model=ModelConfig(lstm_impl=impl), segment=seg))
        reset_counts(counters)
        out[impl] = Separator.from_ggml(wide, cfg, dev).demix_track(audio, seed=0)
        launches[impl] = {k: fn.launches for k, fn in counters.items() if fn.launches}
        forms[impl] = L.lstm_scan.form if impl == "scan" else L.lstm_merged.form
        if impl == "scan":
            require(launches[impl].get("lstm_scan", 0) > 0
                    and not launches[impl].get("lstm_merged") and forms[impl][0] == "wide",
                    f"hidden {SCAN_WIDE_HIDDEN} under scan did not demix through K10's wide "
                    f"form: {launches[impl]}, {forms[impl]}")
        else:
            require(launches[impl].get("lstm_merged", 0) > 0
                    and not launches[impl].get("lstm_scan") and forms[impl][0] == "wide",
                    f"hidden {SCAN_WIDE_HIDDEN} under {impl} did not demix through the wide K1: "
                    f"{launches[impl]}, {forms[impl]}")
    same = bool(np.array_equal(out["auto"], out["pallas_merged"]))
    peak = float(np.abs(out["auto"]).max())
    diff = out["scan"] - out["auto"]
    scan_max = float(np.abs(diff).max()) / peak
    scan_rms = float(np.sqrt(np.mean(diff.astype(np.float64) ** 2))) / peak
    print(f"hidden {SCAN_WIDE_HIDDEN} demix of 5 s, float32 seams: auto K1 "
          f"{launches['auto']['lstm_merged']} launches ({forms['auto']}), K10 none; stems "
          f"bit-equal to lstm_impl pallas_merged's: {same}; scan K10 "
          f"{launches['scan']['lstm_scan']} launches ({forms['scan']}), K1 none, scan - auto of "
          f"the peak: max {scan_max:.3g}, RMS {scan_rms:.3g} (gates {SCAN_VS_BF16_MAX}, "
          f"{SCAN_VS_BF16_RMS}); finite {bool(np.isfinite(out['auto']).all())}  [{smi}]")
    require(same and np.isfinite(out["auto"]).all(),
            "auto at hidden 1280 is not the pallas_merged demix")
    require(np.isfinite(out["scan"]).all() and scan_max <= SCAN_VS_BF16_MAX
            and scan_rms <= SCAN_VS_BF16_RMS,
            f"scan at hidden 1280 is off auto's stems by {scan_max} (max), {scan_rms} (RMS) of "
            f"the peak")
    return {"auto_equals_pallas_merged": same, "scan_vs_auto_max": scan_max,
            "scan_vs_auto_rms": scan_rms, "launches": launches, "forms": forms}


def scan_train_phase(dev, tmp: str, counters: dict, smi: str) -> dict:
    """Phase 20: training through the float32 recurrence (module docstring)."""
    import torch

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fig = {"card": smi, "kernels": check_scan_train_kernels(dev, smi)}
    fig["train"] = scan_train_path(dev, tmp, counters, smi)
    fig["vs_cpu"] = scan_train_vs_cpu(dev, tmp, smi)
    fig["wide_demix"] = wide_auto_demix(dev, tmp, counters, smi)
    fig["stress"] = stress_scan(dev, smi)
    fig["phase_s"] = time.perf_counter() - t_phase
    print(f"scan train phase: {fig['phase_s']:.1f} s wall  [{smi}]")
    return fig


# phase 21: every width the JAX kernels take
WIDTH_PAD_HIDDEN = 36  # G 18: the resident kernels run it padded to 24
WIDTH_K9_WIDE_HIDDEN = 2048  # G 1024: no cluster holds a chain's W_hh; K9 runs the wide K1
WIDTH_RTOL = 2e-3  # PERF.md section 2: the card against the CPU with bf16 recurrence operands
WIDTH_TRAIN_STEPS = 2
# "bfloat16" masks on the card against the CPU's: one bf16 rounding of an
# operand may flip between two f32 sums (2^-8 relative): max and RMS of the
# error over the masks' peak
WIDTH_BF16_MAX, WIDTH_BF16_RMS = 2e-2, 2e-3
# the kernels line's rows of the new forms: name -> (wrapper, source, TPU kernel)
WIDTH_ROWS = {
    "lstm_merged_wide": ("lstm_merged", "umx_tpu_torch/csrc/lstm_merged.cu",
                         "umx_tpu/ops/lstm_pallas.py:158"),
    "lstm_merged_padded": ("lstm_merged", "umx_tpu_torch/csrc/lstm_merged.cu",
                           "umx_tpu/ops/lstm_pallas.py:158"),
    "lstm_merged_train_fwd_wide": ("lstm_merged_train_fwd", "umx_tpu_torch/csrc/lstm_merged.cu",
                                   "umx_tpu/ops/lstm_pallas.py:323"),
    "lstm_merged_train_fwd_padded": ("lstm_merged_train_fwd",
                                     "umx_tpu_torch/csrc/lstm_merged.cu",
                                     "umx_tpu/ops/lstm_pallas.py:323"),
    "lstm_merged_bwd_step_wide": ("lstm_merged_bwd_step", "umx_tpu_torch/csrc/lstm_train.cu",
                                  "umx_tpu/ops/lstm_pallas.py:397"),
    "lstm_merged_bwd_step_padded": ("lstm_merged_bwd_step", "umx_tpu_torch/csrc/lstm_train.cu",
                                    "umx_tpu/ops/lstm_pallas.py:397"),
    "lstm_merged_dw_padded": ("lstm_merged_dw", "umx_tpu_torch/csrc/lstm_dw.cu",
                              "umx_tpu/ops/lstm_pallas.py:397"),
    "lstm_layer_pertarget_padded": ("lstm_layer_pertarget",
                                    "umx_tpu_torch/csrc/lstm_pertarget.cu",
                                    "umx_tpu/ops/lstm_pallas.py:39"),
    "lstm_layer_pertarget_wide": ("lstm_layer_pertarget", "umx_tpu_torch/csrc/lstm_merged.cu",
                                  "umx_tpu/ops/lstm_pallas.py:39"),
}


def wide_vs_streaming(name: str, fn, args, ref, smi: str, err_of=None):
    """The wide block form (``fn(*args)``) beside its streaming yardstick
    (``fn(*args, _form="wide_streaming")``) in turns: the yardstick within
    5e-3 of the plain version's ``ref`` (by ``err_of``, max|err| unless
    given), the wide form faster (a hard gate).  Returns (wide ms,
    streaming ms, the yardstick's error vs plain)."""
    import torch

    streaming = fn(*args, _form="wide_streaming")
    torch.cuda.synchronize()
    form = fn.form
    err = max((err_of or max_err)(a, b) for a, b in zip(streaming, ref))
    stream_ms, ms = paired_ms(lambda: fn(*args, _form="wide_streaming"), lambda: fn(*args), 1,
                              f"{name} streaming vs wide")
    print(f"{name}: wide block form {ms:.4f} ms against its streaming yardstick {stream_ms:.4f} "
          f"ms (form {form}, error vs plain {err:.3g}), in turns  [{smi}]")
    require(form[0] == "wide_streaming" and err <= 5e-3, f"{name} streaming: {form}, {err}")
    require(ms < stream_ms, f"{name}: the wide block form ({ms} ms) is not faster than the "
            f"streaming form ({stream_ms} ms)")
    return ms, stream_ms, err


def width_forward_rows(dev, smi: str) -> dict:
    """Phase 21a: K1 in its wide form (G 640, hidden 1280: a 10-warp block
    form, W_hh in registers and shared memory) and padded (G 18, hidden 36)
    at the segment shape (T 2584, R 8, B 1), K9 padded (G 18) and through
    the wide K1 (G 1024, two chain groups) at T# 4, D 2: each against its
    plain version (5e-3), rows at B 3 bit-equal to their runs alone, a
    second run bit-equal, timed beside its plain version and its bound;
    the wide forms beside their streaming yardstick, which they must beat."""
    import torch

    from umx_tpu_torch.ops import lstm_cuda as L

    rows = {}
    for name, G in (("lstm_merged_wide", SCAN_WIDE_HIDDEN // 2),
                    ("lstm_merged_padded", WIDTH_PAD_HIDDEN // 2)):
        args = lstm_inputs(dev, T_SEG, 1, seed=2100 + G, G=G)
        out = L.lstm_merged(*args)
        torch.cuda.synchronize()
        form = L.lstm_merged.form
        ref = L.lstm_merged_plain(*args)
        err = max(max_err(a, b) for a, b in zip(out, ref))
        stable = all(torch.equal(a, b) for a, b in zip(L.lstm_merged(*args), out))
        xp, whh, h0, c0, B = lstm_inputs(dev, 300, 3, seed=2200 + G, G=G)
        three = L.lstm_merged(xp, whh, h0, c0, B)
        alone = True
        for b in range(B):
            r = torch.arange(R_CHAINS, device=dev) * B + b
            one = L.lstm_merged(xp[:, r].contiguous(), whh, h0[r].contiguous(),
                                c0[r].contiguous(), 1)
            alone &= all(torch.equal(a, o) for a, o in
                         zip(one, (three[0][:, r], three[1][r], three[2][r])))
        ms = cuda_ms(lambda: L.lstm_merged(*args), 3)
        plain_ms = cuda_ms(lambda: L.lstm_merged_plain(*args), 1)
        bound = lstm_bound(T_SEG, R_CHAINS, G, args[:4])
        rows[name] = {"G": G, "form": form, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                      "bound": bound, "rows_alone_bit_equal": alone, "bit_stable": stable}
        print(f"{name} (T={T_SEG}, R={R_CHAINS}, B=1, G={G}): max|err| vs plain {err:.3g}; form "
              f"{form}; rows at B 3 bit-equal alone {alone}; bit-stable {stable}; kernel "
              f"{ms:.4f} ms ({ms / T_SEG * 1e3:.3f} us a step), plain {plain_ms:.4f} ms, bound "
              f"{bound[0]:.4f} ms by {bound[1]}  [{smi}]")
        require(err <= 5e-3 and alone and stable, f"{name} at G {G}: {rows[name]}")
        require((form[0] == "wide") == (name == "lstm_merged_wide"), f"{name} ran form {form}")
        if name == "lstm_merged_wide":
            wide_ms, stream_ms, _ = wide_vs_streaming(name, L.lstm_merged, args, ref, smi)
            rows[name].update(ms_in_turns=wide_ms, streaming_ms=stream_ms)
        del args, out, ref, xp, whh, h0, c0, three
    for name, G in (("lstm_layer_pertarget_padded", WIDTH_PAD_HIDDEN // 2),
                    ("lstm_layer_pertarget_wide", WIDTH_K9_WIDE_HIDDEN // 2)):
        args = check_pertarget_at(dev, N_SRC, T_SEG, G, seed=2300 + G)[0]
        form = L.lstm_layer_pertarget.form
        out = L.lstm_layer_pertarget(*args)
        ref = L.lstm_pertarget_plain(*args)
        err = max(max_err(a, b) for a, b in zip(out, ref))
        stable = all(torch.equal(a, b) for a, b in zip(L.lstm_layer_pertarget(*args), out))
        ms = cuda_ms(lambda: L.lstm_layer_pertarget(*args), 3)
        plain_ms = cuda_ms(lambda: L.lstm_pertarget_plain(*args), 1)
        bound = lstm_bound(T_SEG, R_CHAINS, G, args)
        rows[name] = {"G": G, "form": form, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                      "bound": bound, "bit_stable": stable}
        print(f"{name} (T={T_SEG}, T#={N_SRC}, D=2, G={G}): max|err| vs plain {err:.3g}; form "
              f"{form}; bit-stable {stable}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{bound[0]:.4f} ms by {bound[1]}  [{smi}]")
        require(err <= 5e-3 and stable, f"{name} at G {G}: {rows[name]}")
        require((form[0] == "wide") == (name == "lstm_layer_pertarget_wide"),
                f"{name} ran form {form}")
        if name == "lstm_layer_pertarget_wide":
            wide_ms, stream_ms, _ = wide_vs_streaming(name, L.lstm_layer_pertarget, args, ref,
                                                      smi)
            rows[name].update(ms_in_turns=wide_ms, streaming_ms=stream_ms)
        del args, out, ref
    return rows


def width_train_rows(dev, smi: str) -> dict:
    """Phase 21a: K4 and K5 in their wide form (G 640: both block forms with
    W_hh on the chip, K5's fields the plan's) and padded (G 18) at the
    training shape (T 256, R 8, B 16): against their plain versions (5e-3;
    K5 of each output's largest entry), K4's hs/hT/cT K1's bits, rows alone
    and repeats bit-equal, timed beside plain and bound; the wide forms
    beside their streaming yardstick in turns, which they must beat."""
    import torch

    from umx_tpu_torch.ops import lstm_cuda as L

    rows = {}
    for suffix, G in (("wide", SCAN_WIDE_HIDDEN // 2), ("padded", WIDTH_PAD_HIDDEN // 2)):
        fwd_in, cts = train_inputs(dev, T_TRAIN, B_TRAIN, G, seed=2400 + G)
        xp, whh, h0, c0, B = fwd_in
        fwd = L.lstm_merged_train_fwd(*fwd_in)
        torch.cuda.synchronize()
        f_form = L.lstm_merged_train_fwd.form
        k1_bits = all(torch.equal(a, b) for a, b in zip(fwd[:3], L.lstm_merged(*fwd_in)))
        ferr = max(max_err(a, b) for a, b in zip(fwd, L.lstm_merged_train_fwd_plain(*fwd_in)))
        bwd_in = (fwd[3], fwd[4], c0, whh, *cts, B)
        bwd = L.lstm_merged_bwd_step(*bwd_in)
        torch.cuda.synchronize()
        b_form = L.lstm_merged_bwd_step.form
        bwd_ref = L.lstm_merged_bwd_step_plain(*bwd_in)
        berr = max(rel_err(a, b) for a, b in zip(bwd, bwd_ref))
        babs = max(max_err(a, b) for a, b in zip(bwd, bwd_ref))
        stable = all(torch.equal(a, b) for a, b in zip(L.lstm_merged_bwd_step(*bwd_in), bwd))
        alone = True
        for picks in ([0], sorted({B // 3, B - 1})):
            r = torch.tensor([c * B + b for c in range(R_CHAINS) for b in picks], device=dev)

            def sub(x):
                return (x[:, r] if x.dim() == 3 else x[r]).contiguous()

            n = len(picks)
            f1 = L.lstm_merged_train_fwd(sub(xp), whh, sub(h0), sub(c0), n)
            b1 = L.lstm_merged_bwd_step(sub(fwd[3]), sub(fwd[4]), sub(c0), whh,
                                        *(sub(c) for c in cts), n)
            alone &= all(torch.equal(a, sub(o)) for a, o in zip(f1, fwd))
            alone &= all(torch.equal(a, sub(o)) for a, o in zip(b1, bwd))
        rows_t = R_CHAINS * B
        step_elems = T_TRAIN * rows_t * G * 4
        ops = 2.0 * T_TRAIN * rows_t * G * 4 * G
        bounds = {"fwd": lstm_bound(T_TRAIN, rows_t, G, fwd_in[:4], extra_out=5 * step_elems),
                  "bwd": bound_ms(nbytes(*bwd_in[:7]) + 4 * step_elems + 2 * rows_t * G * 4, ops,
                                  "bf16")}
        times = {"fwd": (cuda_ms(lambda: L.lstm_merged_train_fwd(*fwd_in), 3),
                         cuda_ms(lambda: L.lstm_merged_train_fwd_plain(*fwd_in), 1)),
                 "bwd": (cuda_ms(lambda: L.lstm_merged_bwd_step(*bwd_in), 3),
                         cuda_ms(lambda: L.lstm_merged_bwd_step_plain(*bwd_in), 1))}
        yardstick = {"fwd": {}, "bwd": {}}
        if suffix == "wide":
            ref = L.lstm_merged_train_fwd_plain(*fwd_in)
            wide_ms, stream_ms, _ = wide_vs_streaming("lstm_merged_train_fwd_wide",
                                                      L.lstm_merged_train_fwd, fwd_in, ref, smi)
            yardstick["fwd"] = {"ms_in_turns": wide_ms, "streaming_ms": stream_ms}
            del ref
            # K5's block form: the plan's fields, then beside its streaming
            # yardstick (K11's streaming sweep with dg rounded to bf16)
            plan = L.merged_bwd_wide_plan(G, R_CHAINS, *L.device_limits(dev.index))
            require(b_form[0] == "wide" and b_form[1] == plan.blocks_per_chain
                    and b_form[5] == plan.units and b_form[4] == len(
                        L.resident_row_groups(B, plan.rows)),
                    f"K5 at G {G} ran form {b_form}, not the block form of {plan}")
            wide_ms, stream_ms, _ = wide_vs_streaming("lstm_merged_bwd_step_wide",
                                                      L.lstm_merged_bwd_step, bwd_in, bwd_ref,
                                                      smi, err_of=rel_err)
            yardstick["bwd"] = {"ms_in_turns": wide_ms, "streaming_ms": stream_ms,
                                "plan": plan._asdict()}
        for key, name, form, err in (("fwd", "lstm_merged_train_fwd", f_form, ferr),
                                     ("bwd", "lstm_merged_bwd_step", b_form, babs)):
            rows[f"{name}_{suffix}"] = {"G": G, "form": form, "max_abs_err": err,
                                        "ms": times[key][0], "plain_ms": times[key][1],
                                        "bound": bounds[key], "rows_alone_bit_equal": alone,
                                        **yardstick[key]}
        rows[f"lstm_merged_bwd_step_{suffix}"].update(rel_err=berr, bit_stable=stable)
        if suffix == "padded":
            # K6 at hidden 36 (G 18, where TMA cannot stride the rows: the
            # Hopper form at the padded width 24, here with the pad and cut
            # around the call) and 48 (G 24, what the trainer at hidden 36
            # hands it), its contraction split into slices: each within
            # 1e-5 of plain, bit-stable, and faster than its mma_sync form
            # and the library sequence in turns (hard gates)
            k6 = {name: time_dw_at(dev, *shape, seed=980 + i, smi=smi, f32_in_turns=True)
                  for i, (name, shape) in enumerate(K6_SMALL_SHAPES.items())}
            for name, r6 in k6.items():
                require(r6["plan"][L.DwPlan._fields.index("slices")] > 1 and
                        r6["ms"] < r6["mma_sync_ms"] and r6["ms"] < r6["library_sequence_ms"],
                        f"K6 at {name}: plan {r6['plan']}, {r6['ms']} ms in turns against its "
                        f"mma_sync form's {r6['mma_sync_ms']} and the library sequence's "
                        f"{r6['library_sequence_ms']}")
            r6 = k6["hidden36"]
            rows["lstm_merged_dw_padded"] = {
                "G": K6_SMALL_SHAPES["hidden36"][3], "form": r6["form"], "plan": r6["plan"],
                "max_abs_err": r6["max_abs_err"], "rel_err": r6["max_rel_err"], "ms": r6["ms"],
                "plain_ms": r6["plain_ms"], "bound": (r6["bound_ms"], r6["bound_by"]),
                "library_ms": r6["bmm_f32_ms"], "library_sequence_ms": r6["library_sequence_ms"],
                "mma_sync_ms": r6["mma_sync_ms"],
                "prerounded_bmm_bf16_ms": r6["prerounded_bmm_bf16_ms"], "at_g24": k6["hidden48"]}
        print(f"K4/K5 {suffix} (T={T_TRAIN}, R={R_CHAINS}, B={B}, G={G}): forward max|err| "
              f"{ferr:.3g} (hs/hT/cT K1's bits {k1_bits}), sweep max|err|/max|ref| {berr:.3g}; "
              f"forms {f_form} {b_form}; rows alone bit-equal {alone}; K5 repeat bit-equal "
              f"{stable}; K4 {times['fwd'][0]:.4f} ms (plain {times['fwd'][1]:.4f}, bound "
              f"{bounds['fwd'][0]:.4f}), K5 {times['bwd'][0]:.4f} ms "
              f"({times['bwd'][0] / T_TRAIN * 1e3:.3f} us a step; plain {times['bwd'][1]:.4f}, "
              f"bound {bounds['bwd'][0]:.4f} by {bounds['bwd'][1]})  [{smi}]")
        require(ferr <= 5e-3 and berr <= 5e-3 and k1_bits and alone and stable,
                f"K4/K5 {suffix} at G {G}: {ferr}, {berr}, K1 bits {k1_bits}, alone {alone}, "
                f"K5 bit-stable {stable}")
        require((f_form[0] == "wide") == (b_form[0] == "wide") == (suffix == "wide"),
                f"K4/K5 at G {G} ran forms {f_form} {b_form}")
        del fwd_in, cts, fwd, bwd, bwd_in, bwd_ref, xp, whh, h0, c0
    return rows


def width_cli(model: str, wav: str, out_dir: str, flags, counters: dict, expect: dict,
              smi: str):
    """The CLI on ``model`` with ``flags``, counts set to 0 just before and
    read just after; each kernel of ``expect`` ({wrapper: form is "wide"})
    launched in the form named, K10 never.  Returns (wall s, launches,
    forms, the stems)."""
    from umx_tpu_torch import cli
    from umx_tpu_torch.ops import lstm_cuda as L

    reset_counts(counters)
    t0 = time.perf_counter()
    rc = cli.main([model, wav, out_dir, "--quiet", *flags])
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items() if fn.launches}
    forms = {k: getattr(L, k).form for k in expect}
    print(f"CLI {' '.join(flags)} on {os.path.basename(model)}: {wall:.3f} s wall; kernel runs "
          f"{launches}; forms {forms}  [{smi}]")
    require(rc == 0, f"CLI {flags} on {model} exited {rc}")
    for k, wide in expect.items():
        require(launches.get(k, 0) > 0 and (forms[k][0] == "wide") == wide,
                f"CLI {flags}: {k} launched {launches.get(k, 0)} times in form {forms[k]}")
    require(not launches.get("lstm_scan"), f"CLI {flags} ran K10: {launches}")
    return wall, launches, forms


def width_phase(dev, tmp: str, mix, counters: dict, smi: str) -> dict:
    """Phase 21: K1, K4, K5 and K9 at every width the JAX kernels take (the
    wide forms above G 512, zero-unit padding where G % 8 != 0) and
    ``umx_forward`` with its compute specs (module docstring)."""
    import torch

    from umx_tpu_torch.config import DSPConfig, EngineConfig, ModelConfig, SegmentConfig
    from umx_tpu_torch.data import StemDataset, train_loop
    from umx_tpu_torch.engine.separator import Separator
    from umx_tpu_torch.io.ggml import write_ggml
    from umx_tpu_torch.models import umx
    from umx_tpu_torch.ops import lstm_cuda as L
    from umx_tpu_torch.train import TrainConfig

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    fig = {"card": smi, "kernels": {**width_forward_rows(dev, smi), **width_train_rows(dev, smi)}}

    # the paths: hidden 1280 (phase 19's file and 20 s cut) and hidden 36
    from scipy.io import wavfile

    wide = os.path.join(tmp, "synthetic_h1280.bin")
    narrow = os.path.join(tmp, f"synthetic_h{WIDTH_PAD_HIDDEN}.bin")
    for path, hidden in ((wide, SCAN_WIDE_HIDDEN), (narrow, WIDTH_PAD_HIDDEN)):
        if not os.path.isfile(path):  # phase 19 writes the first
            write_ggml(path, hidden,
                       umx.synthetic_state_dicts(ModelConfig(hidden_size=hidden), seed=0))
    cut = mix[:, : int(SCAN_WIDE_SECS * SR)]
    cut_wav = os.path.join(tmp, "mix_20s.wav")
    if not os.path.isfile(cut_wav):
        wavfile.write(cut_wav, SR, np.ascontiguousarray(cut.T))
    short = mix[:, : 5 * SR]
    seg = SegmentConfig(segment_secs=2.0)
    # the pipelined schedule needs two chunks or more: 8 s segments on the cut
    chunks = ("--segment-secs", "8")
    runs = (  # (name, model, hidden, CLI flags, config, kind, {wrapper: wide}, row)
        ("h1280_pallas_merged", wide, SCAN_WIDE_HIDDEN, ("--lstm-impl", "pallas_merged"),
         {"model": {"lstm_impl": "pallas_merged"}}, "merged", {"lstm_merged": True},
         "lstm_merged_wide"),
        ("h1280_pipelined", wide, SCAN_WIDE_HIDDEN, ("--stream-impl", "pipelined", *chunks),
         {"stream_impl": "pipelined"}, "merged", {"lstm_merged": True}, None),
        ("h36_pallas_merged", narrow, WIDTH_PAD_HIDDEN, ("--lstm-impl", "pallas_merged"),
         {"model": {"lstm_impl": "pallas_merged"}}, "merged", {"lstm_merged": False},
         "lstm_merged_padded"),
        ("h36_pallas", narrow, WIDTH_PAD_HIDDEN, ("--lstm-impl", "pallas"),
         {"model": {"lstm_impl": "pallas"}}, "pertarget", {"lstm_layer_pertarget": False},
         "lstm_layer_pertarget_padded"),
        ("h36_pipelined", narrow, WIDTH_PAD_HIDDEN, ("--stream-impl", "pipelined", *chunks),
         {"stream_impl": "pipelined"}, "merged", {"lstm_merged": False}, None),
    )
    fig["paths"], launches_of = {}, {}
    for name, path, hidden, flags, kw, kind, expect, row in runs:
        wall, launches, forms = width_cli(path, cut_wav, os.path.join(tmp, f"stems_{name}"),
                                          flags, counters, expect, smi)
        stems = check_stems(os.path.join(tmp, f"stems_{name}"), cut, min_corr=0.0)
        corr = float(np.corrcoef(stems.sum(0).ravel(), cut.ravel())[0, 1])
        mcfg = ModelConfig(hidden_size=hidden, **kw.get("model", {}))
        cfg = f32_seams(EngineConfig(model=mcfg, segment=seg,
                                     **{k: v for k, v in kw.items() if k != "model"}))
        r = scan_vs_cpu(tmp, path, cfg, short, kind=kind)
        print(f"{name}: corr(sum of stems, mix) {corr:.6f} on the {SCAN_WIDE_SECS:.0f} s cut "
              f"(printed, not gated: synthetic weights); GPU vs CPU port, 5 s, float32 seams: "
              f"{scan_cpu_line(r)}  [{smi}]")
        check_scan_vs_cpu(r, name, rtol=WIDTH_RTOL)
        fig["paths"][name] = {"s": wall, "launches": launches, "forms": forms,
                              "corr_sum_mix": corr, "gpu_vs_cpu": r}
        if row:
            launches_of[row] = launches.get(WIDTH_ROWS[row][0], 0)

    # K9's chains through the wide K1: hidden 2048 (G 1024), 5 s, 2 s segments
    cfg = EngineConfig(model=ModelConfig(hidden_size=WIDTH_K9_WIDE_HIDDEN, lstm_impl="pallas"),
                       segment=seg)
    sep = Separator(umx.synthetic_params(cfg.model, seed=0, device=dev), cfg, dev)
    reset_counts(counters)
    stems = sep.demix_track(short, seed=0)
    launches = {k: fn.launches for k, fn in counters.items() if fn.launches}
    k9_form = L.lstm_layer_pertarget.form
    print(f"hidden {WIDTH_K9_WIDE_HIDDEN} under lstm_impl pallas, 5 s: kernel runs {launches}; "
          f"K9 form {k9_form}; finite {bool(np.isfinite(stems).all())}  [{smi}]")
    require(launches.get("lstm_layer_pertarget", 0) > 0 and k9_form[0] == "wide"
            and not launches.get("lstm_merged") and bool(np.isfinite(stems).all())
            and stems.shape == (4, *short.shape),
            f"hidden {WIDTH_K9_WIDE_HIDDEN} under pallas: {launches}, form {k9_form}")
    launches_of["lstm_layer_pertarget_wide"] = launches.get("lstm_layer_pertarget", 0)
    fig["paths"]["h2048_pallas"] = {"launches": launches, "form": k9_form}
    del sep, stems

    # the trainer under "pallas_merged": hidden 1280 (wide K4/K5) and 36 (padded)
    root = os.path.join(tmp, "stems_train")
    if not os.path.isdir(root):
        write_stem_dir(root)
    tcfg = TrainConfig(seq_len=T_TRAIN)
    train = StemDataset(root, excerpt_samples=DSPConfig().hop * (tcfg.seq_len - 1),
                        split="train", seed=0)
    fig["train"] = {}
    for suffix, hidden in (("wide", SCAN_WIDE_HIDDEN), ("padded", WIDTH_PAD_HIDDEN)):
        mcfg = ModelConfig(hidden_size=hidden, lstm_impl="pallas_merged")
        reset_counts(counters)
        t0 = time.perf_counter()
        _, hist = train_loop(train, mcfg, tcfg, steps=WIDTH_TRAIN_STEPS, batch_size=B_TRAIN,
                             params=umx.synthetic_params(mcfg, seed=0, device=dev), device=dev,
                             log_every=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items() if fn.launches}
        forms = (L.lstm_merged_train_fwd.form, L.lstm_merged_bwd_step.form)
        dw_forms = dict(L.lstm_merged_dw.form_launches)
        print(f"train_loop under pallas_merged at hidden {hidden}, {WIDTH_TRAIN_STEPS} steps at "
              f"batch {B_TRAIN} x {tcfg.seq_len}: losses {list(map(float, hist))}, {wall:.3f} s; "
              f"kernel runs {launches}; forms {forms}; K6 by form {dw_forms}  [{smi}]")
        n = 3 * WIDTH_TRAIN_STEPS
        require(bool(np.isfinite(hist).all()) and len(hist) == WIDTH_TRAIN_STEPS,
                f"hidden {hidden} under pallas_merged: losses {list(hist)}")
        require(launches.get("lstm_merged_train_fwd") == n and
                launches.get("lstm_merged_bwd_step") == n and launches.get("lstm_merged_dw") == n
                and not launches.get("lstm_scan_train_fwd"),
                f"hidden {hidden} under pallas_merged did not train through K4-K6: {launches}")
        require((forms[0][0] == "wide") == (forms[1][0] == "wide") == (suffix == "wide"),
                f"hidden {hidden}: forms {forms}")
        # the wide K4 and K5 in their block forms (units a block), not streaming
        require(suffix != "wide" or (len(forms[0]) == 6 and len(forms[1]) == 6),
                f"hidden {hidden}: K4/K5 did not run their block forms: {forms}")
        for k in ("lstm_merged_train_fwd", "lstm_merged_bwd_step"):
            launches_of[f"{k}_{suffix}"] = launches.get(k, 0)
        # K6 in its Hopper form at both widths (at 36 on the layer's padded
        # residuals, G 24, its contraction split into slices); the mma_sync
        # form is a yardstick only
        require(dw_forms["wgmma"] == n and dw_forms["mma_sync"] == 0,
                f"hidden {hidden}: K6 by form {dw_forms}, not {n} wgmma and no mma_sync")
        if suffix == "padded":
            plan = L.lstm_merged_dw.plan
            require(plan.slices > 1, f"hidden {hidden}: K6 ran without slices: {plan}")
            launches_of["lstm_merged_dw_padded"] = dw_forms["wgmma"]
        fig["train"][suffix] = {"hidden": hidden, "losses": list(map(float, hist)), "s": wall,
                                "launches": launches, "forms": forms, "k6_by_form": dw_forms}

    # umx_forward(compute="bfloat16") under "scan" is K1's function: on the
    # card it runs K1 (wide at hidden 1280, padded at 36), never K10
    fig["umx_forward_bf16"] = {}
    g = np.random.default_rng(21)
    for hidden in (SCAN_WIDE_HIDDEN, WIDTH_PAD_HIDDEN):
        mcfg = ModelConfig(hidden_size=hidden, lstm_impl="scan")
        x = (np.abs(g.standard_normal((400, mcfg.n_features))) * 0.3).astype(np.float32)
        out = {}
        for where, device in (("card", dev), ("cpu", torch.device("cpu"))):
            params = umx.synthetic_params(mcfg, seed=0, device=device)
            reset_counts(counters)
            with torch.inference_mode():
                masks, st = umx.umx_forward(params, torch.from_numpy(x).to(device),
                                            umx.init_lstm_state(mcfg, device), mcfg, "bfloat16")
            out[where] = masks.float().cpu().numpy()
            if where == "card":
                launches = {k: fn.launches for k, fn in counters.items() if fn.launches}
            del params, masks, st
        err = np.abs(out["card"].astype(np.float64) - out["cpu"])
        peak = float(np.abs(out["cpu"]).max())
        res = {"max_rel": float(err.max()) / peak,
               "rms_rel": float(np.sqrt((err ** 2).mean())) / peak, "launches": launches,
               "form": L.lstm_merged.form}
        print(f"umx_forward(compute=bfloat16) under scan at hidden {hidden}, 400 frames: card vs "
              f"CPU max|err|/peak {res['max_rel']:.3g} (gate {WIDTH_BF16_MAX}), RMS/peak "
              f"{res['rms_rel']:.3g} (gate {WIDTH_BF16_RMS}); kernel runs {launches}; K1 form "
              f"{res['form']}  [{smi}]")
        require(launches.get("lstm_merged") == 3 and not launches.get("lstm_scan"),
                f"bfloat16 under scan at hidden {hidden} did not run K1 alone: {launches}")
        require(res["max_rel"] <= WIDTH_BF16_MAX and res["rms_rel"] <= WIDTH_BF16_RMS,
                f"umx_forward bfloat16 at hidden {hidden}: card vs CPU {res}")
        fig["umx_forward_bf16"][hidden] = res
    for name, n in launches_of.items():
        fig["kernels"][name]["launches"] = n
    fig["phase_s"] = time.perf_counter() - t_phase
    print(f"width phase: {fig['phase_s']:.1f} s wall  [{smi}]")
    return fig


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a GPU",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    phase_done("start")
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
    phase_done("1 build")
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
        "lstm_scan": lstm_cuda.lstm_scan,
        "lstm_scan_train_fwd": lstm_cuda.lstm_scan_train_fwd,
        "lstm_scan_bwd_step": lstm_cuda.lstm_scan_bwd_step,
    }
    wiener_args, wiener_errs, wiener_bf16 = check_wiener(dev, smi)
    k9_args, k9_err, k9_form, k9_ms, k9_k1_ms = check_pertarget(dev, T_SEG, G_HIDDEN, 9, smi)
    _, k9_err_hq, k9_form_hq, k9_ms_hq, k9_k1_ms_hq = check_pertarget(dev, T_SEG, 256, 10, smi)
    mode_args, mode_errs, mode_bf16 = check_wiener_modes(dev, *wiener_args[:3], smi)
    check_reduce_launches(wiener_args, mode_args)
    bf16_forms = {**wiener_bf16, **mode_bf16}
    phase_done("3, 10 Wiener and K9 kernels")

    lstm_args, lstm_err = check_lstm(dev, T_SEG, 1, seed=0)
    lstm16_args, lstm16_err = check_lstm(dev, T_TRAIN, B_TRAIN, seed=16)  # two n-tiles of rows
    lstm_err = max(lstm_err, check_lstm_resident(dev))
    ola_args, ola_err = check_ola(dev)
    istft8_args, istft_err = check_istft_ct(
        dev, [(ISTFT_ROWS, T_SEG), (3, 37), (5, 37), (1, 3)], seed=4)
    istft_size_args, istft_size_errs, istft_reg = check_istft_sizes(dev, smi)
    istft_err = max(istft_err, *(e for n, e in istft_size_errs.items() if n <= 16384))
    phase_done("2, 7 K1, K7, K8 kernels")

    with tempfile.TemporaryDirectory(prefix="umx_smoke_") as tmp:
        model, wav, mix = write_inputs(tmp)
        launches, main_forms, fused_out, cli_s = main_path(tmp, model, wav, mix, counters, smi)
        cpu_err, f32_forms, bf16_vs_cpu = gpu_vs_cpu(model, mix, counters, smi)
        host_launches, host_s, host_err = host_loop_path(tmp, model, wav, mix, counters,
                                                         fused_out, smi)
        print(f"CLI wall time on the {TRACK_SECS:.0f} s track: fused {cli_s:.3f} s, host loop "
              f"{host_s:.3f} s  [{smi}]")
        resample_s = resample_path(tmp, model, counters, smi)
        serving = serving_path(model, wav, mix, counters, smi)
        phase_done("4, 13 demix paths and serving")

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
        phase_done("8, 9 batched path")

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
        mode_launches, planes_err, planes_errs = planes_entry(csep, long_track)
        cat_anchors = catalogue_anchors(csep, tracks, smi)
        del csep
        phase_done("11 catalogue")

        train_args, train_errs = check_train_kernels(dev)
        check_train_resident(dev)
        train_launches, steps_per_s, wide_steps_per_s, held_out = training_path(tmp, counters,
                                                                                  smi)
        phase_done("5, 6 training")
        evaluation = evaluation_path(tmp, held_out, counters, smi)
        phase_done("14 evaluation")
        parity, (k1_half, k1_half_args), err = parity_phase(dev, counters, smi)
        path_lstm_args[k1_half] = k1_half_args
        lstm_err = max(lstm_err, err)
        phase_done("15 parity")
        certification = certification_phase(tmp, model, mix, counters, smi)
        phase_done("16 certification")
        mesh = mesh_phase(dev, tmp, model, mix, list(tracks.values())[:3], counters, smi)
        phase_done("17 mesh")
        stream = stream_phase(dev, model, wav, mix, counters, smi)
        phase_done("18 stream schedules")
        scan, scan_args = scan_phase(dev, tmp, model, wav, mix, counters, smi)
        phase_done("19 float32 recurrence")
        scan_train = scan_train_phase(dev, tmp, counters, smi)
        phase_done("20 training through it")
        width = width_phase(dev, tmp, mix, counters, smi)
        phase_done("21 every width")
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

    library = dict.fromkeys(times)
    library["lstm_merged_dw"] = dw_bmm_ms(*train_args["lstm_merged_dw"])
    # K6 at every shape the paths give it, in turns with the library
    # sequence and with its mma.sync form
    k6_shapes = {name: time_dw_at(dev, *shape, seed=900 + i, smi=smi)
                 for i, (name, shape) in enumerate(K6_SHAPES.items())}
    library["istft_ct2"] = istft_library_ms(*k8_shape)
    # K7's one PyTorch call: the chunk-major to time-major transpose of the
    # combined heads (n_chunks, M, stride), JAX's _transpose_kernel's
    # function, the heads and tails combined outside the timing
    ola_call_ms = {}
    for M in (8, 16):
        ys_m, _, stride_m = ola_args[M]
        combined = ys_m[..., :stride_m].contiguous()
        ola_call_ms[M] = cuda_ms(lambda: combined.transpose(0, 1).contiguous(), 20)
        del combined
    library["ola_normalized"] = ola_call_ms[8]
    require(times["istft_ct2"][0] <= library["istft_ct2"],
            f"istft_ct2 ({times['istft_ct2'][0]} ms) is slower than torch.istft "
            f"({library['istft_ct2']} ms) at {k8_shape}")
    if k8_shape == ISTFT_EARLIER_SHAPE:
        require(times["istft_ct2"][0] < EARLIER["istft_ct2_ms"],
                f"istft_ct2 ({times['istft_ct2'][0]} ms) is not faster than its earlier form "
                f"({EARLIER['istft_ct2_ms']} ms)")
        require(times["istft_ct2"][0] <= ISTFT_4096_SLACK * ISTFT_4096_MS,
                f"istft_ct2 at n_fft 4096 ({times['istft_ct2'][0]} ms) is slower than "
                f"{ISTFT_4096_SLACK} x its figure before the kernel took every n_fft "
                f"({ISTFT_4096_MS} ms)")
    # K8 at the other n_fft: kernel, plain version, torch.istft, bound
    k8_sizes = {}
    for n, a in istft_size_args.items():
        re_n, im_n, _, hop_n, w_n = a
        T_n, F_n = re_n.shape[1], re_n.shape[2]
        spec = torch.complex(re_n, im_n).transpose(-1, -2).contiguous()
        spec.imag[:, 0] = 0.0
        spec.imag[:, -1] = 0.0
        ms = cuda_ms(lambda: istft_ct_cuda.istft_ct2(*a), 10)
        form = istft_ct_cuda.istft_ct2.form
        plain_ms = cuda_ms(lambda: istft_ct.istft_ct2_plain(*a), 5)
        lib_ms = cuda_ms(lambda: torch.istft(spec, n_fft=n, hop_length=hop_n, window=w_n,
                                             center=True, normalized=False, onesided=True,
                                             length=(T_n - 1) * hop_n), 5)
        bound = bound_ms(2 * ISTFT_ROWS * T_n * F_n * 4 + ISTFT_ROWS * ((T_n - 1) * hop_n + n) * 4,
                         ISTFT_ROWS * T_n * (2.5 * n * math.log2(n) + 2 * n), "f32")
        where = istft_ct_cuda.istft_form(n)
        k8_sizes[n] = {"rows": ISTFT_ROWS, "frames": T_n, "ms": ms, "plain_ms": plain_ms,
                       "library_ms": lib_ms, "bound_ms": bound[0], "bound_by": bound[1],
                       "form": form, "where": where}
        line = ""
        if n in istft_reg:
            # the register form, timed in turns in phase 7
            r = istft_reg[n]
            k8_sizes[n].update(where="register", ms_in_turns=r["ms"],
                               mixed_radix_ms=r["mixed_radix_ms"],
                               library_ms_in_turns=r["library_ms"])
            line = (f", in turns (phase 7) {r['ms']:.4f} ms, mixed-radix form "
                    f"{r['mixed_radix_ms']:.4f}, torch.istft {r['library_ms']:.4f}")
        if where == "cluster":
            # the device-memory form it replaces there, in turns with it
            dev_ms, ms2 = paired_ms(lambda: istft_ct_cuda.istft_ct2(*a, _form="device"),
                                    lambda: istft_ct_cuda.istft_ct2(*a), 5,
                                    f"istft_ct2 at n_fft {n}, device-memory vs cluster form")
            k8_sizes[n].update(device_ms=dev_ms, cluster_ms_in_turns=ms2,
                               cluster=istft_ct_cuda.istft_cluster_size(n))
            line = (f", device-memory form {dev_ms:.4f} ms (cluster form in turns with it "
                    f"{ms2:.4f})")
            if n == ISTFT_GATED_N_FFT:
                require(ms2 < dev_ms, f"istft_ct2 at n_fft {n}: the cluster form ({ms2} ms) is "
                        f"not faster than the device-memory form ({dev_ms} ms)")
        print(f"istft_ct2 at n_fft {n} ({ISTFT_ROWS} rows x {T_n} frames, a 60 s segment): "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, torch.istft {lib_ms:.4f} ms, bound "
              f"{bound[0]:.4f} ms by {bound[1]}{line}; form {where} {form}  [{smi}]")
        if n == ISTFT_GATED_N_FFT:
            require(ms < lib_ms, f"istft_ct2 at n_fft {n} ({ms} ms) is not faster than "
                    f"torch.istft ({lib_ms} ms)")
        del spec
    cluster_path = istft_round_trip(dev, counters, smi)
    register_path = istft_round_trip(dev, counters, smi, ISTFT_REGISTER_PATH_N_FFT)
    require(register_path["form"][2] == istft_ct_cuda.istft_register_plan(
        ISTFT_REGISTER_PATH_N_FFT), f"the ct2 round trip at n_fft {ISTFT_REGISTER_PATH_N_FFT} "
            f"did not run the register form: {register_path['form']}")
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
          f"{'K9' if k9_now < k1_ms else 'K1'} is the faster at one row per chain)  [{smi}]")
    k6 = k6_shapes["umxl_train"]
    print(f"lstm_merged_dw at UMX-L training {times['lstm_merged_dw'][0]:.4f} ms (form "
          f"{k6['form']}; earlier form {EARLIER['lstm_merged_dw_ms']}); in turns "
          f"{k6['ms']:.4f} against the library sequence {k6['library_sequence_ms']:.4f}, the "
          f"mma_sync form {k6['mma_sync_ms']:.4f} and the call on pre-rounded operands "
          f"{k6['prerounded_bmm_bf16_ms']:.4f}; torch.bmm f32 {library['lstm_merged_dw']:.4f} "
          f"ms  [{smi}]")
    require(k9_now < EARLIER["lstm_layer_pertarget_ms"],
            f"lstm_layer_pertarget ({k9_now} ms) is not faster than its earlier form "
            f"({EARLIER['lstm_layer_pertarget_ms']} ms)")
    require(times["lstm_merged_dw"][0] <= library["lstm_merged_dw"],
            f"lstm_merged_dw ({times['lstm_merged_dw'][0]} ms) is slower than torch.bmm "
            f"({library['lstm_merged_dw']} ms)")
    require(k6["ms"] <= k6["library_sequence_ms"],
            f"lstm_merged_dw ({k6['ms']} ms) is slower than the library sequence "
            f"({k6['library_sequence_ms']} ms) in turns")
    require(k6["ms"] < k6["mma_sync_ms"],
            f"lstm_merged_dw ({k6['ms']} ms) is not faster than its mma_sync form "
            f"({k6['mma_sync_ms']} ms) in turns")
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
    print(f"ola_normalized's one PyTorch call, combined.transpose(0, 1).contiguous() of the "
          f"combined heads (n_chunks, M, stride): {ola_call_ms[8]:.4f} ms at M=8, "
          f"{ola_call_ms[16]:.4f} ms at M=16  [{smi}]")
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

    phase_done("12 timings")
    wsrc, wrep = "umx_tpu_torch/csrc/wiener.cu", "umx_tpu/ops/wiener_pallas.py"
    st_kernels = scan_train["kernels"]
    meta = {
        "lstm_merged": ("umx_tpu_torch/csrc/lstm_merged.cu",
                        "umx_tpu/ops/lstm_pallas.py:158", max(lstm_err, lstm16_err)),
        "wiener_reduce": (wsrc, f"{wrep}:89", wiener_errs["wiener_reduce"]),
        "wiener_apply": (wsrc, f"{wrep}:128", wiener_errs["wiener_apply"]),
        "wiener_reduce_y": (wsrc, f"{wrep}:148", mode_errs["wiener_reduce_y"]),
        "wiener_apply_y": (wsrc, f"{wrep}:245", mode_errs["wiener_apply_y"]),
        "wiener_reduce_mags": (wsrc, f"{wrep}:148", mode_errs["wiener_reduce_mags"]),
        "wiener_apply_mags": (wsrc, f"{wrep}:245", mode_errs["wiener_apply_mags"]),
        # the bfloat16 forms (bf16 masks read by K2/K3; bf16 planes written
        # by K3), the TPU kernels' storage dtypes
        "wiener_reduce_bf16": (wsrc, f"{wrep}:89", bf16_forms["wiener_reduce_bf16"]["max_abs_err"]),
        "wiener_apply_bf16": (wsrc, f"{wrep}:128", bf16_forms["wiener_apply_bf16"]["max_abs_err"]),
        "wiener_apply_y_bf16": (wsrc, f"{wrep}:245",
                                bf16_forms["wiener_apply_y_bf16"]["max_abs_err"]),
        "wiener_apply_mags_bf16": (wsrc, f"{wrep}:245",
                                   bf16_forms["wiener_apply_mags_bf16"]["max_abs_err"]),
        "lstm_layer_pertarget": ("umx_tpu_torch/csrc/lstm_pertarget.cu",
                                 "umx_tpu/ops/lstm_pallas.py:39", max(k9_err, k9_err_hq)),
        "lstm_merged_train_fwd": ("umx_tpu_torch/csrc/lstm_merged.cu",
                                  "umx_tpu/ops/lstm_pallas.py:323",
                                  train_errs["lstm_merged_train_fwd"]),
        "lstm_merged_bwd_step": ("umx_tpu_torch/csrc/lstm_train.cu",
                                 "umx_tpu/ops/lstm_pallas.py:397",
                                 train_errs["lstm_merged_bwd_step"]),
        "lstm_merged_dw": ("umx_tpu_torch/csrc/lstm_dw.cu",
                           "umx_tpu/ops/lstm_pallas.py:397", train_errs["lstm_merged_dw"]),
        "ola_normalized": ("umx_tpu_torch/csrc/ola.cu", "umx_tpu/ops/ola_pallas.py:61", ola_err),
        "istft_ct2": ("umx_tpu_torch/csrc/istft_ct.cu", "umx_tpu/ops/istft_ct.py:270", istft_err),
        # not Pallas: the lax.scan step of _bilstm_layer (lstm_impl="scan")
        "lstm_scan": ("umx_tpu_torch/csrc/lstm_scan.cu", "umx_tpu/models/umx.py:388",
                      scan["max_abs_err"]),
        # not Pallas: JAX's autodiff of that step, forward with residuals
        # and the reverse sweep (the trainer under lstm_impl="scan")
        "lstm_scan_train_fwd": ("umx_tpu_torch/csrc/lstm_scan.cu", "umx_tpu/models/umx.py:388",
                                max(r["fwd_max_abs_err"] for r in st_kernels["shapes"].values())),
        "lstm_scan_bwd_step": ("umx_tpu_torch/csrc/lstm_scan_train.cu",
                               "umx_tpu/models/umx.py:388",
                               max(r["bwd"]["max_abs_err"] for r in st_kernels["shapes"].values())),
    }
    # each kernel's launches on its own path: K1-K3 the demix, K4-K6
    # training, K7-K8 the batched whole-track demix, K9 the per-target
    # catalogue run, the Wiener modes mags and y the planes entry
    # K2/K3: the bf16 forms on the demix path (the card's default), the
    # float32 forms on the float32-seams run of phase 4b
    path_launches = {"lstm_merged": launches["lstm_merged"],
                     **{k: f32_forms[k] for k in ("wiener_reduce", "wiener_apply")},
                     **{k: main_forms[k] for k in ("wiener_reduce_bf16", "wiener_apply_bf16")},
                     **{k: train_launches[k] for k in
                        ("lstm_merged_train_fwd", "lstm_merged_bwd_step", "lstm_merged_dw")},
                     **{k: batched_launches[k] for k in ("ola_normalized", "istft_ct2")},
                     "lstm_layer_pertarget": k9_launches["lstm_layer_pertarget"],
                     **mode_launches,
                     "lstm_scan": scan["cli"]["dense"]["launches"]["lstm_scan"],
                     **{k: scan_train["train"]["launches"][k] for k in
                        ("lstm_scan_train_fwd", "lstm_scan_bwd_step")}}
    for name, n in path_launches.items():
        require(n > 0, f"kernel {name} was launched no time on its path")
    k10 = scan["shapes"]["G512_B1"]
    times["lstm_scan"] = (k10["ms"], k10["plain_ms"])
    bounds["lstm_scan"] = scan_bound(T_SEG, R_CHAINS, G_HIDDEN, scan_args[:4])
    library["lstm_scan"] = None  # nn.LSTM computes the ih product too: a yardstick
    for name in ("lstm_scan_train_fwd", "lstm_scan_bwd_step"):
        times[name] = (st_kernels["ms"][name], st_kernels["plain_ms"][name])
        bounds[name] = st_kernels["bound"][name]
        library[name] = None  # nn.LSTM (forward and backward) is a yardstick, printed
    for name, form in bf16_forms.items():
        if name not in meta:
            continue  # the mixed forms: figures under "wiener_bf16_forms"
        times[name] = (form["ms"], form["plain_ms"])
        bounds[name] = form["bound"]
        library[name] = None
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": path_launches[name], "max_abs_err": err,
         "ms": times[name][0], "plain_ms": times[name][1], "bound_ms": bounds[name][0],
         "bound_by": bounds[name][1], "library_ms": library[name]}
        for name, (src, rep, err) in meta.items()
    ]
    for k in kernels:
        if k["name"] in bf16_forms:
            k["f32_form_ms"] = bf16_forms[k["name"]]["f32_ms"]
    # each row's form: the Wiener passes' storage form; K8's run plan and
    # radices, K9's, K10's, K10 with residuals' and K11's form at the timed
    # shape; the others as their wrapper last ran
    row_forms = {name: WIENER_FORMS[name][1] for name in meta if name in WIENER_FORMS}
    row_forms.update({"istft_ct2": k8_form, "lstm_scan": scan["shapes"]["G512_B1"]["form"],
                      "lstm_layer_pertarget": k9_form, "lstm_merged_dw": k6["form"],
                      **st_kernels["form"]})
    for k in kernels:
        k["form"] = row_forms.get(k["name"], getattr(counters.get(k["name"]), "form", None))
    # phase 21's forms: the wide K1, K4, K5 and K9 and the padded ones, each
    # with its launches on its own path of that phase
    for name, (_, src, rep) in WIDTH_ROWS.items():
        r = width["kernels"][name]
        require(r["launches"] > 0, f"kernel {name} was launched no time on its path")
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": rep,
                        "launches": r["launches"], "max_abs_err": r["max_abs_err"],
                        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
                        "bound_by": r["bound"][1], "library_ms": r.get("library_ms"),
                        "form": r["form"],
                        **{k: r[k] for k in ("streaming_ms", "ms_in_turns", "library_sequence_ms",
                                             "mma_sync_ms", "plan", "at_g24") if k in r}})
    next(k for k in kernels if k["name"] == "ola_normalized")["library_ms_m16"] = ola_call_ms[16]
    k8_row = next(k for k in kernels if k["name"] == "istft_ct2")
    k8_row["n_fft"] = 4096
    k8_row["other_n_fft"] = k8_sizes
    # K8's cluster form at n_fft 32768, with its launches on the ct2 round
    # trip at that size and its device-memory form's time beside it
    k8c = k8_sizes[ISTFT_GATED_N_FFT]
    kernels.append({"name": "istft_ct2_cluster", "route": "cuda",
                    "source": "umx_tpu_torch/csrc/istft_ct.cu",
                    "replaces": "umx_tpu/ops/istft_ct.py:270",
                    "launches": cluster_path["launches"],
                    "max_abs_err": istft_size_errs[ISTFT_GATED_N_FFT], "ms": k8c["ms"],
                    "plain_ms": k8c["plain_ms"], "bound_ms": k8c["bound_ms"],
                    "bound_by": k8c["bound_by"], "library_ms": k8c["library_ms"],
                    "device_ms": k8c["device_ms"], "n_fft": ISTFT_GATED_N_FFT,
                    "cluster": k8c["cluster"], "form": k8c["form"],
                    "round_trip_rel_err": cluster_path["round_trip_rel_err"]})
    # K8's register form (n_fft = 1024 k up to 16384 but 4096): its row at
    # the round trip's n_fft, its launches there, every size's figures beside
    kr = k8_sizes[ISTFT_REGISTER_PATH_N_FFT]
    kernels.append({"name": "istft_ct2_register", "route": "cuda",
                    "source": "umx_tpu_torch/csrc/istft_ct.cu",
                    "replaces": "umx_tpu/ops/istft_ct.py:270",
                    "launches": register_path["launches"],
                    "max_abs_err": max(istft_size_errs[n] for n in istft_reg),
                    "ms": kr["ms_in_turns"], "plain_ms": kr["plain_ms"],
                    "bound_ms": kr["bound_ms"], "bound_by": kr["bound_by"],
                    "library_ms": kr["library_ms_in_turns"], "mixed_radix_ms": kr["mixed_radix_ms"],
                    "n_fft": ISTFT_REGISTER_PATH_N_FFT, "form": kr["form"],
                    "round_trip_rel_err": register_path["round_trip_rel_err"],
                    "by_n_fft": {n: {k: r[k] for k in ("ms", "mixed_radix_ms", "library_ms",
                                                        "plain_ms", "bound_ms", "max_abs_err",
                                                        "float64_err", "form")}
                                 for n, r in istft_reg.items()}})
    k10_row = next(k for k in kernels if k["name"] == "lstm_scan")
    k10_row["streaming_ms"] = scan["shapes"]["G512_B1"]["forms"]["streaming"]["ms"]
    k10_row["by_shape_ms"] = {key: {f: v["ms"] for f, v in row["forms"].items()}
                              for key, row in scan["shapes"].items()}
    for name in ("lstm_scan_train_fwd", "lstm_scan_bwd_step"):
        row = next(k for k in kernels if k["name"] == name)
        row["streaming_ms"] = st_kernels["ms"][f"{name}_streaming"]
        row["at_g640"] = st_kernels["wide"][name]
    # K1's launches by chain count on the CLI's pipelined run (phase 18)
    kernels[0]["pipelined_launches_by_chains"] = stream["k1_chain_launches"]
    kernels[0]["pipelined_hq"] = stream["hq"]["k1"]
    next(k for k in kernels if k["name"] == "lstm_scan")["nn_lstm_x4_yardstick_ms"] = \
        scan["nn_lstm_x4_ms"]
    k6_row = next(k for k in kernels if k["name"] == "lstm_merged_dw")
    k6_row.update(library_bf16_out_f32_ms=k6["prerounded_bmm_bf16_ms"],
                  library_sequence_ms=k6["library_sequence_ms"], mma_sync_ms=k6["mma_sync_ms"],
                  ms_in_turns=k6["ms"], by_shape=k6_shapes)
    k11 = next(k for k in kernels if k["name"] == "lstm_scan_bwd_step")
    k11["nn_lstm_x4_fwd_bwd_yardstick_ms"] = st_kernels["ms"]["nn_lstm_x4_fwd_bwd"]
    k11["dw_bmm_ms"] = st_kernels["ms"]["lstm_scan_dw_bmm"]
    # the wide forms of K10, K10 with residuals and K11 (G 640: W_hh on the
    # chip in shares of 20 units), timed in turns with their streaming form,
    # each with its launches on its own path: the hidden-1280 CLI run under
    # scan (phase 19) and the hidden-1280 steps under scan (phase 20b)
    w10 = scan["shapes"]["G640_B1"]
    w_train = st_kernels["shapes"][f"G{SCAN_TRAIN_WIDE_G}_B{B_TRAIN}"]["forms"]["wide"]
    wide_scan = scan_train["train"]["wide_scan"]["launches"]
    for name, src, launched, r, err in (
        ("lstm_scan", "umx_tpu_torch/csrc/lstm_scan.cu", scan["wide"]["launches"]["lstm_scan"],
         {"ms": w10["wide_vs_streaming"]["wide_ms"],
          "streaming_ms": w10["wide_vs_streaming"]["streaming_ms"],
          "plain_ms": w10["plain_ms"], "bound_ms": w10["bound_ms"], "bound_by": w10["bound_by"],
          "form": w10["forms"]["wide"]["form"]}, w10["forms"]["wide"]["max_abs_err"]),
        ("lstm_scan_train_fwd", "umx_tpu_torch/csrc/lstm_scan.cu",
         wide_scan.get("lstm_scan_train_fwd", 0), st_kernels["wide"]["lstm_scan_train_fwd"],
         w_train["fwd_max_abs_err"]),
        ("lstm_scan_bwd_step", "umx_tpu_torch/csrc/lstm_scan_train.cu",
         wide_scan.get("lstm_scan_bwd_step", 0), st_kernels["wide"]["lstm_scan_bwd_step"],
         w_train["bwd"]["max_abs_err"]),
    ):
        require(launched > 0, f"kernel {name}_wide was launched no time on its path")
        kernels.append({"name": f"{name}_wide", "route": "cuda", "source": src,
                        "replaces": "umx_tpu/models/umx.py:388", "launches": launched,
                        "max_abs_err": err, "ms": r["ms"], "plain_ms": r["plain_ms"],
                        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
                        "streaming_ms": r["streaming_ms"], "form": r["form"],
                        "G": SCAN_TRAIN_WIDE_G})
    print(f"phase seconds: {json.dumps(PHASE_S)}; {sum(PHASE_S.values()):.1f} s in all  "
          f"[{smi}]")
    print(json.dumps({"kernels": kernels, "build_s": build_s, "demix_s": demix_s,
                      "gpu_vs_cpu_rel_err": cpu_err, "bf16_default_vs_cpu": bf16_vs_cpu,
                      "wiener_bf16_forms": {n: {k: v for k, v in f.items() if k != "bound"}
                                            | {"bound_ms": f["bound"][0]}
                                            for n, f in bf16_forms.items()},
                      "planes_entry_errs": planes_errs, "train_steps_per_s": steps_per_s,
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
                      "serving": serving, "evaluation": evaluation, "parity": parity,
                      "certification": certification, "mesh": mesh, "stream": stream,
                      "scan": scan, "scan_train": scan_train, "width": width,
                      "phase_s": PHASE_S}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
