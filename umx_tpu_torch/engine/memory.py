"""Device-memory planning for the whole-track programs and the serving
batcher: the subset of ``umx_tpu.engine.memory`` that the port's demix
paths call (the chunk-group width, the shift and fleet batches, the window
of a long track, the width of a batched segment call).

The non-streaming program runs its segments in groups of ``width`` rows
and the batched shifts run B tracks at once, so the peak grows with
B × width; these estimates let the separator pick the widest group (and
the largest shift batch) that fits instead of finding out by running out
of memory.  The liveness model is the JAX package's: at the boundary
between the last segment group and the overlap-add, the stacked weighted
chunk outputs, the stems, the padded audio and one group of segment
transients are live together.  How the port differs:

* capacity is ``torch.cuda.mem_get_info(device)[1]`` on a GPU (the
  default device; it raises without one) and the physical RAM when the
  CPU is asked for;
* the stacked chunk outputs count ``EngineConfig.stems_stack_dtype``'s
  bytes on the device the run uses (``device``; None is the GPU), "auto"
  resolved as the JAX package resolves it: bfloat16 on the GPU, float32
  on the CPU;
* the segment transients count the masks and the Wiener planes at
  float32 whatever their storage dtype, as the JAX package does (an upper
  bound where they are bfloat16);
* parameter bytes are exact when the parameters are given, quantized
  ones counted at their stored size;
* with ``istft_algo="ct2"`` the segment transients count no iSTFT frames:
  the kernel overlap-adds on chip and writes only the signal (the dense
  path keeps a quarter of the frames, as the JAX package counts it);
* the fitted factors are anchored on an H100, one transient factor per
  iSTFT algorithm (``chip_smoke.py`` prints the measured peaks beside
  these estimates; PERF.md keeps them).
"""

from __future__ import annotations

import math
import os
from dataclasses import fields

import torch

from umx_tpu_torch.config import EngineConfig, storage_dtype
from umx_tpu_torch.models.umx import resolve_lstm_impl
from umx_tpu_torch.ops.lstm_cuda import resident_exchange_words, scan_exchange_words

# Slack on the segment-transient share of the boundary model, per iSTFT
# algorithm.  The port's segment forward keeps more per row alive than the
# JAX program (torch.stft and torch.istft intermediates, the input
# projections of all three LSTM layers, the per-row Wiener outputs).
# Fitted on an H100 80GB HBM3 at 700 W from the UMX-L peaks
# (torch.cuda.max_memory_allocated) of a 100 s track at widths 1-3 and two
# batched shifts, streaming or not: the dense inverse needs 2.91 to 3.01
# times its per-row term, the ct2 inverse 1.37 to 1.69 times its own (which
# counts no frames: with the frames buffer gone the Wiener stage holds its
# peak, and one row alone needs the most); each factor bounds them all.
_TRANSIENT_FACTOR = {"dense": 3.2, "ct2": 1.75}
# Slack on the batched segment call (the serving batcher's
# ``segment_forward_batched`` over B rows), per iSTFT algorithm: a per-row
# factor on each row's segment transients and a fixed factor on one row's,
# for what runs one row at a time (the Wiener passes) or once a call.
# Fitted on an H100 80GB HBM3 at 700 W from the UMX-L peaks
# (torch.cuda.max_memory_allocated) of one 60 s segment call at B = 1 and
# B = 4 (chip_smoke.py phase 13): the dense inverse's peak grows by 2.94
# times a row's transients (plus its audio and waves) a row, with almost
# nothing fixed; the ct2 inverse's by 1.40, with a quarter of a row fixed.
_SEGMENT_ROW_FACTOR = {"dense": 3.0, "ct2": 1.42}
_SEGMENT_FIXED_FACTOR = {"dense": 0.05, "ct2": 0.3}
# Resident bytes over the raw float32 parameter bytes: 452,427,776
# allocated for UMX-L's 452,424,832 (the caching allocator's rounding),
# on the same card.
_PARAMS_OVERHEAD = 1.0001
_F32 = 4


def device_hbm_bytes(device=None) -> int:
    """Memory capacity of ``device``: total device memory of a GPU, the
    physical RAM for the CPU.  The default is the current GPU; without a
    usable one that raises, and the CPU's capacity is given only when the
    CPU is asked for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda.is_available() is False")
        return int(torch.cuda.mem_get_info(dev)[1])
    return int(os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES"))


def params_hbm_bytes(cfg: EngineConfig, params=None, quantized: bool = False) -> int:
    """Bytes of the resident parameters: exact when ``params`` (a
    ``UMXParams``) is given, else derived from the model shape (per
    target fc1, 3 bidirectional LSTM layers, fc2, fc3, batch norms, input
    and output mean and scale), all float32 or, with ``quantized``, in the
    layout of ``quantized_params_from_ggml``: fc1 and W_ih as one bf16
    plane (2 bytes a weight), fc2 and fc3 as two (4 bytes), W_hh bf16."""
    if params is not None:
        # a QTensor counts its planes, scale and offset at their stored size
        return sum(
            t.nbytes if hasattr(t, "planes") else t.numel() * t.element_size()
            for t in (getattr(params, f.name) for f in fields(params))
        )
    m = cfg.model
    h, g, s = m.hidden_size, m.lstm_hidden, m.n_targets
    nf, no = m.n_features, m.n_outputs
    mat_u8 = nf * h + 6 * (h * 4 * g + g * 4 * g)  # fc1 + 3x2 LSTM ih/hh
    mat_u16 = 2 * h * h + h * no  # fc2 + fc3
    vec = (
        4 * h + 4 * h + 4 * no  # bn1, bn2, bn3 (w, b, mean, var)
        + 2 * nf + 2 * no       # input/output mean+scale
        + 6 * 2 * 4 * g         # LSTM b_ih + b_hh per direction-layer
    )
    if quantized:
        per_target = 2 * mat_u8 + 4 * mat_u16 + _F32 * vec
    else:
        per_target = _F32 * (mat_u8 + mat_u16 + vec)
    return int(s * per_target * _PARAMS_OVERHEAD)


def _segment_transient_bytes(cfg: EngineConfig) -> int:
    """Bytes of one segment row's pipeline tensors: Wiener y planes,
    masks, mix spectrogram planes and the iSTFT frames (a quarter share
    for the dense inverse, as the JAX package counts it; none for the ct2
    kernel, which keeps no frame in device memory)."""
    s = cfg.model.n_targets
    t = cfg.dsp.n_frames(cfg.segment.segment_samples(cfg.dsp.sample_rate))
    f = cfg.dsp.n_bins
    y_planes = 2 * s * 2 * t * f * _F32
    mix_planes = 2 * 2 * t * f * _F32
    masks = s * t * 2 * f * _F32
    frames_share = 0 if cfg.dsp.istft_algo == "ct2" else s * 2 * t * cfg.dsp.n_fft * _F32 // 4
    return y_planes + mix_planes + masks + frames_share


def _stems_itemsize(cfg: EngineConfig, device=None) -> int:
    """Bytes a sample of the stacked weighted chunk outputs takes on
    ``device`` (``EngineConfig.stems_stack_dtype``; "auto" = 2 on the GPU,
    4 on the CPU)."""
    return storage_dtype(cfg.stems_stack_dtype, device).itemsize


def _track_terms(cfg: EngineConfig, track_secs: float, b: int, device=None) -> dict[str, int]:
    sr = cfg.dsp.sample_rate
    seg = cfg.segment.segment_samples(sr)
    stride = cfg.segment.stride_samples(sr)
    n_chunks = max(1, math.ceil(int(track_secs * sr) / stride))
    padded = (n_chunks - 1) * stride + seg
    s = cfg.model.n_targets
    return {
        "n_chunks": n_chunks,
        "ys": b * s * 2 * n_chunks * seg * _stems_itemsize(cfg, device),  # stacked weighted chunks
        "ola": b * 2 * s * 2 * n_chunks * stride * _F32,  # pad+sum combine grids
        "stems": b * s * 2 * padded * _F32,
        "audio": b * 2 * padded * _F32,
    }


def _dequant_transient_bytes(params) -> int:
    """The largest transient float32 copy a quantized matmul makes of its
    weight (``ops/qmatmul.py``); 0 for dense parameters."""
    if params is None:
        return 0
    return max((4 * t.planes[0].numel() for t in (getattr(params, f.name) for f in fields(params))
                if hasattr(t, "planes")), default=0)


def _lstm_exchange_bytes(cfg: EngineConfig) -> int:
    """The recurrence kernel's exchange buffer (``ops/lstm_cuda.py``): one
    per layer call, whatever the rows; K10's (``lstm_impl="scan"``, and
    "auto" where G % 8 != 0) holds one f32 value of h a word, K1's (in
    every form, at every other width under "auto") two bf16 values."""
    m = cfg.model
    scan = resolve_lstm_impl(m.lstm_impl, m.lstm_hidden) == "scan"
    words = scan_exchange_words if scan else resident_exchange_words
    return 8 * words(m.n_targets * 2, m.lstm_hidden)


def _peak(cfg: EngineConfig, terms: dict, seg_transients: int, params) -> dict[str, int]:
    ys, ola, stems, audio = terms["ys"], terms["ola"], terms["stems"], terms["audio"]
    params_b = params_hbm_bytes(cfg, params)
    factor = _TRANSIENT_FACTOR["ct2" if cfg.dsp.istft_algo == "ct2" else "dense"]
    # the last group's transients beside the track buffers; with a factor
    # above 1 this bounds the phase before the stems exist as well
    boundary = (ys + stems + audio + int(seg_transients * factor)
                + _dequant_transient_bytes(params) + _lstm_exchange_bytes(cfg))
    ola_phase = ys + ola + stems
    peak = max(boundary, ola_phase) if cfg.ola_impl == "xla" else boundary
    return {
        "ys": ys, "ola": ola, "stems": stems, "audio": audio,
        "seg_transients": seg_transients, "params": params_b,
        "boundary": boundary, "ola_phase": ola_phase, "total": peak + params_b,
    }


def fused_track_hbm_bytes(cfg: EngineConfig, batch: int, track_secs: float,
                          params=None, device=None) -> dict[str, int]:
    """Estimated peak of B stacked tracks through the streaming program
    (one segment row per track in flight) on ``device`` (None: the GPU).
    Returns the liveness terms (bytes) and ``total``."""
    terms = _track_terms(cfg, track_secs, batch, device)
    return _peak(cfg, terms, batch * _segment_transient_bytes(cfg), params)


def parallel_track_hbm_bytes(cfg: EngineConfig, chunk_batch: int, track_secs: float,
                             params=None, batch: int = 1, device=None) -> dict[str, int]:
    """Estimated peak of the non-streaming program at group width
    ``chunk_batch`` over ``batch`` stacked tracks (batch × width segment
    rows in flight) on ``device`` (None: the GPU).  Returns the liveness
    terms (bytes) and ``total``."""
    b = max(1, batch)
    terms = _track_terms(cfg, track_secs, b, device)
    width = min(chunk_batch, terms["n_chunks"])
    return _peak(cfg, terms, b * width * _segment_transient_bytes(cfg), params)


def segment_batch_hbm_bytes(cfg: EngineConfig, batch: int, quantized: bool = False,
                            params=None) -> dict[str, int]:
    """Estimated peak of one batched segment call (the serving batcher's
    ``segment_forward_batched`` over ``batch`` rows): the parameters, the
    rows' audio in and waveforms out, each row's segment transients
    (``seg_transients``, the JAX package's ``transients`` plus the dense
    inverse's frames share) times the per-row factor, and a fixed part for
    what runs a row at a time.  ``quantized`` matters only without
    ``params`` (:func:`params_hbm_bytes`).  Returns the terms (bytes) and
    ``total``."""
    seg = cfg.segment.segment_samples(cfg.dsp.sample_rate)
    algo = "ct2" if cfg.dsp.istft_algo == "ct2" else "dense"
    row = _segment_transient_bytes(cfg)
    transients = int(batch * row * _SEGMENT_ROW_FACTOR[algo])
    io = batch * (2 + cfg.model.n_targets * 2) * seg * _F32  # audio in + waves out
    fixed = (int(row * _SEGMENT_FIXED_FACTOR[algo]) + _dequant_transient_bytes(params)
             + _lstm_exchange_bytes(cfg))
    params_b = params_hbm_bytes(cfg, params, quantized)
    return {
        "seg_transients": batch * row, "transients": transients, "io": io, "fixed": fixed,
        "params": params_b, "total": transients + io + fixed + params_b,
    }


def _suggest(estimate, budget: float, hard_cap: int = 1024) -> int:
    """Largest b in [1, hard_cap] with estimate(b) <= budget (estimate
    monotonic in b; always >= 1): exponential probe, then bisection."""
    if hard_cap <= 1 or estimate(2) > budget:
        return 1
    lo, hi = 2, 4
    while hi <= hard_cap and estimate(hi) <= budget:
        lo, hi = hi, hi * 2
    hi = min(hi, hard_cap + 1)
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if estimate(mid) <= budget:
            lo = mid
        else:
            hi = mid
    return lo


def suggest_max_batch(cfg: EngineConfig, track_secs: float, hbm_bytes: int | None = None,
                      safety: float = 0.9, params=None, device=None) -> int:
    """Largest number of ``track_secs`` tracks whose estimated streaming
    footprint fits in ``safety`` × the capacity (always >= 1)."""
    budget = (device_hbm_bytes(device) if hbm_bytes is None else hbm_bytes) * safety
    return _suggest(lambda b: fused_track_hbm_bytes(cfg, b, track_secs, params, device)["total"],
                    budget)


def suggest_chunk_batch(cfg: EngineConfig, track_secs: float, hbm_bytes: int | None = None,
                        safety: float = 0.9, params=None, batch: int = 1, device=None) -> int:
    """Widest non-streaming group whose estimated footprint fits (the
    ``chunk_batch=0`` auto mode).  Capped, as in the JAX package, so that
    batch × width stays at most 16 rows."""
    budget = (device_hbm_bytes(device) if hbm_bytes is None else hbm_bytes) * safety
    return _suggest(
        lambda w: parallel_track_hbm_bytes(cfg, w, track_secs, params, batch, device)["total"],
        budget,
        hard_cap=max(1, 16 // max(1, batch)),
    )


def suggest_max_fleet_batch(cfg: EngineConfig, track_secs: float, hbm_bytes: int | None = None,
                            safety: float = 0.9, params=None, device=None) -> int:
    """Largest batch of whole ``track_secs`` tracks for one bucket dispatch
    of ``fleet.demix_tracks``.  Streaming buckets run the chunk loop over
    the batch (:func:`suggest_max_batch`); non-streaming buckets run chunk
    groups whose width is re-resolved per batch, so each candidate batch
    is estimated at the width it would run at (``chunk_batch``, or the
    planner's batch-aware pick)."""
    if cfg.segment.streaming:
        return suggest_max_batch(cfg, track_secs, hbm_bytes, safety, params, device)
    capacity = device_hbm_bytes(device) if hbm_bytes is None else hbm_bytes

    def est(b: int) -> int:
        w = cfg.segment.chunk_batch
        if w <= 0:
            w = suggest_chunk_batch(cfg, track_secs, capacity, safety, params, batch=b,
                                    device=device)
        return parallel_track_hbm_bytes(cfg, w, track_secs, params, batch=b,
                                        device=device)["total"]

    return _suggest(est, capacity * safety)


def suggest_window_chunks(cfg: EngineConfig, hbm_bytes: int | None = None, safety: float = 0.9,
                          params=None, resident_bytes: int = 0, device=None) -> int:
    """Largest W (chunks) for one window of a windowed track
    (``SegmentConfig.window_chunks == 0``): the widest window whose
    footprint, that of a W-chunk track through the single program plus
    the previous window's normalized stems (live until they are copied
    out or written into the result), fits in ``safety`` × the capacity
    after ``resident_bytes`` are set aside for what the caller keeps on
    the device across windows (its whole-track audio and result buffer
    when the input arrived as a device tensor)."""
    capacity = device_hbm_bytes(device) if hbm_bytes is None else hbm_bytes
    budget = capacity * safety - resident_bytes
    return _suggest(lambda w: window_hbm_bytes(cfg, w, capacity, safety, params, device), budget,
                    hard_cap=4096)


def window_hbm_bytes(cfg: EngineConfig, w: int, hbm_bytes: int, safety: float = 0.9,
                     params=None, device=None) -> int:
    """Estimated peak of one W-chunk window on ``device`` (None: the GPU):
    a W-chunk track through the single program (non-streaming: at
    ``chunk_batch``, or the width the planner picks within ``safety`` ×
    ``hbm_bytes``) plus the previous window's normalized stems."""
    stride = cfg.segment.stride_samples(cfg.dsp.sample_rate)
    # track_secs = w*stride/sr gives exactly w chunks: a window of W chunks
    # has the buffer shapes of a W-chunk track
    secs = w * stride / cfg.dsp.sample_rate
    prev_out = cfg.model.n_targets * 2 * w * stride * _F32
    if cfg.segment.streaming:
        one = fused_track_hbm_bytes(cfg, 1, secs, params, device)["total"]
    else:
        width = cfg.segment.chunk_batch
        if width <= 0:
            width = suggest_chunk_batch(cfg, secs, hbm_bytes, safety, params, device=device)
        one = parallel_track_hbm_bytes(cfg, width, secs, params, device=device)["total"]
    return one + prev_out


def suggest_max_segment_batch(cfg: EngineConfig, hbm_bytes: int | None = None,
                              safety: float = 0.9, quantized: bool = False, params=None,
                              device=None) -> int:
    """Widest batched segment call (the serving batcher's ``max_batch``)
    whose estimated footprint fits in ``safety`` × the capacity (always
    >= 1)."""
    budget = (device_hbm_bytes(device) if hbm_bytes is None else hbm_bytes) * safety
    return _suggest(
        lambda b: segment_batch_hbm_bytes(cfg, b, quantized, params)["total"], budget)
