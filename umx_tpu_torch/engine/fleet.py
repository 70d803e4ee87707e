"""The fleet runner: many tracks of mixed lengths through batched
whole-track programs, on one device or data-parallel over a mesh's dp
devices (``umx_tpu.engine.fleet``).

:func:`demix_tracks` buckets the tracks by chunk count, so that each
bucket is one shape, caps every dispatch with the memory planner and
sends tracks beyond one program's window through the per-track windowed
path.  A bucket runs B stacked tracks through one program: streaming
configs run the chunk loop over all B tracks at once, each track's LSTM
state carried in its own batch row (the recurrence kernel runs B rows per
chain); non-streaming configs run the chunk groups with B × width segment
rows per group.  With a mesh, a bucket's tracks are split over the dp
devices, each of which runs the same program on its rows.  A dispatch's
batch is built on its devices: each track crosses to the device once a
pass at its own length, into its row of a zero batch, and its stems come
back once, cut to its span (and divided by the pass count) on the device.
"""

from __future__ import annotations

import math
import time
from collections import defaultdict

import numpy as np
import torch

from umx_tpu_torch.config import EngineConfig
from umx_tpu_torch.engine.memory import (
    suggest_chunk_batch,
    suggest_max_fleet_batch,
    suggest_window_chunks,
)
from umx_tpu_torch.engine.separator import Separator, demix_fused, demix_fused_parallel, to_host
from umx_tpu_torch.models.umx import init_lstm_state
from umx_tpu_torch.parallel.sharding import device_guard, params_on
from umx_tpu_torch.utils.profiling import span


def resolve_batched_width(cfg: EngineConfig, n_chunks: int, seg: int, stride: int,
                          batch: int = 1, params=None, device=None) -> int:
    """Chunk-group width of the non-streaming program over ``batch``
    tracks: ``cfg.segment.chunk_batch``, or the planner's batch-aware pick
    when it is 0 (batch × width <= 16 rows), capped at ``n_chunks``."""
    cb = cfg.segment.chunk_batch
    if cb <= 0:
        track_secs = ((n_chunks - 1) * stride + seg) / cfg.dsp.sample_rate
        cb = suggest_chunk_batch(cfg, track_secs, params=params, batch=max(1, batch),
                                 device=device)
    return min(cb, n_chunks)


def _batched_demix(cfg: EngineConfig, n_chunks: int, seg: int, stride: int, batch: int = 1,
                   device=None):
    """The program demixing B stacked tracks: a function
    ``(params, audio (B, 2, P), states h/c (B, T#, L, D, G)) →
    (stems (B, T#, 2, P), states)``.  Non-streaming configs pass the
    states through untouched (nothing carries)."""
    if cfg.segment.streaming:
        def run(params, audio_p, states):
            return demix_fused(params, audio_p, states, cfg, n_chunks, seg, stride)
    else:
        def run(params, audio_p, states):
            cb = resolve_batched_width(cfg, n_chunks, seg, stride, batch=batch, params=params,
                                       device=device)
            return demix_fused_parallel(params, audio_p, cfg, n_chunks, seg, stride, cb), states
    return run


def _add(stats: dict | None, **kw) -> None:
    if stats is not None:
        for k, v in kw.items():
            stats[k] = stats.get(k, 0) + v


def _rows_per_device(per_dev: int, dp_devices: list) -> int:
    """Track rows a dp device takes in one dispatch: the planner's
    ``per_dev`` rows over the dp rows that share its card, so that no card
    holds more than ``per_dev`` rows (at least one row each)."""
    share = max(dp_devices.count(d) for d in dp_devices)
    return max(1, per_dev // share)


@torch.inference_mode()
def demix_tracks(sep_or_params, tracks: list[np.ndarray], cfg: EngineConfig | None = None,
                 seeds: list[int] | None = None, stats: dict | None = None,
                 mesh=None) -> list[np.ndarray]:
    """Demix many tracks on one device, or data-parallel over a mesh.

    ``sep_or_params``: a :class:`Separator` (its parameters and device;
    ``cfg`` defaults to its config) or parameters already on their device.
    tracks: (2, n_i) float32 arrays, lengths may differ.  Returns
    (T#, 2, n_i) float32 arrays in input order, equal to what
    ``Separator.demix_track(track, seed)`` gives each track (``seeds``
    default to 0 as there).

    mesh: a :class:`~umx_tpu_torch.parallel.mesh.Mesh`; its dp devices
    share each bucket.  The parameters are placed once on each distinct dp
    device; a dispatch takes the planner's rows per card
    (``suggest_max_fleet_batch``, divided among the dp rows that share a
    card) times dp, padded to a multiple of dp with silent tracks, and
    each dp device runs the program on its share.  Tracks beyond the
    single-program window keep the windowed path on the parameters' own
    device.  ``None``: everything on the parameters' device.

    stats: an optional dict that accumulates the phase times of every
    dispatch, each closed by a device synchronisation: ``upload_s``
    (the batch built on the device from the tracks' uploads),
    ``compute_s`` (the program), ``download_s`` (each track's stems cut
    on the device and copied to the host, summed there from the second
    pass on), and ``dispatches``, ``rows`` (track rows dispatched, silent
    padding rows included), ``upload_bytes`` and ``download_bytes`` (the
    audio and stems that crossed between host and device: each track's
    own length, once a pass) and ``windowed_tracks`` (tracks beyond the
    single-program window, demixed one by one through the windowed
    path)."""
    if isinstance(sep_or_params, Separator):
        params, device = sep_or_params.params, sep_or_params.device
        cfg = sep_or_params.cfg if cfg is None else cfg
    else:
        params = sep_or_params
        device = params.input_mean.device
        cfg = EngineConfig() if cfg is None else cfg
    def sync():
        if stats is not None:
            for dev in placed:
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
        return time.perf_counter()

    results: list[np.ndarray | None] = [None] * len(tracks)
    # the call's set-up: the parameters' placement, the shift offsets, the
    # planner's window and the buckets with their caps
    with span("umx.prepare"):
        dp_devices = [device] if mesh is None else list(mesh.devices[:, 0])
        dp = len(dp_devices)
        # the parameters placed once per distinct device, outside the pass
        # and bucket loops (a UMX-L tree is about 450 MB)
        placed = {dev: params_on(params, dev) for dev in dict.fromkeys(dp_devices)}
        sr = cfg.dsp.sample_rate
        seg = cfg.segment.segment_samples(sr)
        stride = cfg.segment.stride_samples(sr)
        max_shift = cfg.segment.max_shift_samples(sr)
        if seeds is None:
            seeds = [0] * len(tracks)

        # per-track offsets drawn as Separator.demix_track draws them
        n_passes = max(1, cfg.shifts)
        track_offsets = []
        for seed in seeds:
            rng = np.random.default_rng(seed)
            track_offsets.append([int(rng.integers(0, max_shift)) if cfg.shifts > 0 else 0
                                  for _ in range(n_passes)])
        # the pass count as a device tensor: a CUDA division by a Python
        # scalar multiplies by its reciprocal, which is not the host's
        # quotient in the last bit (at 3 passes)
        divisor = {dev: torch.full((), n_passes, dtype=torch.float32, device=dev) for dev in placed}

        # Tracks beyond the single-program window go one by one through
        # Separator.demix_track, which chains windows: a bucket never
        # dispatches a program that the planner says does not fit.  The
        # same seed draws the same offsets, and windowed equals
        # single-program.  The buckets run the scan whatever
        # ``stream_impl`` says, and so do these tracks, so that they window.
        # The rest are bucketed by chunk count, which the shift pad and
        # the length alone decide, so one bucketing serves every pass.
        audio = [np.ascontiguousarray(t, np.float32) for t in tracks]
        win_limit = cfg.segment.window_chunks
        if win_limit == 0:
            win_limit = suggest_window_chunks(cfg, params=params, device=device)
        shift_pad = max_shift if cfg.shifts > 0 else 0
        long_tracks: list[int] = []
        buckets: dict[int, list[int]] = defaultdict(list)
        for i, a in enumerate(audio):
            n_chunks = max(1, math.ceil((a.shape[1] + shift_pad) / stride))
            if 0 < win_limit < n_chunks:
                long_tracks.append(i)
            else:
                buckets[n_chunks].append(i)
        # each bucket's sub-batches: at most the planner's batch for its length
        caps = {}
        for n_chunks in buckets:
            track_secs = ((n_chunks - 1) * stride + seg) / sr
            per_dev = max(1, suggest_max_fleet_batch(cfg, track_secs, params=params,
                                                     device=device))
            caps[n_chunks] = _rows_per_device(per_dev, dp_devices) * dp
    if long_tracks:
        sep = Separator(params, cfg.replace(stream_impl="scan"), device)
        for i in long_tracks:
            results[i] = sep.demix_track(audio[i], seed=seeds[i])
            _add(stats, windowed_tracks=1)

    for p in range(n_passes):
        for n_chunks, items in sorted(buckets.items()):
            padded_len = (n_chunks - 1) * stride + seg
            for s0 in range(0, len(items), caps[n_chunks]):
                sub = items[s0 : s0 + caps[n_chunks]]
                share = -(-len(sub) // dp)  # silent rows up to a multiple of dp
                with span("umx.prepare"):
                    # each track uploaded once into its row of a zero batch,
                    # at its shift offset
                    t0 = sync()
                    inputs = []
                    for k, dev in enumerate(dp_devices):
                        audio_b = torch.zeros((share, 2, padded_len), device=dev)
                        for r, i in enumerate(sub[k * share : (k + 1) * share]):
                            off = track_offsets[i][p]
                            audio_b[r, :, off : off + audio[i].shape[1]].copy_(
                                torch.from_numpy(audio[i]))
                        inputs.append((audio_b, init_lstm_state(cfg.model, dev, batch=share)))
                    t1 = sync()
                with span("umx.program"):
                    outs = []
                    for dev, (audio_b, states) in zip(dp_devices, inputs):
                        fn = _batched_demix(cfg, n_chunks, seg, stride, batch=share, device=dev)
                        with device_guard(dev):
                            outs.append(fn(placed[dev], audio_b, states)[0])
                    t2 = sync()
                with span("umx.combine"):
                    # each track's span cut and divided on its device, then
                    # copied out once; the passes summed on the host in order
                    down = 0
                    for j, i in enumerate(sub):
                        k, off, length = j // share, track_offsets[i][p], audio[i].shape[1]
                        cut = outs[k][j % share, ..., off : off + length]
                        cut = cut / divisor[dp_devices[k]] if n_passes > 1 else cut.clone()
                        stems = to_host(cut)
                        down += stems.nbytes
                        if results[i] is None:
                            results[i] = stems
                        else:
                            results[i] += stems
                    t3 = sync()
                    _add(stats, upload_s=t1 - t0, compute_s=t2 - t1, download_s=t3 - t2,
                         dispatches=1, rows=share * dp,
                         upload_bytes=sum(audio[i].nbytes for i in sub), download_bytes=down)
    return results  # type: ignore[return-value]
