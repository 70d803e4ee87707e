"""The fleet's staging as it was on the host, the yardstick of
``engine.fleet.demix_tracks``: every track padded with ``np.pad`` (the
shift, then the bucket's length), a dispatch's rows stacked with
``np.stack`` and uploaded whole, the padded stems copied back whole, and
each track's span cut, divided by the pass count and summed on the host.
The programs, buckets, caps and shift offsets are the fleet's own, so
``demix_tracks`` must give these arrays bit for bit.  Tracks beyond the
window are not taken: call it with ``window_chunks=-1``.
"""

from __future__ import annotations

import math
from collections import defaultdict

import numpy as np
import torch

from umx_tpu_torch.engine import fleet
from umx_tpu_torch.models.umx import init_lstm_state
from umx_tpu_torch.parallel.sharding import device_guard, params_on


@torch.inference_mode()
def host_staged_demix_tracks(params, tracks, cfg, seeds, mesh=None) -> list[np.ndarray]:
    device = params.input_mean.device
    dp_devices = [device] if mesh is None else list(mesh.devices[:, 0])
    dp = len(dp_devices)
    placed = {dev: params_on(params, dev) for dev in dict.fromkeys(dp_devices)}
    sr = cfg.dsp.sample_rate
    seg, stride = cfg.segment.segment_samples(sr), cfg.segment.stride_samples(sr)
    max_shift = cfg.segment.max_shift_samples(sr)
    n_passes = max(1, cfg.shifts)
    offsets = []
    for seed in seeds:
        rng = np.random.default_rng(seed)
        offsets.append([int(rng.integers(0, max_shift)) if cfg.shifts > 0 else 0
                        for _ in range(n_passes)])
    results: list = [None] * len(tracks)
    for p in range(n_passes):
        buckets = defaultdict(list)
        for i, track in enumerate(tracks):
            track = np.asarray(track, np.float32)
            length, offset = track.shape[1], offsets[i][p]
            if cfg.shifts > 0:
                track = np.pad(track, ((0, 0), (offset, max_shift - offset)))
            n_chunks = max(1, math.ceil(track.shape[1] / stride))
            padded_len = (n_chunks - 1) * stride + seg
            track = np.pad(track, ((0, 0), (0, padded_len - track.shape[1])))
            buckets[n_chunks].append((i, offset, length, track))
        for n_chunks, items in sorted(buckets.items()):
            track_secs = ((n_chunks - 1) * stride + seg) / sr
            per_dev = max(1, fleet.suggest_max_fleet_batch(cfg, track_secs, params=params,
                                                           device=device))
            cap = fleet._rows_per_device(per_dev, dp_devices) * dp
            for s0 in range(0, len(items), cap):
                sub = items[s0 : s0 + cap]
                batch = [it[3] for it in sub]
                while len(batch) % dp:
                    batch.append(np.zeros_like(batch[0]))
                share = len(batch) // dp
                outs = []
                for k, dev in enumerate(dp_devices):
                    audio_b = torch.from_numpy(np.stack(batch[k * share : (k + 1) * share]))
                    fn = fleet._batched_demix(cfg, n_chunks, seg, stride, batch=share, device=dev)
                    with device_guard(dev):
                        out = fn(placed[dev], audio_b.to(dev),
                                 init_lstm_state(cfg.model, dev, batch=share))[0]
                    outs.append(out.cpu().numpy())
                out_b = np.concatenate(outs)
                for (idx, offset, length, _), out in zip(sub, out_b):
                    contrib = out[..., offset : offset + length] / n_passes
                    results[idx] = contrib if results[idx] is None else results[idx] + contrib
    return results
