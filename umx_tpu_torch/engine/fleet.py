"""B stacked tracks through one whole-track program: the two functions of
``umx_tpu.engine.fleet`` that the batched shift passes use.

Streaming configs run the chunk loop over all B tracks at once, each
track's LSTM state carried in its own batch row (the recurrence kernel
runs B rows per chain).  Non-streaming configs run the chunk groups with
B × width segment rows per group.
"""

from __future__ import annotations

from umx_tpu_torch.config import EngineConfig
from umx_tpu_torch.engine.memory import suggest_chunk_batch
from umx_tpu_torch.engine.separator import demix_fused, demix_fused_parallel


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
