"""Real-time streaming demixer.

Push audio pieces of any size and receive finished stems as soon as every
overlapping segment that covers them has run.  The semantics are those of
the offline ``Separator.demix``: the same segment grid, triangular
weights, LSTM state carried from segment to segment (when the config
streams) and zero-padded final segments, so ``push()`` over any chunking
followed by ``flush()`` gives the offline stems.  The latency is one
segment (``SegmentConfig.segment_secs``).

Memory stays one segment whatever the stream's length: one input window
on the host and one weighted accumulation window on the device, both
rolling by the stride.
"""

from __future__ import annotations

import numpy as np
import torch

from umx_tpu_torch.config import EngineConfig
from umx_tpu_torch.engine.separator import (
    resolve_device,
    segment_forward,
    to_host,
    transition_weight,
)
from umx_tpu_torch.models.umx import LSTMState, UMXParams, init_lstm_state


def _segment_accum_emit(params: UMXParams, chunk, state: LSTMState, acc, wacc, weight,
                        cfg: EngineConfig, seg: int, stride: int):
    """One streaming step on the device: demix the segment, add
    ``weight * out`` and ``weight`` into the rolling windows, divide their
    first ``stride`` samples (the finished block), and roll both windows
    by ``stride``.  Returns (block (T#, 2, stride), acc, wacc, new state);
    only the block is copied to the host by the caller."""
    out, new_state = segment_forward(params, chunk, state, cfg, seg)
    acc = acc + weight * out
    wacc = wacc + weight
    block = acc[..., :stride] / torch.clamp(wacc[:stride], min=1e-12)
    acc = torch.cat([acc[..., stride:], acc.new_zeros((*acc.shape[:-1], stride))], dim=-1)
    wacc = torch.cat([wacc[stride:], wacc.new_zeros((stride,))])
    return block, acc, wacc, new_state


class StreamingDemixer:
    """Streaming demix of one stream with ``params`` on ``device`` (the GPU
    unless ``device`` names another; the parameters must lie there)."""

    def __init__(self, params: UMXParams, cfg: EngineConfig = EngineConfig(), device=None):
        self.device = resolve_device(device)
        self.params = params
        self.cfg = cfg
        sr = cfg.dsp.sample_rate
        self.seg = cfg.segment.segment_samples(sr)
        self.stride = cfg.segment.stride_samples(sr)
        self.n_targets = cfg.model.n_targets
        self._weight = transition_weight(self.seg, cfg.segment.transition_power, self.device)
        self.reset()

    def reset(self):
        self._state = init_lstm_state(self.cfg.model, self.device)
        self._in = np.zeros((2, 0), np.float32)  # samples not yet emitted
        self._acc = torch.zeros((self.n_targets, 2, self.seg), device=self.device)
        self._wacc = torch.zeros((self.seg,), device=self.device)
        self._pushed = 0  # samples received
        self._emitted = 0  # samples emitted

    @property
    def latency_samples(self) -> int:
        """Most samples between pushing a sample and receiving its demixed
        value (one segment)."""
        return self.seg

    def _emit_block(self, chunk: np.ndarray) -> np.ndarray:
        """Run one segment on the device, roll the host input window and
        return the finished block."""
        block, self._acc, self._wacc, new_state = _segment_accum_emit(
            self.params, torch.from_numpy(np.ascontiguousarray(chunk)).to(self.device),
            self._state, self._acc, self._wacc, self._weight, self.cfg, self.seg, self.stride,
        )
        if self.cfg.segment.streaming:
            self._state = new_state
        self._in = self._in[:, self.stride :]
        self._emitted += self.stride
        return to_host(block)

    @torch.inference_mode()
    def push(self, chunk: np.ndarray) -> np.ndarray:
        """Feed (2, n) samples; returns (n_targets, 2, m) finished stems
        (m may be 0)."""
        chunk = np.asarray(chunk, np.float32)
        if chunk.ndim != 2 or chunk.shape[0] != 2:
            raise ValueError(f"expected (2, n) audio chunk, got {chunk.shape}")
        self._in = np.concatenate([self._in, chunk], axis=1)
        self._pushed += chunk.shape[1]
        blocks = []
        while self._in.shape[1] >= self.seg:
            blocks.append(self._emit_block(self._in[:, : self.seg]))
        if blocks:
            return np.concatenate(blocks, axis=-1)
        return np.zeros((self.n_targets, 2, 0), np.float32)

    @torch.inference_mode()
    def flush(self) -> np.ndarray:
        """End of stream: run the remaining partial segments (zero-padded,
        as the offline demix pads its tail) and return the remaining stems,
        trimmed to the samples pushed."""
        total = self._pushed
        blocks = []
        while self._emitted < total:
            pending = self._in.shape[1]  # == total - self._emitted < seg
            blocks.append(self._emit_block(np.pad(self._in, ((0, 0), (0, self.seg - pending)))))
        if not blocks:
            return np.zeros((self.n_targets, 2, 0), np.float32)
        out = np.concatenate(blocks, axis=-1)
        excess = self._emitted - total
        return out[..., : out.shape[-1] - excess] if excess > 0 else out
