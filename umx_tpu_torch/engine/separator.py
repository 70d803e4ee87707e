"""The demixing engine: the per-segment pipeline and the track loop.

A segment runs STFT → magnitude → crop/stack → mask network (pre,
recurrence, post) → Wiener-EM (or mix-phase masking) → iSTFT.  A track
is split into full-length segments at a fixed stride (the last one
zero-padded), the streaming LSTM state is threaded from segment to
segment, and the outputs are cross-faded with the triangular transition
weight, accumulated into one float32 track buffer and divided by the
weight sum.  With shifts ≥ 1 the track is front-padded by a random
offset drawn from ``np.random.default_rng(seed)`` and trimmed back.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from umx_tpu_torch.config import EngineConfig
from umx_tpu_torch.models.umx import (
    LSTMState,
    UMXParams,
    init_lstm_state,
    umx_post,
    umx_pre,
    umx_recurrence,
)
from umx_tpu_torch.ops.stft import crop_stack, istft_planes, masks_to_planes, stft_planes
from umx_tpu_torch.ops.wiener import wiener_filter_masks


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; a CUDA device without a usable GPU
    raises instead of running anywhere else."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but torch.cuda.is_available() is False")
    return dev


def segment_forward(
    params: UMXParams, audio, state: LSTMState, cfg: EngineConfig, n_samples: int
):
    """Demix one segment: audio (2, n_samples) → (waveforms
    (T#, 2, n_samples), new LSTM state)."""
    mcfg = cfg.model
    re, im = stft_planes(audio, cfg.dsp)  # (2, T, F)
    mag = torch.sqrt(re * re + im * im)
    x1 = umx_pre(params, crop_stack(mag, mcfg.nb_bins_cropped), mcfg)
    lstm_out, new_state = umx_recurrence(params, x1, state, mcfg)
    masks = umx_post(params, x1, lstm_out, mcfg)
    if cfg.use_wiener:
        tre, tim = wiener_filter_masks(re, im, masks, mcfg.n_bins, cfg.wiener)
    else:
        # mix-phase reconstruction: mag * unit(x) = mask * x
        m = masks_to_planes(masks, mcfg.n_bins)
        tre = m * re[None]
        tim = m * im[None]
    return istft_planes(tre, tim, n_samples, cfg.dsp), new_state


def transition_weight(segment_samples: int, power: float, device="cpu"):
    """Demucs triangular cross-fade weight; an odd length gets a one-sample
    plateau at the maximum."""
    half = segment_samples // 2
    up = torch.arange(1, half + 1, dtype=torch.float32, device=device)
    if segment_samples % 2:
        w = torch.cat([up, up[-1:], up.flip(0)])
    else:
        w = torch.cat([up, up.flip(0)])
    w = w / w.max()
    return w**power


class Separator:
    """Demixer holding one model's parameters on one device."""

    def __init__(self, params: UMXParams, cfg: EngineConfig = EngineConfig(), device="cpu"):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # full-f32 matmuls, as the reference computes them
            torch.backends.cuda.matmul.allow_tf32 = False
        self.params = params
        self.cfg = cfg

    @classmethod
    def from_ggml(cls, path: str, cfg: EngineConfig | None = None, device="cpu") -> "Separator":
        """Load ggml weights onto ``device``; the model's hidden size
        overrides ``cfg``'s."""
        from umx_tpu_torch.io.ggml import read_ggml
        from umx_tpu_torch.models.umx import params_from_ggml

        device = resolve_device(device)
        model = read_ggml(path)
        if cfg is None:
            cfg = EngineConfig()
        if cfg.model.hidden_size != model.hidden_size:
            cfg = dataclasses.replace(
                cfg, model=dataclasses.replace(cfg.model, hidden_size=model.hidden_size)
            )
        return cls(params_from_ggml(model, cfg.model, device), cfg, device)

    @torch.inference_mode()
    def demix(self, audio) -> torch.Tensor:
        """Overlapping-segment demix of a track: audio (2, length) →
        (T#, 2, length) float32 on the separator's device."""
        cfg = self.cfg
        sr = cfg.dsp.sample_rate
        seg = cfg.segment.segment_samples(sr)
        stride = cfg.segment.stride_samples(sr)
        audio = torch.as_tensor(np.asarray(audio, np.float32)).to(self.device)
        length = audio.shape[1]

        n_chunks = max(1, math.ceil(length / stride))
        padded_len = (n_chunks - 1) * stride + seg
        audio_p = torch.nn.functional.pad(audio, (0, padded_len - length))

        weight = transition_weight(seg, cfg.segment.transition_power, self.device)
        out = torch.zeros((cfg.model.n_targets, 2, padded_len), device=self.device)
        sum_weight = torch.zeros((padded_len,), device=self.device)
        state = init_lstm_state(cfg.model, self.device)
        for i in range(n_chunks):
            off = i * stride
            chunk_out, new_state = segment_forward(
                self.params, audio_p[:, off : off + seg], state, cfg, seg
            )
            if cfg.segment.streaming:
                state = new_state
            out[..., off : off + seg] += weight * chunk_out
            sum_weight[off : off + seg] += weight
        return (out / sum_weight)[..., :length]

    def demix_track(self, audio, seed: int = 0) -> np.ndarray:
        """Full-track demix with the Demucs random-shift trick: each of
        ``cfg.shifts`` passes front-pads the track by an offset in
        [0, max_shift) and trims the output back; the passes are
        averaged.  Returns (T#, 2, length) float32 numpy."""
        cfg = self.cfg
        audio = np.asarray(audio, np.float32)
        length = audio.shape[1]
        if cfg.shifts <= 0:
            return self.demix(audio).cpu().numpy()

        max_shift = cfg.segment.max_shift_samples(cfg.dsp.sample_rate)
        rng = np.random.default_rng(seed)
        offsets = [int(rng.integers(0, max_shift)) for _ in range(cfg.shifts)]
        acc = None
        for offset in offsets:
            shifted = np.pad(audio, ((0, 0), (offset, max_shift - offset)))
            out = self.demix(shifted)[..., offset : offset + length]
            acc = out if acc is None else acc + out
        return (acc / cfg.shifts).cpu().numpy()
