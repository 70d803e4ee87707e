"""STFT / iSTFT on (re, im) float32 planes in the (..., T, F) layout,
through ``torch.stft``/``torch.istft`` (cuFFT on the GPU).

Conventions (those of ``umx_tpu.ops.stft`` and of torch.stft):
centered with a reflect pad of n_fft/2, periodic Hann window, one-sided,
unscaled forward, 1/N inverse, overlap-add normalized by the window
sum-of-squares, cropped to ``[pad : pad + n]``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from umx_tpu_torch.config import DSPConfig


@functools.lru_cache(maxsize=8)
def _hann_window_np(n_fft: int) -> np.ndarray:
    # periodic Hann in float64, rounded once to float32 (as the JAX package)
    n = np.arange(n_fft, dtype=np.float64)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * n / n_fft))).astype(np.float32)


def hann_window(n_fft: int, device) -> torch.Tensor:
    return torch.from_numpy(_hann_window_np(n_fft)).to(device)


def stft_planes(x: torch.Tensor, cfg: DSPConfig):
    """Centered STFT of x (..., n) → (re, im), each (..., T, F) float32
    with T = n // hop + 1."""
    lead = x.shape[:-1]
    spec = torch.stft(
        x.reshape(-1, x.shape[-1]).float(),
        n_fft=cfg.n_fft,
        hop_length=cfg.hop,
        window=hann_window(cfg.n_fft, x.device),
        center=True,
        pad_mode="reflect",
        normalized=False,
        onesided=True,
        return_complex=True,
    )  # (N, F, T)
    spec = spec.transpose(-1, -2).reshape(*lead, spec.shape[-1], spec.shape[-2])
    return spec.real.contiguous(), spec.imag.contiguous()


def istft_planes(re: torch.Tensor, im: torch.Tensor, n_samples: int, cfg: DSPConfig):
    """Inverse STFT from (re, im) planes (..., T, F) → (..., n_samples)."""
    lead = re.shape[:-2]
    T, F = re.shape[-2:]
    spec = torch.complex(re.float(), im.float()).reshape(-1, T, F).transpose(-1, -2)
    sig = torch.istft(
        spec,
        n_fft=cfg.n_fft,
        hop_length=cfg.hop,
        window=hann_window(cfg.n_fft, re.device),
        center=True,
        normalized=False,
        onesided=True,
        length=n_samples,
    )
    return sig.reshape(*lead, n_samples)


def crop_stack(mag: torch.Tensor, nb_bins_cropped: int) -> torch.Tensor:
    """(2, T, F) magnitudes → (T, 2*crop) stacked-stereo network input
    (left bins, then right bins)."""
    cropped = mag[:, :, :nb_bins_cropped]
    return torch.cat([cropped[0], cropped[1]], dim=-1)


def masks_to_planes(masks: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Network-layout masks (T#, T, 2*n_bins) → channel planes
    (T#, 2, T, n_bins)."""
    m = masks.reshape(masks.shape[0], masks.shape[1], 2, n_bins)
    return m.permute(0, 2, 1, 3)


def polar_to_complex(mag: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``mag * exp(i * angle(ref))`` without trig; |ref| = 0 gives the
    unit phasor 1 + 0i."""
    a = ref.abs()
    nz = a > 0
    unit = torch.where(nz, ref / torch.where(nz, a, torch.ones_like(a)), torch.ones_like(ref))
    return mag.to(a.dtype) * unit
