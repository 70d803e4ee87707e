"""STFT / iSTFT on (re, im) float32 planes in the (..., T, F) layout.

Conventions (those of ``umx_tpu.ops.stft`` and of torch.stft):
centered with a reflect pad of n_fft/2, periodic Hann window, one-sided,
unscaled forward, 1/N inverse, overlap-add normalized by the window
sum-of-squares, cropped to ``[pad : pad + n]``.

The forward transform and the dense inverse run through
``torch.stft``/``torch.istft`` (cuFFT on the GPU).  ``istft_algo="ct2"``
runs the fused Cooley-Tukey inverse (K8, ``ops/istft_ct_cuda.py``) and
normalizes as the JAX package does: raw signal / (window_sumsquare +
1e-8), then the crop.
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


def frame_signal(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """Split x (..., n) into hop-strided frames (..., T, n_fft) with
    T = (n - n_fft) // hop + 1 (``umx_tpu.ops.stft.frame_signal``): frame t
    is the concatenation of the n_fft/hop pieces of hop samples starting
    at (t + p) * hop.  Requires hop | n_fft."""
    if n_fft % hop:
        raise ValueError(f"frame_signal requires hop | n_fft, got {hop}, {n_fft}")
    n_frames = (x.shape[-1] - n_fft) // hop + 1
    pieces = [x[..., p * hop:(p + n_frames) * hop].reshape(*x.shape[:-1], n_frames, hop)
              for p in range(n_fft // hop)]
    return torch.cat(pieces, dim=-1)


def stft(x: torch.Tensor, cfg: DSPConfig) -> torch.Tensor:
    """Centered STFT of x (..., n) → complex64 (..., T, F) with
    T = n // hop + 1, the JAX package's layout (:func:`stft_planes` as one
    complex tensor)."""
    re, im = stft_planes(x, cfg)
    return torch.complex(re, im)


def istft(spec: torch.Tensor, n_samples: int, cfg: DSPConfig) -> torch.Tensor:
    """Inverse of :func:`stft`: spec (..., T, F) complex → (..., n_samples)
    (:func:`istft_planes` on its real and imaginary planes)."""
    return istft_planes(spec.real, spec.imag, n_samples, cfg)


def magnitude(spec: torch.Tensor) -> torch.Tensor:
    """|spec| of a complex spectrogram."""
    return spec.abs()


def stft_magnitude(x: torch.Tensor, cfg: DSPConfig) -> torch.Tensor:
    """|STFT| of x (..., n) → (..., T, F) float32, e.g. a batch of mixes
    (B, 2, n) or of targets (B, T#, 2, n)."""
    re, im = stft_planes(x, cfg)
    return torch.sqrt(re * re + im * im)


def hermitian_spectrum(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    """complex(re, im) with the imaginary parts of the DC and Nyquist bins
    set to 0.  A one-sided inverse drops them by definition (the JAX
    package's and the CPU's irfft ignore them), but cuFFT's C2R transform
    assumes they are 0 and gives another result where they are not; the
    Wiener output can carry them."""
    spec = torch.complex(re.float(), im.float())
    spec.imag[..., 0] = 0.0
    spec.imag[..., -1] = 0.0
    return spec


def overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """Sum frames (..., T, n_fft) at hop-strided offsets into a signal
    (..., (T-1)*hop + n_fft): the sum of n_fft/hop zero-padded piece grids,
    in piece order (``umx_tpu.ops.stft.overlap_add``)."""
    *lead, n_frames, n_fft = frames.shape
    if n_fft % hop:
        raise ValueError(f"overlap_add requires hop | n_fft, got {hop}, {n_fft}")
    ratio = n_fft // hop
    pieces = frames.reshape(*lead, n_frames, ratio, hop)
    total = None
    for p in range(ratio):
        # piece p of frame t lands at row t + p of a hop-wide grid
        x = torch.nn.functional.pad(pieces[..., p, :], (0, 0, p, ratio - 1 - p))
        total = x if total is None else total + x
    out = total.reshape(*lead, (n_frames + ratio - 1) * hop)
    return out[..., : (n_frames - 1) * hop + n_fft]


def window_sumsquare(window: torch.Tensor, n_frames: int, hop: int, out_len: int) -> torch.Tensor:
    """Sum of the squared, hop-shifted windows over ``n_frames`` frames,
    cut to ``out_len`` samples."""
    w2 = (window * window).expand(n_frames, window.shape[0])
    return overlap_add(w2, hop)[:out_len]


def istft_planes(re: torch.Tensor, im: torch.Tensor, n_samples: int, cfg: DSPConfig):
    """Inverse STFT from (re, im) planes (..., T, F) → (..., n_samples)."""
    if cfg.istft_algo == "ct2":
        from umx_tpu_torch.ops.istft_ct_cuda import istft_ct2

        win = hann_window(cfg.n_fft, re.device)
        sig = istft_ct2(re.float().contiguous(), im.float().contiguous(), cfg.n_fft, cfg.hop, win)
        wss = window_sumsquare(win, re.shape[-2], cfg.hop, sig.shape[-1])
        sig = sig / (wss + 1e-8)
        return sig[..., cfg.pad : cfg.pad + n_samples]
    lead = re.shape[:-2]
    T, F = re.shape[-2:]
    spec = hermitian_spectrum(re, im).reshape(-1, T, F).transpose(-1, -2)
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
    """(..., 2, T, F) magnitudes → (..., T, 2*crop) stacked-stereo network
    input (left bins, then right bins)."""
    cropped = mag[..., :nb_bins_cropped]
    return torch.cat([cropped[..., 0, :, :], cropped[..., 1, :, :]], dim=-1)


def masks_to_planes(masks: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Network-layout masks (..., T#, T, 2*n_bins) → channel planes
    (..., T#, 2, T, n_bins)."""
    m = masks.reshape(*masks.shape[:-1], 2, n_bins)
    return m.movedim(-2, -3)


def polar_to_complex(mag: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``mag * exp(i * angle(ref))`` without trig; |ref| = 0 gives the
    unit phasor 1 + 0i."""
    a = ref.abs()
    nz = a > 0
    unit = torch.where(nz, ref / torch.where(nz, a, torch.ones_like(a)), torch.ones_like(ref))
    return mag.to(a.dtype) * unit
