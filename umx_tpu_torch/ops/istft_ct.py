"""The plain PyTorch version of the fused Cooley-Tukey iSTFT
(``umx_tpu/ops/istft_ct.py::istft_ct2_fused``): the windowed inverse real
DFT of every frame, overlap-added to ``(T-1)*hop + n_fft`` samples.  The
caller divides by the window sum-of-squares.

``torch.fft.irfft`` computes the same one-sided fold as the JAX function
(v = c_k X / N with c_k = 1 at DC and Nyquist, else 2), once the imaginary
parts of those two bins, which drop out of the sum, are set to 0.  Its
kernel is K8 (``ops/istft_ct_cuda.py``).
"""

from __future__ import annotations

import torch

from umx_tpu_torch.ops.stft import hermitian_spectrum, overlap_add


def check_ct2_geometry(n_fft: int, hop: int, n_bins: int) -> None:
    """Raise unless the CT split applies: 1024 | n_fft, hop = n_fft/4,
    one-sided bins (the JAX function asserts the same)."""
    if n_fft < 1024 or n_fft % 1024:
        raise ValueError(f"ct2 requires 1024 | n_fft, got {n_fft}")
    if 4 * hop != n_fft:
        raise ValueError(f"ct2 requires hop == n_fft/4, got hop {hop} at n_fft {n_fft}")
    if n_bins != n_fft // 2 + 1:
        raise ValueError(f"ct2 needs {n_fft // 2 + 1} one-sided bins, got {n_bins}")


def istft_ct2_plain(re: torch.Tensor, im: torch.Tensor, n_fft: int, hop: int,
                    window: torch.Tensor | None = None) -> torch.Tensor:
    """Planes (..., T, n_fft/2+1) f32 → raw overlap-added signal
    (..., (T-1)*hop + n_fft), window folded in."""
    frames = torch.fft.irfft(hermitian_spectrum(re, im), n=n_fft, dim=-1)
    if window is not None:
        frames = frames * window
    return overlap_add(frames, hop)
