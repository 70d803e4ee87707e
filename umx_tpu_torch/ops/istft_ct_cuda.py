"""K8, the fused Cooley-Tukey iSTFT kernel (``csrc/istft_ct.cu``).

:func:`istft_ct2` has the contract of ``istft_ct2_fused`` in
``umx_tpu/ops/istft_ct.py`` (the TPU kernel of that function): CPU
tensors run :func:`umx_tpu_torch.ops.istft_ct.istft_ct2_plain`, CUDA
tensors launch the kernel or raise.  No cuFFT, cuBLAS or ``torch.fft``
runs inside the kernel: those belong to the plain version only.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from umx_tpu_torch import _build
from umx_tpu_torch.ops.istft_ct import check_ct2_geometry, istft_ct2_plain

N_FFT = 4096  # the one transform size the kernel is built for
_MAX_ROWS = 65535  # the overlap-add grid's y extent
_MAX_GRID = 4096  # frame blocks; each walks the frames grid-stride


@functools.lru_cache(maxsize=8)
def _table_np(n_fft: int) -> np.ndarray:
    # cos, sin of 2 pi i / n_fft in float64, rounded once to float32
    ph = 2.0 * np.pi * np.arange(n_fft, dtype=np.float64) / n_fft
    return np.stack([np.cos(ph), np.sin(ph)]).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _table(n_fft: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_table_np(n_fft)).to(device)


def istft_ct2(re: torch.Tensor, im: torch.Tensor, n_fft: int, hop: int,
              window: torch.Tensor | None = None) -> torch.Tensor:
    """Planes re/im (..., T, n_fft/2+1) f32 → raw overlap-added signal
    (..., (T-1)*hop + n_fft) with the window folded in (the caller divides
    by the window sum-of-squares).  Needs n_fft = 4096 and hop = n_fft/4,
    on either route.
    Counts ``istft_ct2.launches`` once per kernel run (a frames launch and
    an overlap-add launch)."""
    if re.dim() < 2 or tuple(im.shape) != tuple(re.shape):
        raise ValueError(f"re and im must both be (..., T, F), got {tuple(re.shape)}, {tuple(im.shape)}")
    *lead, T, F = re.shape
    check_ct2_geometry(n_fft, hop, F)
    if n_fft != N_FFT:
        raise ValueError(f"the iSTFT kernel is built for n_fft = {N_FFT} (UMX's transform), "
                         f"got {n_fft}")
    if T < 1:
        raise ValueError("no frames")
    tensors = [("re", re), ("im", im)] + ([("window", window)] if window is not None else [])
    for name, t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != re.device:
            raise ValueError(f"{name} is on {t.device}, expected {re.device}")
    if window is not None and tuple(window.shape) != (n_fft,):
        raise ValueError(f"window must be ({n_fft},), got {tuple(window.shape)}")
    if re.device.type == "cpu":
        return istft_ct2_plain(re, im, n_fft, hop, window)
    if re.device.type != "cuda":
        raise ValueError(f"no kernel for device {re.device}")

    rows = int(np.prod(lead)) if lead else 1
    if rows > _MAX_ROWS:
        raise ValueError(f"the iSTFT kernel takes at most {_MAX_ROWS} rows, got {rows}")
    dev = re.device
    re_c = re.reshape(rows, T, F).contiguous()
    im_c = im.reshape(rows, T, F).contiguous()
    win = window.contiguous() if window is not None else None
    L = (T - 1) * hop + n_fft
    frames = torch.empty((rows, T, n_fft), dtype=torch.float32, device=dev)
    out = torch.empty((rows, L), dtype=torch.float32, device=dev)
    err = _build.library().umx_istft_ct2(
        re_c.data_ptr(), im_c.data_ptr(), _table(n_fft, dev).data_ptr(),
        win.data_ptr() if win is not None else None, frames.data_ptr(), out.data_ptr(),
        rows, T, F, n_fft, hop, min(rows * T, _MAX_GRID),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "umx_istft_ct2")
    istft_ct2.launches += 1
    return out.reshape(*lead, L)


istft_ct2.launches = 0
