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
PIECES = 4  # hop = n_fft / 4: a frame reaches 4 output hops, a hop 4 frames
_MIN_HOPS = 8  # no run shorter than this, unless the row is


@functools.lru_cache(maxsize=8)
def _table_np(n_fft: int) -> np.ndarray:
    # cos, sin of 2 pi i / n_fft in float64, rounded once to float32
    ph = 2.0 * np.pi * np.arange(n_fft, dtype=np.float64) / n_fft
    return np.stack([np.cos(ph), np.sin(ph)]).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _table(n_fft: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_table_np(n_fft)).to(device)


def istft_run_plan(rows: int, n_frames: int, capacity: int) -> tuple[int, int]:
    """How the kernel's blocks share the work → (runs per row, output hops
    per run).  A row's (T + 3) output hops of ``hop`` samples are cut into
    equal runs of consecutive hops, one block each, so that rows × runs is
    about ``capacity`` (the blocks the device holds at once): fewer where
    a run would be shorter than 8 hops, one run a row where there are more
    rows than blocks."""
    if rows < 1 or n_frames < 1 or capacity < 1:
        raise ValueError(f"rows {rows}, frames {n_frames} and capacity {capacity} must be positive")
    hops = n_frames + PIECES - 1
    per_row = max(1, min(capacity // rows, -(-hops // _MIN_HOPS)))
    hops_per_run = -(-hops // per_row)
    return -(-hops // hops_per_run), hops_per_run


def istft_runs(rows: int, n_frames: int, capacity: int) -> list[tuple[int, int, int, int, int]]:
    """The runs of :func:`istft_run_plan`, one per block in block order:
    (row, first hop, end hop, first frame, last frame).  A run stores the
    hops [first, end) and walks the frames [first frame, last frame] down
    from the last: the frames that reach its hops, of which up to 3 below
    its first hop belong to the run before it as well (the halo)."""
    per_row, hops_per_run = istft_run_plan(rows, n_frames, capacity)
    hops = n_frames + PIECES - 1
    runs = []
    for row in range(rows):
        for part in range(per_row):
            a = part * hops_per_run
            b = min(a + hops_per_run, hops)
            runs.append((row, a, b, max(a - (PIECES - 1), 0), min(b - 1, n_frames - 1)))
    return runs


@functools.lru_cache(maxsize=None)
def _capacity(index: int) -> int:
    """Blocks of the kernel that CUDA device ``index`` holds at once."""
    import ctypes

    blocks = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = _build.library().umx_istft_ct2_capacity(ctypes.addressof(blocks))
    _build.check(err, "umx_istft_ct2_capacity")
    return blocks.value


def istft_ct2(re: torch.Tensor, im: torch.Tensor, n_fft: int, hop: int,
              window: torch.Tensor | None = None) -> torch.Tensor:
    """Planes re/im (..., T, n_fft/2+1) f32 → raw overlap-added signal
    (..., (T-1)*hop + n_fft) with the window folded in (the caller divides
    by the window sum-of-squares).  Needs n_fft = 4096 and hop = n_fft/4,
    on either route.
    One kernel launch transforms, windows and overlap-adds (no frames
    buffer); the run plan that ran is left in ``istft_ct2.form`` as (runs
    per row, hops per run).  Counts ``istft_ct2.launches`` once per launch."""
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
    dev = re.device
    per_row, hops_per_run = istft_run_plan(rows, T, _capacity(dev.index))
    re_c = re.reshape(rows, T, F).contiguous()
    im_c = im.reshape(rows, T, F).contiguous()
    win = window.contiguous() if window is not None else None
    L = (T - 1) * hop + n_fft
    out = torch.empty((rows, L), dtype=torch.float32, device=dev)
    err = _build.library().umx_istft_ct2(
        re_c.data_ptr(), im_c.data_ptr(), _table(n_fft, dev).data_ptr(),
        win.data_ptr() if win is not None else None, out.data_ptr(),
        rows, T, F, n_fft, hop, per_row, hops_per_run,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "umx_istft_ct2")
    istft_ct2.launches += 1
    istft_ct2.form = (per_row, hops_per_run)
    return out.reshape(*lead, L)


istft_ct2.launches = 0
istft_ct2.form = None
