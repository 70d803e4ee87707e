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

N_FFT = 4096  # UMX's transform: the kernel's hand-scheduled form
SHARED_N_FFT_MAX = 16384  # the largest n_fft whose frame and ring fit a block's shared memory
PIECES = 4  # hop = n_fft / 4: a frame reaches 4 output hops, a hop 4 frames
_MIN_HOPS = 8  # no run shorter than this, unless the row is
# the device-memory form's scratch slot a block: two buffers of n_fft/2
# complex values and the overlap-add ring, n_fft floats each
_BIG_SLOT_FLOATS = 3


def istft_radix_plan(n_fft: int) -> tuple[int, ...]:
    """The radices of the kernel's n_fft/2-point complex inverse, first
    pass first: 16 x 16 x 8 at 4096 (its hand-scheduled form); up to
    ``SHARED_N_FFT_MAX`` a pass of K = n_fft/1024 points (none at K = 1)
    and three radix-8 passes (the Stockham form in shared memory); above,
    in device memory (:func:`istft_form`), the odd part of K as one pass,
    its power-of-two part in radix 8 (then 4 or 2), then three radix 8."""
    if n_fft < 1024 or n_fft % 1024:
        raise ValueError(f"the iSTFT kernel takes n_fft = 1024 k, got {n_fft}")
    if n_fft == N_FFT:
        return (16, 16, 8)
    k = n_fft // 1024
    if n_fft <= SHARED_N_FFT_MAX:
        return ((k,) if k > 1 else ()) + (8, 8, 8)
    odd = k
    while odd % 2 == 0:
        odd //= 2
    plan, two = [odd] if odd > 1 else [], k // odd
    while two > 1:
        r = 8 if two >= 8 else two
        plan.append(r)
        two //= r
    return (*plan, 8, 8, 8)


def istft_form(n_fft: int) -> str:
    """Where the kernel keeps a frame at ``n_fft``: "shared" (shared
    memory, the hand-scheduled 4096 form and the mixed radix up to
    ``SHARED_N_FFT_MAX``) or "device" (a scratch slot a block in device
    memory, above it)."""
    istft_radix_plan(n_fft)
    return "shared" if n_fft <= SHARED_N_FFT_MAX else "device"


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
def istft_block_layout(index: int, n_fft: int) -> tuple[int, int]:
    """What the kernel at ``n_fft`` reports of itself on CUDA device
    ``index``, asked once: (the blocks the device holds at once, the
    dynamic shared memory a block asks for, in bytes)."""
    import ctypes

    blocks, smem = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(index):
        err = _build.library().umx_istft_ct2_capacity(n_fft, ctypes.addressof(blocks),
                                                      ctypes.addressof(smem))
    _build.check(err, "umx_istft_ct2_capacity")
    return blocks.value, smem.value


def istft_ct2(re: torch.Tensor, im: torch.Tensor, n_fft: int, hop: int,
              window: torch.Tensor | None = None) -> torch.Tensor:
    """Planes re/im (..., T, n_fft/2+1) f32 → raw overlap-added signal
    (..., (T-1)*hop + n_fft) with the window folded in (the caller divides
    by the window sum-of-squares).  Takes every n_fft with 1024 | n_fft and
    hop = n_fft/4, as the JAX function does, on either device.  One kernel
    launch transforms, windows and overlap-adds (no frames buffer; above
    ``SHARED_N_FFT_MAX`` a scratch slot of 3 n_fft floats for each block of
    the grid, :func:`istft_form`); the run plan that ran is left in
    ``istft_ct2.form`` as (runs per row, hops per run, radix plan).  Counts
    ``istft_ct2.launches`` once per launch."""
    if re.dim() < 2 or tuple(im.shape) != tuple(re.shape):
        raise ValueError(f"re and im must both be (..., T, F), got {tuple(re.shape)}, {tuple(im.shape)}")
    *lead, T, F = re.shape
    check_ct2_geometry(n_fft, hop, F)
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

    plan = istft_radix_plan(n_fft)
    rows = int(np.prod(lead)) if lead else 1
    dev = re.device
    capacity = istft_block_layout(dev.index, n_fft)[0]
    per_row, hops_per_run = istft_run_plan(rows, T, capacity)
    re_c = re.reshape(rows, T, F).contiguous()
    im_c = im.reshape(rows, T, F).contiguous()
    win = window.contiguous() if window is not None else None
    L = (T - 1) * hop + n_fft
    out = torch.empty((rows, L), dtype=torch.float32, device=dev)
    args = (re_c.data_ptr(), im_c.data_ptr(), _table(n_fft, dev).data_ptr(),
            win.data_ptr() if win is not None else None, out.data_ptr())
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _build.library()
    if istft_form(n_fft) == "shared":
        err = lib.umx_istft_ct2(*args, rows, T, F, n_fft, hop, per_row, hops_per_run, stream)
    else:
        grid = min(rows * per_row, capacity)
        scratch = torch.empty(grid * _BIG_SLOT_FLOATS * n_fft, dtype=torch.float32, device=dev)
        err = lib.umx_istft_ct2_big(*args, scratch.data_ptr(), rows, T, F, n_fft, hop, per_row,
                                    hops_per_run, grid, stream)
    _build.check(err, "umx_istft_ct2")
    istft_ct2.launches += 1
    istft_ct2.form = (per_row, hops_per_run, plan)
    return out.reshape(*lead, L)


istft_ct2.launches = 0
istft_ct2.form = None
