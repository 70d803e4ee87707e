"""K7, the normalized overlap-add kernel (``csrc/ola.cu``), and the
whole-track entry point over it.

:func:`ola_normalized` has the contract of ``_ola_impl`` in
``umx_tpu/ops/ola_pallas.py`` (the TPU kernel ``_transpose_kernel``):
CPU tensors run :func:`umx_tpu_torch.ops.ola.ola_normalized_plain`, CUDA
tensors launch the kernel or raise.  The kernel sums the same two addends
as the plain version, in the same order, so the two are bit-equal.

The launch is planned here, in pure functions that the CPU tests reach:
:func:`ola_vector_width` (16-byte vectors or scalars) and
:func:`ola_blocks` (one block an SM).
"""

from __future__ import annotations

import functools
import math

import torch

from umx_tpu_torch import _build
from umx_tpu_torch.ops.ola import ola_geometry_ok, ola_normalized_plain

THREADS = 256  # threads a block: 8 warps (csrc/ola.cu)
WARPS = THREADS // 32
_MAX_LEN = 2**31 - 4 * 32 * 2  # a lane's sample index steps past L by up to 32 vectors


def ola_vector_width(seg: int, stride: int, *pointers: int) -> int:
    """Samples a lane moves at a time: 4 (16-byte vectors) where seg and
    stride are multiples of 4 and every pointer is 16-byte aligned, so that
    every run of the kernel starts and ends on a vector; else 1."""
    aligned = all(p % 16 == 0 for p in pointers)
    return 4 if seg % 4 == 0 and stride % 4 == 0 and aligned else 1


def ola_blocks(L: int, V: int, grid: int) -> int:
    """Blocks of one launch: ``grid`` (one an SM), fewer where the track
    has less than a vector a thread."""
    return max(1, min(grid, -(-L // (THREADS * V))))


@functools.lru_cache(maxsize=None)
def _grid(index: int) -> int:
    """Blocks of one launch on CUDA device ``index`` (one an SM)."""
    import ctypes

    blocks = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = _build.library().umx_ola_grid(ctypes.addressof(blocks))
    _build.check(err, "umx_ola_grid")
    return blocks.value


def ola_normalized(ys: torch.Tensor, inv_sw: torch.Tensor, stride: int) -> torch.Tensor:
    """ys (n_chunks, M, seg) f32 contiguous, inv_sw (L,) f32 with
    L = n_chunks*stride + seg - stride and 0 <= seg - stride <= stride →
    (M, L).  Counts ``ola_normalized.launches`` once per kernel run."""
    if ys.dim() != 3:
        raise ValueError(f"ys must be (n_chunks, M, seg), got {tuple(ys.shape)}")
    n_chunks, M, seg = ys.shape
    tail_len = seg - stride
    if stride < 1 or not 0 <= tail_len <= stride:
        raise ValueError("the overlap-add kernel needs overlap of at most 50 %, "
                         f"0 <= seg - stride <= stride (seg {seg}, stride {stride})")
    L = n_chunks * stride + tail_len
    if tuple(inv_sw.shape) != (L,):
        raise ValueError(f"inv_sw must be ({L},), got {tuple(inv_sw.shape)}")
    for name, t in (("ys", ys), ("inv_sw", inv_sw)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != ys.device:
            raise ValueError(f"{name} is on {t.device}, expected {ys.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if ys.device.type == "cpu":
        return ola_normalized_plain(ys, inv_sw, stride)
    if ys.device.type != "cuda":
        raise ValueError(f"no kernel for device {ys.device}")
    if L > _MAX_LEN:
        raise ValueError(f"the overlap-add kernel takes L <= {_MAX_LEN} samples; got L = {L}")
    out = torch.empty((M, L), dtype=torch.float32, device=ys.device)
    V = ola_vector_width(seg, stride, ys.data_ptr(), inv_sw.data_ptr(), out.data_ptr())
    blocks = ola_blocks(L, V, _grid(ys.device.index))
    err = _build.library().umx_ola_normalized(
        ys.data_ptr(), inv_sw.data_ptr(), out.data_ptr(), n_chunks, M, seg, stride, L,
        blocks, int(V == 4), torch.cuda.current_stream(ys.device).cuda_stream,
    )
    _build.check(err, "umx_ola_normalized")
    ola_normalized.launches += 1
    ola_normalized.form = (blocks, V)
    return out


ola_normalized.launches = 0
ola_normalized.form = None  # (blocks, samples a lane moves at a time) of the last launch


def overlap_add_normalized(ys: torch.Tensor, inv_sw: torch.Tensor, stride: int,
                           padded_len: int) -> torch.Tensor | None:
    """Normalized overlap-add of weighted chunks ``ys (n_chunks, *mid,
    seg)`` → ``(*mid, padded_len)``, the port of the JAX
    ``overlap_add_normalized``: every leading axis of ``mid`` (batch
    rows, targets, channels) folds into the kernel's rows M.

    On the CPU it returns None where the JAX function does (overlap above
    50 %, or a stride without the divisor its TPU transpose tiles by), and
    the caller falls back to the slice-adds as the JAX package does, so
    both packages take the same arm.  On CUDA the kernel takes every
    stride and never returns None: overlap above 50 % raises."""
    n_chunks, *mid, seg = ys.shape
    if ys.device.type == "cpu" and not ola_geometry_ok(seg, stride):
        return None
    M = math.prod(mid)
    out = ola_normalized(ys.reshape(n_chunks, M, seg).contiguous(), inv_sw.contiguous(), stride)
    return out[..., :padded_len].reshape(*mid, padded_len)
