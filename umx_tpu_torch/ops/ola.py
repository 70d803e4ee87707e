"""The normalized overlap-add of stacked weighted chunk outputs: the plain
PyTorch version of ``umx_tpu/ops/ola_pallas.py::_ola_impl`` and the
geometry rule of its ``overlap_add_normalized``.

A whole-track program emits its weighted chunk outputs chunk-major,
``(n_chunks, ..., seg)``; the track wants them time-major, ``(...,
padded_len)``, with chunk k's head added to chunk k-1's tail (overlap at
most 50 %) and every sample multiplied by the reciprocal weight sum.  The
kernel of this function is K7 (``ops/ola_cuda.py``).
"""

from __future__ import annotations

import torch


def pick_t2(stride: int) -> int | None:
    """Largest divisor of ``stride`` in [128, 4096], as the JAX package
    picks the lane extent of its transpose; None when there is none."""
    best = None
    for d in range(1, int(stride**0.5) + 1):
        if stride % d == 0:
            for c in (d, stride // d):
                if 128 <= c <= 4096 and (best is None or c > best):
                    best = c
    return best


def ola_geometry_ok(seg: int, stride: int) -> bool:
    """The JAX function's rule for its head/tail form: overlap at most
    50 %, and the stride has the divisor its TPU transpose tiles by.  It
    returns None otherwise and its caller falls back to the slice-add
    form; the CPU route refuses the same geometries, so the two packages
    take the same arm and give the same bits.  The CUDA kernel needs only
    the overlap bound."""
    tail_len = seg - stride
    return 0 <= tail_len <= stride and pick_t2(stride) is not None


def overlap_add_chunks(ys: torch.Tensor, stride: int) -> torch.Tensor:
    """Chunks (n_chunks, *mid, seg) with 0 <= seg - stride <= stride →
    (*mid, n_chunks*stride + seg - stride): each chunk's head plus the
    previous chunk's tail (zero-padded to one stride), chunk-major to
    time-major, the last tail appended."""
    n_chunks, *mid, seg = ys.shape
    combined = ys[..., :stride]
    if seg > stride:
        tails = torch.nn.functional.pad(ys[:-1, ..., stride:], (0, 2 * stride - seg))
        combined = combined + torch.cat([torch.zeros_like(combined[:1]), tails])
    out = combined.movedim(0, -2).reshape(*mid, n_chunks * stride)
    return torch.cat([out, ys[-1, ..., stride:]], dim=-1)


def ola_normalized_plain(ys: torch.Tensor, inv_sw: torch.Tensor, stride: int) -> torch.Tensor:
    """ys (n_chunks, M, seg) weighted chunks, inv_sw (L,) with
    L = n_chunks*stride + seg - stride → (M, L): the combined heads and
    tails times ``inv_sw``."""
    return overlap_add_chunks(ys, stride) * inv_sw
