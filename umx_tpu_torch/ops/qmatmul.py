"""Quantized weights resident on the device, with the dequantization
fused into the matmul (``umx_tpu.ops.qmatmul``).

The fusion is algebraic and exact:

    W = scale * q + offset              (per-tensor affine of the ggml file)
    x @ W = scale * (x @ q) + offset * rowsum(x)

``q`` is stored as bfloat16 *integers*: every u8 value is exactly
representable in bfloat16, and a u16 payload is split into hi and lo byte
planes (q = 256 * hi + lo), each exact in bfloat16.  ``x`` is rounded to
bfloat16 and every product of a bf16 value with an integer below 2^16 is
exact in float32, so ``x @ q`` differs from the JAX package's
``einsum(bf16(x), plane, preferred_element_type=f32)`` only in the order
of the float32 sums.

How the product is computed here: ``torch.matmul`` of two bfloat16
tensors returns bfloat16, which would round the sums, so the operands go
in as float32 tensors holding the bf16-rounded ``x`` and the exact
integers (one transient float32 copy of the weight per call, 256 * hi +
lo combined for u16; TF32 must be off, as the separator sets it).  Only
the bfloat16 planes stay resident: 2 bytes per u8 weight and 4 per u16
weight.

``q_einsum_hh`` of the JAX module serves its scan recurrence with a
quantized ``hh``; ``quantized_params_from_ggml`` never produces one (it
densifies ``hh`` to bfloat16 for the recurrence kernels), so it is left
out here.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class QTensor:
    """Quantized weight: byte planes (bf16-encoded exact integers) with a
    per-tensor affine scale and offset.  ``planes`` is (q,) for u8 sources
    and (hi, lo) for u16; leading axes (targets, layers, ...) stack, and
    scale/offset have exactly those leading axes."""

    planes: tuple[torch.Tensor, ...]
    scale: torch.Tensor
    offset: torch.Tensor

    @property
    def shape(self):
        return self.planes[0].shape

    @property
    def nbytes(self) -> int:
        """Resident bytes: the planes plus scale and offset."""
        return sum(t.numel() * t.element_size() for t in (*self.planes, self.scale, self.offset))

    def __getitem__(self, idx) -> "QTensor":
        """Index the stacked leading axes (scale and offset share them)."""
        return QTensor(
            planes=tuple(p[idx] for p in self.planes),
            scale=self.scale[idx],
            offset=self.offset[idx],
        )

    def to(self, device) -> "QTensor":
        return QTensor(
            planes=tuple(p.to(device) for p in self.planes),
            scale=self.scale.to(device),
            offset=self.offset.to(device),
        )

    def integers(self) -> torch.Tensor:
        """The quantized values as exact float32 integers (transient)."""
        dense = self.planes[0].float()
        if len(self.planes) == 2:
            dense = 256.0 * dense + self.planes[1].float()
        return dense


def qtensor_from_raw(q: np.ndarray, scale: float, offset: float) -> QTensor:
    """A QTensor from a stored payload in its original dtype (u8 or u16)."""
    if q.dtype == np.uint8:
        planes = (torch.from_numpy(q.astype(np.float32)).to(torch.bfloat16),)
    elif q.dtype == np.uint16:
        hi = torch.from_numpy((q >> 8).astype(np.float32)).to(torch.bfloat16)
        lo = torch.from_numpy((q & 0xFF).astype(np.float32)).to(torch.bfloat16)
        planes = (hi, lo)
    else:
        raise ValueError(f"unsupported quantized dtype {q.dtype}")
    return QTensor(
        planes=planes,
        scale=torch.tensor(scale, dtype=torch.float32),
        offset=torch.tensor(offset, dtype=torch.float32),
    )


def stack_qtensors(qts: list[QTensor]) -> QTensor:
    """Stack QTensors (same plane count) along a new leading axis."""
    n_planes = len(qts[0].planes)
    return QTensor(
        planes=tuple(torch.stack([qt.planes[p] for qt in qts]) for p in range(n_planes)),
        scale=torch.stack([qt.scale for qt in qts]),
        offset=torch.stack([qt.offset for qt in qts]),
    )


def q_mm(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """x (..., K) @ QTensor (*stack, K, N) → (..., N) float32, the stack
    axes of the QTensor broadcasting against x's as in ``torch.matmul``
    (scale and offset follow them)."""
    x = x.float()
    acc = torch.matmul(x.to(torch.bfloat16).float(), qt.integers())
    rowsum = x.sum(dim=-1, keepdim=True)
    return qt.scale[..., None, None] * acc + qt.offset[..., None, None] * rowsum


def q_einsum_ih(xs: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """'dti,dig->tdg' against a (D, in, 4G) QTensor with per-direction
    scale and offset of shape (D,): the LSTM input projection."""
    return q_mm(xs, qt).transpose(0, 1)
