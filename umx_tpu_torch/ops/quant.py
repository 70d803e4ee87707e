"""Affine min/max quantization of the ggml weight format (host, numpy).

``scale = (max - min) / (iinfo(qtype).max - 1)``, ``offset = min``,
``q = round((x - offset) / scale)``; dequantization is
``x = q * scale + offset``.
"""

from __future__ import annotations

import numpy as np


def quantize(array: np.ndarray, qtype=np.uint8) -> tuple[np.ndarray, float, float]:
    """Per-tensor affine quantization to ``qtype`` (u8 or u16)."""
    array = np.asarray(array, dtype=np.float32)
    min_val = float(array.min())
    max_val = float(array.max())
    qmax = float(np.iinfo(qtype).max - 1)
    scale = (max_val - min_val) / qmax
    if scale == 0.0:
        # constant tensor: encode zeros, dequant reproduces the constant
        scale = 1.0
    offset = min_val
    q = np.round((array - offset) / scale).astype(qtype)
    return q, float(scale), offset


def dequantize(q: np.ndarray, scale: float, offset: float) -> np.ndarray:
    """``x = q * scale + offset`` in float32."""
    return q.astype(np.float32) * np.float32(scale) + np.float32(offset)
