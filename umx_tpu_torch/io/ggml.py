"""Reader/writer for the umx.cpp ggml-style quantized weight file.

File layout (all little-endian)::

    i32 magic = 0x756d7867 ("umxg")
    i32 hidden_size
    repeated tensor records, 43 per target x 4 targets in order
    (bass, drums, other, vocals):
        f32 scale, f32 offset, i32 n_dims, i32 name_len
        i32 dims[n_dims]                 # REVERSED: dims[i] = shape[n_dims-1-i]
        u8  name[name_len]               # utf-8, no terminator
        u8|u16 payload[prod(shape)]      # u16 iff name contains bn2/bn3/fc2/fc3

Tensor names repeat for each target; a new target starts when a name
repeats.  The file may be gzipped.  Dequantization is
``x = q * scale + offset``.  Pure Python and numpy.
"""

from __future__ import annotations

import gzip
import io
import struct
from dataclasses import dataclass

import numpy as np

from umx_tpu_torch.config import TARGETS as TARGET_ORDER
from umx_tpu_torch.ops.quant import dequantize, quantize

GGML_MAGIC = 0x756D7867  # "umxg"
# largest plausible single dimension (fc3 output is 4098)
_MAX_DIM = 1 << 20
_U16_SUBSTRINGS = ("bn2", "bn3", "fc2", "fc3")

# Per-target record order of written files; bn3.running_var comes last
# because the reference loader advances its target counter on it.
TENSOR_ORDER = (
    ["input_mean", "input_scale", "output_scale", "output_mean", "fc1.weight"]
    + [f"bn1.{s}" for s in ("weight", "bias", "running_mean", "running_var")]
    + [
        f"lstm.{kind}_l{layer}{rev}"
        for layer in range(3)
        for rev in ("", "_reverse")
        for kind in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")
    ]
    + ["fc2.weight"]
    + [f"bn2.{s}" for s in ("weight", "bias", "running_mean", "running_var")]
    + ["fc3.weight"]
    + [f"bn3.{s}" for s in ("weight", "bias", "running_mean", "running_var")]
)


def qtype_for(name: str):
    return np.uint16 if any(s in name for s in _U16_SUBSTRINGS) else np.uint8


@dataclass
class GGMLModel:
    """Parsed ggml file: ``hidden_size`` plus 4 per-target dicts of
    dequantized float32 arrays in torch state-dict shapes."""

    hidden_size: int
    targets: dict[str, dict[str, np.ndarray]]


def read_ggml_bytes(data: bytes) -> GGMLModel:
    """Parse a ggml payload (optionally gzipped)."""
    if data[:2] == b"\x1f\x8b":
        data = gzip.decompress(data)
    total = len(data)
    f = io.BytesIO(data)

    head = f.read(8)
    if len(head) < 8:
        raise ValueError(
            f"bad ggml file: {total} bytes is too short for the magic + "
            f"hidden_size header"
        )
    magic, hidden_size = struct.unpack("<ii", head)
    if magic != GGML_MAGIC:
        raise ValueError(f"bad ggml magic {magic:#x}, expected {GGML_MAGIC:#x}")

    targets: list[dict[str, np.ndarray]] = [{}]
    while True:
        header = f.read(16)
        if len(header) < 16:
            break
        scale, offset, n_dims, name_len = struct.unpack("<ffii", header)
        if not 0 < n_dims <= 4 or not 0 < name_len <= 256:
            raise ValueError(
                f"bad ggml tensor header at byte {f.tell() - 16}: "
                f"n_dims={n_dims} name_len={name_len}"
            )
        dim_bytes = f.read(4 * n_dims)
        if len(dim_bytes) < 4 * n_dims:
            raise ValueError("truncated ggml tensor header (dims)")
        dims = struct.unpack(f"<{n_dims}i", dim_bytes)
        if any(not 0 < d <= _MAX_DIM for d in dims):
            raise ValueError(
                f"bad ggml tensor header at byte {f.tell() - 16 - 4 * n_dims}: "
                f"dims={dims}"
            )
        name_bytes = f.read(name_len)
        if len(name_bytes) != name_len:
            raise ValueError("truncated ggml tensor header (name)")
        name = name_bytes.decode("utf-8")
        shape = tuple(reversed(dims))
        qtype = qtype_for(name)
        n = int(np.prod(shape))
        raw = f.read(n * np.dtype(qtype).itemsize)
        if len(raw) != n * np.dtype(qtype).itemsize:
            raise ValueError(f"truncated payload for tensor {name!r}")
        payload = np.frombuffer(raw, dtype=qtype)
        if name in targets[-1]:
            targets.append({})
        targets[-1][name] = dequantize(payload, scale, offset).reshape(shape)

    if len(targets) != len(TARGET_ORDER):
        raise ValueError(f"expected {len(TARGET_ORDER)} targets, got {len(targets)}")
    return GGMLModel(
        hidden_size=hidden_size, targets=dict(zip(TARGET_ORDER, targets))
    )


def read_ggml(path: str) -> GGMLModel:
    """Load a ggml model file (.bin or .bin.gz)."""
    with open(path, "rb") as fh:
        return read_ggml_bytes(fh.read())


def write_ggml_bytes(hidden_size: int, targets: dict[str, dict[str, np.ndarray]]) -> bytes:
    """Serialize per-target float32 tensors (torch state-dict shapes) into
    the quantized ggml format."""
    f = io.BytesIO()
    f.write(struct.pack("<ii", GGML_MAGIC, hidden_size))
    for target in TARGET_ORDER:
        tensors = targets[target]
        missing = set(TENSOR_ORDER) - set(tensors)
        if missing:
            raise ValueError(f"target {target!r} missing tensors: {sorted(missing)}")
        for name in TENSOR_ORDER:
            data = np.ascontiguousarray(np.squeeze(tensors[name]), dtype=np.float32)
            q, scale, offset = quantize(data, qtype_for(name))
            encoded = name.encode("utf-8")
            f.write(struct.pack("<ffii", scale, offset, data.ndim, len(encoded)))
            f.write(struct.pack(f"<{data.ndim}i", *reversed(data.shape)))
            f.write(encoded)
            f.write(q.tobytes())
    return f.getvalue()


def write_ggml(path: str, hidden_size: int, targets: dict[str, dict[str, np.ndarray]]):
    """Write a ggml file; a ``.gz`` suffix gzips it."""
    data = write_ggml_bytes(hidden_size, targets)
    if path.endswith(".gz"):
        with gzip.open(path, "wb", compresslevel=6) as fh:
            fh.write(data)
    else:
        with open(path, "wb") as fh:
            fh.write(data)
