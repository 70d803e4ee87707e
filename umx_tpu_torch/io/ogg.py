"""OGG/Vorbis decode via the system libvorbisfile (ctypes, header-free).

The port's copy of ``umx_tpu.io.ogg`` (the port imports nothing of the JAX
package).

Role-equivalent of the reference's OGG support, which it gets for free
from libnyquist's vendored codecs (reference src/dsp.cpp:6-8 +
vendor/libnyquist).  We take the same "link the codec, don't rewrite it"
stance: the Xiph reference decoder is the format's ground truth, and a
from-scratch Vorbis decoder (unlike FLAC, which is lossless and
spec-checkable bit-for-bit) has no exactness target to validate against.

The binding is pure ctypes against the stable public vorbisfile ABI —
no headers required.  Only two struct layouts are touched:

* ``OggVorbis_File`` is treated as opaque: callers pass a buffer that
  only libvorbisfile reads/writes internally, so we over-allocate
  (the real struct is ~944 bytes on LP64; we hand it ``_VF_ALLOC`` =
  65536 bytes of slack).
* ``vorbis_info`` field offsets for ``channels`` (int, offset 4) and
  ``rate`` (long, offset 8) — fixed by the published ABI since 2000.

Decoding goes through ``ov_read_float`` so the samples arrive exactly as
the codec's float output, with no intermediate int16 quantization.

Quality note (docs/audio-formats.md): Vorbis is lossy, so SDR numbers
computed from OGG inputs are not comparable with published MUSDB18-HQ
(WAV) results.  Decode support exists for capability parity with the
reference CLI; evaluation tooling still wants lossless inputs.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

_VF_ALLOC = 65536  # >> sizeof(OggVorbis_File) ~944 on LP64


class _AlignedBuf:
    """Zeroed, 64-byte-aligned opaque storage (OggVorbis_File holds
    int64/double members; ctypes.create_string_buffer only guarantees
    byte alignment, which is UB to hand a C struct)."""

    def __init__(self, nbytes: int):
        self._arr = np.zeros(nbytes // 8 + 8, dtype=np.uint64)
        addr = self._arr.ctypes.data
        self.addr = (addr + 63) & ~63

    @property
    def _as_parameter_(self):
        return ctypes.c_void_p(self.addr)


class _VorbisInfoView(ctypes.Structure):
    # leading fields of vorbis_info (codec.h); layout fixed by the ABI
    _fields_ = [
        ("version", ctypes.c_int),
        ("channels", ctypes.c_int),
        ("rate", ctypes.c_long),
    ]


_lib = None
_lib_tried = False


def _load_lib():
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    for name in ("libvorbisfile.so.3", "libvorbisfile.so"):
        try:
            lib = ctypes.CDLL(name)
        except OSError:
            continue
        lib.ov_fopen.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
        lib.ov_fopen.restype = ctypes.c_int
        lib.ov_info.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.ov_info.restype = ctypes.POINTER(_VorbisInfoView)
        lib.ov_pcm_total.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.ov_pcm_total.restype = ctypes.c_int64
        lib.ov_read_float.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.POINTER(ctypes.POINTER(ctypes.c_float))),
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.ov_read_float.restype = ctypes.c_long
        lib.ov_clear.argtypes = [ctypes.c_void_p]
        lib.ov_clear.restype = ctypes.c_int
        _lib = lib
        break
    return _lib


def available() -> bool:
    """True when the system libvorbisfile is loadable."""
    return _load_lib() is not None


def decode_ogg(path: str) -> Optional[tuple[np.ndarray, int]]:
    """Decode an OGG/Vorbis file to ((n_samples, channels) float32, rate).

    Returns None when libvorbisfile is not present (the caller raises a
    library-specific UnsupportedAudio).  Raises ValueError on corrupt or
    non-Vorbis Ogg streams (e.g. Opus), mirroring the native WAV/FLAC
    parsers' failure behavior.
    """
    lib = _load_lib()
    if lib is None:
        return None
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    vf = _AlignedBuf(_VF_ALLOC)
    rc = lib.ov_fopen(path.encode(), vf)
    if rc != 0:
        raise ValueError(
            f"{path}: not a decodable Ogg Vorbis stream (ov_fopen rc={rc}; "
            "Ogg containers holding Opus/FLAC/Theora are not Vorbis)"
        )
    try:
        info = lib.ov_info(vf, -1)
        if not info:
            raise ValueError(f"{path}: ov_info failed")
        channels = info.contents.channels
        rate = int(info.contents.rate)
        if channels <= 0 or rate <= 0:
            raise ValueError(f"{path}: bad stream params ({channels} ch, {rate} Hz)")
        total = int(lib.ov_pcm_total(vf, -1))
        chunks: list[np.ndarray] = []
        pcm = ctypes.POINTER(ctypes.POINTER(ctypes.c_float))()
        bitstream = ctypes.c_int(0)
        while True:
            got = lib.ov_read_float(vf, ctypes.byref(pcm), 4096, ctypes.byref(bitstream))
            if got == 0:
                break
            if got < 0:
                # OV_HOLE (-3) = recoverable corruption: skip like the
                # reference decoder chain does; other codes are fatal
                if got == -3:
                    continue
                raise ValueError(f"{path}: vorbis decode error {got}")
            frame = np.empty((got, channels), dtype=np.float32)
            for c in range(channels):
                frame[:, c] = np.ctypeslib.as_array(pcm[c], shape=(got,))
            chunks.append(frame)
        if not chunks:
            data = np.zeros((0, channels), dtype=np.float32)
        else:
            data = np.concatenate(chunks, axis=0)
        # ov_pcm_total can disagree with the decoded length on truncated
        # files; trust the decoded stream but never exceed the declared
        # total (matches vorbisfile's own seeking convention)
        if 0 <= total < data.shape[0]:
            data = data[:total]
        return data, rate
    finally:
        lib.ov_clear(vf)
