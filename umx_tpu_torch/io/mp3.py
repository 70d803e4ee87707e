"""MP3 decode via the system libmpg123 (ctypes, header-free).

The port's copy of ``umx_tpu.io.mp3`` (the port imports nothing of the JAX
package).

Role-equivalent of the reference's MP3 support, which it gets for free
from libnyquist's vendored dr_mp3 (reference src/dsp.cpp:6-8 +
vendor/libnyquist).  Same stance as io/ogg.py: link the battle-tested
system codec rather than rewriting a lossy decoder that has no
bit-exactness target to validate against.

Binding notes (all against the stable public mpg123 ABI):

* the handle from ``mpg123_new`` is fully opaque — only the library
  touches it, so no struct layout is assumed at all;
* output is forced to ``MPG123_ENC_FLOAT_32`` via ``mpg123_format``,
  so samples arrive as the decoder's native float output with no
  int16 quantization step;
* ``mpg123_scan`` runs before decoding so ``mpg123_length`` reports the
  exact gapless sample count (mpg123 honours LAME/Xing encoder-delay
  tags by default, trimming the codec's leading/trailing padding).

Quality note (docs/audio-formats.md): MP3 is lossy, so SDR numbers from
MP3 inputs are not comparable with published MUSDB18-HQ (WAV) results.
Decode support exists for capability parity with the reference CLI.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

_ENC_FLOAT_32 = 0x200  # MPG123_ENC_FLOAT_32 (mpg123.h, fixed by the ABI)
_ADD_FLAGS = 2  # enum mpg123_parms: MPG123_ADD_FLAGS
_FORCE_FLOAT = 0x400  # MPG123_FORCE_FLOAT
_OK = 0
_NEW_FORMAT = -11  # MPG123_NEW_FORMAT
_DONE = -12  # MPG123_DONE

_lib = None
_lib_tried = False


def _load_lib():
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    for name in ("libmpg123.so.0", "libmpg123.so"):
        try:
            lib = ctypes.CDLL(name)
        except OSError:
            continue
        # mpg123_init is a deprecated no-op since 1.27 but required
        # before; calling it unconditionally is always safe
        lib.mpg123_init.argtypes = []
        lib.mpg123_init.restype = ctypes.c_int
        lib.mpg123_new.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int)]
        lib.mpg123_new.restype = ctypes.c_void_p
        lib.mpg123_param.argtypes = [
            ctypes.c_void_p,
            ctypes.c_int,
            ctypes.c_long,
            ctypes.c_double,
        ]
        lib.mpg123_param.restype = ctypes.c_int
        lib.mpg123_open.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.mpg123_open.restype = ctypes.c_int
        lib.mpg123_getformat.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.mpg123_getformat.restype = ctypes.c_int
        lib.mpg123_scan.argtypes = [ctypes.c_void_p]
        lib.mpg123_scan.restype = ctypes.c_int
        lib.mpg123_length.argtypes = [ctypes.c_void_p]
        lib.mpg123_length.restype = ctypes.c_int64  # off_t is 64-bit on LP64
        lib.mpg123_read.argtypes = [
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_size_t),
        ]
        lib.mpg123_read.restype = ctypes.c_int
        lib.mpg123_close.argtypes = [ctypes.c_void_p]
        lib.mpg123_close.restype = ctypes.c_int
        lib.mpg123_delete.argtypes = [ctypes.c_void_p]
        lib.mpg123_delete.restype = None
        lib.mpg123_init()
        _lib = lib
        break
    return _lib


def available() -> bool:
    """True when the system libmpg123 is loadable."""
    return _load_lib() is not None


def looks_like_mp3(magic: bytes) -> bool:
    """Cheap container sniff: ID3v2 tag or an MPEG audio frame sync.

    MP3 has no fixed magic; the standard dispatch is the ``ID3`` tag
    prefix or the 11-bit frame sync (0xFFE) at byte 0.  Called AFTER the
    fixed-magic formats (RIFF/fLaC/OggS), so false positives only steal
    files that would otherwise fail the WAV parser anyway.
    """
    if len(magic) >= 3 and magic[:3] == b"ID3":
        return True
    return len(magic) >= 2 and magic[0] == 0xFF and (magic[1] & 0xE0) == 0xE0


def decode_mp3(path: str) -> Optional[tuple[np.ndarray, int]]:
    """Decode an MP3 file to ((n_samples, channels) float32, rate).

    Returns None when libmpg123 is not present (the caller raises a
    library-specific UnsupportedAudio).  Raises ValueError on corrupt
    streams, mirroring the native WAV/FLAC parsers' failure behavior.
    """
    lib = _load_lib()
    if lib is None:
        return None
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    err = ctypes.c_int(0)
    h = lib.mpg123_new(None, ctypes.byref(err))
    if not h:
        raise ValueError(f"{path}: mpg123_new failed (err={err.value})")
    try:
        # force float32 output BEFORE open — format requests after open
        # only apply at the next stream's negotiation (verified: a
        # post-open mpg123_format returns OK but the stream stays int16)
        lib.mpg123_param(h, _ADD_FLAGS, _FORCE_FLOAT, 0.0)
        if lib.mpg123_open(h, path.encode()) != _OK:
            raise ValueError(f"{path}: not a decodable MPEG audio stream")
        rate_l = ctypes.c_long(0)
        channels = ctypes.c_int(0)
        encoding = ctypes.c_int(0)
        if lib.mpg123_getformat(h, ctypes.byref(rate_l), ctypes.byref(channels),
                                ctypes.byref(encoding)) != _OK:
            raise ValueError(f"{path}: mpg123_getformat failed")
        rate = int(rate_l.value)
        n_ch = int(channels.value)
        if rate <= 0 or n_ch not in (1, 2):
            raise ValueError(f"{path}: bad stream params ({n_ch} ch, {rate} Hz)")
        if int(encoding.value) != _ENC_FLOAT_32:
            raise ValueError(
                f"{path}: float32 output unavailable (enc={encoding.value:#x})"
            )
        lib.mpg123_scan(h)  # exact (gapless) length for VBR streams
        total = int(lib.mpg123_length(h))

        chunk_frames = 65536
        # the DECODER writes into this buffer; keep it bound to a local
        # for its whole lifetime (a bare .ctypes.data of a temporary is
        # freed before the callee reads it — repo ctypes rule)
        buf = np.empty(chunk_frames * n_ch, dtype=np.float32)
        done = ctypes.c_size_t(0)
        chunks: list[np.ndarray] = []
        while True:
            rc = lib.mpg123_read(h, buf.ctypes.data, buf.nbytes, ctypes.byref(done))
            got = done.value // (4 * n_ch)
            if got:
                chunks.append(buf[: got * n_ch].reshape(got, n_ch).copy())
            if rc == _DONE:
                break
            if rc == _NEW_FORMAT:
                # mid-stream format change: re-read params; rate changes
                # are beyond the gapless contract — reject them
                if lib.mpg123_getformat(h, ctypes.byref(rate_l), ctypes.byref(channels),
                                        ctypes.byref(encoding)) != _OK or (
                    int(rate_l.value) != rate
                    or int(channels.value) != n_ch
                    or int(encoding.value) != _ENC_FLOAT_32
                ):
                    raise ValueError(f"{path}: mid-stream format change unsupported")
                continue
            if rc != _OK:
                raise ValueError(f"{path}: mpg123 decode error {rc}")
        if not chunks:
            data = np.zeros((0, n_ch), dtype=np.float32)
        else:
            data = np.concatenate(chunks, axis=0)
        # mpg123_length can disagree on truncated files; trust the
        # decoded stream but never exceed the declared gapless total
        if 0 <= total < data.shape[0]:
            data = data[:total]
        return data, rate
    finally:
        lib.mpg123_close(h)
        lib.mpg123_delete(h)
