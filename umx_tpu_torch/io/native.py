"""ctypes bindings to the native C++ IO library (``native/umxio.cpp`` and
``native/flac.cpp``): WAV and FLAC decode, WAV encode, and the ggml
reader (gzip inflation, record parsing, dequantization).

The port builds its own copy of the library from those sources, with the
flags of ``native/Makefile``, into its build directory
(``build/umx_tpu_torch/libumxio-<source hash>.so``) at first use.  The
build runs under an ``fcntl`` lock on a file beside it and writes through
a temporary file that is renamed into place, so processes that start
together (test workers, servers) build it once and never load a partial
file.  Every entry point returns ``None`` (``write_wav_native``: False)
when the library cannot be built or loaded; :func:`build_error` says why.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import tempfile
import threading
from functools import lru_cache
from pathlib import Path

import numpy as np

from umx_tpu_torch._build import BUILD_DIR

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_SOURCES = ("umxio.cpp", "flac.cpp")
_HEADERS = ("umxio_internal.hpp",)
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")
LD_FLAGS = ("-lz",)
_LOCK = threading.Lock()


def library_path() -> Path:
    """Path of the library for the current sources and flags (built or not)."""
    h = hashlib.sha256(" ".join(CXX_FLAGS + LD_FLAGS).encode())
    for name in _SOURCES + _HEADERS:
        h.update(name.encode())
        h.update((NATIVE_DIR / name).read_bytes())
    return BUILD_DIR / f"libumxio-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library if the one for these sources is missing; raises
    (``OSError`` or ``RuntimeError``) when it cannot."""
    out = library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "libumxio.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if out.is_file():  # another process built it while this one waited
            return out
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run(
                [os.environ.get("CXX", "g++"), *CXX_FLAGS,
                 *(str(NATIVE_DIR / s) for s in _SOURCES), "-o", tmp, *LD_FLAGS],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError(f"building libumxio failed:\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return out


def build_error() -> str | None:
    """Why the library could not be built or loaded, or None."""
    with _LOCK:
        return _load_once()[1]


def _load_lib():
    with _LOCK:
        return _load_once()[0]


@lru_cache(maxsize=1)
def _load_once():
    """(the loaded library, None), or (None, why not)."""
    try:
        lib = ctypes.CDLL(str(build()))
    except (OSError, RuntimeError) as e:
        return None, str(e)
    _declare(lib)
    return lib, None


def _declare(lib):
    lib.umxio_read_ggml.restype = ctypes.c_void_p
    lib.umxio_read_ggml.argtypes = [ctypes.c_char_p]
    lib.umxio_model_hidden_size.restype = ctypes.c_int
    lib.umxio_model_hidden_size.argtypes = [ctypes.c_void_p]
    lib.umxio_model_num_tensors.restype = ctypes.c_int
    lib.umxio_model_num_tensors.argtypes = [ctypes.c_void_p]
    lib.umxio_tensor_name.restype = ctypes.c_char_p
    lib.umxio_tensor_name.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.umxio_tensor_target.restype = ctypes.c_int
    lib.umxio_tensor_target.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.umxio_tensor_ndims.restype = ctypes.c_int
    lib.umxio_tensor_ndims.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.umxio_tensor_dims.restype = ctypes.POINTER(ctypes.c_int64)
    lib.umxio_tensor_dims.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.umxio_tensor_data.restype = ctypes.POINTER(ctypes.c_float)
    lib.umxio_tensor_data.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.umxio_model_free.argtypes = [ctypes.c_void_p]

    lib.umxio_read_wav.restype = ctypes.c_void_p
    lib.umxio_read_wav.argtypes = [ctypes.c_char_p]
    lib.umxio_read_flac.restype = ctypes.c_void_p
    lib.umxio_read_flac.argtypes = [ctypes.c_char_p]
    lib.umxio_wav_num_frames.restype = ctypes.c_int64
    lib.umxio_wav_num_frames.argtypes = [ctypes.c_void_p]
    lib.umxio_wav_num_channels.restype = ctypes.c_int
    lib.umxio_wav_num_channels.argtypes = [ctypes.c_void_p]
    lib.umxio_wav_sample_rate.restype = ctypes.c_int
    lib.umxio_wav_sample_rate.argtypes = [ctypes.c_void_p]
    lib.umxio_wav_data.restype = ctypes.POINTER(ctypes.c_float)
    lib.umxio_wav_data.argtypes = [ctypes.c_void_p]
    lib.umxio_wav_free.argtypes = [ctypes.c_void_p]
    lib.umxio_write_wav.restype = ctypes.c_int
    lib.umxio_write_wav.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
        ctypes.c_int,
        ctypes.c_int,
    ]


def available() -> bool:
    return _load_lib() is not None


def read_ggml_native(path: str):
    """Parse a ggml model file with the native library into the port's
    :class:`umx_tpu_torch.io.ggml.GGMLModel` (dequantized only), or None
    when the library is missing.  Raises on a malformed file."""
    lib = _load_lib()
    if lib is None:
        return None
    from umx_tpu_torch.io.ggml import TARGET_ORDER, TENSOR_ORDER, GGMLModel

    handle = lib.umxio_read_ggml(path.encode())
    if not handle:
        raise IOError(f"native ggml parse failed for {path}")
    try:
        hidden = lib.umxio_model_hidden_size(handle)
        n = lib.umxio_model_num_tensors(handle)
        targets: list[dict[str, np.ndarray]] = [{} for _ in TARGET_ORDER]
        for i in range(n):
            name = lib.umxio_tensor_name(handle, i).decode()
            tgt = lib.umxio_tensor_target(handle, i)
            if not 0 <= tgt < len(TARGET_ORDER):
                # a malformed file whose names repeat more than 3 times
                raise ValueError(f"expected {len(TARGET_ORDER)} targets, got {tgt + 1}")
            ndims = lib.umxio_tensor_ndims(handle, i)
            dims = lib.umxio_tensor_dims(handle, i)
            shape = tuple(dims[j] for j in range(ndims))
            count = int(np.prod(shape)) if shape else 1
            data_ptr = lib.umxio_tensor_data(handle, i)
            targets[tgt][name] = np.ctypeslib.as_array(data_ptr, shape=(count,)).reshape(shape).copy()
        # a short file gives an incomplete model: fail as the Python parser does
        for t, d in zip(TARGET_ORDER, targets):
            missing = set(TENSOR_ORDER) - set(d)
            if missing:
                raise ValueError(f"target {t!r} missing tensors: {sorted(missing)}")
        return GGMLModel(hidden_size=hidden, targets=dict(zip(TARGET_ORDER, targets)))
    finally:
        lib.umxio_model_free(handle)


def _decoded(lib, handle) -> tuple[np.ndarray, int]:
    try:
        frames = lib.umxio_wav_num_frames(handle)
        ch = lib.umxio_wav_num_channels(handle)
        rate = lib.umxio_wav_sample_rate(handle)
        ptr = lib.umxio_wav_data(handle)
        return np.ctypeslib.as_array(ptr, shape=(frames * ch,)).reshape(frames, ch).copy(), rate
    finally:
        lib.umxio_wav_free(handle)


def read_wav_native(path: str):
    """Decode a WAV → (data (frames, ch) float32, rate), or None when the
    library is missing or cannot decode this file's format (e.g. 8-bit
    PCM, which scipy reads)."""
    lib = _load_lib()
    if lib is None:
        return None
    handle = lib.umxio_read_wav(path.encode())
    if not handle:
        return None
    return _decoded(lib, handle)


def read_flac_native(path: str):
    """Decode a FLAC file (``native/flac.cpp``) → (data (frames, ch)
    float32, rate), or None when the library is missing; raises on a
    malformed stream."""
    lib = _load_lib()
    if lib is None:
        return None
    handle = lib.umxio_read_flac(path.encode())
    if not handle:
        raise IOError(f"FLAC decode failed for {path}")
    return _decoded(lib, handle)


def write_wav_native(path: str, interleaved: np.ndarray, rate: int) -> bool:
    """Encode interleaved (frames, ch) samples as a float32 PCM WAV; False
    when the library is missing."""
    lib = _load_lib()
    if lib is None:
        return False
    data = np.ascontiguousarray(interleaved, dtype=np.float32)
    frames, ch = data.shape
    ok = lib.umxio_write_wav(
        path.encode(), data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), frames, ch, rate
    )
    if ok != 0:
        raise IOError(f"native wav encode failed for {path}")
    return True
