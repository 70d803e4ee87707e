"""Build and bind the port's CUDA kernels.

All ``csrc/*.cu`` sources compile with nvcc into one shared library with
a plain C interface, ``build/umx_tpu_torch/libumx_kernels-<hash>.so`` at
the repository root, at first use.  The file name carries a hash of the
sources and flags, so an edited source rebuilds.  The library is bound
with ``ctypes``: pointers and the CUDA stream go in as ``c_void_p``,
sizes as ``c_int``, and every entry point returns the ``cudaError_t`` of
its launches, which :func:`check` turns into an exception.

Nothing here runs at import time: this module is imported on machines
without nvcc or a GPU, where only the kernels' plain PyTorch versions run.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "umx_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # per-kernel registers/spills into the build log
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# entry point -> argtypes (see the extern "C" functions in csrc/)
_SIGNATURES = {
    # xp, whh, h0, c, hs, hT, T, R, B, G, stream
    "umx_lstm_merged": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # mode, a_re, a_im, masks, inv_ma, partials, racc, T, F, t_chunk, stream
    "umx_wiener_reduce": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    # mode, xre, xim, m_or_yre, yim, racc, inv_ma, yre_out, yim_out, T, F, eps, reg, stream
    "umx_wiener_apply": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _F, _P],
}


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")


def library_path() -> Path:
    """Path of the library for the current sources (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libumx_kernels-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels if the library for these sources is missing.
    The compiler's output (including ``-Xptxas -v``) is kept beside the
    library as ``<name>.log``."""
    out = library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = [str(s) for s in _sources() if s.suffix == ".cu"]
    # build to a temporary name, then rename: a concurrent or interrupted
    # build never leaves a half-written library under the final name
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp, *cu],
            capture_output=True, text=True,
        )
        Path(str(out) + ".log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed (rc {proc.returncode}):\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call in the process)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.umx_error_string.argtypes = [_I]
    lib.umx_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, what: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if err != 0:
        msg = library().umx_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
