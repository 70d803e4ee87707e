"""Build and bind the port's CUDA kernels.

Each ``csrc/*.cu`` source compiles with its own nvcc process, all started
together, and the objects link into one shared library with a plain C
interface, ``build/umx_tpu_torch/libumx_kernels-<hash>.so`` at the
repository root, at first use.  The file name carries a hash of the
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
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "umx_tpu_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # per-kernel registers/spills into the build log
)

_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
# entry point -> argtypes (see the extern "C" functions in csrc/)
_SIGNATURES = {
    # xp, whh, h0, c, hs, hT, gates, cs, hx, T, R, B, G, warps, r0, nr, b0, nb, tag0, stream
    "umx_lstm_merged": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                        _U, _P],
    # G, resid, warps, rows, blocks (out), smem (out)
    "umx_lstm_merged_layout": [_I, _I, _I, _I, _P, _P],
    # sms, smem_per_block, regs_per_sm (out)
    "umx_device_limits": [_P, _P, _P],
    # G, blocks (out)
    "umx_lstm_bwd_capacity": [_I, _P],
    # gates, cs, c0, whh, dhs, dhT, dc, dxp, dh0, dgx, flags, T, R, B, G, r0, nr, b0, nb, tag0,
    # stream
    "umx_lstm_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                     _U, _P],
    # G, R, held (out, 17 ints)
    "umx_lstm_pertarget_clusters": [_I, _I, _P],
    # xp, whh, h0, c0, hs, hT, cT, T, n_targets, D, G, CL, U, stream
    "umx_lstm_pertarget": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # form (0 streaming, 1 resident, 2 wide), G, whh_bf16, resid, rows, blocks, smem, w_regs (out)
    "umx_lstm_scan_capacity": [_I, _I, _I, _I, _P, _P, _P, _P],
    # form, xp, whh, whh_bf16, h0, c, hs, hT, hx, T, R, B, G, r0, nr, b0, nb, rt, tag0,
    # stream
    "umx_lstm_scan": [_I, _P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                      _U, _P],
    # form, xp, whh, whh_bf16, h0, c, hs, hT, gates, cs, hx, T, R, B, G, r0, nr, b0, nb, rt,
    # tag0, stream
    "umx_lstm_scan_train": [_I, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                            _I, _I, _I, _U, _P],
    # form, G, whh_bf16, rows, blocks, smem, w_regs (out)
    "umx_lstm_scan_bwd_capacity": [_I, _I, _I, _P, _P, _P, _P],
    # form, gates, cs, c0, whh, whh_bf16, dhs, dhT, dc, dxp, dh0, hx, T, R, B, G, r0, nr,
    # b0, nb, rt, tag0, stream
    "umx_lstm_scan_bwd": [_I, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                          _I, _I, _I, _U, _P],
    # hs, h0, dxp, dw, T, R, B, G, stream
    "umx_lstm_dw": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    # bn, clusters (out), smem (out)
    "umx_lstm_dw_capacity": [_I, _P, _P],
    # hs, h0, dxp, dw, parts, padded, T, R, B, G, Gp, bn, bp, tb, nbc, stages, slices,
    # per_slice, stream
    "umx_lstm_dw_wgmma": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                          _P],
    # mode, mask_bf16, a_re, a_im, masks, inv_ma, racc, T, F, stream
    "umx_wiener_reduce": [_I, _I, _P, _P, _P, _P, _P, _I, _I, _P],
    # mode, mask_bf16, out_bf16, xre, xim, m_or_yre, yim, racc, inv_ma, yre_out, yim_out, T, F,
    # eps, reg, stream
    "umx_wiener_apply": [_I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _F, _P],
    # blocks (out)
    "umx_ola_grid": [_P],
    # ys, inv_sw, out, n_chunks, M, seg, stride, L, blocks, vec, stream
    "umx_ola_normalized": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # n_fft, blocks (out), smem (out)
    "umx_istft_ct2_capacity": [_I, _P, _P],
    # re, im, table, window, out, rows, T, F, N, hop, runs_per_row, hops_per_run, stream
    "umx_istft_ct2": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # re, im, table, window, out, scratch, rows, T, F, N, hop, runs_per_row, hops_per_run,
    # grid, stream
    "umx_istft_ct2_big": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # n_fft, blocks (out), smem (out)
    "umx_istft_ct2_reg_capacity": [_I, _P, _P],
    # re, im, table, tw1, window, out, rows, T, F, N, hop, runs_per_row, hops_per_run, stream
    "umx_istft_ct2_reg": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # n_fft, cluster, clusters (out), smem (out)
    "umx_istft_ct2_cluster_capacity": [_I, _I, _P, _P],
    # re, im, table, ptw, window, out, rows, T, F, N, hop, cluster, runs_per_row, hops_per_run,
    # stream
    "umx_istft_ct2_cluster": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # G, resid, rows, blocks, smem, w_regs (out)
    "umx_lstm_merged_streaming_capacity": [_I, _I, _P, _P, _P, _P],
    # xp, whh, h0, c, hs, hT, gates, cs, hx, T, R, B, G, r0, nr, b0, nb, rt, tag0, stream
    "umx_lstm_merged_streaming": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                  _I, _I, _U, _P],
    # mtw, units, rows, blocks (out), smem (out)
    "umx_lstm_bwd_block_layout": [_I, _I, _I, _P, _P],
    # gates, cs, c0, whh, dhs, dhT, dc, dxp, dh0, px, flags, T, R, B, G, mtw, units, r0, nr, b0,
    # nb, tag0, stream
    "umx_lstm_bwd_block": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                           _I, _I, _I, _U, _P],
    # G, rows, blocks, smem, w_regs (out)
    "umx_lstm_bwd_wide_capacity": [_I, _P, _P, _P, _P],
    # gates, cs, c0, wt, dhs, dhT, dc, dxp, dh0, hx, T, R, B, G, r0, nr, b0, nb, rt, tag0,
    # stream
    "umx_lstm_bwd_wide": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                          _I, _U, _P],
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
    """Compile the kernels if the library for these sources is missing:
    one nvcc per source, run in parallel, then one link.  The compilers'
    output (including ``-Xptxas -v``) is kept beside the library as
    ``<name>.log``."""
    out = library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    # build in a temporary directory, then rename: a concurrent or
    # interrupted build never leaves a half-written library under the
    # final name
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        cu = [s for s in _sources() if s.suffix == ".cu"]
        objs = [os.path.join(tmp, s.stem + ".o") for s in cu]
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", obj, str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for src, obj in zip(cu, objs)
        ]
        logs = [f"== {src.name}\n{p.communicate()[0]}" for src, p in zip(cu, procs)]
        failed = [src.name for src, p in zip(cu, procs) if p.returncode != 0]
        lib = os.path.join(tmp, out.name)
        if not failed:
            link = subprocess.run(
                [nvcc, *ARCH_FLAGS, "-shared", "-o", lib, *objs],
                capture_output=True, text=True,
            )
            logs.append(f"== link\n{link.stdout}{link.stderr}")
            if link.returncode != 0:
                failed.append("link")
        log = "".join(logs)
        Path(str(out) + ".log").write_text(log)
        if failed:
            raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{log}")
        os.replace(lib, out)
    return out


_LIBRARY_LOCK = threading.Lock()


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call in the process).
    Threads that reach their first kernel together (a server's batcher
    worker and its request threads) build and load it once: the lock
    holds the others until the first has bound it."""
    with _LIBRARY_LOCK:
        return _load_library()


@functools.lru_cache(maxsize=1)
def _load_library() -> ctypes.CDLL:
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
