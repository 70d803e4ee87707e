"""The card, the process and the run's guards."""

from __future__ import annotations

import os
import subprocess
import sys
import time

# top-level module names that no run may hold once its window has closed:
# JAX, and the JAX package the system was ported from (compared whole, so
# that the port, whose name begins with it, is not taken for it)
FORBIDDEN = ("jax", "jaxlib", "flax", "umx_tpu")


class NoCard(RuntimeError):
    pass


def process_start() -> float:
    """The process's start on the ``time.time()`` clock, from
    ``/proc/self/stat`` (clock ticks since boot) and the boot time; the
    time of this call where that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


def require_cards(n: int) -> None:
    """Raise :class:`NoCard` unless torch sees a CUDA device and at least
    ``n`` of them."""
    import torch

    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false: this benchmark measures the card only")
    if torch.cuda.device_count() < n:
        raise NoCard(f"the cell needs {n} cards; torch sees {torch.cuda.device_count()}")


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True, timeout=30).stdout.strip().splitlines()
        return out[0] if out else "nvidia-smi listed no card"
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unreadable ({exc.__class__.__name__})"


def forbidden_modules() -> list[str]:
    """The forbidden top-level names that ``sys.modules`` holds."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def cache_dirs(checkout: str) -> None:
    """Fixed cache directories inside the checkout for the compilers a
    run might reach: Triton, PyTorch's extensions and its runtime-compiled
    elementwise kernels, the CUDA driver's JIT (the system's own kernel
    library is built under ``build/umx_tpu_torch`` there already)."""
    base = os.path.join(checkout, "build", "bench_cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(base, sub)
        os.makedirs(os.environ[var], exist_ok=True)
