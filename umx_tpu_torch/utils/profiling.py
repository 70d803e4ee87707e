"""Per-stage wall-clock timers and device traces (counterpart of
``umx_tpu.utils.profiling``).

:class:`StageTimer` gives the JAX class's table and JSON for the same
totals; a stage's ``block_on`` synchronizes the device of every CUDA
tensor in it, so the device time lands in the stage that produced it.
:func:`device_trace` records a ``torch.profiler`` trace (CPU and CUDA
activities) and writes it under ``log_dir`` as a Chrome trace file.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict


def _cuda_devices(tree, out: set) -> set:
    """The CUDA devices of the tensors in ``tree`` (a tensor, or lists,
    tuples and dicts of them)."""
    import torch

    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            out.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _cuda_devices(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _cuda_devices(v, out)
    return out


def block_until_ready(tree):
    """Wait until the devices of the tensors in ``tree`` have finished
    their queued work (``jax.block_until_ready`` for tensors); returns
    ``tree``."""
    import torch

    for dev in _cuda_devices(tree, set()):
        torch.cuda.synchronize(dev)
    return tree


class StageTimer:
    """Accumulates wall-clock per named stage; blocks on device results
    so device time is attributed to the stage that produced it."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, block_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                block_until_ready(block_on)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = [f"{'stage':<24} {'total_s':>9} {'calls':>6} {'mean_ms':>9}"]
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name:<24} {total:>9.3f} {n:>6} {total / n * 1000:>9.2f}")
        return "\n".join(lines)

    def as_json(self) -> str:
        return json.dumps(
            {k: {"total_s": v, "calls": self.counts[k]} for k, v in self.totals.items()}
        )


@contextlib.contextmanager
def device_trace(log_dir: str, device=None):
    """Record a ``torch.profiler`` trace of the block and write it under
    ``log_dir`` as ``<host>_<pid>.<ns>.pt.trace.json`` (open it in
    Perfetto or ``chrome://tracing``).  ``device`` defaults to the GPU
    (CPU and CUDA activities; raises without one); ``"cpu"`` records the
    CPU only.  Yields the profiler, whose ``key_averages()`` sum the
    events by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    from umx_tpu_torch.engine.separator import resolve_device

    dev = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        try:
            yield prof
        finally:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
