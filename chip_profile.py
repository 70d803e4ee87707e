#!/usr/bin/env python3
"""Where the catalogue run of the PyTorch/CUDA port spends the card's time.

    python3 chip_profile.py

Builds the kernels, writes the synthetic UMX-L weights and the five
catalogue tracks of ``chip_smoke.py`` (three of 100 s, one of 40 s, one of
400 s), and profiles one warm ``demix_tracks`` run with quantized weights
and ``window_chunks=4`` under ``torch.profiler``: device time by kind of
work (the recurrence kernel, the Wiener passes, copies, matrix products,
FFTs, the rest) as shares of the wall time, and the idle share.  A
measurement aid, not a check: it holds nothing against a reference.
Needs one CUDA GPU and exits non-zero without one.
"""

from __future__ import annotations

import subprocess
import sys
import tempfile
import time

import chip_smoke as S


def profile_catalogue(sep, tracks, smi: str):
    """One warm ``demix_tracks`` run under ``torch.profiler``: the card's
    time by kind of device work, beside the run's wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from umx_tpu_torch.engine.fleet import demix_tracks

    audio = list(tracks.values())
    demix_tracks(sep, audio)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        demix_tracks(sep, audio)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kinds = (("K1 lstm_merged", ("lstm_step_kernel",)),
             ("K9 lstm_pertarget", ("lstm_pertarget_kernel",)),
             ("K2+K3 wiener", ("reduce_partial_kernel", "reduce_sum_kernel", "apply_kernel")),
             ("stems copy to host", ("Memcpy DtoH",)),
             ("audio copy to device", ("Memcpy HtoD",)),
             ("matrix products", ("gemm", "gemv", "cutlass", "cublas")),
             ("FFTs", ("fft",)))
    totals = dict.fromkeys([k for k, _ in kinds] + ["other"], 0.0)
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        ms = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0)) / 1e3
        kind = next((k for k, keys in kinds if any(x in e.key for x in keys)), "other")
        totals[kind] += ms
    busy = sum(totals.values())
    S.require(busy > 0, "the profiler saw no device time")
    print(f"catalogue profile (demix_tracks, window_chunks {S.WINDOW_CHUNKS}, quantized, warm, "
          f"{sum(S.CATALOGUE_SECS):.0f} s of audio): wall {wall_ms:.1f} ms under the profiler, device "
          f"busy {busy:.1f} ms ({100 * busy / wall_ms:.1f} %), idle {100 - 100 * busy / wall_ms:.1f} %"
          f"  [{smi}]")
    for kind, ms in sorted(totals.items(), key=lambda kv: -kv[1]):
        print(f"  {kind}: {ms:.1f} ms ({100 * ms / wall_ms:.1f} % of the wall)")
    return totals, wall_ms


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_profile: torch.cuda.is_available() is false; this needs a GPU",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}")

    from umx_tpu_torch.config import EngineConfig, SegmentConfig
    from umx_tpu_torch.engine.separator import Separator

    with tempfile.TemporaryDirectory(prefix="umx_profile_") as tmp:
        model, _, _ = S.write_inputs(tmp)
        _, tracks = S.write_catalogue(tmp)
        cfg = EngineConfig(segment=SegmentConfig(window_chunks=S.WINDOW_CHUNKS))
        sep = Separator.from_ggml(model, cfg, "cuda", quantized_hbm=True)
        profile_catalogue(sep, tracks, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
