"""Long-track robustness of the port (counterpart of
``scripts/longtrack-probe.py``): demix a 30-minute track through the
fused path on ``--device`` (default ``cuda``, which raises without a GPU;
``cpu`` when asked for), the reference's 'Georgia Wonder - Siren'
memory-test story (README.md:46-54) at 4x the length.

Checks: the memory planner's single-track estimate against the device's
capacity (``engine/memory.py::device_hbm_bytes``), the route the
separator takes (one program, or windows when the planner says the track
does not fit), finite output, stems that sum to the mix (corr ~= 1 with
Wiener EM), and reports x realtime.  ``UMX_PROBE_TRACK_SECS`` sets the
length (default 1800 s).

    python -m umx_tpu_torch.scripts.longtrack_probe [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default=None, help="torch device: cuda (default) or cpu")
    return p


def signal(track_secs: float, sr: int = 44100):
    """The probe's track: band-limited-ish content, two tones plus noise,
    the right channel 10 ms behind the left → (2, n) float32."""
    import numpy as np

    rng = np.random.default_rng(0)
    t = np.arange(int(track_secs * sr)) / sr
    sig = (
        0.3 * np.sin(2 * np.pi * 220 * t)
        + 0.2 * np.sin(2 * np.pi * 554 * t)
        + 0.05 * rng.standard_normal(t.size)
    ).astype(np.float32)
    return np.stack([sig, np.roll(sig, 441)])


def probe(device, cfg=None, track_secs: float = 1800.0) -> dict:
    """Demix a synthetic ``track_secs`` track twice on ``device`` (the
    first run builds the kernels) → the second run's figures: the
    planner's estimate and the device's capacity (GiB), the route,
    wall s, x realtime, and corr(sum of stems, mix) over the whole track
    and over its first and last tenths (the signal is stationary, so a
    route that drifts along the track shows as a gap between the two).
    ``cfg`` (an ``EngineConfig``, default UMX-L's) lets a caller run it at
    a small width."""
    import numpy as np
    import torch

    from umx_tpu_torch.config import EngineConfig
    from umx_tpu_torch.engine.memory import device_hbm_bytes, fused_track_hbm_bytes
    from umx_tpu_torch.engine.separator import Separator, to_host
    from umx_tpu_torch.models.umx import synthetic_params
    from umx_tpu_torch.utils.profiling import card_name

    cfg = EngineConfig() if cfg is None else cfg
    fig = {"secs": track_secs, "card": card_name(device),
           "planner_gib": fused_track_hbm_bytes(cfg, 1, track_secs,
                                                 device=device)["total"] / 2**30,
           "device_gib": device_hbm_bytes(device) / 2**30}
    print(
        f"# planner: {fig['planner_gib']:.2f} GiB estimated of "
        f"{fig['device_gib']:.2f} GiB for {track_secs:.0f}s on {device} [{fig['card']}]",
        file=sys.stderr,
    )

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    sr = cfg.dsp.sample_rate
    audio = signal(track_secs, sr)
    sep = Separator(synthetic_params(cfg.model, seed=0, device=device), cfg, device)

    dev = torch.from_numpy(audio).to(device)
    sync()
    t0 = time.perf_counter()
    out = sep.demix(dev)
    sync()
    print(f"# first run (kernel builds included): {time.perf_counter() - t0:.1f}s",
          file=sys.stderr)
    del out

    # a fused run reports progress once, at its end; a windowed run once
    # per window
    calls: list[float] = []
    t0 = time.perf_counter()
    out = sep.demix(dev, progress=calls.append, fused=True)
    sync()
    fig["wall_s"] = time.perf_counter() - t0
    fig["route"] = "one program" if len(calls) == 1 else f"{len(calls)} windows"
    stems = to_host(out)
    del out
    if not np.isfinite(stems).all():
        raise RuntimeError("non-finite stems")
    mix_sum = stems.sum(axis=0)
    del stems

    def corr(a, b) -> float:
        return float(np.corrcoef(a.ravel(), b.ravel())[0, 1])

    tenth = audio.shape[1] // 10
    fig["corr"] = corr(mix_sum, audio)
    fig["corr_first_tenth"] = corr(mix_sum[:, :tenth], audio[:, :tenth])
    fig["corr_last_tenth"] = corr(mix_sum[:, -tenth:], audio[:, -tenth:])
    fig["chunks"] = math.ceil(audio.shape[1] / cfg.segment.stride_samples(sr))
    fig["xrt"] = track_secs / fig["wall_s"]
    return fig


def main(argv=None, cfg=None) -> int:
    """``cfg`` (an ``EngineConfig``, default UMX-L's) lets a caller run
    the probe at a small width."""
    from umx_tpu_torch.engine.separator import resolve_device

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    fig = probe(device, cfg, float(os.environ.get("UMX_PROBE_TRACK_SECS", "1800")))
    print(
        f"longtrack {fig['secs']:.0f}s: {fig['chunks']} chunks, xRT={fig['xrt']:.0f}, "
        f"corr(sum stems, mix)={fig['corr']:.6f}, finite=True, route={fig['route']}, "
        f"corr first/last tenth={fig['corr_first_tenth']:.6f}/{fig['corr_last_tenth']:.6f}, "
        f"planner={fig['planner_gib']:.2f} GiB of {fig['device_gib']:.2f} GiB [{fig['card']}]"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
