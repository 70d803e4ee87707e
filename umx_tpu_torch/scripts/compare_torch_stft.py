"""STFT parity probe (counterpart of ``scripts/compare-torch-stft.py``):
the port's ``stft_planes`` on ``--device`` (default ``cuda``, which raises
without a GPU; ``cpu`` when asked for) beside ``torch.stft`` on the host
CPU, on a synthetic square wave.

Role of the reference's scripts/compare-torch-stft.py:1-35 (its output
was eyeball-diffed against the C++ gtest prints); here the difference is
computed and checked: the run fails above 2e-4 of the spectrum's peak.

    python -m umx_tpu_torch.scripts.compare_torch_stft [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default=None,
                   help="torch device of the port's transform: cuda (default) or cpu")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from umx_tpu_torch.config import DSPConfig
    from umx_tpu_torch.engine.separator import resolve_device, to_host
    from umx_tpu_torch.ops.stft import stft_planes

    device = resolve_device(args.device)
    cfg = DSPConfig()
    n = 4096 * 10
    t = np.arange(n) / cfg.sample_rate
    x = np.sign(np.sin(2 * np.pi * 441.0 * t)).astype(np.float32)[None]

    win = torch.hann_window(cfg.n_fft, periodic=True)
    ref = (
        torch.stft(
            torch.from_numpy(x), n_fft=cfg.n_fft, hop_length=cfg.hop, window=win,
            center=True, pad_mode="reflect", onesided=True, return_complex=True,
        )
        .numpy()
        .swapaxes(-1, -2)
    )
    re, im = stft_planes(torch.from_numpy(x).to(device), cfg)
    ours = to_host(re) + 1j * to_host(im)

    frame = ref.shape[1] // 2
    print(f"center frame {frame}, bins 0..9 (|X|), port on {device}:")
    print(f"{'bin':>4} {'torch':>14} {'umx-tpu':>14} {'absdiff':>12}")
    for b in range(10):
        tv, ov = abs(ref[0, frame, b]), abs(ours[0, frame, b])
        print(f"{b:>4} {tv:>14.6f} {ov:>14.6f} {abs(tv - ov):>12.3e}")

    scale = np.abs(ref).max()
    err = np.abs(ours - ref).max() / scale
    print(f"\nmax relative error vs torch.stft: {err:.3e}")
    if not err < 2e-4:
        raise RuntimeError(f"STFT parity broken: {err:.3e} of the peak (limit 2e-4)")
    print("parity OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
