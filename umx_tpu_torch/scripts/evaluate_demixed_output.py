"""BSS-eval a demixed output directory against reference stems
(counterpart of ``scripts/evaluate-demixed-output.py``).

    python -m umx_tpu_torch.scripts.evaluate_demixed_output <est_dir> <track_dir> \\
        [--win 1.0] [--flen 512] [--json out.json] [--mode v4|v3] [--device cuda|cpu]

Expects:

* estimates: <est_dir>/target_{0..3}.wav  (bass, drums, other, vocals)
* references: a MUSDB18-HQ track directory containing
  bass.wav/drums.wav/other.wav/vocals.wav.

Prints per-stem median SDR/ISR/SIR/SAR over 1 s windows.  ``--mode v4``
(museval's default) is float64 host code; ``--mode v3`` batches its
per-window solves in float32 on ``--device`` (default the GPU, which
raises without one; ``cpu`` runs them with torch on the host).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

TARGETS = ("bass", "drums", "other", "vocals")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("est_dir", type=Path, help="directory with target_{0..3}.wav")
    p.add_argument("track_dir", type=Path, help="MUSDB track dir with <stem>.wav files")
    p.add_argument("--win", type=float, default=1.0, help="window seconds")
    p.add_argument("--flen", type=int, default=512, help="projection filter length")
    p.add_argument("--json", type=Path, default=None, help="also write results as JSON")
    p.add_argument("--mode", choices=("v4", "v3"), default="v4",
                   help="v4 = museval default (global filters); v3 = per-window filters")
    p.add_argument("--device", default=None,
                   help="torch device of the v3 solves: cuda (default) or cpu")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from umx_tpu_torch.engine.separator import resolve_device
    from umx_tpu_torch.eval.bss import bss_eval_images_framewise
    from umx_tpu_torch.io.audio import load_audio

    device = resolve_device(args.device)
    refs, ests = [], []
    for i, t in enumerate(TARGETS):
        refs.append(load_audio(str(args.track_dir / f"{t}.wav")))
        ests.append(load_audio(str(args.est_dir / f"target_{i}.wav")))
    n = min(min(r.shape[1] for r in refs), min(e.shape[1] for e in ests))
    references = np.stack([r[:, :n] for r in refs]).astype(np.float64)
    estimates = np.stack([e[:, :n] for e in ests]).astype(np.float64)

    win = int(args.win * 44100)
    res = bss_eval_images_framewise(
        references, estimates, window=win, hop=win, flen=args.flen, mode=args.mode,
        accelerator="torch", device=device,
    )

    print(f"{'stem':<8} {'SDR':>8} {'ISR':>8} {'SIR':>8} {'SAR':>8}")
    for j, t in enumerate(TARGETS):
        print(
            f"{t:<8} {res['median_SDR'][j]:>8.3f} {res['median_ISR'][j]:>8.3f} "
            f"{res['median_SIR'][j]:>8.3f} {res['median_SAR'][j]:>8.3f}"
        )
    if args.mode == "v3":
        print(f"# {res['float64_resolves']} windows re-solved in float64")

    if args.json:
        import json

        payload = {
            t: {
                m: float(res[f"median_{m}"][j])
                for m in ("SDR", "ISR", "SIR", "SAR")
            }
            for j, t in enumerate(TARGETS)
        }
        args.json.write_text(json.dumps(payload, indent=2))
        print(f"wrote {args.json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
