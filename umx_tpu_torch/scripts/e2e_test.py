"""End-to-end pipeline test of the port: (convert →) demix (CLI) →
BSS-evaluate (counterpart of ``scripts/e2e_test.py``).

Equivalent of the reference's test/e2e_test.sh (build → convert both
models → demix 2 MUSDB tracks → museval SDR), with two upgrades: it runs
hermetically without the MUSDB dataset (synthetic stems are mixed on the
fly when no --musdb-track is given) and it ASSERTS instead of relying on
human inspection of SDR printouts.  The demix is ``python -m
umx_tpu_torch.cli`` in a subprocess on ``--device`` (default ``cuda``,
which raises without a GPU; ``cpu`` when asked for); the scoring is the
port's BSS-eval v4 (float64 host code).

With real data:   python -m umx_tpu_torch.scripts.e2e_test --model ggml-model-umxl-u8.bin.gz \\
                      --musdb-track /path/to/MUSDB18-HQ/test/<track>
Hermetic (no model or track): synthesizes 4 band-limited stems, mixes,
demixes with synthetic weights (nothing is converted), and checks the
pipeline's self-consistency (finite stems, conservation of the mixture,
BSS-eval runs).
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent.parent


def synth_stems(seconds: float = 3.0, sr: int = 44100) -> np.ndarray:
    """4 synthetic 'stems' occupying different bands → (4, 2, n)."""
    rng = np.random.default_rng(0)
    n = int(seconds * sr)
    t = np.arange(n) / sr
    stems = []
    for i, f0 in enumerate((80.0, 200.0, 500.0, 1200.0)):
        wave = np.zeros((2, n), np.float32)
        for h in range(1, 4):
            amp = 0.25 / h
            wave[0] += amp * np.sin(2 * np.pi * f0 * h * t + i)
            wave[1] += amp * np.sin(2 * np.pi * f0 * h * 1.005 * t + i)
        wave += 0.01 * rng.standard_normal((2, n)).astype(np.float32)
        stems.append(wave.astype(np.float32))
    return np.stack(stems)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", default=None, help="ggml model (default: synthesize one)")
    p.add_argument("--musdb-track", default=None, help="MUSDB18-HQ track dir with stems")
    p.add_argument("--keep", action="store_true", help="keep the work dir")
    p.add_argument("--device", default=None, help="torch device: cuda (default) or cpu")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from umx_tpu_torch.engine.separator import resolve_device
    from umx_tpu_torch.eval.bss import bss_eval_images_framewise
    from umx_tpu_torch.io.audio import load_audio, write_audio

    device = resolve_device(args.device)
    work = Path(tempfile.mkdtemp(prefix="umx_e2e_"))
    print(f"workdir: {work}")

    # 1. model
    if args.model:
        model_path = args.model
    else:
        from umx_tpu_torch.config import ModelConfig
        from umx_tpu_torch.io.ggml import write_ggml
        from umx_tpu_torch.models.umx import synthetic_state_dicts

        model_path = str(work / "model.bin.gz")
        write_ggml(model_path, 64, synthetic_state_dicts(ModelConfig(hidden_size=64), 0))
        print("synthesized model (hidden=64)")

    # 2. input track + references
    if args.musdb_track:
        track = Path(args.musdb_track)
        mix = load_audio(str(track / "mixture.wav"))
        refs = np.stack(
            [load_audio(str(track / f"{s}.wav")) for s in ("bass", "drums", "other", "vocals")]
        )
    else:
        refs = synth_stems()
        mix = refs.sum(axis=0)
    mix_path = str(work / "mix.wav")
    write_audio(mix_path, mix)

    # 3. demix through the CLI (the real user surface)
    out_dir = work / "out"
    cmd = [
        sys.executable, "-m", "umx_tpu_torch.cli", model_path, mix_path, str(out_dir),
        "--quiet", "--segment-secs", "2.0", "--shifts", "0", "--device", device.type,
    ]
    print("+", " ".join(cmd))
    subprocess.run(cmd, check=True, cwd=REPO, timeout=1800)

    # 4. load stems, check the basic contract
    ests = np.stack(
        [load_audio(str(out_dir / f"target_{i}.wav")) for i in range(4)]
    )
    n = min(ests.shape[-1], refs.shape[-1])
    ests, refs, mix = ests[..., :n], refs[..., :n], mix[..., :n]
    if not np.isfinite(ests).all():
        raise RuntimeError("non-finite samples in stems")

    total = ests.sum(axis=0)
    corr = np.corrcoef(total.ravel(), mix.ravel())[0, 1]
    print(f"corr(sum stems, mix) = {corr:.4f}")
    if not corr > 0.98:
        raise RuntimeError(f"Wiener partition property violated (corr {corr:.4f})")

    # 5. BSS-eval (short filters keep the hermetic run quick)
    res = bss_eval_images_framewise(
        refs.astype(np.float64), ests.astype(np.float64), flen=64
    )
    print(f"{'stem':<8} {'SDR':>8} {'ISR':>8} {'SIR':>8} {'SAR':>8}")
    for j, t in enumerate(("bass", "drums", "other", "vocals")):
        print(
            f"{t:<8} {res['median_SDR'][j]:>8.3f} {res['median_ISR'][j]:>8.3f} "
            f"{res['median_SIR'][j]:>8.3f} {res['median_SAR'][j]:>8.3f}"
        )
    if not np.isfinite(res["median_SDR"]).all():
        raise RuntimeError(f"non-finite median SDR: {res['median_SDR']}")

    if not args.keep and not args.model:
        import shutil

        shutil.rmtree(work)
    print("e2e OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
