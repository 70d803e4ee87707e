"""Golden PyTorch inference for parity validation (counterpart of
``scripts/umx-golden-inference.py``).

Role of the reference's scripts/umx_pytorch_inference.py:20-88: run the
same demix through an independent pure-PyTorch path and write
target_{0..3}.wav, so that the port's stems can be diffed and
SDR-compared against it.  It is a reference, not the port's path: the
mask nets (``eval/oracle.py``'s ``TorchUMX``, fed the ggml weights), the
numpy Wiener-EM oracle and ``torch.stft``/``torch.istft`` all compute on
the host CPU in float32 (the Wiener oracle in complex128), whatever GPU
the machine has.

    python -m umx_tpu_torch.scripts.umx_golden_inference <model.bin[.gz]> <mix.wav> <out_dir>
           [--no-wiener]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("model_file", help="ggml model file (.bin/.bin.gz)")
    p.add_argument("wav_file")
    p.add_argument("out_dir", type=Path)
    p.add_argument("--no-wiener", action="store_true")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from umx_tpu_torch.config import TARGETS
    from umx_tpu_torch.eval.oracle import TorchUMX, numpy_wiener_oracle
    from umx_tpu_torch.io.audio import load_audio, write_audio
    from umx_tpu_torch.io.ggml import read_ggml

    audio = load_audio(args.wav_file)
    model = read_ggml(args.model_file)

    x = torch.from_numpy(audio)
    win = torch.hann_window(4096, periodic=True)
    spec = torch.stft(
        x, n_fft=4096, hop_length=1024, window=win, center=True,
        pad_mode="reflect", onesided=True, return_complex=True,
    ).transpose(-1, -2)  # (2, T, F)
    mag = spec.abs()

    feats = torch.cat([mag[0, :, :1487], mag[1, :, :1487]], dim=-1)  # (T, 2974)

    target_mags = []
    for t in TARGETS:
        net = TorchUMX(model.hidden_size)
        net.load_target_state_dict(model.targets[t])
        mask = net.forward(feats)  # (T, 4098)
        m = mask.reshape(-1, 2, 2049).permute(1, 0, 2)  # (2, T, F)
        target_mags.append(m * mag)
    target_mags = torch.stack(target_mags)  # (4, 2, T, F)

    if args.no_wiener:
        phase = torch.angle(spec)
        specs = target_mags * torch.exp(1j * phase)[None]
    else:
        specs = torch.from_numpy(numpy_wiener_oracle(spec.numpy(), target_mags.numpy()))

    args.out_dir.mkdir(parents=True, exist_ok=True)
    for i in range(4):
        wave = torch.istft(
            specs[i].transpose(-1, -2), n_fft=4096, hop_length=1024, window=win,
            center=True, length=audio.shape[1],
        ).numpy()
        write_audio(str(args.out_dir / f"target_{i}.wav"), wave)
        print(f"wrote target_{i}.wav")
    return 0


if __name__ == "__main__":
    sys.exit(main())
