"""Convert Open-Unmix PyTorch checkpoints to the quantized ggml format
(counterpart of ``scripts/convert-umx-pth-to-ggml.py``).

Functional equivalent of the reference converter
(scripts/convert-umx-pth-to-ggml.py:72-165): loads the 4 per-target .pth
state dicts (from the torchhub cache or an explicit directory), quantizes
per tensor (u8, or u16 for bn2/bn3/fc2/fc3) and writes one ggml file that
the port, the JAX package and the reference loader all read.  It needs
no openunmix package (it reads raw checkpoint state dicts) and no GPU.

    python -m umx_tpu_torch.scripts.convert_umx_pth_to_ggml [--model umxl|umxhq]
           [--ckpt-dir DIR] [--gzip] <dest_dir>
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

# torchhub checkpoint file names per model family (the artifacts the
# reference enumerates at scripts/convert-umx-pth-to-ggml.py:37-50)
HUB_FILES = {
    "umxhq": {
        "vocals": "vocals-b62c91ce.pth",
        "drums": "drums-9619578f.pth",
        "bass": "bass-8d85a5bd.pth",
        "other": "other-b52fbbf7.pth",
    },
    "umxl": {
        "vocals": "vocals-bccbd9aa.pth",
        "drums": "drums-69e0ebd4.pth",
        "bass": "bass-2ca1ce51.pth",
        "other": "other-c8c5b3e6.pth",
    },
}

SKIP_KEYS = {
    "stft.window",
    "sample_rate",
    "transform.0.window",
    "bn1.num_batches_tracked",
    "bn2.num_batches_tracked",
    "bn3.num_batches_tracked",
}


def load_state_dicts(model: str, ckpt_dir: Path | None):
    import torch

    if ckpt_dir is None:
        ckpt_dir = Path(torch.hub.get_dir()) / "checkpoints"
    out = {}
    for target, fname in HUB_FILES[model].items():
        path = ckpt_dir / fname
        if not path.exists():
            # fall back to <target>.pth naming for locally trained models
            alt = ckpt_dir / f"{target}.pth"
            if not alt.exists():
                raise FileNotFoundError(f"checkpoint not found: {path} (or {alt})")
            path = alt
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        sd = ckpt.get("state_dict", ckpt)
        out[target] = {
            k: v.squeeze().numpy() for k, v in sd.items() if k not in SKIP_KEYS
        }
    return out


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--model", choices=("umxhq", "umxl"), default="umxl")
    parser.add_argument(
        "--ckpt-dir",
        type=Path,
        default=None,
        help="directory holding the .pth files (default: torchhub cache)",
    )
    parser.add_argument("--gzip", action="store_true", help="write .bin.gz")
    parser.add_argument("dest_dir", type=Path)
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from umx_tpu_torch.io.ggml import write_ggml

    state_dicts = load_state_dicts(args.model, args.ckpt_dir)
    hidden_size = state_dicts["bass"]["fc1.weight"].shape[0]
    print(f"hidden_size = {hidden_size}")

    args.dest_dir.mkdir(parents=True, exist_ok=True)
    suffix = ".bin.gz" if args.gzip else ".bin"
    dest = args.dest_dir / f"ggml-model-{args.model}-u8{suffix}"
    write_ggml(str(dest), hidden_size, state_dicts)
    print(f"wrote {dest} ({dest.stat().st_size / 1e6:.1f} MB)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
