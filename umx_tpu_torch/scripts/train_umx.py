"""Train a UMX mask network on a directory of stem folders
(<root>/<track>/{bass,drums,other,vocals}.wav) and export ggml weights
(counterpart of ``scripts/train-umx.py``).

    python -m umx_tpu_torch.scripts.train_umx <data_root> <out_model.bin.gz> \\
        [--hidden-size 512] [--steps 1000] [--valid-tracks N] [--device cuda|cpu]

The lifecycle the vendored open-unmix-pytorch covers for the reference:
train → quantize → serve with the same engine.  Training runs on one
device (default the GPU, which raises without one); ``--mesh`` shards
the step over every card (``parallel/mesh.py::make_mesh``: batch rows
over dp; ``--device cpu`` makes it a mesh of the one CPU device).
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("data_root", help="directory of stem track folders")
    p.add_argument("out_model", help="output ggml path (.bin or .bin.gz)")
    p.add_argument("--hidden-size", type=int, default=512)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--seq-len", type=int, default=256, help="frames per example")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--mesh", action="store_true", help="shard over all devices (dp x tp)")
    p.add_argument("--valid-tracks", type=int, default=0,
                   help="hold out the last N tracks for validation; enables the "
                   "full recipe (plateau LR decay + early stopping)")
    p.add_argument("--valid-every", type=int, default=50, help="steps between validations")
    p.add_argument("--lr-decay-gamma", type=float, default=0.3)
    p.add_argument("--lr-decay-patience", type=int, default=80)
    p.add_argument("--early-stop-patience", type=int, default=140)
    p.add_argument("--device", default=None, help="torch device: cuda (default) or cpu")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import os

    from umx_tpu_torch.config import DSPConfig, ModelConfig
    from umx_tpu_torch.data import StemDataset, train_loop
    from umx_tpu_torch.engine.separator import resolve_device
    from umx_tpu_torch.train import TrainConfig, export_ggml

    device = resolve_device(args.device)
    mcfg = ModelConfig(hidden_size=args.hidden_size)
    tcfg = TrainConfig(
        learning_rate=args.lr,
        seq_len=args.seq_len,
        lr_decay_gamma=args.lr_decay_gamma,
        lr_decay_patience=args.lr_decay_patience,
        early_stop_patience=args.early_stop_patience,
    )
    dsp = DSPConfig()
    excerpt = dsp.hop * (args.seq_len - 1)
    valid_dataset = None
    if args.valid_tracks > 0:
        dataset = StemDataset(args.data_root, excerpt_samples=excerpt,
                              split="train", n_valid_tracks=args.valid_tracks)
        valid_dataset = StemDataset(args.data_root, excerpt_samples=excerpt,
                                    split="valid", n_valid_tracks=args.valid_tracks)
        print(f"{len(dataset.tracks)} training / {len(valid_dataset.tracks)} validation tracks")
    else:
        dataset = StemDataset(args.data_root, excerpt_samples=excerpt)
        print(f"{len(dataset.tracks)} training tracks")

    mesh = None
    if args.mesh:
        from umx_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(devices=None if args.device is None else [device])
        print(f"mesh: {dict(mesh.shape)}")

    if args.checkpoint_dir:
        os.makedirs(args.checkpoint_dir, exist_ok=True)
    state, losses = train_loop(
        dataset, mcfg, tcfg, steps=args.steps, batch_size=args.batch_size,
        device=device, checkpoint_dir=args.checkpoint_dir,
        valid_dataset=valid_dataset, valid_every=args.valid_every, mesh=mesh,
    )
    print(f"final loss {losses[-1]:.5f}")
    if valid_dataset is not None and losses.valid:
        print(
            f"best valid {losses.best_valid:.5f} at step {losses.best_step}"
            + (" (early-stopped)" if losses.stopped_early else "")
        )
    export_ggml(state.params, args.out_model, mcfg)
    print(f"wrote {args.out_model}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
