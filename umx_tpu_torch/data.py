"""Training data pipeline and loop (counterpart of ``umx_tpu.data``).

Samples random fixed-length excerpts from tracks laid out as
``<root>/<track>/{bass,drums,other,vocals}.wav``, applies the standard
source-separation augmentations (random gain, channel swap, inter-track
source mixing) and emits mixtures plus per-source targets.  The random
draws come in the same order as in the JAX package, so one seed gives the
same batches in both.  Host-side numpy; the STFT/feature step is
:func:`umx_tpu_torch.train.make_batch_from_audio`.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field, fields

import numpy as np

from umx_tpu_torch.config import TARGETS


@dataclass
class AugmentConfig:
    gain_min: float = 0.25
    gain_max: float = 1.25
    channel_swap_prob: float = 0.5
    # sample each source from a different random track ("source mixing",
    # the strongest openunmix augmentation)
    source_mixing: bool = True


@dataclass
class StemDataset:
    """Random-excerpt sampler over a directory of stem folders."""

    root: str
    excerpt_samples: int
    sample_rate: int = 44100
    augment: AugmentConfig = field(default_factory=AugmentConfig)
    seed: int = 0
    # decoded-track memo bound (evict the least recently used beyond this)
    max_cached_tracks: int = 16
    # "all" uses every track; "train"/"valid" hold out the LAST
    # ``n_valid_tracks`` in sorted order
    split: str = "all"
    n_valid_tracks: int = 1

    def __post_init__(self):
        all_tracks = sorted(
            d
            for d in os.listdir(self.root)
            if os.path.isdir(os.path.join(self.root, d))
            and all(os.path.exists(os.path.join(self.root, d, f"{t}.wav")) for t in TARGETS)
        )
        if self.split == "all":
            self.tracks = all_tracks
        elif self.split == "train":
            self.tracks = all_tracks[: len(all_tracks) - self.n_valid_tracks]
        elif self.split == "valid":
            self.tracks = all_tracks[len(all_tracks) - self.n_valid_tracks :]
        else:
            raise ValueError(f"unknown split {self.split!r}")
        if not self.tracks:
            raise FileNotFoundError(
                f"no stem folders with {'/'.join(TARGETS)}.wav under {self.root}"
                f" (split={self.split!r})"
            )
        self._rng = np.random.default_rng(self.seed)
        self._cache: dict[str, np.ndarray] = {}

    def _load_stems(self, track: str) -> np.ndarray:
        """(T#, 2, n) float32, memoized (bounded LRU)."""
        if track not in self._cache:
            from umx_tpu_torch.io.audio import load_audio

            stems = [
                load_audio(os.path.join(self.root, track, f"{t}.wav"), self.sample_rate)
                for t in TARGETS
            ]
            n = min(s.shape[1] for s in stems)
            while len(self._cache) >= self.max_cached_tracks:
                self._cache.pop(next(iter(self._cache)))
            self._cache[track] = np.stack([s[:, :n] for s in stems])
        else:
            self._cache[track] = self._cache.pop(track)  # LRU touch
        return self._cache[track]

    def _excerpt(self, track: str, target_idx: int, start: int | None = None) -> np.ndarray:
        stems = self._load_stems(track)
        n = stems.shape[-1]
        L = self.excerpt_samples
        if n <= L:
            pad = np.zeros((2, L), np.float32)
            pad[:, :n] = stems[target_idx]
            return pad
        if start is None:
            start = int(self._rng.integers(0, n - L))
        return stems[target_idx, :, start : start + L].copy()

    def _draw_augment(self) -> tuple[np.float32, bool]:
        a = self.augment
        gain = np.float32(self._rng.uniform(a.gain_min, a.gain_max))
        swap = bool(self._rng.random() < a.channel_swap_prob)
        return gain, swap

    @staticmethod
    def _apply_augment(x: np.ndarray, gain: np.float32, swap: bool) -> np.ndarray:
        x = x * gain
        if swap:
            x = x[::-1]
        return x

    def sample(self, batch_size: int) -> tuple[np.ndarray, np.ndarray]:
        """Returns (mix (B, 2, L), targets (B, T#, 2, L)).

        With ``source_mixing`` each stem comes from an independent random
        track and offset with its own gain and swap.  Without it, one
        track, one offset, one gain and one swap are shared by all four
        stems, so the stems stay time-aligned and the mix is a real one."""
        B = batch_size
        targets = np.empty((B, len(TARGETS), 2, self.excerpt_samples), np.float32)
        for b in range(B):
            if self.augment.source_mixing:
                for j in range(len(TARGETS)):
                    track = self.tracks[int(self._rng.integers(len(self.tracks)))]
                    targets[b, j] = self._apply_augment(
                        self._excerpt(track, j), *self._draw_augment()
                    )
            else:
                base = self.tracks[int(self._rng.integers(len(self.tracks)))]
                n = self._load_stems(base).shape[-1]
                L = self.excerpt_samples
                start = 0 if n <= L else int(self._rng.integers(0, n - L))
                gain, swap = self._draw_augment()
                for j in range(len(TARGETS)):
                    targets[b, j] = self._apply_augment(
                        self._excerpt(base, j, start=start), gain, swap
                    )
        return targets.sum(axis=1), targets

    def fixed_batches(self, batch_size: int, n_batches: int):
        """Deterministic un-augmented aligned excerpts for validation:
        example ``i`` takes track ``i % n_tracks`` at an evenly spaced start
        offset, so validation losses are comparable across steps and runs."""
        L = self.excerpt_samples
        total = batch_size * n_batches
        examples = []
        for i in range(total):
            track = self.tracks[i % len(self.tracks)]
            stems = self._load_stems(track)
            n = stems.shape[-1]
            if n <= L:
                pad = np.zeros((len(TARGETS), 2, L), np.float32)
                pad[..., :n] = stems
                examples.append(pad)
            else:
                k = i // len(self.tracks)
                n_slots = max(1, total // len(self.tracks))
                start = (k * max(1, (n - L) // n_slots)) % (n - L)
                examples.append(stems[..., start : start + L].copy())
        for b in range(n_batches):
            targets = np.stack(examples[b * batch_size : (b + 1) * batch_size])
            yield targets.sum(axis=1), targets


class TrainHistory(list):
    """The train-loss list, plus the validation-driven recipe record."""

    def __init__(self):
        super().__init__()
        self.valid: list[tuple[int, float]] = []  # (step, valid loss)
        self.lrs: list[tuple[int, float]] = []  # (step, lr after the scheduler)
        self.best_valid: float = float("inf")
        self.best_step: int = 0
        self.stopped_early: bool = False


def train_loop(
    dataset: StemDataset,
    model_cfg,
    train_cfg,
    steps: int,
    batch_size: int = 4,
    params=None,
    device=None,
    log_every: int = 50,
    checkpoint_dir: str | None = None,
    valid_dataset: StemDataset | None = None,
    valid_every: int = 50,
    valid_batches: int = 4,
):
    """Dataset → batches → train steps on one ``device``: the GPU unless
    another is named (``"cpu"`` runs the kernels' plain versions).

    With a ``valid_dataset`` this runs the upstream open-unmix recipe:
    every ``valid_every`` steps the deterministic validation loss drives
    ReduceLROnPlateau (the optimizer's LR lowered in place) and
    EarlyStopping, and ``checkpoint_dir`` keeps the best-validation state
    as ``best.pt``.  Returns (state, history)."""
    import torch

    from umx_tpu_torch.config import DSPConfig
    from umx_tpu_torch.engine.separator import resolve_device
    from umx_tpu_torch.models.umx import UMXParams, synthetic_params
    from umx_tpu_torch.train import (
        EarlyStopper,
        PlateauScheduler,
        get_lr,
        init_train_state,
        make_batch_from_audio,
        make_eval_step,
        make_train_step,
        save_checkpoint,
        set_lr,
    )
    from umx_tpu_torch.utils import logging as log

    device = resolve_device(device)
    if params is None:
        params = synthetic_params(model_cfg, seed=0)
    state = init_train_state(
        UMXParams(**{f.name: getattr(params, f.name).to(device) for f in fields(UMXParams)}),
        train_cfg,
    )
    step = make_train_step(model_cfg)
    dsp = DSPConfig(sample_rate=dataset.sample_rate)
    eval_step = make_eval_step(model_cfg) if valid_dataset is not None else None
    sched = PlateauScheduler(
        lr=train_cfg.learning_rate,
        gamma=train_cfg.lr_decay_gamma,
        patience=train_cfg.lr_decay_patience,
        cooldown=train_cfg.lr_decay_cooldown,
    )
    stopper = EarlyStopper(patience=train_cfg.early_stop_patience)

    def batch_of(mix, targets):
        return make_batch_from_audio(mix, targets, model_cfg, dsp, train_cfg.seq_len, device)

    def validate() -> float:
        vals = [
            float(eval_step(state.params, batch_of(vmix, vtargets)))
            for vmix, vtargets in valid_dataset.fixed_batches(batch_size, valid_batches)
        ]
        return float(np.mean(vals))

    history = TrainHistory()
    for i in range(steps):
        state, loss = step(state, batch_of(*dataset.sample(batch_size)))
        history.append(float(loss))
        if log_every and (i + 1) % log_every == 0:
            log.info(f"step {i + 1}/{steps} loss {np.mean(history[-log_every:]):.5f}")
        if checkpoint_dir and (i + 1) % max(1, steps // 5) == 0:
            save_checkpoint(os.path.join(checkpoint_dir, f"step_{i + 1}.pt"), state)

        if eval_step is not None and (i + 1) % valid_every == 0:
            vloss = validate()
            history.valid.append((i + 1, vloss))
            if vloss < history.best_valid:
                history.best_valid = vloss
                history.best_step = i + 1
                if checkpoint_dir:
                    save_checkpoint(os.path.join(checkpoint_dir, "best.pt"), state)
            new_lr = sched.update(vloss)
            if new_lr != get_lr(state.optimizer):
                log.info(f"step {i + 1}: plateau — lr -> {new_lr:.2e}")
                set_lr(state.optimizer, new_lr)
            history.lrs.append((i + 1, new_lr))
            if stopper.update(vloss):
                log.info(f"step {i + 1}: early stop (best {stopper.best:.5f})")
                history.stopped_early = True
                break
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return state, history
