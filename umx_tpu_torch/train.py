"""Training for the UMX mask network (counterpart of ``umx_tpu.train``).

Objective as upstream open-unmix: MSE between the masked mixture
magnitude and the target source magnitude, all four targets at once
(their weights are stacked on one axis).  The BLSTM recurrence runs
through the merged kernels: K4 forward with residuals, K5 + K6 backward
(``ops/lstm_cuda.py``); validation runs under ``torch.no_grad()`` and so
takes the inference kernel K1.

The BatchNorm running statistics are inference buffers, not trained: they
never enter the optimizer (the JAX package routes them to
``optax.set_to_zero``).  Checkpoints are ``torch.save`` files holding
parameters, optimizer state and step; they are not interchangeable with
the JAX package's orbax checkpoints.  Sharded training (``dp`` × ``tp``
over a mesh) is not ported.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, fields

import numpy as np
import torch

from umx_tpu_torch.config import ModelConfig
from umx_tpu_torch.engine.separator import apply_masks, resolve_device
from umx_tpu_torch.models.umx import (
    LSTMState,
    UMXParams,
    init_lstm_state,
    params_to_state_dicts,
    umx_forward_batched,
)
from umx_tpu_torch.ops.stft import crop_stack, stft_magnitude

FROZEN = ("bn1_rm", "bn1_rv", "bn2_rm", "bn2_rv", "bn3_rm", "bn3_rv")


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-3
    weight_decay: float = 1e-5
    # sequence length (frames) per training example
    seq_len: int = 256
    # the upstream open-unmix recipe: ReduceLROnPlateau(factor=0.3,
    # patience=80, cooldown=10) + EarlyStopping(patience=140), driven by
    # the validation loss; patience counts validation rounds
    lr_decay_gamma: float = 0.3
    lr_decay_patience: int = 80
    lr_decay_cooldown: int = 10
    early_stop_patience: int = 140


@dataclass
class TrainState:
    """Parameters (updated in place by the optimizer), the optimizer and
    the number of steps taken."""

    params: UMXParams
    optimizer: torch.optim.AdamW
    step: int = 0


def make_optimizer(params: UMXParams, tcfg: TrainConfig) -> torch.optim.AdamW:
    """AdamW over every field except the BatchNorm running statistics,
    which get ``requires_grad = False`` and stay out of the optimizer."""
    trainable = []
    for f in fields(UMXParams):
        t = getattr(params, f.name)
        t.requires_grad_(f.name not in FROZEN)
        if f.name not in FROZEN:
            trainable.append(t)
    return torch.optim.AdamW(trainable, lr=tcfg.learning_rate, weight_decay=tcfg.weight_decay)


def get_lr(optimizer) -> float:
    return optimizer.param_groups[0]["lr"]


def set_lr(optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


@dataclass
class PlateauScheduler:
    """ReduceLROnPlateau (torch semantics, as the upstream open-unmix
    trainer uses it): when the monitored loss hasn't improved for
    ``patience`` rounds, multiply the LR by ``gamma``, then pause counting
    for ``cooldown`` rounds."""

    lr: float
    gamma: float = 0.3
    patience: int = 80
    cooldown: int = 10
    best: float = float("inf")
    _bad: int = 0
    _cool: int = 0

    def update(self, loss: float) -> float:
        """Feed one validation loss; returns the (possibly lowered) LR.
        The cooldown counter decrements every round it is active and
        suppresses bad-round counting meanwhile."""
        if loss < self.best:
            self.best = loss
            self._bad = 0
        else:
            self._bad += 1
        if self._cool > 0:
            self._cool -= 1
            self._bad = 0
        if self._bad > self.patience:
            self.lr *= self.gamma
            self._bad = 0
            self._cool = self.cooldown
        return self.lr


@dataclass
class EarlyStopper:
    """Stop when the monitored loss hasn't improved by ``min_delta`` for
    ``patience`` validation rounds (upstream utils.EarlyStopping)."""

    patience: int = 140
    min_delta: float = 0.0
    best: float = float("inf")
    _bad: int = 0

    def update(self, loss: float) -> bool:
        if loss < self.best - self.min_delta:
            self.best = loss
            self._bad = 0
            return False
        self._bad += 1
        return self._bad > self.patience


def init_train_state(params: UMXParams, tcfg: TrainConfig) -> TrainState:
    """A fresh state over a copy of ``params`` (the caller's tensors are
    left as they are, as with the JAX package's immutable arrays)."""
    params = UMXParams(**{
        f.name: getattr(params, f.name).detach().clone() for f in fields(UMXParams)
    })
    if params.fc1_w.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False  # full-f32 matmuls
    return TrainState(params, make_optimizer(params, tcfg), 0)


def mask_loss(params: UMXParams, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """MSE between masked mix magnitudes and target magnitudes.

    batch:
      x           (B, T, F_in)  cropped stacked-stereo mix magnitudes
      mix_mag     (B, 2, T, n_bins)
      target_mag  (B, T#, 2, T, n_bins)
    The LSTM state starts at zeros for every row.  ``lstm_impl="pallas"``
    is ignored: the per-target kernel has no backward, so training and
    its validation always run the merged kernels (the JAX trainer lowers
    it to its scan the same way)."""
    if cfg.lstm_impl == "pallas":
        cfg = dataclasses.replace(cfg, lstm_impl="auto")
    B = batch["x"].shape[0]
    st = init_lstm_state(cfg, batch["x"].device)
    state_b = LSTMState(h=st.h.expand(B, *st.h.shape), c=st.c.expand(B, *st.c.shape))
    masks, _ = umx_forward_batched(params, batch["x"], state_b, cfg)  # (B, T#, T, O)
    pred = apply_masks(masks, batch["mix_mag"], cfg.n_bins)
    return torch.mean(torch.square(pred - batch["target_mag"]))


def make_eval_step(cfg: ModelConfig):
    """``eval_step(params, batch) -> loss``: the training objective with no
    gradient (so the recurrence runs the inference kernel)."""

    @torch.no_grad()
    def eval_step(params: UMXParams, batch: dict) -> torch.Tensor:
        return mask_loss(params, batch, cfg)

    return eval_step


def make_train_step(cfg: ModelConfig):
    """``train_step(state, batch) -> (state, loss)``: one AdamW step on
    ``mask_loss``; the state is updated in place and returned."""

    def train_step(state: TrainState, batch: dict):
        state.optimizer.zero_grad(set_to_none=True)
        loss = mask_loss(state.params, batch, cfg)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return state, loss.detach()

    return train_step


def save_checkpoint(path: str, state: TrainState) -> None:
    """Parameters, optimizer state and step, with ``torch.save``."""
    torch.save({
        "params": {f.name: getattr(state.params, f.name).detach() for f in fields(UMXParams)},
        "optimizer": state.optimizer.state_dict(),
        "step": state.step,
    }, path)


def restore_checkpoint(path: str, state: TrainState) -> TrainState:
    """Load a :func:`save_checkpoint` file into ``state`` (whose parameters
    fix the shapes and device) and return it."""
    ckpt = torch.load(path, map_location=state.params.fc1_w.device, weights_only=True)
    with torch.no_grad():
        for f in fields(UMXParams):
            getattr(state.params, f.name).copy_(ckpt["params"][f.name])
    state.optimizer.load_state_dict(ckpt["optimizer"])
    state.step = int(ckpt["step"])
    return state


def export_ggml(params: UMXParams, path: str, cfg: ModelConfig) -> None:
    """Write trained parameters as a quantized ggml file (train → serve)."""
    from umx_tpu_torch.io.ggml import write_ggml

    write_ggml(path, cfg.hidden_size, params_to_state_dicts(params, cfg))


def make_batch_from_audio(audio_mix, audio_targets, cfg: ModelConfig, dsp_cfg, seq_len: int,
                          device=None) -> dict:
    """A training batch from raw audio: audio_mix (B, 2, n), audio_targets
    (B, T#, 2, n) → the ``mask_loss`` batch on ``device``, cut to
    ``seq_len`` frames.  The STFTs of the whole batch run there: the
    default is the GPU, which raises without one; the CPU runs it only
    when asked for by name."""
    device = resolve_device(device)
    mix = torch.as_tensor(np.asarray(audio_mix, np.float32), device=device)
    targets = torch.as_tensor(np.asarray(audio_targets, np.float32), device=device)
    mix_mag = stft_magnitude(mix, dsp_cfg)  # (B, 2, T, F)
    tgt_mag = stft_magnitude(targets, dsp_cfg)  # (B, T#, 2, T, F)
    x = crop_stack(mix_mag, cfg.nb_bins_cropped)  # (B, T, F_in)
    return {
        "x": x[:, :seq_len].contiguous(),
        "mix_mag": mix_mag[:, :, :seq_len].contiguous(),
        "target_mag": tgt_mag[:, :, :, :seq_len].contiguous(),
    }
