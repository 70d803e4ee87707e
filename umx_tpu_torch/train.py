"""Training for the UMX mask network (counterpart of ``umx_tpu.train``).

Objective as upstream open-unmix: MSE between the masked mixture
magnitude and the target source magnitude, all four targets at once
(their weights are stacked on one axis).  The BLSTM recurrence runs
through the merged kernels, K4 forward with residuals and K5 + K6
backward, or under ``lstm_impl="scan"`` (and ``"pallas"``, and ``"auto"``
where the width is no multiple of 8) through the float32
ones, K10 with residuals forward and K11 + an f32 ``torch.bmm`` backward
(``ops/lstm_cuda.py``); validation runs under ``torch.no_grad()`` and so
takes the inference kernel K1 or K10.

The BatchNorm running statistics are inference buffers, not trained: they
never enter the optimizer (the JAX package routes them to
``optax.set_to_zero``).  Checkpoints are ``torch.save`` files holding
parameters, optimizer state and step; they are not interchangeable with
the JAX package's orbax checkpoints.  :func:`make_sharded_train_step`
runs the step over a ``dp`` × ``tp`` mesh (``parallel/mesh.py``): batch
rows over dp, the target slices of the parameters and of AdamW's state
over tp.
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
    return _adamw([params], tcfg.learning_rate, tcfg.weight_decay)


def _adamw(trees: list[UMXParams], lr: float, weight_decay: float) -> torch.optim.AdamW:
    """AdamW over the trainable fields of ``trees`` (tree by tree, in field
    order); the BatchNorm running statistics get ``requires_grad = False``."""
    trainable = []
    for params in trees:
        for f in fields(UMXParams):
            t = getattr(params, f.name)
            t.requires_grad_(f.name not in FROZEN)
            if f.name not in FROZEN:
                trainable.append(t)
    return torch.optim.AdamW(trainable, lr=lr, weight_decay=weight_decay)


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


def _masked_magnitudes(params: UMXParams, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """The masked mix magnitudes (B, T#, 2, T, n_bins) of ``mask_loss``,
    T# the parameters' own target count (a tp slice's, in the sharded
    step).  The LSTM state starts at zeros for every row.
    ``lstm_impl="pallas"`` is lowered to ``"scan"``, as the JAX trainer
    lowers it (``umx_tpu/train.py:187-190``): the per-target kernel has no
    backward, so training and its validation run the float32 recurrence."""
    if cfg.lstm_impl == "pallas":
        cfg = dataclasses.replace(cfg, lstm_impl="scan")
    B, n_t = batch["x"].shape[0], params.input_mean.shape[0]
    st = init_lstm_state(cfg, batch["x"].device)
    state_b = LSTMState(h=st.h[:n_t].expand(B, n_t, *st.h.shape[1:]),
                        c=st.c[:n_t].expand(B, n_t, *st.c.shape[1:]))
    masks, _ = umx_forward_batched(params, batch["x"], state_b, cfg)  # (B, T#, T, O)
    return apply_masks(masks, batch["mix_mag"], cfg.n_bins)


def mask_loss(params: UMXParams, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """MSE between masked mix magnitudes and target magnitudes.

    batch:
      x           (B, T, F_in)  cropped stacked-stereo mix magnitudes
      mix_mag     (B, 2, T, n_bins)
      target_mag  (B, T#, 2, T, n_bins)"""
    pred = _masked_magnitudes(params, batch, cfg)
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


@dataclass
class ShardedTrainState:
    """The state of :func:`make_sharded_train_step`: one :class:`UMXParams`
    per target slice (``slices[j]`` on tp device j of dp row 0; its
    trainable fields are the optimizer's leaves), AdamW, whose state lies
    beside each leaf, and the number of steps taken."""

    slices: list[UMXParams]
    optimizer: torch.optim.AdamW
    step: int = 0

    @property
    def params(self) -> UMXParams:
        """The whole parameters on the first slice's device, detached (the
        slices gathered on the target axis; the one slice itself when there
        is one)."""
        dst = self.slices[0].fc1_w.device
        return UMXParams(**{
            f.name: torch.cat([getattr(s, f.name).detach().to(dst) for s in self.slices])
            if len(self.slices) > 1 else getattr(self.slices[0], f.name).detach()
            for f in fields(UMXParams)
        })


@dataclass
class ShardedBatch:
    """A training batch placed on a mesh's grid: ``cells[i, j]`` is the
    ``mask_loss`` batch of dp row i's rows (targets of tp slice j) on
    device (i, j); ``count`` is the element count of the whole batch's
    ``target_mag``, the loss's denominator."""

    cells: np.ndarray
    count: int


def unshard_state(state: ShardedTrainState) -> TrainState:
    """A :class:`TrainState` with the whole parameters and a fresh AdamW
    whose state is the slices' state gathered on the target axis: what
    ``save_checkpoint`` and ``export_ggml`` take, and what
    ``restore_checkpoint`` into :func:`init_train_state` gives back."""
    params = state.params
    if len(state.slices) == 1:
        params = UMXParams(**{f.name: getattr(params, f.name).clone() for f in fields(UMXParams)})
    group = state.optimizer.param_groups[0]
    opt = _adamw([params], group["lr"], group["weight_decay"])
    dst = params.fc1_w.device
    for f in fields(UMXParams):
        parts = [state.optimizer.state.get(getattr(s, f.name)) for s in state.slices]
        if f.name in FROZEN or not all(parts):
            continue
        opt.state[getattr(params, f.name)] = {
            k: parts[0][k].clone() if k == "step" else torch.cat([p[k].to(dst) for p in parts])
            for k in parts[0]
        }
    return TrainState(params, opt, state.step)


def make_sharded_train_step(cfg: ModelConfig, tcfg: TrainConfig, mesh, tp: bool = True):
    """The train step over a (dp, tp) mesh (``parallel/mesh.py``): batch
    rows over dp; with ``tp`` the parameters and AdamW's state split over
    tp on the target axis.  Returns ``(step, shard_state, shard_batch)``:

    - ``shard_state(TrainState) → ShardedTrainState``: one leaf per field
      and target slice on the tp device of dp row 0, with AdamW's state
      beside it (sliced from the given optimizer's);
    - ``shard_batch(batch) → ShardedBatch``: each dp row's rows, and each
      tp slice's targets of ``target_mag``, on their grid device; a batch
      that does not split evenly over dp raises;
    - ``step(state, batch) → (state, loss)``: each grid device runs the
      forward of its rows and targets on copies of its slice's leaves
      (:func:`~umx_tpu_torch.parallel.sharding.broadcast`, a
      differentiable ``.to()``, so autograd sums the dp rows' gradients
      into each leaf: the all-reduce over dp); the loss is the sum of
      the devices' squared errors over the whole batch's element count,
      ``mask_loss``'s mean.  The state is updated in place and returned.

    The recurrence runs the trainer's kernels on CUDA at (T#/tp)·D chains
    and batch/dp rows, each device its rows through the same
    ``autograd.Function`` as the single-device step: under ``"auto"`` K4
    forward and K5 + K6 backward, under ``"scan"`` K10 with residuals and
    K11.  This departs on purpose from the JAX package's sharded step,
    which pins ``lstm_impl="scan"`` because a ``pallas_call`` under pjit
    would need shard_map plumbing: a limit of XLA's partitioner, not of
    the step, so the port keeps the value it is given.
    ``unshard_state`` gives back one whole state for checkpoints and
    export; ``ShardedTrainState.params`` the whole parameters."""
    from umx_tpu_torch.parallel.mesh import Mesh, shard
    from umx_tpu_torch.parallel.sharding import all_reduce_sum, broadcast, device_guard

    cols = mesh.shape["tp"] if tp else 1
    if cfg.n_targets % cols:
        raise ValueError(f"tp={cols} does not divide the {cfg.n_targets} targets")
    grid = Mesh(mesh.devices[:, :cols])
    dp, per = grid.shape["dp"], cfg.n_targets // cols
    names = [f.name for f in fields(UMXParams)]
    if any(d.type == "cuda" for d in grid.devices.flat):
        torch.backends.cuda.matmul.allow_tf32 = False  # full-f32 matmuls

    def shard_state(state: TrainState) -> ShardedTrainState:
        def part(x, j):
            return x.detach()[j * per : (j + 1) * per].to(grid.devices[0, j], copy=True)

        slices = [UMXParams(**{n: part(getattr(state.params, n), j) for n in names})
                  for j in range(cols)]
        group = state.optimizer.param_groups[0]
        opt = _adamw(slices, group["lr"], group["weight_decay"])
        for n in names:
            st = state.optimizer.state.get(getattr(state.params, n))
            for j, s in enumerate(slices):
                if st:
                    opt.state[getattr(s, n)] = {
                        k: v.clone() if k == "step" else part(v, j) for k, v in st.items()}
        return ShardedTrainState(slices, opt, state.step)

    def shard_batch(batch: dict) -> ShardedBatch:
        B = batch["x"].shape[0]
        if B % dp:
            raise ValueError(f"a batch of {B} rows does not split evenly over dp={dp}")
        x = shard(batch["x"], grid, dp_axis=0)
        mix = shard(batch["mix_mag"], grid, dp_axis=0)
        tgt = shard(batch["target_mag"], grid, dp_axis=0, tp_axis=1)
        cells = np.empty(grid.devices.shape, dtype=object)
        for idx in np.ndindex(*cells.shape):
            cells[idx] = {"x": x[idx], "mix_mag": mix[idx], "target_mag": tgt[idx]}
        return ShardedBatch(cells, batch["target_mag"].numel())

    def step(state: ShardedTrainState, batch: ShardedBatch):
        state.optimizer.zero_grad(set_to_none=True)
        partials = []
        for j, leaves in enumerate(state.slices):
            copies = {n: broadcast(getattr(leaves, n), grid.devices[:, j]) for n in names}
            for i in range(dp):
                cell = batch.cells[i, j]
                with device_guard(grid.devices[i, j]):
                    pred = _masked_magnitudes(UMXParams(**{n: copies[n][i] for n in names}),
                                              cell, cfg)
                    partials.append(torch.sum(torch.square(pred - cell["target_mag"])))
        dst = grid.devices[0, 0]
        with device_guard(dst):
            loss = all_reduce_sum(partials, dst) / batch.count
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return state, loss.detach()

    return step, shard_state, shard_batch


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
