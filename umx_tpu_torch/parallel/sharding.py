"""Sharding plans for parameters and batched inference over a
:class:`~umx_tpu_torch.parallel.mesh.Mesh` (counterpart of
``umx_tpu.parallel.sharding``).

* Parameters: replicated over dp, optionally split over tp on the leading
  target axis (every UMX tensor exists per target, so the target axis is
  a clean model-parallel dimension).
* Batched demix: a batch of independent segments split over dp; each dp
  row of the grid runs the whole segment pipeline on its rows.  With tp,
  each tp device runs the mask network for its targets and the masks are
  gathered to the row's first device, where the Wiener filter and the
  iSTFT run.

One process drives the whole grid, so the caller passes and gets back
whole tensors, as with the JAX package's global arrays.  Every combine
between grid devices goes through one of the helpers :func:`all_gather`
(the demix's masks), :func:`all_reduce_sum` and :func:`broadcast` (the
sharded train step's loss and parameters), each an explicit
``Tensor.to(device, non_blocking=True)``; :func:`audit_collectives` lists
the gathers of the demix's forward pass.  Moving the caller's batch in and
the result out is placement, not a combine, as in the JAX audit.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, fields

import numpy as np
import torch

from umx_tpu_torch.config import EngineConfig
from umx_tpu_torch.engine.separator import segment_finish, segment_masks
from umx_tpu_torch.models.umx import LSTMState, UMXParams, init_lstm_state
from umx_tpu_torch.parallel.mesh import Mesh, shard, to_device


def device_guard(device: torch.device):
    """A block with ``device`` as the current CUDA device (the kernels
    launch on the current device); nothing for another device type."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


@dataclass(frozen=True)
class Combine:
    """One combine between grid devices: its kind, the devices the pieces
    come from, the device they go to, and the bytes that come from
    another grid position than the destination's own."""

    kind: str
    sources: tuple[str, ...]
    destination: str
    nbytes: int

    def __str__(self) -> str:
        return f"{self.kind}: {', '.join(self.sources)} -> {self.destination}, {self.nbytes} bytes"


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def all_gather(pieces: list[torch.Tensor], dst: torch.device, dim: int,
               log: list | None = None) -> torch.Tensor:
    """The pieces, the first of which is the destination's own, concatenated
    along ``dim`` on ``dst``; recorded in ``log`` when one is given."""
    if log is not None:
        log.append(Combine("all-gather", tuple(str(p.device) for p in pieces), str(dst),
                           sum(_nbytes(p) for p in pieces[1:])))
    return torch.cat([to_device(p, dst) for p in pieces], dim=dim)


def all_reduce_sum(pieces: list[torch.Tensor], dst: torch.device) -> torch.Tensor:
    """The sum of same-shaped pieces on ``dst`` (differentiable)."""
    total = to_device(pieces[0], dst)
    for p in pieces[1:]:
        total = total + to_device(p, dst)
    return total


def broadcast(x: torch.Tensor, devices) -> list[torch.Tensor]:
    """``x`` on each of ``devices`` (differentiable: the gradients of the
    copies sum into ``x``, an all-reduce in the backward pass)."""
    return [to_device(x, d) for d in devices]


def params_on(params: UMXParams, device: torch.device) -> UMXParams:
    """``params`` on ``device``; a field already there is not copied."""
    return UMXParams(**{f.name: to_device(getattr(params, f.name), device)
                        for f in fields(UMXParams)})


def _target_parts(n_targets: int, tp: int) -> None:
    if n_targets % tp:
        raise ValueError(f"tp={tp} does not divide the {n_targets} targets")


def shard_params(params: UMXParams, mesh: Mesh, tp: bool = False) -> np.ndarray:
    """The mesh's (dp, tp) grid of :class:`UMXParams`: every device holds the
    whole tree, or with ``tp`` the slice ``[j·T#/tp : (j+1)·T#/tp]`` of the
    leading target axis of every field (``QTensor`` fields alike).  tp must
    divide T#."""
    if tp:
        _target_parts(params.input_mean.shape[0], mesh.shape["tp"])
    grids = {f.name: shard(getattr(params, f.name), mesh, tp_axis=0 if tp else None)
             for f in fields(UMXParams)}
    out = np.empty(mesh.devices.shape, dtype=object)
    for idx in np.ndindex(*mesh.devices.shape):
        out[idx] = UMXParams(**{name: g[idx] for name, g in grids.items()})
    return out


def batched_lstm_state(cfg: EngineConfig, batch: int, device="cpu") -> LSTMState:
    """Zero LSTM state with a leading batch axis: h/c (batch, T#, L, D, G)."""
    return init_lstm_state(cfg.model, device, batch=batch)


def _grid_mesh(mesh: Mesh, tp: bool) -> Mesh:
    """The part of the grid a sharded pass runs on: the whole grid with
    ``tp``, else its first column (a tp device of a dp row would compute
    the same as the row's first one)."""
    return mesh if tp else Mesh(mesh.devices[:, :1])


def _place(params, audio_batch, states: LSTMState, grid: Mesh, tp: bool):
    """Parameters, audio and states placed on the grid: audio rows split
    over dp, state rows over dp and (with ``tp``) targets over tp."""
    if not isinstance(audio_batch, torch.Tensor):
        audio_batch = torch.from_numpy(np.asarray(audio_batch, np.float32))
    B, dp = audio_batch.shape[0], grid.shape["dp"]
    if B % dp:
        raise ValueError(f"a batch of {B} segments does not split evenly over dp={dp}")
    t_axis = 1 if tp else None
    return (shard_params(params, grid, tp), shard(audio_batch.float(), grid, dp_axis=0),
            shard(states.h, grid, dp_axis=0, tp_axis=t_axis),
            shard(states.c, grid, dp_axis=0, tp_axis=t_axis))


def _forward(placed, cfg: EngineConfig, grid: Mesh, log: list | None = None):
    """The sharded forward on placed inputs → per dp row (waveforms on the
    row's first device, [new state of each tp device])."""
    params_g, audio_g, h_g, c_g = placed
    n_samples = audio_g[0, 0].shape[-1]
    dp, tp = grid.devices.shape
    rows = []
    for i in range(dp):
        parts = []
        for j in range(tp):
            with device_guard(grid.devices[i, j]):
                parts.append(segment_masks(params_g[i, j], audio_g[i, j],
                                           LSTMState(h=h_g[i, j], c=c_g[i, j]), cfg))
        dst = grid.devices[i, 0]
        with device_guard(dst):
            re, im, masks, _ = parts[0]
            if tp > 1:
                masks = all_gather([p[2] for p in parts], dst, dim=1, log=log)
            rows.append((segment_finish(re, im, masks, cfg, n_samples), [p[3] for p in parts]))
    return rows


@torch.inference_mode()
def demix_segments_batch(params: UMXParams, audio_batch, states: LSTMState, cfg: EngineConfig,
                         mesh: Mesh, tp: bool = False):
    """Demix a batch of independent segments split over the mesh's dp axis;
    with ``tp`` the target axis of the weights is split over the tp axis as
    well, and the masks are gathered where they combine.

    audio_batch (B, 2, n) and states h/c (B, T#, L, D, G), B a multiple of
    dp → ((B, T#, 2, n), new states), whole, on the mesh's first device.
    Each dp row runs ``segment_forward_batched`` on its rows; with tp each
    tp device runs the mask network (the recurrence kernel at
    (T#/tp)·D chains), and the row's first device the Wiener filter and
    the iSTFT."""
    grid = _grid_mesh(mesh, tp)
    rows = _forward(_place(params, audio_batch, states, grid, tp), cfg, grid)
    dst = grid.devices[0, 0]
    waves = torch.cat([to_device(w, dst) for w, _ in rows])

    def whole(attr):
        return torch.cat([torch.cat([to_device(getattr(s, attr), dst) for s in sts], dim=1)
                          for _, sts in rows])

    return waves, LSTMState(h=whole("h"), c=whole("c"))


@torch.inference_mode()
def audit_collectives(params: UMXParams, audio_batch, states: LSTMState, cfg: EngineConfig,
                      mesh: Mesh, tp: bool = False) -> list[str]:
    """Run the sharded forward of :func:`demix_segments_batch` and return
    one line per combine between grid devices inside it (kind, source and
    destination devices, bytes).  The dp plan promises none: each device
    runs the whole segment pipeline on its rows; with ``tp`` the masks'
    gather, one per dp row."""
    grid = _grid_mesh(mesh, tp)
    log: list[Combine] = []
    _forward(_place(params, audio_batch, states, grid, tp), cfg, grid, log=log)
    return [str(c) for c in log]
