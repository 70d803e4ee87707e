"""Multi-process input distribution for fleet runs (counterpart of
``umx_tpu.parallel.multihost``, on ``torch.distributed``).

A track's forward pass needs no collective at all, so the only problem
past one process is *input distribution*: hand each process its own
slice of the track list and let every process run the ordinary fleet
(``engine/fleet.py::demix_tracks``) on its devices: one card, or a mesh
of the cards it sees (``parallel/mesh.py``).  The process group carries
nothing but the final metric gather; audio never crosses processes.

    process 0: tracks 0, P, 2P, ...
    process 1: tracks 1, P+1, ...      (P = process count)

Every function degrades to one process (no process group, or a group of
world size 1), so the same code path runs everywhere; the tests drive
the partitioning with explicit process ids.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np


def _group():
    """``torch.distributed`` when a process group is up, else None."""
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def _rank() -> int:
    dist = _group()
    return dist.get_rank() if dist is not None else 0


def _world_size() -> int:
    dist = _group()
    return dist.get_world_size() if dist is not None else 1


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Join a ``torch.distributed`` process group for a multi-process run.

    Call once per process with ``coordinator_address`` (``host:port``, or
    an init URL such as ``tcp://host:port`` or ``file:///path``), the
    process count and this process's id; without an address the
    ``MASTER_ADDR``/``WORLD_SIZE``/``RANK`` environment is read, and
    without that either this is a single-process run.  The backend is
    NCCL where CUDA is available, gloo otherwise.  A group that is
    already up is kept.  Returns True when a group of more than
    one process is up after the call, so callers need no branching."""
    import torch
    import torch.distributed as dist

    if not dist.is_available():
        return False
    if not dist.is_initialized():
        if coordinator_address is None and "MASTER_ADDR" not in os.environ:
            return False
        init_method = coordinator_address
        if init_method is not None and "://" not in init_method:
            init_method = f"tcp://{init_method}"
        dist.init_process_group(
            "nccl" if torch.cuda.is_available() else "gloo",
            init_method=init_method,
            world_size=-1 if num_processes is None else num_processes,
            rank=-1 if process_id is None else process_id,
        )
    return dist.get_world_size() > 1


def partition_tracks(
    n_tracks: int, process_id: int | None = None, process_count: int | None = None
) -> list[int]:
    """Global track indices owned by this process: round-robin
    ``[pid, pid+P, pid+2P, ...]``, balanced to within one track and
    independent of the track lengths.  The defaults are this process's
    rank and the group's size (0 of 1 without a process group)."""
    pid = _rank() if process_id is None else process_id
    num = _world_size() if process_count is None else process_count
    if not 0 <= pid < num:
        raise ValueError(f"process_id {pid} out of range for {num} processes")
    return list(range(pid, n_tracks, num))


@dataclass
class MultihostFleetResult:
    """Local results plus the bookkeeping to reassemble globally."""

    # global index -> (n_targets, 2, n_i) stems, for THIS process's tracks
    local: dict[int, np.ndarray]
    process_id: int
    process_count: int

    def owned_indices(self) -> list[int]:
        return sorted(self.local)


def demix_tracks_multihost(
    sep_or_params,
    tracks: list,
    cfg=None,
    seeds: list[int] | None = None,
    process_id: int | None = None,
    process_count: int | None = None,
    mesh=None,
) -> MultihostFleetResult:
    """Fleet demix of this process's share of a track list.

    ``tracks`` is the GLOBAL list, the same in every process; an entry may
    be a (2, n) array or a callable that loads it, called only for the
    tracks this process owns.  ``sep_or_params``, ``cfg`` and ``mesh`` are
    those of :func:`umx_tpu_torch.engine.fleet.demix_tracks` (a
    ``Separator``, or parameters already on their device), which demixes
    the owned tracks; nothing is transferred between processes.

    ``mesh`` defaults to a dp mesh over the cards this process sees when
    the parameters are on a card and it sees more than one.  A launcher
    that runs one process per card gives each process one visible card
    (``CUDA_VISIBLE_DEVICES``), so there the default stays one device."""
    import torch

    from umx_tpu_torch.engine.fleet import demix_tracks
    from umx_tpu_torch.engine.separator import Separator
    from umx_tpu_torch.parallel.mesh import make_mesh

    pid = _rank() if process_id is None else process_id
    num = _world_size() if process_count is None else process_count
    owned = partition_tracks(len(tracks), pid, num)

    local_tracks = []
    for i in owned:
        t = tracks[i]
        t = t() if callable(t) else t  # lazy loader support
        local_tracks.append(np.asarray(t, np.float32))

    params = sep_or_params.params if isinstance(sep_or_params, Separator) else sep_or_params
    if mesh is None and params.input_mean.is_cuda and torch.cuda.device_count() > 1:
        mesh = make_mesh()

    local_seeds = [seeds[i] for i in owned] if seeds is not None else None
    outs = demix_tracks(sep_or_params, local_tracks, cfg, seeds=local_seeds, mesh=mesh)
    return MultihostFleetResult(
        local=dict(zip(owned, outs)), process_id=pid, process_count=num
    )


def allgather_metrics(values: dict[int, float]) -> dict[int, float]:
    """Combine per-track scalar metrics (e.g. SDR) across processes into
    the full global dict in EVERY process: the one collective of a fleet
    run, a few floats per track.  One process: identity.  Several:
    ``torch.distributed.all_gather_object`` of each process's dict."""
    dist = _group()
    if dist is None or dist.get_world_size() == 1:
        return dict(values)
    parts: list = [None] * dist.get_world_size()
    dist.all_gather_object(parts, {int(k): float(v) for k, v in values.items()})
    out: dict[int, float] = {}
    for part in parts:
        out.update(part)
    return out
