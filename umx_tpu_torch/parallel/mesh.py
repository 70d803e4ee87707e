"""Device mesh: a (dp, tp) grid of devices driven by one process
(counterpart of ``umx_tpu.parallel.mesh``).

The JAX mesh is single-controller: one process holds a grid of its local
devices and callers pass and get back whole arrays.  Its counterpart here
is a grid of ``torch.device`` s in one process.  Parameters are placed on
the grid's devices, batch rows go to the dp devices and target slices to
the tp devices; every combine between devices inside a forward pass is an
explicit copy in a named helper of :mod:`umx_tpu_torch.parallel.sharding`.
One process per host sits above it (``parallel/multihost.py``).

Axes:

* ``dp``: data parallel, independent tracks or segments over devices.  A
  track's forward needs nothing from another device, so dp is the
  throughput axis of the fleet.
* ``tp``: model parallel over the 4 separation targets: each device holds
  4/tp targets' weights.  The only combine is the gather of the
  per-target masks before the Wiener filter.

A device may repeat in the grid (``[torch.device("cpu")] * 8`` in the
tests, ``[cuda:0] * 4`` to run the mesh paths on one card): a tensor
moved to the device it is on is not copied.
"""

from __future__ import annotations

import numpy as np
import torch


class Mesh:
    """A (dp, tp) grid of devices.  ``devices`` is a numpy object array of
    ``torch.device``, ``shape`` is ``{"dp": dp, "tp": tp}`` and
    ``axis_names`` is ``("dp", "tp")``, as for a JAX mesh."""

    axis_names = ("dp", "tp")

    def __init__(self, devices: np.ndarray):
        if devices.ndim != 2 or devices.size == 0:
            raise ValueError(f"a mesh needs a non-empty (dp, tp) grid, got shape {devices.shape}")
        self.devices = devices

    @property
    def shape(self) -> dict[str, int]:
        dp, tp = self.devices.shape
        return {"dp": dp, "tp": tp}

    def distinct_devices(self) -> list[torch.device]:
        """The grid's devices without repeats, in grid order."""
        return list(dict.fromkeys(self.devices.flat))


def _indexed(device) -> torch.device:
    """``torch.device`` with the current index filled in for a bare "cuda",
    so that equal devices compare equal."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(dp: int | None = None, tp: int = 1, devices=None) -> Mesh:
    """A (dp, tp) mesh over the first dp·tp of ``devices``; with ``dp`` None,
    dp is n // tp.  ``devices=None`` means every CUDA device, and raises
    where there is none: a CPU mesh is built only from CPU devices named
    by the caller."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no devices given and torch.cuda.is_available() is "
                               "False; name the devices (e.g. [torch.device('cpu')]) to use others")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [_indexed(d) for d in devices]
    n = len(devices)
    if dp is None:
        if tp < 1 or n % tp:
            raise ValueError(f"{n} devices not divisible by tp={tp}")
        dp = n // tp
    if dp < 1 or tp < 1:
        raise ValueError(f"mesh {dp}x{tp}: both axes must be at least 1")
    if dp * tp > n:
        raise ValueError(f"mesh {dp}x{tp} needs {dp * tp} devices, have {n}")
    grid = np.empty((dp, tp), dtype=object)
    for k, dev in enumerate(devices[: dp * tp]):
        grid[k // tp, k % tp] = dev
    return Mesh(grid)


def to_device(x, device: torch.device):
    """``x`` (a tensor or a ``QTensor``) on ``device``; no copy where it is
    there already."""
    if isinstance(x, torch.Tensor):
        return x.to(device, non_blocking=True)
    return x.to(device)


def _part(x, axis: int, k: int, parts: int, what: str):
    """Part ``k`` of ``parts`` even parts of ``x`` along ``axis``."""
    n = x.shape[axis]
    if n % parts:
        raise ValueError(f"axis {axis} of size {n} does not split evenly over {what}={parts}")
    step = n // parts
    return x[(slice(None),) * axis + (slice(k * step, (k + 1) * step),)]


def shard(x, mesh: Mesh, dp_axis: int | None = None, tp_axis: int | None = None) -> np.ndarray:
    """The (dp, tp) grid of ``x`` placed on the mesh: device (i, j) holds
    part i of ``dp_axis`` split over dp and part j of ``tp_axis`` split over
    tp (an axis left None is not split).  Each distinct part is copied to
    each distinct device once; a part already on its device is not copied.
    ``x`` is a tensor or a ``QTensor`` (split on its leading axes only)."""
    dp, tp = mesh.devices.shape
    placed: dict = {}
    out = np.empty((dp, tp), dtype=object)
    for (i, j), dev in np.ndenumerate(mesh.devices):
        key = (i if dp_axis is not None else 0, j if tp_axis is not None else 0, dev)
        if key not in placed:
            y = x
            if dp_axis is not None:
                y = _part(y, dp_axis, i, dp, "dp")
            if tp_axis is not None:
                y = _part(y, tp_axis, j, tp, "tp")
            placed[key] = to_device(y, dev)
        out[i, j] = placed[key]
    return out


def replicated(mesh: Mesh):
    """Placement: the whole tensor on every device of the grid."""
    return lambda x: shard(x, mesh)


def dp_sharding(mesh: Mesh, axis: int = 0):
    """Placement: ``axis`` split evenly over dp; device (i, j) holds part i."""
    return lambda x: shard(x, mesh, dp_axis=axis)


def tp_sharding(mesh: Mesh, axis: int = 0):
    """Placement: ``axis`` split evenly over tp; device (i, j) holds part j."""
    return lambda x: shard(x, mesh, tp_axis=axis)
