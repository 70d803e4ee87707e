"""The program's own spans on the device trace's clock.

``umx_tpu_torch`` marks its stages with ``umx.`` spans
(``utils.profiling.span``: a ``record_function`` while a profiler
records), so they lie on the kineto timeline beside the kernels and
copies.  From the raw events of a traced window (``bench.window``):

- ``idle_by_span``: each idle gap of the window, as ``trace.summarize``
  finds them, given to the innermost ``umx.`` span open at its middle
  (the aten operations inside it are not looked at); ``OUTSIDE`` where no
  ``umx.`` span is open;
- ``device_by_span``: each kernel, copy and set inside the window,
  clipped to it, given to the innermost ``umx.`` span open when it was
  launched, ``OUTSIDE`` where none was.  The launch is the CUDA runtime
  or driver call (``cuda*``, ``cu*``) with the record's correlation id,
  else the host operation whose correlation id is the record's linked
  one: the two calls number their correlation ids apart.  The match
  is by time whatever the thread: autograd launches the backward from
  its own thread while ``umx.train.backward`` is open on the caller's;
- ``unlinked_s``: the device time whose launch was not found (events
  without correlation ids count here).

``idle_pct`` and ``device_ms`` give no number where the window holds no
``umx.`` span, and ``device_ms`` none where more than ``MAX_UNLINKED`` of
the device time is unlinked.  ``trace.Trace`` keeps no raw events, so the
benchmark's readers cannot reach ``summarize``; what they read of the
spans is ``host_idle_pct``, from ``Trace.idle_by_host``.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

from benchmarks.harness import trace

PREFIX = "umx."
OUTSIDE = "outside the program"
MAX_UNLINKED = 0.10
RUNTIME = re.compile(r"cu(da)?[A-Z]\w*")  # cudaLaunchKernel, cuLaunchKernelEx
HOST = ("umx.prepare", "umx.to_host", "umx.combine")
PROGRAM = ("umx.program",)
BACKWARD = "umx.train.backward"
OPTIMIZER = "umx.train.optimizer"


@dataclass
class Program:
    window_s: float
    device_s: float
    unlinked_s: float
    idle_by_span: dict = field(default_factory=dict)
    device_by_span: dict = field(default_factory=dict)

    @property
    def unlinked_share(self) -> float:
        return self.unlinked_s / self.device_s if self.device_s > 0 else 0.0


def _get(e, method: str):
    """``e.<method>()``, or None where the event has no such method."""
    fn = getattr(e, method, None)
    return fn() if fn is not None else None


def _named(by: dict) -> dict:
    return {(OUTSIDE if k == "host outside any operation" else k): v for k, v in by.items()}


def summarize(events) -> Program | None:
    """The window's time by program span, or None where the window, its
    device work or its ``umx.`` spans are missing."""
    from torch.autograd import DeviceType

    window = None
    device, spans = [], []
    runtime, ops = {}, {}  # correlation id -> the launching call's start
    for e in events:
        name = e.name()
        start, end = e.start_ns() * 1e-9, e.end_ns() * 1e-9
        if e.device_type() == DeviceType.CUDA:
            if e.is_user_annotation() or ("#" in name and "(" not in name):
                continue  # as trace.summarize: annotations' ranges are not work
            device.append((start, end, _get(e, "correlation_id"),
                           _get(e, "linked_correlation_id")))
            continue
        if name == trace.WINDOW:
            window = (start, end)
            continue
        if name.startswith(PREFIX):
            spans.append((start, end, name))
        cid = _get(e, "correlation_id")
        if not cid:
            continue
        if RUNTIME.fullmatch(name):
            runtime[cid] = start
        elif not _get(e, "linked_correlation_id"):
            ops[cid] = start
    if window is None:
        return None
    t0, t1 = window
    spans = [sp for sp in spans if sp[1] > t0 and sp[0] < t1]
    inside = [(max(s, t0), min(e, t1), c, lc) for s, e, c, lc in device if e > t0 and s < t1]
    if not spans or not inside:
        return None
    _, merged = trace.union_length([(s, e) for s, e, _, _ in inside])
    idle = trace.attribute(trace.idle_gaps(merged, t0, t1), spans)
    # a record becomes an interval of its own length centred on its launch,
    # so that ``attribute`` gives its time to the span open at the launch
    launched, unlinked = [], 0.0
    for s, e, c, lc in inside:
        at = runtime.get(c) if c else None
        if at is None and lc:
            at = ops.get(lc)
        if at is None:
            unlinked += e - s
        else:
            launched.append((at - (e - s) / 2, at + (e - s) / 2))
    return Program(window_s=t1 - t0, device_s=sum(e - s for s, e, _, _ in inside),
                   unlinked_s=unlinked, idle_by_span=_named(idle),
                   device_by_span=_named(trace.attribute(launched, spans)))


def idle_pct(program: Program | None, names) -> float | None:
    """The share of the window that is idle with one of ``names`` the
    innermost program span."""
    if program is None:
        return None
    return 100.0 * sum(program.idle_by_span.get(n, 0.0) for n in names) / program.window_s


def device_ms(program: Program | None, name: str, count: int) -> float | None:
    """The device time launched under span ``name``, in ms per one of
    ``count`` (a training step), where the launches were found."""
    if (program is None or count <= 0 or program.unlinked_share > MAX_UNLINKED
            or name not in program.device_by_span):
        return None
    return 1e3 * program.device_by_span[name] / count


def host_idle_pct(tr) -> float | None:
    """The share of a ``trace.Trace``'s window that is idle with
    ``umx.prepare``, ``umx.to_host`` or ``umx.combine`` the innermost host
    operation (``idle_by_host``: an aten operation inside one of them keeps
    its own idle), or None without a trace or where no ``umx.`` span
    holds idle."""
    if tr is None or not any(n.startswith(PREFIX) for n in tr.idle_by_host):
        return None
    return 100.0 * sum(tr.idle_by_host.get(n, 0.0) for n in HOST) / tr.window_s
