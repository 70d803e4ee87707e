"""The device trace of a window, and what the per-layer readers take from it.

A traced run records the window under ``torch.profiler`` (CPU and CUDA
activities) and reads the raw events from memory: nothing is written to
disk.  The window is the harness's own span ``bench.window``.  From the
kernels, copies and sets on the device inside it:

- ``busy_s``: the length of the union of their intervals (overlapping
  work on several streams counts once), so the idle share is 1 − the
  union over the window, not 1 − the sum;
- ``by_kind``: device time by kind of work, the kinds and their name
  patterns from ``kernels.json``;
- ``device_ops``: device time by operation name;
- ``idle_by_host``: each idle gap inside the window, attributed to the
  innermost host operation running at its middle, summed by name.
"""

from __future__ import annotations

import contextlib
import heapq
import json
import re
from dataclasses import dataclass, field
from pathlib import Path

WINDOW = "bench.window"
KINDS = [(k, re.compile(p)) for k, p in
         json.loads((Path(__file__).resolve().parent / "kernels.json").read_text())["kinds"]]


@dataclass
class Trace:
    window_s: float
    busy_s: float
    by_kind: dict = field(default_factory=dict)
    device_ops: dict = field(default_factory=dict)
    idle_by_host: dict = field(default_factory=dict)
    events: int = 0

    def kind_s(self, kind: str) -> float:
        return self.by_kind.get(kind, 0.0)


def kind_of(name: str) -> str:
    for kind, pattern in KINDS:
        if pattern.search(name):
            return kind
    return "other"


def union_length(intervals: list[tuple[float, float]]) -> tuple[float, list]:
    """The length of the union of (start, end) intervals, and the merged
    intervals in order."""
    merged: list[list[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), [tuple(m) for m in merged]


def idle_gaps(merged: list, t0: float, t1: float) -> list[tuple[float, float]]:
    """The gaps between merged busy intervals inside [t0, t1]."""
    gaps, cursor = [], t0
    for s, e in merged:
        if s > cursor:
            gaps.append((cursor, min(s, t1)))
        cursor = max(cursor, e)
    if cursor < t1:
        gaps.append((cursor, t1))
    return [(s, e) for s, e in gaps if e > s]


def attribute(gaps: list, host: list[tuple[float, float, str]]) -> dict:
    """Idle seconds by the innermost host operation covering each gap's
    middle (the one that started last); "host outside any operation"
    where none does."""
    out: dict[str, float] = {}
    host = sorted(host)
    active: list = []  # heap of (-start, end, name)
    i = 0
    for s, e in sorted(gaps, key=lambda g: (g[0] + g[1]) / 2):
        mid = (s + e) / 2
        while i < len(host) and host[i][0] <= mid:
            heapq.heappush(active, (-host[i][0], host[i][1], host[i][2]))
            i += 1
        # what ended before this middle ended before every later one; the
        # top is then the latest started operation still open
        while active and active[0][1] < mid:
            heapq.heappop(active)
        name = active[0][2] if active else "host outside any operation"
        out[name] = out.get(name, 0.0) + (e - s)
    return out


def short(name: str, n: int = 96) -> str:
    """An operation's name without ``void``, anonymous namespaces and its
    argument list, at most ``n`` characters."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    head = name.split("(", 1)[0].strip() or name
    return head[:n]


def summarize(events) -> tuple[Trace | None, str]:
    """A :class:`Trace` from the profiler's raw events, or None and why."""
    from torch.autograd import DeviceType

    window = None
    device, host = [], []
    for e in events:
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if e.is_user_annotation() or ("#" in name and "(" not in name):
                continue  # an annotation's range would count its kernels twice
            device.append((e.start_ns() * 1e-9, e.end_ns() * 1e-9, name))
        else:
            if name == WINDOW:
                window = (e.start_ns() * 1e-9, e.end_ns() * 1e-9)
            host.append((e.start_ns() * 1e-9, e.end_ns() * 1e-9, name))
    if window is None:
        return None, f"the trace holds no {WINDOW} span"
    t0, t1 = window
    inside = [(max(s, t0), min(e, t1), n) for s, e, n in device if e > t0 and s < t1]
    if not inside:
        return None, "the profiler saw no device activity in the window"
    busy, merged = union_length([(s, e) for s, e, _ in inside])
    tr = Trace(window_s=t1 - t0, busy_s=busy, events=len(inside))
    for s, e, n in inside:
        k = kind_of(n)
        tr.by_kind[k] = tr.by_kind.get(k, 0.0) + (e - s)
        key = short(n)
        tr.device_ops[key] = tr.device_ops.get(key, 0.0) + (e - s)
    host = [(s, e, short(n)) for s, e, n in host if n != WINDOW and e > t0 and s < t1]
    tr.idle_by_host = attribute(idle_gaps(merged, t0, t1), host)
    return tr, ""


def top(d: dict, n: int = 10) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


class Recorder:
    """The traced window's profiler, or nothing when tracing is off."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None

    @contextlib.contextmanager
    def window(self):
        """Record the block as the window span, under the profiler when
        tracing is on."""
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        if not self.enabled:
            yield
            return
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            with record_function(WINDOW):
                yield
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        self.prof = prof

    def summary(self) -> tuple[Trace | None, str]:
        if self.prof is None:
            return None, "tracing was off"
        return summarize(self.prof.profiler.kineto_results.events())


def span(name: str):
    """A host span of the harness's own, around a call into the system."""
    from torch.profiler import record_function

    return record_function(name)
