"""The arithmetic the per-layer readers share.  Each takes a
``run.Reading`` and gives a number, or None where it finds nothing to
read (no trace, no device time of the kind, no count)."""

from __future__ import annotations

from benchmarks.harness import counts


def idle_pct(r):
    """The device's idle share of the traced window: 1 − the union of its
    kernels, copies and sets over the window."""
    if r.trace is None:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)


def kind_pct(r, kind: str):
    """Device time of one kind of work over the traced window."""
    if r.trace is None or r.trace.kind_s(kind) <= 0.0:
        return None
    return 100.0 * r.trace.kind_s(kind) / r.trace.window_s


def mfu(r, flops: float):
    """``flops`` over the traced window at the bf16 peak."""
    if r.trace is None or flops <= 0:
        return None
    return 100.0 * flops / (r.trace.window_s * counts.PEAKS["bf16_flops_per_s"])


def demix_flops(r) -> float:
    """The mask network's FLOPs over the frames the window's segments ran."""
    return r.work["frames"] * counts.model_flops_per_frame(r.config)


def roofline_pct(r, kind: str, least_s: float):
    """A layer's least time over its kernels' device time."""
    if r.trace is None or r.trace.kind_s(kind) <= 0.0 or least_s <= 0.0:
        return None
    return 100.0 * least_s / r.trace.kind_s(kind)


def recurrence_least_s(r) -> float:
    """The least time of the window's inference recurrence calls."""
    total = 0.0
    for rows, calls in r.work["recurrence_calls"].items():
        ops, nbytes = counts.recurrence_call(r.config, rows, r.work["steps"])
        total += calls * counts.least_time(ops, nbytes, "bf16_flops_per_s")
    return total


def wiener_least_s(r) -> float:
    """The least time of the window's Wiener EM, a segment at a time."""
    ops, nbytes = counts.wiener_segment(r.config, r.work["steps"])
    return r.work["segments"] * counts.least_time(ops, nbytes, "f32_flops_per_s")


def recurrence_train_least_s(r) -> float:
    """The least time of the window's training recurrence, forward and
    backward, every layer of every step."""
    ops, nbytes = counts.recurrence_train_layer(r.config, r.work["batch"], r.work["steps"])
    per_step = r.config["nb_layers"] * counts.least_time(ops, nbytes, "bf16_flops_per_s")
    return r.work["train_steps"] * per_step


def fleet(r, key: str):
    """One of the fleet runner's own ``stats``, summed over the window's
    calls (read in the traced run only: its syncs perturb the timing)."""
    stats = r.work.get("fleet")
    return None if not stats or key not in stats else stats[key]
