"""The numbers compared with the reference, each held against its limit."""

from __future__ import annotations

import math
import statistics

import numpy as np


def stem_rel_l1(candidates: list, references: list) -> float:
    """The worst track's mean absolute error of its stems relative to the
    reference's mean absolute value: max_i Σ |c_i − r_i| / Σ |r_i|.  A
    missing, misshapen or non-finite answer reads infinity.

    The absolute error, not the squared one: the bfloat16 seams round both
    sides, and where their inputs differ by little they round to the same
    value but at a few elements, which differ by a whole bfloat16 step.  A
    squared error weighs those few as heavily as an error spread over
    every element; the absolute error grows with how many elements moved,
    so it tells a sound run from one in a lower precision."""
    worst = 0.0
    for c, r in zip(candidates, references, strict=True):
        if c is None or np.shape(c) != np.shape(r) or not np.all(np.isfinite(c)):
            return math.inf
        c64, r64 = np.asarray(c, np.float64), np.asarray(r, np.float64)
        worst = max(worst, float(np.abs(c64 - r64).sum()) / max(float(np.abs(r64).sum()), 1e-30))
    return worst


def loss_gap(candidate: list, reference: list) -> float:
    """The worst step's |loss − reference| / |reference|."""
    if len(candidate) != len(reference) or not all(map(math.isfinite, candidate)):
        return math.inf
    return max(abs(c - r) / abs(r) for c, r in zip(candidate, reference))


def norm_gap(candidate: dict, reference: dict, leaves=None) -> tuple[float, str]:
    """The worst leaf's gap of norms, |‖c‖ − ‖r‖|, over the larger of the
    reference's norm of that leaf and of the median leaf; and that leaf.
    ``leaves`` limits the leaves taken (all of ``reference`` by default)."""
    leaves = sorted(reference) if leaves is None else sorted(leaves)
    median = statistics.median(reference[k] for k in reference)
    worst, where = 0.0, ""
    for k in leaves:
        c = candidate.get(k, math.nan)
        gap = abs(c - reference[k]) / max(reference[k], median, 1e-30)
        if not math.isfinite(gap):
            return math.inf, k
        if gap > worst:
            worst, where = gap, k
    return worst, where


def gap_profile(candidate, reference, block: int) -> dict:
    """Where one track's error lies: its relative absolute error whole, by
    stem, and over blocks of ``block`` samples (the median, the 90th
    percentile, the largest), with the track's length and its relative RMS
    error."""
    c, r = np.asarray(candidate, np.float64), np.asarray(reference, np.float64)

    def rel(a, b):
        return float(np.abs(a - b).sum()) / max(float(np.abs(b).sum()), 1e-30)

    n = r.shape[-1] // block
    blocks = [rel(c[..., i * block:(i + 1) * block], r[..., i * block:(i + 1) * block])
              for i in range(n)] or [rel(c, r)]
    rms = math.sqrt(float(np.sum((c - r) ** 2)) / max(float(np.sum(r ** 2)), 1e-30))
    return {"samples": int(r.shape[-1]), "whole": rel(c, r), "rel_rms": rms,
            "stems": [rel(c[j], r[j]) for j in range(r.shape[0])],
            "block_median": float(np.median(blocks)), "block_p90": float(np.percentile(blocks, 90)),
            "block_max": max(blocks), "first_blocks": blocks[:4]}
