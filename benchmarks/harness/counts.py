"""Operations and bytes counted from shapes and stated dtypes.

The yardstick of the per-layer metrics.  Every count here follows from a
configuration file's sizes and the work a run completed; none reads the
system's own tensors, so it holds whatever implements a layer.  Bytes
count each input read once and each output written once.  The peaks are
``peaks.json``'s.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())
F32, BF16 = 4, 2


def frames(samples: int, hop: int) -> int:
    """Frames of a centered STFT over ``samples``."""
    return samples // hop + 1


def geometry(cfg: dict) -> dict:
    """Segment, stride and shift in samples, and a segment's frames."""
    sr = cfg["sample_rate"]
    seg = int(cfg["segment_secs"] * sr)
    return {
        "seg": seg,
        "stride": int((1.0 - cfg["overlap"]) * seg),
        "max_shift": int(cfg["max_shift_secs"] * sr) if cfg["shifts"] > 0 else 0,
        "seg_frames": frames(seg, cfg["n_hop"]),
    }


def track_chunks(samples: int, cfg: dict) -> int:
    """Segments a track of ``samples`` runs: its length with the shift pad,
    cut at the stride."""
    g = geometry(cfg)
    return max(1, math.ceil((samples + g["max_shift"]) / g["stride"]))


def model_flops_per_frame(cfg: dict) -> int:
    """Multiply-adds × 2 of the mask network for one frame, all targets:
    fc1, each BLSTM layer's input and recurrent products in both
    directions, fc2, fc3 (the elementwise work is not counted)."""
    H, G = cfg["hidden_size"], cfg["hidden_size"] // 2
    C, F, O = cfg["nb_channels"], cfg["max_bin"], cfg["nb_output_bins"]
    per_target = C * F * H + 2 * H * H + H * C * O
    per_target += cfg["nb_layers"] * 2 * (H * 4 * G + G * 4 * G)
    return 2 * len(cfg["targets"]) * per_target


def train_step_flops(cfg: dict) -> float:
    """Model FLOPs of one training step at the configuration's recipe:
    3 × the forward's (the backward's two products a forward product)."""
    rc = cfg["train"]
    return 3.0 * rc["batch_size"] * rc["seq_len"] * model_flops_per_frame(cfg)


def recurrence_call(cfg: dict, rows: int, steps: int) -> tuple[float, float]:
    """Operations and bytes of one inference layer of the recurrence over
    all targets' chains and both directions (R = T#·D), ``rows`` rows a
    chain and ``steps`` steps: the products of bf16 h and W_hh; reads the
    f32 input projections, W_hh in bf16 and the f32 h0 and c0, writes the
    f32 hs, hT and cT."""
    G, R = cfg["hidden_size"] // 2, 2 * len(cfg["targets"])
    ops = 2.0 * rows * R * steps * G * 4 * G
    nbytes = (rows * R * steps * 4 * G * F32 + R * G * 4 * G * BF16
              + rows * R * steps * G * F32 + 4 * rows * R * G * F32)
    return ops, nbytes


def recurrence_train_layer(cfg: dict, rows: int, steps: int) -> tuple[float, float]:
    """Operations and bytes of one layer of the recurrence's forward and
    backward in training (R = T#·D chains, ``rows`` rows a chain): the
    forward product, the backward's dh and dW products, all on bf16
    operands; reads the f32 input projections, W_hh in bf16, the f32
    output gradients; writes the f32 hs, the f32 input-projection
    gradients and the f32 dW_hh.  The initial state is zero and has no
    gradient that is used."""
    G, R = cfg["hidden_size"] // 2, 2 * len(cfg["targets"])
    ops = 3 * 2.0 * rows * R * steps * G * 4 * G
    nbytes = (rows * R * steps * 4 * G * F32 * 2  # xp in, dxp out
              + rows * R * steps * G * F32 * 2  # hs out, dhs in
              + R * G * 4 * G * (BF16 + F32))  # W_hh in, dW_hh out
    return ops, nbytes


def wiener_segment(cfg: dict, frames_: int) -> tuple[float, float]:
    """Operations and bytes of the Wiener EM of one segment (4 sources,
    stereo, ``frames_`` × bins, one iteration as the configuration states
    it): reads the bf16 masks and the f32 mix planes, writes the bf16
    estimates.  Operations (f32, per frame and bin): the first estimates
    (2 a source and channel), each source's PSD and 2×2 covariance sums
    (10 a source), the mix covariance (8 a source), its inverse (14) and
    the new estimates (16 a source and channel): a lower count."""
    S, C, F = len(cfg["targets"]), cfg["nb_channels"], cfg["nb_output_bins"]
    tf = frames_ * F
    ops = tf * (S * C * 2 + S * 10 + S * 8 + 14 + S * C * 16)
    nbytes = tf * (S * C * BF16 + C * 2 * F32 + S * C * 2 * BF16)
    return float(ops), float(nbytes)


def least_time(ops: float, nbytes: float, op_peak: str) -> float:
    """The least time of ``ops`` at the named peak and ``nbytes`` at the
    memory's bandwidth, the larger."""
    return max(ops / PEAKS[op_peak], nbytes / PEAKS["hbm_bytes_per_s"])
