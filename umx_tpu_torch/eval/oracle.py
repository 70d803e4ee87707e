"""Independent golden oracle of the demix pipeline: the Open-Unmix mask
network on ``torch.nn`` (``TorchUMX``, upstream open-unmix-pytorch's
OpenUnmix module in inference mode) and a straight-line numpy Wiener-EM
(:func:`numpy_wiener_oracle`, a transcription of openunmix's EM math).

It shares no compute code with what it checks: it imports ``torch.nn``,
numpy and the port's ``TARGETS`` constant, and nothing of ``ops/``,
``models/`` or ``engine/``.  Agreement between it and the port is
therefore evidence.  Weights load from the per-target torch-layout state
dicts that the ggml converter consumes, so synthetic and real checkpoints
drive it alike.  It computes wherever its tensors lie; the parity and
golden-inference scripts run it on the host CPU in float32 (the Wiener
oracle in complex128), so that no device library becomes the reference.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from umx_tpu_torch.config import TARGETS


class TorchUMX(nn.Module):
    """One target's mask network (upstream OpenUnmix, inference mode)."""

    def __init__(self, hidden_size: int, nb_bins: int = 1487, nb_output_bins: int = 2049):
        super().__init__()
        self.nb_bins = nb_bins
        self.nb_output_bins = nb_output_bins
        self.hidden_size = hidden_size
        self.fc1 = nn.Linear(nb_bins * 2, hidden_size, bias=False)
        self.bn1 = nn.BatchNorm1d(hidden_size)
        self.lstm = nn.LSTM(
            input_size=hidden_size,
            hidden_size=hidden_size // 2,
            num_layers=3,
            bidirectional=True,
            batch_first=False,
            dropout=0.0,
        )
        self.fc2 = nn.Linear(hidden_size * 2, hidden_size, bias=False)
        self.bn2 = nn.BatchNorm1d(hidden_size)
        self.fc3 = nn.Linear(hidden_size, nb_output_bins * 2, bias=False)
        self.bn3 = nn.BatchNorm1d(nb_output_bins * 2)
        self.input_mean = nn.Parameter(torch.zeros(nb_bins))
        self.input_scale = nn.Parameter(torch.ones(nb_bins))
        self.output_scale = nn.Parameter(torch.ones(nb_output_bins))
        self.output_mean = nn.Parameter(torch.zeros(nb_output_bins))

    @torch.no_grad()
    def load_target_state_dict(self, sd: dict[str, np.ndarray]):
        tensors = {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in sd.items()}
        self.load_state_dict(tensors, strict=False)

    @torch.no_grad()
    def forward(
        self,
        x: torch.Tensor,
        input_scaling: str = "openunmix",
        state=None,
        return_state: bool = False,
    ):
        """x: (T, 2*nb_bins) cropped stacked-stereo magnitudes →
        mask (T, 2*nb_output_bins).

        ``state`` is an optional nn.LSTM (h0, c0) pair carried from a
        previous segment, the reference's streaming LSTM whose arenas
        persist across segments (umx.cpp:167-171, lstm.cpp:82).  With
        ``return_state`` the new (hT, cT) is returned alongside the mask.
        """
        self.eval()
        T = x.shape[0]
        mean = torch.cat([self.input_mean, self.input_mean])
        scale = torch.cat([self.input_scale, self.input_scale])
        if input_scaling == "openunmix":
            x = (x + mean) * scale
        else:
            x = x * scale + mean
        x = self.fc1(x)
        x = self.bn1(x)
        x = torch.tanh(x)
        # nn.LSTM wants (T, batch, feat)
        lstm_out, new_state = self.lstm(x.unsqueeze(1), state)
        x = torch.cat([x, lstm_out.squeeze(1)], dim=-1)
        x = self.fc2(x)
        x = self.bn2(x)
        x = torch.relu(x)
        x = self.fc3(x)
        x = self.bn3(x)
        out_scale = torch.cat([self.output_scale, self.output_scale])
        out_mean = torch.cat([self.output_mean, self.output_mean])
        x = x * out_scale + out_mean
        mask = torch.relu(x).reshape(T, -1)
        return (mask, new_state) if return_state else mask


def _target_models(state_dicts, hidden_size: int, nb_bins: int) -> list[TorchUMX]:
    models = []
    for t in TARGETS:
        m = TorchUMX(hidden_size, nb_bins=nb_bins)
        m.load_target_state_dict(state_dicts[t])
        models.append(m)
    return models


def oracle_masks(
    state_dicts: dict[str, dict[str, np.ndarray]],
    x: np.ndarray,
    hidden_size: int,
    input_scaling: str = "openunmix",
) -> np.ndarray:
    """Masks for all 4 targets, stacked in (bass, drums, other, vocals)
    order: x (T, 2974) → (4, T, 4098)."""
    models = _target_models(state_dicts, hidden_size, x.shape[1] // 2)
    return np.stack([m.forward(torch.from_numpy(x), input_scaling).numpy() for m in models])


def oracle_masks_stream(
    state_dicts: dict[str, dict[str, np.ndarray]],
    xs: list[np.ndarray],
    hidden_size: int,
    input_scaling: str = "openunmix",
) -> list[np.ndarray]:
    """Like :func:`oracle_masks` but over SEQUENTIAL segments with the
    LSTM state carried across boundaries, the reference's streaming LSTM
    semantics (persistent arenas, umx.cpp:167-171 / lstm.cpp:82).
    Returns one stacked (4, T, 4098) mask array per segment."""
    models = _target_models(state_dicts, hidden_size, xs[0].shape[1] // 2)
    states = [None] * len(models)
    outs = []
    for x in xs:
        seg = []
        for i, m in enumerate(models):
            mask, states[i] = m.forward(
                torch.from_numpy(x), input_scaling, state=states[i], return_state=True
            )
            seg.append(mask.numpy())
        outs.append(np.stack(seg))
    return outs


def numpy_wiener_oracle(mix, mags, iterations=1, eps=1e-10, scale_factor=10.0, psd="correct"):
    """Straight-line numpy EM, written independently of the port's.

    mix: (2, T, F) complex; mags: (S, 2, T, F) float.
    ``psd="umxcpp"`` reproduces the reference's PSD quirk
    (wiener.cpp:185-204: v = mean_c ((re+im))^2 instead of |y|^2).
    """
    S = mags.shape[0]
    F = mix.shape[2]

    angle = np.angle(mix)  # (2, T, F)
    y = mags * np.exp(1j * angle)[None]  # (S, 2, T, F)

    max_abs = max(1.0, float(np.abs(mix).max()) / scale_factor)
    x = mix / max_abs
    y = y / max_abs

    for _ in range(iterations):
        # PSD: average |y|^2 over channels -> (S, T, F)
        if psd == "umxcpp":
            v = np.mean((y.real + y.imag) ** 2, axis=1)
        else:
            v = np.mean(np.abs(y) ** 2, axis=1)
        # spatial covariance per source: (S, F, 2, 2)
        R = np.zeros((S, F, 2, 2), np.complex128)
        for s in range(S):
            for c1 in range(2):
                for c2 in range(2):
                    R[s, :, c1, c2] = np.sum(y[s, c1] * np.conj(y[s, c2]), axis=0)
            R[s] /= eps + np.sum(v[s], axis=0)[:, None, None]
        # mix covariance (T, F, 2, 2), regularized once
        Cxx = np.sqrt(eps) * np.eye(2)[None, None]
        Cxx = Cxx + np.einsum("stf,sfcd->tfcd", v, R)
        inv = np.linalg.inv(Cxx)
        y_new = np.zeros_like(y)
        for s in range(S):
            gain = np.einsum("fck,tfkd->tfcd", R[s], inv) * v[s][..., None, None]
            # y_s(c) = sum_d gain(c, d) * x(d)
            y_new[s] = np.einsum("tfcd,dtf->ctf", gain, x)
        y = y_new

    return (y * max_abs).astype(np.complex64)
