"""Open-Unmix mask-prediction network in PyTorch.

Per target: crop+stack stereo magnitudes → input norm → fc1 → bn1 →
tanh → 3-layer bidirectional LSTM → skip-concat [x, lstm] → fc2 → bn2 →
ReLU → fc3 → bn3 → output norm → ReLU = mask.

All four targets' weights are stacked on a leading axis (the layouts of
``umx_tpu.models.umx.UMXParams``), so the fc layers run as batched
matmuls over targets.  The LSTM input projections run outside the
recurrence as one f32 batched matmul per layer; the recurrence of all
targets × directions runs as one merged kernel call per layer
(``ops/lstm_cuda.py``).  The backward direction is the forward
recurrence over the time-reversed sequence, so its state, like the
forward one's, carries across segments (the reference's streaming LSTM).

Float32 matmuls stay full float32 on the GPU (no TF32): the separator
sets ``torch.backends.cuda.matmul.allow_tf32 = False``.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

from umx_tpu_torch.config import TARGETS, ModelConfig
from umx_tpu_torch.ops.lstm_cuda import lstm_layer_merged


@dataclass
class UMXParams:
    """UMX weights for all targets, stacked on a leading target axis
    (float32 tensors).  T#=4 targets, F=2974 features, H=hidden_size,
    L=3 layers, D=2 directions, G=H/2, O=4098 outputs."""

    input_mean: torch.Tensor  # (T#, F)
    input_scale: torch.Tensor  # (T#, F)
    fc1_w: torch.Tensor  # (T#, F, H) — applied as x @ fc1_w
    bn1_w: torch.Tensor  # (T#, H)
    bn1_b: torch.Tensor  # (T#, H)
    bn1_rm: torch.Tensor  # (T#, H)
    bn1_rv: torch.Tensor  # (T#, H)
    lstm_ih_w: torch.Tensor  # (T#, L, D, H, 4G)
    lstm_hh_w: torch.Tensor  # (T#, L, D, G, 4G)
    lstm_ih_b: torch.Tensor  # (T#, L, D, 4G)
    lstm_hh_b: torch.Tensor  # (T#, L, D, 4G)
    fc2_w: torch.Tensor  # (T#, 2H, H)
    bn2_w: torch.Tensor  # (T#, H)
    bn2_b: torch.Tensor  # (T#, H)
    bn2_rm: torch.Tensor  # (T#, H)
    bn2_rv: torch.Tensor  # (T#, H)
    fc3_w: torch.Tensor  # (T#, H, O)
    bn3_w: torch.Tensor  # (T#, O)
    bn3_b: torch.Tensor  # (T#, O)
    bn3_rm: torch.Tensor  # (T#, O)
    bn3_rv: torch.Tensor  # (T#, O)
    output_scale: torch.Tensor  # (T#, O)
    output_mean: torch.Tensor  # (T#, O)


@dataclass
class LSTMState:
    """Streaming LSTM state: hidden and cell per target/layer/direction."""

    h: torch.Tensor  # (T#, L, D, G)
    c: torch.Tensor  # (T#, L, D, G)


def init_lstm_state(cfg: ModelConfig, device="cpu") -> LSTMState:
    shape = (cfg.n_targets, cfg.n_lstm_layers, 2, cfg.lstm_hidden)
    return LSTMState(
        h=torch.zeros(shape, dtype=torch.float32, device=device),
        c=torch.zeros(shape, dtype=torch.float32, device=device),
    )


# ---------------------------------------------------------------------------
# Parameter construction
# ---------------------------------------------------------------------------


def params_from_ggml(model, cfg: ModelConfig | None = None, device="cpu") -> UMXParams:
    """Stacked parameters from a parsed :class:`umx_tpu_torch.io.ggml.GGMLModel`
    (torch state-dict layouts: Linear/LSTM weights are transposed to
    ``x @ w`` form; input/output mean and scale are duplicated for the
    stacked stereo features)."""
    if cfg is None:
        cfg = ModelConfig(hidden_size=model.hidden_size)
    per_target = [model.targets[t] for t in TARGETS]

    def stack(fn):
        return np.stack([fn(t) for t in per_target])

    def stack_lstm(kind, transpose):
        def one(t):
            return np.stack([
                np.stack([
                    t[f"lstm.{kind}_l{layer}{rev}"].T if transpose
                    else t[f"lstm.{kind}_l{layer}{rev}"]
                    for rev in ("", "_reverse")
                ])
                for layer in range(cfg.n_lstm_layers)
            ])

        return stack(one)

    def dup(name):
        return stack(lambda t: np.concatenate([t[name], t[name]]))

    arrays = dict(
        input_mean=dup("input_mean"),
        input_scale=dup("input_scale"),
        fc1_w=stack(lambda t: t["fc1.weight"].T),
        bn1_w=stack(lambda t: t["bn1.weight"]),
        bn1_b=stack(lambda t: t["bn1.bias"]),
        bn1_rm=stack(lambda t: t["bn1.running_mean"]),
        bn1_rv=stack(lambda t: t["bn1.running_var"]),
        lstm_ih_w=stack_lstm("weight_ih", transpose=True),
        lstm_hh_w=stack_lstm("weight_hh", transpose=True),
        lstm_ih_b=stack_lstm("bias_ih", transpose=False),
        lstm_hh_b=stack_lstm("bias_hh", transpose=False),
        fc2_w=stack(lambda t: t["fc2.weight"].T),
        bn2_w=stack(lambda t: t["bn2.weight"]),
        bn2_b=stack(lambda t: t["bn2.bias"]),
        bn2_rm=stack(lambda t: t["bn2.running_mean"]),
        bn2_rv=stack(lambda t: t["bn2.running_var"]),
        fc3_w=stack(lambda t: t["fc3.weight"].T),
        bn3_w=stack(lambda t: t["bn3.weight"]),
        bn3_b=stack(lambda t: t["bn3.bias"]),
        bn3_rm=stack(lambda t: t["bn3.running_mean"]),
        bn3_rv=stack(lambda t: t["bn3.running_var"]),
        output_scale=dup("output_scale"),
        output_mean=dup("output_mean"),
    )
    return _to_params(arrays, device)


def params_from_jax(np_params, device="cpu") -> UMXParams:
    """The port's parameters from a ``umx_tpu.models.umx.UMXParams`` (or
    any object with the same fields) holding numpy-convertible dense
    arrays — so both packages can be fed identical weights."""
    return _to_params(
        {f.name: np.asarray(getattr(np_params, f.name)) for f in fields(UMXParams)}, device
    )


def _to_params(arrays: dict, device) -> UMXParams:
    return UMXParams(**{
        k: torch.tensor(np.asarray(v, dtype=np.float32), device=device)
        for k, v in arrays.items()
    })


def synthetic_state_dicts(cfg: ModelConfig, seed: int = 0) -> dict[str, dict[str, np.ndarray]]:
    """Random per-target torch-layout state dicts, scaled so activations
    stay in a sane range.  Draws the same numbers, in the same order, as
    ``umx_tpu.models.umx.synthetic_state_dicts``."""
    rng = np.random.default_rng(seed)
    H, F, O, G = cfg.hidden_size, cfg.n_features, cfg.n_outputs, cfg.lstm_hidden

    def w(*shape, scale=None):
        scale = scale if scale is not None else 1.0 / np.sqrt(shape[-1])
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    targets = {}
    for t in TARGETS:
        d = {
            "input_mean": w(F // 2, scale=0.1),
            "input_scale": (1.0 + 0.1 * rng.standard_normal(F // 2)).astype(np.float32),
            "output_scale": (1.0 + 0.1 * rng.standard_normal(O // 2)).astype(np.float32),
            "output_mean": w(O // 2, scale=0.1),
            "fc1.weight": w(H, F),
            "fc2.weight": w(H, 2 * H),
            "fc3.weight": w(O, H),
        }
        for i, pre in enumerate(("bn1", "bn2", "bn3")):
            dim = (H, H, O)[i]
            d[f"{pre}.weight"] = (1.0 + 0.1 * rng.standard_normal(dim)).astype(np.float32)
            d[f"{pre}.bias"] = w(dim, scale=0.1)
            d[f"{pre}.running_mean"] = w(dim, scale=0.1)
            d[f"{pre}.running_var"] = (1.0 + 0.1 * np.abs(rng.standard_normal(dim))).astype(
                np.float32
            )
        for layer in range(cfg.n_lstm_layers):
            for rev in ("", "_reverse"):
                # lstm input is H for layer 0 and 2G = H for layers 1..
                d[f"lstm.weight_ih_l{layer}{rev}"] = w(4 * G, H)
                d[f"lstm.weight_hh_l{layer}{rev}"] = w(4 * G, G)
                d[f"lstm.bias_ih_l{layer}{rev}"] = w(4 * G, scale=0.1)
                d[f"lstm.bias_hh_l{layer}{rev}"] = w(4 * G, scale=0.1)
        targets[t] = d
    return targets


# ---------------------------------------------------------------------------
# Forward pass
# ---------------------------------------------------------------------------


def _batchnorm(x, w, b, rm, rv, eps: float):
    """Inference-mode BatchNorm1d over the last axis; per-target (T#, C)
    statistics broadcast over time."""
    inv = torch.rsqrt(rv + eps)[:, None]
    return (x - rm[:, None]) * inv * w[:, None] + b[:, None]


def umx_pre(params: UMXParams, x, cfg: ModelConfig):
    """Everything before the recurrence: input norm + fc1 + bn1 + tanh for
    all targets.  x: (T, F) shared input magnitudes → x1 (T#, T, H)."""
    x = x.float()[None]
    if cfg.input_scaling == "openunmix":
        x = (x + params.input_mean[:, None]) * params.input_scale[:, None]
    else:  # the umx.cpp reference's convention
        x = x * params.input_scale[:, None] + params.input_mean[:, None]
    x = torch.matmul(x, params.fc1_w)
    return torch.tanh(
        _batchnorm(x, params.bn1_w, params.bn1_b, params.bn1_rm, params.bn1_rv, cfg.bn_eps)
    )


def umx_post(params: UMXParams, x1, lstm_out, cfg: ModelConfig):
    """Skip-concat + fc2/bn2/relu + fc3/bn3 + output norm for all targets.
    Returns masks (T#, T, O)."""
    eps = cfg.bn_eps
    x = torch.matmul(torch.cat([x1, lstm_out], dim=-1), params.fc2_w)
    x = torch.relu(_batchnorm(x, params.bn2_w, params.bn2_b, params.bn2_rm, params.bn2_rv, eps))
    x = torch.matmul(x, params.fc3_w)
    x = _batchnorm(x, params.bn3_w, params.bn3_b, params.bn3_rm, params.bn3_rv, eps)
    return torch.relu(x * params.output_scale[:, None] + params.output_mean[:, None])


def umx_recurrence(params: UMXParams, x1, state: LSTMState, cfg: ModelConfig):
    """The 3-layer bidirectional LSTM, the only phase with streaming state.

    x1: (T#, T, H) → (lstm_out (T#, T, 2G), new state).  Per layer: the
    (T#, D, T, in) stack of forward and time-reversed rows, the input
    projection as one f32 batched matmul plus both biases, the merged
    recurrence over all T#·D chains, and the backward direction
    re-reversed."""
    lstm_in = x1
    hTs, cTs = [], []
    for layer in range(cfg.n_lstm_layers):
        xs = torch.stack([lstm_in, lstm_in.flip(1)], dim=1)  # (T#, D, T, in)
        proj = torch.matmul(xs, params.lstm_ih_w[:, layer])  # (T#, D, T, 4G)
        bias = params.lstm_ih_b[:, layer] + params.lstm_hh_b[:, layer]  # (T#, D, 4G)
        x_proj = (proj + bias[:, :, None]).transpose(1, 2)  # (T#, T, D, 4G)
        hs, hT, cT = lstm_layer_merged(
            x_proj, params.lstm_hh_w[:, layer], state.h[:, layer], state.c[:, layer]
        )
        lstm_in = torch.cat([hs[:, :, 0], hs[:, :, 1].flip(1)], dim=-1)  # (T#, T, 2G)
        hTs.append(hT)
        cTs.append(cT)
    return lstm_in, LSTMState(h=torch.stack(hTs, dim=1), c=torch.stack(cTs, dim=1))

