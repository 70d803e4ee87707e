"""Open-Unmix mask-prediction network in PyTorch.

Per target: crop+stack stereo magnitudes → input norm → fc1 → bn1 →
tanh → 3-layer bidirectional LSTM → skip-concat [x, lstm] → fc2 → bn2 →
ReLU → fc3 → bn3 → output norm → ReLU = mask.

All four targets' weights are stacked on a leading axis (the layouts of
``umx_tpu.models.umx.UMXParams``), so the fc layers run as batched
matmuls over targets.  The LSTM input projections run outside the
recurrence as one f32 batched matmul per layer; the recurrence of all
targets × directions (× batch rows, in training) runs as one merged
kernel call per layer (``ops/lstm_cuda.py``), differentiable through the
training kernels when a gradient is wanted, or with
``ModelConfig.lstm_impl="pallas"`` as one per-target kernel launch per
layer and batch row, or with ``lstm_impl="scan"`` as the float32
recurrence kernel (f32 h against W_hh in its stored dtype), one launch per
layer, differentiable through its reverse sweep; ``"auto"`` takes that
kernel where the merged one cannot hold the width (:func:`resolve_lstm_impl`).
With quantized parameters
(:func:`quantized_params_from_ggml`) the fc and input-projection weights
are ``QTensor`` s whose dequantization is fused into the matmul
(``ops/qmatmul.py``) and ``lstm_hh_w`` is dense bfloat16, which the
recurrence kernels take as it is.  The backward direction is
the forward recurrence over the time-reversed sequence, so its state,
like the forward one's, carries across segments (the reference's
streaming LSTM).

Float32 matmuls stay full float32 on the GPU (no TF32): the separator
sets ``torch.backends.cuda.matmul.allow_tf32 = False``.  The phases take
the JAX package's ``compute`` specs (:func:`resolve_compute`) with the
meaning they have there off a TPU: every spec but a narrower dtype
("bfloat16") is a float32 product; "bfloat16" rounds the operands of the
fc and input-projection products to bf16 (f32 sums) and, under
``lstm_impl="scan"``, h and W_hh in the recurrence, which is the merged
kernel's function (K1).  The merged and per-target recurrences and the
quantized weights' products ignore the spec, as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

from umx_tpu_torch.config import TARGETS, ModelConfig
from umx_tpu_torch.ops.lstm_cuda import (
    MERGED_G_ALIGN,
    RESIDENT_G_MAX,
    lstm_layer_merged_batched,
    lstm_layer_pertarget_batched,
    lstm_layer_scan_batched,
)
from umx_tpu_torch.ops.qmatmul import QTensor, q_mm, qtensor_from_raw, stack_qtensors


@dataclass
class UMXParams:
    """UMX weights for all targets, stacked on a leading target axis
    (float32 tensors; in the quantized mode ``fc*_w`` and ``lstm_ih_w``
    are ``QTensor`` s and ``lstm_hh_w`` is bfloat16).  T#=4 targets,
    F=2974 features, H=hidden_size, L=3 layers, D=2 directions, G=H/2,
    O=4098 outputs."""

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


def init_lstm_state(cfg: ModelConfig, device="cpu", batch: int | None = None) -> LSTMState:
    """Zero state (T#, L, D, G), or (batch, T#, L, D, G) with ``batch``."""
    shape = (cfg.n_targets, cfg.n_lstm_layers, 2, cfg.lstm_hidden)
    if batch is not None:
        shape = (batch, *shape)
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
    return _to_params(_arrays_from_ggml(model, cfg), device)


def _arrays_from_ggml(model, cfg: ModelConfig) -> dict[str, np.ndarray]:
    """The stacked float32 numpy arrays of :func:`params_from_ggml`."""
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

    return dict(
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


_QUANTIZED_FIELDS = ("fc1_w", "fc2_w", "fc3_w", "lstm_ih_w")


def quantized_params_from_ggml(model, cfg: ModelConfig | None = None, device="cpu") -> UMXParams:
    """Like :func:`params_from_ggml`, but the large matmul weights (fc1,
    fc2, fc3, LSTM ih) stay quantized on the device as ``QTensor`` s: the
    u8/u16 payloads of the file, byte for byte, dequantized inside each
    matmul (``ops/qmatmul.py``).  ``lstm_hh_w`` is densified to bfloat16
    (the recurrence kernels' operand type, and no larger than the u8
    planes would be); the small vectors are float32.  Needs a model read
    with ``keep_quantized=True``."""
    if model.raw is None:
        raise ValueError("GGMLModel.raw missing: re-read with keep_quantized=True")
    if cfg is None:
        cfg = ModelConfig(hidden_size=model.hidden_size)
    arrays = _arrays_from_ggml(model, cfg)
    hh = torch.from_numpy(arrays.pop("lstm_hh_w")).to(torch.bfloat16).to(device)
    for name in _QUANTIZED_FIELDS:
        del arrays[name]

    def q_stack(name):
        return stack_qtensors([
            qtensor_from_raw(np.ascontiguousarray(model.raw[t][name][0].T), *model.raw[t][name][1:])
            for t in TARGETS
        ])

    def q_stack_lstm(kind):
        return stack_qtensors([
            stack_qtensors([
                stack_qtensors([
                    qtensor_from_raw(np.ascontiguousarray(q.T), scale, offset)
                    for q, scale, offset in (
                        model.raw[t][f"lstm.{kind}_l{layer}{rev}"] for rev in ("", "_reverse")
                    )
                ])
                for layer in range(cfg.n_lstm_layers)
            ])
            for t in TARGETS
        ])

    dense = _to_params_dict(arrays, device)
    return UMXParams(
        **dense,
        fc1_w=q_stack("fc1.weight").to(device),
        fc2_w=q_stack("fc2.weight").to(device),
        fc3_w=q_stack("fc3.weight").to(device),
        lstm_ih_w=q_stack_lstm("weight_ih").to(device),
        lstm_hh_w=hh,
    )


def is_quantized(params: UMXParams) -> bool:
    return isinstance(params.fc1_w, QTensor)


def params_from_jax(np_params, device="cpu") -> UMXParams:
    """The port's parameters from a ``umx_tpu.models.umx.UMXParams`` (or
    any object with the same fields) holding numpy-convertible dense
    arrays — so both packages can be fed identical weights."""
    return _to_params(
        {f.name: np.asarray(getattr(np_params, f.name)) for f in fields(UMXParams)}, device
    )


def quantized_params_from_jax(np_params, device="cpu") -> UMXParams:
    """The port's quantized parameters from the JAX package's quantized
    ``UMXParams`` (as :func:`params_from_jax`), bit for bit: each field
    with ``planes`` becomes a ``QTensor`` of the same integer planes (any
    numpy-convertible type that holds them exactly), scale and offset;
    ``lstm_hh_w`` (bfloat16 or float32 values) becomes bfloat16; the rest
    float32."""
    out = {}
    for f in fields(UMXParams):
        v = getattr(np_params, f.name)
        if hasattr(v, "planes"):
            out[f.name] = QTensor(
                planes=tuple(
                    torch.from_numpy(np.asarray(p).astype(np.float32)).to(torch.bfloat16).to(device)
                    for p in v.planes
                ),
                scale=torch.tensor(np.asarray(v.scale, dtype=np.float32), device=device),
                offset=torch.tensor(np.asarray(v.offset, dtype=np.float32), device=device),
            )
        else:
            t = torch.from_numpy(np.asarray(v).astype(np.float32))
            out[f.name] = (t.to(torch.bfloat16) if f.name == "lstm_hh_w" else t).to(device)
    return UMXParams(**out)


def _to_params_dict(arrays: dict, device) -> dict:
    return {
        k: torch.tensor(np.asarray(v, dtype=np.float32), device=device) for k, v in arrays.items()
    }


def _to_params(arrays: dict, device) -> UMXParams:
    return UMXParams(**_to_params_dict(arrays, device))


def params_to_state_dicts(params: UMXParams, cfg: ModelConfig) -> dict[str, dict[str, np.ndarray]]:
    """Per-target torch-layout float32 state dicts from stacked parameters:
    the inverse of :func:`params_from_ggml` (the halves of the duplicated
    input/output norms, Linear/LSTM weights transposed back).  Dense
    parameters only."""
    if is_quantized(params):
        raise ValueError("quantized parameters have no state-dict form: load the dense ones")
    half_f, half_o = cfg.n_features // 2, cfg.n_outputs // 2
    targets = {}
    for t_idx, tname in enumerate(TARGETS):
        p = {f.name: getattr(params, f.name)[t_idx].detach().cpu().numpy() for f in fields(UMXParams)}
        d = {
            "input_mean": p["input_mean"][:half_f],
            "input_scale": p["input_scale"][:half_f],
            "output_scale": p["output_scale"][:half_o],
            "output_mean": p["output_mean"][:half_o],
            "fc1.weight": p["fc1_w"].T,
            "fc2.weight": p["fc2_w"].T,
            "fc3.weight": p["fc3_w"].T,
        }
        for pre in ("bn1", "bn2", "bn3"):
            d[f"{pre}.weight"] = p[f"{pre}_w"]
            d[f"{pre}.bias"] = p[f"{pre}_b"]
            d[f"{pre}.running_mean"] = p[f"{pre}_rm"]
            d[f"{pre}.running_var"] = p[f"{pre}_rv"]
        for layer in range(cfg.n_lstm_layers):
            for di, rev in enumerate(("", "_reverse")):
                d[f"lstm.weight_ih_l{layer}{rev}"] = p["lstm_ih_w"][layer, di].T
                d[f"lstm.weight_hh_l{layer}{rev}"] = p["lstm_hh_w"][layer, di].T
                d[f"lstm.bias_ih_l{layer}{rev}"] = p["lstm_ih_b"][layer, di]
                d[f"lstm.bias_hh_l{layer}{rev}"] = p["lstm_hh_b"][layer, di]
        targets[tname] = d
    return targets


def synthetic_params(cfg: ModelConfig, seed: int = 0, device="cpu") -> UMXParams:
    """Stacked parameters from :func:`synthetic_state_dicts` (as
    ``umx_tpu.models.umx.synthetic_params``)."""
    from umx_tpu_torch.io.ggml import GGMLModel

    return params_from_ggml(
        GGMLModel(hidden_size=cfg.hidden_size, targets=synthetic_state_dicts(cfg, seed)),
        cfg, device,
    )


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
    statistics broadcast over time (and over a leading batch axis)."""
    inv = torch.rsqrt(rv + eps)[:, None]
    return (x - rm[:, None]) * inv * w[:, None] + b[:, None]


# compute spec: name -> (the products' operand dtype, the JAX package's
# precision name).  Off a TPU the JAX package's "default", "float32",
# "high" and "highest" are all one float32 product, as every one is here
# (TF32 off); only a narrower operand dtype changes the arithmetic.
_COMPUTE_SPECS = {
    "default": (torch.float32, "default"),
    "float32": (torch.float32, "default"),
    "bfloat16": (torch.bfloat16, "default"),
    "high": (torch.float32, "high"),
    "highest": (torch.float32, "highest"),
}


def resolve_compute(name) -> tuple[torch.dtype, str]:
    """Resolve a compute spec (``umx_tpu.models.umx.resolve_compute``): a
    name from ``_COMPUTE_SPECS``, a dtype or dtype name (the "default"
    precision), or an already-resolved (dtype, precision) tuple, returned
    as it is."""
    if isinstance(name, tuple):
        return name
    if isinstance(name, str) and name in _COMPUTE_SPECS:
        return _COMPUTE_SPECS[name]
    if isinstance(name, torch.dtype):
        return name, "default"
    try:
        dtype = getattr(torch, np.dtype(name).name)
    except TypeError:
        dtype = None
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown compute spec {name!r}; valid names: "
                         f"{sorted(_COMPUTE_SPECS)} or any dtype name")
    return dtype, "default"


_F32 = _COMPUTE_SPECS["float32"]


def _mm(x, w, compute=_F32):
    """x @ w for a dense weight, its operands rounded to the resolved
    ``compute`` spec's dtype and the product summed in float32; a
    ``QTensor`` weight ignores the spec (dequantization fused)."""
    if isinstance(w, QTensor):
        return q_mm(x, w)
    dtype = compute[0]
    if dtype == torch.float32:
        return torch.matmul(x, w)
    return torch.matmul(x.to(dtype).float(), w.to(dtype).float())


def umx_pre(params: UMXParams, x, cfg: ModelConfig, compute="default"):
    """Everything before the recurrence: input norm + fc1 + bn1 + tanh for
    all targets.  x: (T, F) shared input magnitudes → x1 (T#, T, H); with a
    leading batch axis (B, T, F) → (B, T#, T, H)."""
    spec = resolve_compute(compute)
    x = x.float().unsqueeze(-3)
    if cfg.input_scaling == "openunmix":
        x = (x + params.input_mean[:, None]) * params.input_scale[:, None]
    else:  # the umx.cpp reference's convention
        x = x * params.input_scale[:, None] + params.input_mean[:, None]
    x = _mm(x, params.fc1_w, spec)
    return torch.tanh(
        _batchnorm(x, params.bn1_w, params.bn1_b, params.bn1_rm, params.bn1_rv, cfg.bn_eps)
    )


def umx_post(params: UMXParams, x1, lstm_out, cfg: ModelConfig, compute="default"):
    """Skip-concat + fc2/bn2/relu + fc3/bn3 + output norm for all targets.
    Returns masks (T#, T, O), or (B, T#, T, O) for batched inputs."""
    spec = resolve_compute(compute)
    eps = cfg.bn_eps
    x = _mm(torch.cat([x1, lstm_out], dim=-1), params.fc2_w, spec)
    x = torch.relu(_batchnorm(x, params.bn2_w, params.bn2_b, params.bn2_rm, params.bn2_rv, eps))
    x = _mm(x, params.fc3_w, spec)
    x = _batchnorm(x, params.bn3_w, params.bn3_b, params.bn3_rm, params.bn3_rv, eps)
    return torch.relu(x * params.output_scale[:, None] + params.output_mean[:, None])


def resolve_lstm_impl(impl: str, G: int) -> str:
    """The recurrence ``impl`` runs at width G (``ModelConfig.lstm_hidden``)
    by a named width rule: ``"auto"`` is the merged kernel (K1, and K4-K6
    under a gradient) at G <= ``RESIDENT_G_MAX`` with G % 8 == 0, the widths
    its resident form holds without padding, and the float32 recurrence
    ``"scan"`` (K10, K11) at every other width, on the CPU as on the GPU, so
    both compute one program (the JAX package's ``"auto"`` is its scan at
    every width off a TPU).  Every other value is itself: ``"pallas_merged"``
    and ``"pallas"`` run their kernels at any width (padded, or the wide
    forms)."""
    if impl == "auto" and (G > RESIDENT_G_MAX or G % MERGED_G_ALIGN):
        return "scan"
    return impl


def umx_recurrence_batched(params: UMXParams, x1_b, state_b: LSTMState, cfg: ModelConfig,
                           compute="default"):
    """The 3-layer bidirectional LSTM over a batch, in the training
    recurrence's layout (``umx_tpu.models.umx.umx_recurrence_batched``).

    x1_b: (B, T#, T, H); state_b: h/c (B, T#, L, D, G) → (lstm_out
    (B, T#, T, 2G), new state).  Per layer: the (B, T#, D, T, in) stack of
    forward and time-reversed rows, the input projection as one f32
    batched matmul plus both biases, the recurrence, and the backward
    direction re-reversed.  ``cfg.lstm_impl`` (:func:`resolve_lstm_impl`):
    "auto"/"pallas_merged" run the merged kernel over all T#·D chains × B
    rows; "pallas" runs the per-target kernel once per batch row; "scan"
    (and "auto" where the merged kernel cannot hold G) runs the float32
    recurrence over all chains × rows, W_hh in its stored dtype (the
    quantized parameters' hh is dense bf16).  Where a gradient is wanted the
    merged and the float32 recurrences run their training kernels; "pallas"
    raises (the trainer's loss lowers it to "scan", as the JAX trainer
    does).  ``compute`` (:func:`resolve_compute`) sets the input
    projections' operand dtype; under "scan" with dense weights a bfloat16
    spec also rounds h and W_hh, which is the merged recurrence (K1, at any
    width), as the JAX scan computes it."""
    spec = resolve_compute(compute)
    impl = resolve_lstm_impl(cfg.lstm_impl, cfg.lstm_hidden)
    if impl == "scan" and spec[0] != torch.float32 and not is_quantized(params):
        if spec[0] != torch.bfloat16:
            raise ValueError(f'the recurrence under lstm_impl "scan" has products in float32 or '
                             f'bfloat16, got compute dtype {spec[0]}')
        impl = "pallas_merged"  # bf16(h) x bf16(W_hh), f32 sums: K1's function
    layer_fn = {"pallas": lstm_layer_pertarget_batched,
                "scan": lstm_layer_scan_batched}.get(impl, lstm_layer_merged_batched)
    lstm_in = x1_b
    hTs, cTs = [], []
    for layer in range(cfg.n_lstm_layers):
        xs = torch.stack([lstm_in, lstm_in.flip(2)], dim=2)  # (B, T#, D, T, in)
        proj = _mm(xs, params.lstm_ih_w[:, layer], spec)  # (B, T#, D, T, 4G)
        bias = params.lstm_ih_b[:, layer] + params.lstm_hh_b[:, layer]  # (T#, D, 4G)
        x_proj = (proj + bias[:, :, None]).transpose(2, 3)  # (B, T#, T, D, 4G)
        hs, hT, cT = layer_fn(
            x_proj, params.lstm_hh_w[:, layer], state_b.h[:, :, layer], state_b.c[:, :, layer]
        )
        lstm_in = torch.cat([hs[:, :, :, 0], hs[:, :, :, 1].flip(2)], dim=-1)  # (B, T#, T, 2G)
        hTs.append(hT)
        cTs.append(cT)
    return lstm_in, LSTMState(h=torch.stack(hTs, dim=2), c=torch.stack(cTs, dim=2))


def pipelined_hh(params: UMXParams) -> torch.Tensor:
    """W_hh layer-major in bfloat16, (L, T#, D, G, 4G) contiguous: the
    operand of :func:`umx_recurrence_pipelined_step`, made once per track
    so that each iteration's stacked layers are a contiguous slice."""
    return params.lstm_hh_w.transpose(0, 1).to(torch.bfloat16).contiguous()


def umx_recurrence_pipelined_step(params: UMXParams, stage_inputs: list, stage_states: list,
                                  layers: list, cfg: ModelConfig, whh=None):
    """One iteration of the layer-pipelined streaming recurrence
    (``EngineConfig.stream_impl="pipelined"``;
    ``umx_tpu.models.umx.umx_recurrence_pipelined_step``).

    Stage s runs LSTM layer ``layers[s]`` on another chunk's data: layer l
    of chunk k needs layer l-1 of chunk k (one iteration earlier) and its
    own layer-l state after chunk k-1, so the schedule L1(k) | L2(k-1) |
    L3(k-2) computes what the serial program computes.  The stages' chains
    are stacked into one merged-kernel call of R = S·T#·D chains at B rows,
    stage-major (chain ``(s*T# + j)*D + d``), after one stacked float32 ih
    projection plus both biases.

    stage_inputs: per stage (B, T#, T, H) layer inputs; stage_states: per
    stage (h, c), each (B, T#, D, G); layers: a contiguous ascending range
    of layer indices.  ``whh``: :func:`pipelined_hh` of the parameters
    (made here when not given).  Dense weights only.  The merged kernel
    (K1) runs whatever ``cfg.lstm_impl`` says, as the JAX arm always calls
    its merged kernel.  Returns (per-stage outputs (B, T#, T, 2G),
    per-stage new (h, c))."""
    if is_quantized(params):
        raise ValueError("the pipelined recurrence needs dense weights (quantized weights "
                         "run the scan)")
    S = len(layers)
    if not (S >= 1 and S == len(stage_inputs) == len(stage_states)
            and list(layers) == list(range(layers[0], layers[0] + S))):
        raise ValueError(f"layers must be a contiguous range, one per stage; got {layers}")
    l0, l1 = layers[0], layers[0] + S
    if whh is None:
        whh = pipelined_hh(params)
    x = torch.stack(stage_inputs, dim=1)  # (B, S, T#, T, H)
    xs = torch.stack([x, x.flip(3)], dim=3)  # (B, S, T#, D, T, H)
    ih_w = params.lstm_ih_w[:, l0:l1].transpose(0, 1)  # (S, T#, D, H, 4G)
    bias = (params.lstm_ih_b[:, l0:l1] + params.lstm_hh_b[:, l0:l1]).transpose(0, 1)
    proj = torch.matmul(xs, ih_w) + bias[:, :, :, None]  # (B, S, T#, D, T, 4G)
    Bsz, _, n_t, D, T, G4 = proj.shape
    # the stages as S*T# targets of one merged layer: (B, S*T#, T, D, 4G)
    x_proj = proj.view(Bsz, S * n_t, D, T, G4).transpose(2, 3)
    h0 = torch.stack([h for h, _ in stage_states], dim=1).reshape(Bsz, S * n_t, D, -1)
    c0 = torch.stack([c for _, c in stage_states], dim=1).reshape(Bsz, S * n_t, D, -1)
    hs, hT, cT = lstm_layer_merged_batched(
        x_proj, whh[l0:l1].reshape(S * n_t, D, G4 // 4, G4), h0, c0)
    outs, states = [], []
    for s in range(S):
        j = slice(s * n_t, (s + 1) * n_t)
        outs.append(torch.cat([hs[:, j, :, 0], hs[:, j, :, 1].flip(2)], dim=-1))
        states.append((hT[:, j], cT[:, j]))
    return outs, states


def umx_recurrence(params: UMXParams, x1, state: LSTMState, cfg: ModelConfig,
                   compute="default"):
    """The 3-layer bidirectional LSTM, the only phase with streaming state:
    x1 (T#, T, H) → (lstm_out (T#, T, 2G), new state); one batch row of
    :func:`umx_recurrence_batched`."""
    out, st = umx_recurrence_batched(
        params, x1[None], LSTMState(h=state.h[None], c=state.c[None]), cfg, compute
    )
    return out[0], LSTMState(h=st.h[0], c=st.c[0])


def umx_forward_batched(params: UMXParams, x_b, state_b: LSTMState, cfg: ModelConfig,
                        compute="default"):
    """Batched all-targets mask network (the training forward): x_b
    (B, T, F) → (masks (B, T#, T, O), new state)."""
    spec = resolve_compute(compute)
    x1_b = umx_pre(params, x_b, cfg, spec)
    lstm_out, new_state = umx_recurrence_batched(params, x1_b, state_b, cfg, spec)
    return umx_post(params, x1_b, lstm_out, cfg, spec), new_state


def umx_forward(params: UMXParams, x, state: LSTMState, cfg: ModelConfig, compute="default"):
    """All-targets mask network of one segment (``umx_tpu.models.umx.umx_forward``):
    x (T, F) shared input magnitudes → (masks (T#, T, O), new streaming
    state).  ``compute`` names a spec of :func:`resolve_compute`; the
    activations and the state stay float32."""
    spec = resolve_compute(compute)
    x1 = umx_pre(params, x, cfg, spec)
    lstm_out, new_state = umx_recurrence(params, x1, state, cfg, spec)
    return umx_post(params, x1, lstm_out, cfg, spec), new_state


def param_count(params: UMXParams) -> int:
    """The number of parameters: the elements of every field (a quantized
    field counts its weight's shape)."""
    return sum(int(np.prod(getattr(params, f.name).shape)) for f in fields(params))
