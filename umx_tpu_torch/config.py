"""Configuration for the port: the fields of ``umx_tpu.config`` that the
port's demix paths read, with the same names and defaults, so a JAX
config translates field for field.

The algorithm choices that carry over: ``DSPConfig.istft_algo`` ("ct2" is
the hand-written Cooley-Tukey iSTFT kernel), ``ModelConfig.lstm_impl``
("pallas_merged" and "pallas" keep their JAX names and select the merged
and the per-target recurrence kernel, "scan" the float32 recurrence), ``WienerConfig.impl`` ("pallas"
keeps its JAX name and selects the fused Wiener kernels, "einsum" the
einsum path), ``SegmentConfig.chunk_batch`` (the chunk-group width, 0 =
the memory planner's pick), ``SegmentConfig.window_chunks`` (windowed
long tracks), ``EngineConfig.ola_impl`` ("pallas" selects the
hand-written overlap-add kernel) and ``EngineConfig.stream_impl`` (the
streaming schedules "scan", "groups" and "pipelined").  So do the storage
dtypes ``EngineConfig.mask_dtype``, ``EngineConfig.stems_stack_dtype``
and ``WienerConfig.out_dtype``: "bfloat16" stores that seam's tensor in
bfloat16, and "auto" resolves as the JAX package resolves it, by the
device (:func:`storage_dtype`): bfloat16 on the GPU, float32 on the CPU.
In bfloat16 the Wiener kernels read the masks and write their planes as
the TPU kernels do, so each seam halves its tensor's bytes.
Values the port does not implement raise ``ValueError``.  The TPU's
matmul and DFT precisions and the iDFT frame dtype have no field: the
port's matmuls are float32 with TF32 off and its transforms are cuFFT or
the ct2 kernel, which is what the JAX package computes for every value
of those knobs off a TPU (the CLI accepts their flags).
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import torch

# storage dtypes of the seams (mask, Wiener output, stems stack)
STORAGE_DTYPES = ("auto", "float32", "bfloat16")


def _check_storage(name: str, choice: str) -> None:
    if choice not in STORAGE_DTYPES:
        raise ValueError(f"{name} must be auto, float32 or bfloat16, got {choice!r}")


def storage_dtype(choice: str, device) -> torch.dtype:
    """The torch dtype of a seam's storage choice on ``device`` (None: the
    GPU, the port's default device).  "auto" is bfloat16 on every device
    but the CPU and float32 on the CPU, the JAX package's rule
    (``jax.default_backend() not in ("cpu",)``)."""
    if choice == "auto":
        cpu = device is not None and torch.device(device).type == "cpu"
        return torch.float32 if cpu else torch.bfloat16
    return torch.bfloat16 if choice == "bfloat16" else torch.float32


@dataclasses.dataclass(frozen=True)
class DSPConfig:
    """STFT/iSTFT constants: centered, reflect-padded, periodic Hann,
    one-sided, unscaled forward / 1/N inverse with window-sumsquare
    normalization."""

    sample_rate: int = 44100
    n_fft: int = 4096
    hop: int = 1024
    # inverse-transform algorithm: "dense" = torch.istft; "ct2" = the
    # fused Cooley-Tukey kernel (K8, ops/istft_ct_cuda.py; needs
    # 1024 | n_fft and hop = n_fft/4, n_fft <= 16384 on the card); "auto" = dense
    istft_algo: Literal["auto", "dense", "ct2"] = "auto"

    def __post_init__(self):
        if self.istft_algo not in ("auto", "dense", "ct2"):
            raise ValueError(f"istft_algo must be auto, dense or ct2, got {self.istft_algo!r}")

    @property
    def n_bins(self) -> int:
        return self.n_fft // 2 + 1

    @property
    def pad(self) -> int:
        return self.n_fft // 2

    def n_frames(self, n_samples: int) -> int:
        """Frame count of a centered STFT over ``n_samples``."""
        return n_samples // self.hop + 1


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """UMX mask-network architecture constants."""

    hidden_size: int = 1024  # UMX-L; UMX-HQ uses 512
    n_targets: int = 4  # bass, drums, other, vocals
    n_lstm_layers: int = 3
    nb_bins_cropped: int = 1487
    n_bins: int = 2049
    bn_eps: float = 1e-5
    # "openunmix": x = (x + mean) * scale (upstream open-unmix-pytorch);
    # "umxcpp":    x = x * scale + mean   (the umx.cpp reference)
    input_scaling: Literal["openunmix", "umxcpp"] = "openunmix"
    # BLSTM recurrence kernel: "pallas_merged" = the merged kernel (K1:
    # bf16 W_hh and h operands, f32 state, any G: resident up to G 512,
    # zero units padding G % 8 != 0, the wide form above; the kernel the
    # JAX package's "auto" runs on a TPU); "pallas" = the per-target kernel
    # (K9, one launch per layer with each chain's weights and state kept
    # on chip, one launch per batch row; the wide K1 where no cluster holds
    # a chain); "scan" = the float32 recurrence (K10: f32 h against W_hh in
    # its stored dtype, f32 sums, any G; the JAX package's portable
    # lax.scan, its "auto" off a TPU).  "auto" is resolved by a width rule,
    # not by the device (models.umx.resolve_lstm_impl): K1 at G <= 512 with
    # G % 8 == 0, the scan at every other width.  "pallas_interpret" (the
    # JAX interpreter) has no port.  Training runs K4-K6 under
    # "pallas_merged" (and "auto" where it is K1), K10/K11 under "scan",
    # and lowers "pallas" to "scan", as the JAX trainer does.
    lstm_impl: Literal["auto", "pallas_merged", "pallas", "scan"] = "auto"

    def __post_init__(self):
        if self.lstm_impl == "pallas_interpret":
            raise ValueError(
                "lstm_impl 'pallas_interpret' has no meaning in the port (the recurrence "
                "always runs a kernel on a GPU and its plain version on the CPU); "
                "use auto, pallas_merged, pallas or scan"
            )
        if self.lstm_impl not in ("auto", "pallas_merged", "pallas", "scan"):
            raise ValueError(
                f"lstm_impl must be auto, pallas_merged, pallas or scan, got {self.lstm_impl!r}"
            )

    @property
    def lstm_hidden(self) -> int:
        return self.hidden_size // 2

    @property
    def n_features(self) -> int:
        return 2 * self.nb_bins_cropped  # 2974 stacked-stereo input features

    @property
    def n_outputs(self) -> int:
        return 2 * self.n_bins  # 4098 stacked-stereo mask outputs


@dataclasses.dataclass(frozen=True)
class WienerConfig:
    """Multichannel Wiener-EM post-filter constants.  ``psd="umxcpp"``
    reproduces the reference's (re+im)^2 source-PSD quirk and, like
    ``iterations=0``, runs the plain einsum path by semantics."""

    iterations: int = 1
    eps: float = 1e-10
    scale_factor: float = 10.0
    psd: Literal["correct", "umxcpp"] = "correct"
    # "auto" = "pallas" = the fused reduce/apply passes (K2/K3 on CUDA
    # tensors, their plain versions on the CPU) where the semantics allow
    # them (psd "correct", iterations >= 1); "einsum" = the einsum path
    impl: Literal["auto", "einsum", "pallas"] = "auto"
    # dtype of the final apply pass's y planes on the fused path (K3 writes
    # it; earlier EM iterations stay float32); the einsum path always gives
    # float32.  bfloat16 halves K3's dominant write and the planes' memory;
    # "auto" = bfloat16 on the GPU, float32 on the CPU (storage_dtype)
    out_dtype: Literal["auto", "float32", "bfloat16"] = "auto"

    def __post_init__(self):
        if self.impl == "pallas_interpret":
            raise ValueError(
                "wiener impl 'pallas_interpret' has no meaning in the port (the fused passes "
                "run their kernels on a GPU and their plain versions on the CPU); use auto, "
                "einsum or pallas"
            )
        if self.impl not in ("auto", "einsum", "pallas"):
            raise ValueError(f"wiener impl must be auto, einsum or pallas, got {self.impl!r}")
        _check_storage("wiener out_dtype", self.out_dtype)


@dataclasses.dataclass(frozen=True)
class SegmentConfig:
    """Overlapping-segment inference constants."""

    segment_secs: float = 60.0
    overlap: float = 0.25
    max_shift_secs: float = 0.5
    transition_power: float = 1.0
    # LSTM h/c state carries across segments (the reference's streaming LSTM)
    streaming: bool = True
    # non-streaming tracks run their segments in groups of this many rows
    # through one batched segment forward; 0 = auto, the memory planner's
    # widest fitting width (engine/memory.py::suggest_chunk_batch)
    chunk_batch: int = 0
    # tracks longer than one whole-track program can hold run as a chain of
    # W-chunk windows carrying the LSTM state and the unnormalized
    # overlap-add tail: 0 = auto (one program while the memory planner says
    # the track fits, else its widest fitting W,
    # engine/memory.py::suggest_window_chunks); -1 = never; > 0 = that W
    window_chunks: int = 0

    def __post_init__(self):
        if not (0.0 <= self.overlap < 1.0):
            raise ValueError(f"overlap must be in [0, 1), got {self.overlap}")
        if self.segment_secs <= 0:
            raise ValueError(f"segment_secs must be positive, got {self.segment_secs}")
        if self.max_shift_secs < 0:
            raise ValueError(f"max_shift_secs must be >= 0, got {self.max_shift_secs}")

    def segment_samples(self, sample_rate: int) -> int:
        return int(self.segment_secs * sample_rate)

    def stride_samples(self, sample_rate: int) -> int:
        return int((1.0 - self.overlap) * self.segment_samples(sample_rate))

    def max_shift_samples(self, sample_rate: int) -> int:
        return int(self.max_shift_secs * sample_rate)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Top-level inference-engine configuration."""

    dsp: DSPConfig = DSPConfig()
    model: ModelConfig = ModelConfig()
    wiener: WienerConfig = WienerConfig()
    segment: SegmentConfig = SegmentConfig()
    use_wiener: bool = True
    # random-shift passes averaged for the Demucs time-equivariance trick
    # (0 disables; the reference supports exactly 1)
    shifts: int = 1
    # overlap-add of the stacked weighted chunk outputs: "auto" = "unroll"
    # (one slice-add per chunk, then / weight sum); "xla" = the pad+sum
    # form; "pallas" = the overlap-add kernel (K7, ops/ola_cuda.py; on
    # CUDA overlap above 50 % raises)
    ola_impl: str = "auto"
    # dtype of the masks at the seam between the network and the Wiener
    # passes (K2/K3 read them in it and upcast in registers); bfloat16
    # halves both passes' mask reads and the masks' memory.  "auto" =
    # bfloat16 on the GPU, float32 on the CPU (storage_dtype)
    mask_dtype: Literal["auto", "float32", "bfloat16"] = "auto"
    # dtype of the stacked weighted chunk outputs that feed the overlap-add
    # (which accumulates in float32); bfloat16 halves the stack's memory.
    # "auto" as mask_dtype
    stems_stack_dtype: Literal["auto", "float32", "bfloat16"] = "auto"
    # the streaming whole-track schedule: "scan" = one segment call per
    # chunk; "groups" = the state-free halves over groups of chunk_batch
    # chunks, only the recurrence chained chunk by chunk; "pipelined" =
    # iteration i runs layer 1 of chunk i, layer 2 of chunk i-1 and layer 3
    # of chunk i-2 as one merged-kernel call (dense weights).  The same
    # arithmetic in every schedule; the two arms never window.
    stream_impl: Literal["scan", "groups", "pipelined"] = "scan"

    def __post_init__(self):
        if self.ola_impl not in ("auto", "unroll", "xla", "pallas"):
            raise ValueError(
                f"ola_impl must be auto, unroll, xla or pallas, got {self.ola_impl!r}"
            )
        _check_storage("mask_dtype", self.mask_dtype)
        _check_storage("stems_stack_dtype", self.stems_stack_dtype)
        if self.stream_impl not in ("scan", "groups", "pipelined"):
            raise ValueError(
                f"stream_impl must be scan, groups or pipelined, got {self.stream_impl!r}"
            )

    def replace(self, **kw) -> "EngineConfig":
        return dataclasses.replace(self, **kw)


UMXL = EngineConfig()
UMXHQ = EngineConfig(model=ModelConfig(hidden_size=512))

TARGETS = ("bass", "drums", "other", "vocals")
# output file digit convention (the reference's scripts/umx_pytorch_inference.py)
TARGET_FILE_INDEX = {"bass": 0, "drums": 1, "other": 2, "vocals": 3}
