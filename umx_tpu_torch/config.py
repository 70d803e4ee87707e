"""Configuration for the port: the fields of ``umx_tpu.config`` that the
CLI demix path reads, with the same names and defaults.

The TPU-only knobs (FFT/DFT algorithm and precision, storage dtypes,
overlap-add and streaming schedules, window planning) have no
counterpart here: the port keeps masks, Wiener output and stems in
float32 and runs the transforms through cuFFT.
"""

from __future__ import annotations

import dataclasses
from typing import Literal


@dataclasses.dataclass(frozen=True)
class DSPConfig:
    """STFT/iSTFT constants: centered, reflect-padded, periodic Hann,
    one-sided, unscaled forward / 1/N inverse with window-sumsquare
    normalization."""

    sample_rate: int = 44100
    n_fft: int = 4096
    hop: int = 1024


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


@dataclasses.dataclass(frozen=True)
class SegmentConfig:
    """Overlapping-segment inference constants."""

    segment_secs: float = 60.0
    overlap: float = 0.25
    max_shift_secs: float = 0.5
    transition_power: float = 1.0
    # LSTM h/c state carries across segments (the reference's streaming LSTM)
    streaming: bool = True

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

    def replace(self, **kw) -> "EngineConfig":
        return dataclasses.replace(self, **kw)


TARGETS = ("bass", "drums", "other", "vocals")
