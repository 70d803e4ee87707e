"""The port's streaming demixer: the cases of tests/test_streaming.py
(any chunking reproduces the port's offline demix; one segment of
latency; reset; bad shapes), the port against the JAX
``StreamingDemixer`` on the same weights and audio, and its device
default."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from umx_tpu.config import EngineConfig as JEngineConfig
from umx_tpu.config import ModelConfig as JModelConfig
from umx_tpu.config import SegmentConfig as JSegmentConfig
from umx_tpu.config import WienerConfig as JWienerConfig
from umx_tpu.engine.streaming import StreamingDemixer as JStreamingDemixer
from umx_tpu.models.umx import synthetic_params as jsynthetic_params
from umx_tpu_torch.config import EngineConfig, ModelConfig, SegmentConfig
from umx_tpu_torch.engine.separator import Separator
from umx_tpu_torch.engine.streaming import StreamingDemixer
from umx_tpu_torch.models.umx import params_from_jax

HIDDEN = 64


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jax_params():
    return jsynthetic_params(JModelConfig(hidden_size=HIDDEN), seed=0)


@pytest.fixture(scope="module")
def cfg():
    return EngineConfig(model=ModelConfig(hidden_size=HIDDEN),
                        segment=SegmentConfig(segment_secs=0.5), shifts=0)


@pytest.fixture(scope="module")
def params(jax_params):
    return params_from_jax(jax_params)


@pytest.fixture(scope="module")
def audio():
    rng = np.random.default_rng(111)
    return rng.uniform(-0.5, 0.5, (2, 60_000)).astype(np.float32)


@pytest.fixture(scope="module")
def track():
    """Tones and noise (the slice test's kind of input, tests/test_torch_separator.py)
    for the comparisons with the JAX package: on uniform noise the Wiener-EM
    2x2 inverse amplifies the recurrence's bf16 rounding differences about
    30-fold in both packages (3.6e-5 of max|stem| without Wiener, 1.0e-3
    with it, at these settings)."""
    t = np.arange(60_000) / 44100
    rng = np.random.default_rng(7)
    return np.stack([
        0.4 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.standard_normal(t.size),
        0.3 * np.sin(2 * np.pi * 330 * t) + 0.05 * rng.standard_normal(t.size),
    ]).astype(np.float32)


@pytest.fixture(scope="module")
def offline(cfg, params, audio):
    return Separator(params, cfg, "cpu").demix(audio).numpy()


def _stream(sd, audio, chunk_size):
    pieces = [sd.push(audio[:, s : s + chunk_size]) for s in range(0, audio.shape[1], chunk_size)]
    pieces.append(sd.flush())
    return np.concatenate(pieces, axis=-1)


@pytest.mark.parametrize("chunk_size", [1000, 7777, 30_000, 60_000])
def test_streamed_equals_offline(cfg, params, audio, offline, chunk_size):
    streamed = _stream(StreamingDemixer(params, cfg, "cpu"), audio, chunk_size)
    assert streamed.shape == offline.shape
    np.testing.assert_allclose(streamed, offline, atol=1e-5)


def test_latency_bounded(cfg, params, audio):
    # output becomes available as soon as one full segment is in
    sd = StreamingDemixer(params, cfg, "cpu")
    seg = sd.seg
    assert sd.push(audio[:, : seg - 1]).shape[-1] == 0
    assert sd.push(audio[:, seg - 1 : seg]).shape[-1] == sd.stride
    assert sd.latency_samples == seg


def test_reset_reproduces(cfg, params, audio):
    sd = StreamingDemixer(params, cfg, "cpu")
    a = np.concatenate([sd.push(audio), sd.flush()], axis=-1)
    sd.reset()
    b = np.concatenate([sd.push(audio), sd.flush()], axis=-1)
    np.testing.assert_array_equal(a, b)


def test_push_rejects_bad_shapes(cfg, params):
    sd = StreamingDemixer(params, cfg, "cpu")
    with pytest.raises(ValueError):
        sd.push(np.zeros((3, 100), np.float32))
    with pytest.raises(ValueError):
        sd.push(np.zeros((100,), np.float32))


def test_non_streaming_config_resets_the_state(params, audio):
    """Without ``streaming`` no state is carried: the stream equals the
    offline demix of the same non-streaming config."""
    cfg = EngineConfig(model=ModelConfig(hidden_size=HIDDEN),
                       segment=SegmentConfig(segment_secs=0.5, streaming=False), shifts=0)
    want = Separator(params, cfg, "cpu").demix(audio, fused=False).numpy()
    np.testing.assert_allclose(_stream(StreamingDemixer(params, cfg, "cpu"), audio, 7777), want,
                               atol=1e-5)


@pytest.mark.parametrize("chunk_size", [7777, 60_000])
def test_streamed_matches_jax(jax_params, params, cfg, track, chunk_size):
    """The port's stream against the JAX package's on the same weights and
    chunking, its Pallas kernels in interpret mode (bf16 recurrence
    operands, as the port's): FFT and matmul summation orders differ, so
    within 2e-4 of max|stem|."""
    jcfg = JEngineConfig(model=JModelConfig(hidden_size=HIDDEN, lstm_impl="pallas_interpret"),
                         wiener=JWienerConfig(impl="pallas_interpret"),
                         segment=JSegmentConfig(segment_secs=0.5), shifts=0)
    ref = _stream(JStreamingDemixer(jax_params, jcfg), track, chunk_size)
    ours = _stream(StreamingDemixer(params, cfg, "cpu"), track, chunk_size)
    assert ours.shape == ref.shape == (4, 2, track.shape[1])
    assert np.max(np.abs(ours - ref)) / np.max(np.abs(ref)) <= 2e-4


def test_defaults_to_the_gpu_and_raises_without_one(cfg, params, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        StreamingDemixer(params, cfg)
