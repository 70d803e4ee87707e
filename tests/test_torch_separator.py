"""The whole slice: the port's Separator.demix_track against the JAX
Separator.demix_track on the same weights and track — STFT, mask network
with the streaming BLSTM carried across chunks, Wiener-EM, iSTFT,
triangular overlap-add and the seeded shift."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from umx_tpu.config import EngineConfig as JEngineConfig
from umx_tpu.config import ModelConfig as JModelConfig
from umx_tpu.config import SegmentConfig as JSegmentConfig
from umx_tpu.config import WienerConfig as JWienerConfig
from umx_tpu.engine.separator import Separator as JSeparator
from umx_tpu.engine.separator import _transition_weight as jtransition_weight
from umx_tpu.models.umx import synthetic_params
from umx_tpu_torch.config import EngineConfig, ModelConfig, SegmentConfig
from umx_tpu_torch.engine import separator as tsep
from umx_tpu_torch.models.umx import params_from_jax

HIDDEN = 32
SR = 44100


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def track():
    # 2.6 s of stereo tones + noise; with 1 s segments at 25 % overlap and
    # the shift pad that is 5 chunks, so the state carry and OLA both run
    t = np.arange(int(2.6 * SR)) / SR
    rng = np.random.default_rng(0)
    mix = np.stack([
        0.4 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.standard_normal(t.size),
        0.3 * np.sin(2 * np.pi * 330 * t) + 0.05 * rng.standard_normal(t.size),
    ])
    return mix.astype(np.float32)


@pytest.fixture(scope="module")
def jax_params():
    return synthetic_params(JModelConfig(hidden_size=HIDDEN), seed=0)


def _cfgs(streaming=True, use_wiener=True):
    jcfg = JEngineConfig(
        model=JModelConfig(hidden_size=HIDDEN, lstm_impl="pallas_interpret"),
        segment=JSegmentConfig(segment_secs=1.0, streaming=streaming, window_chunks=-1),
        wiener=JWienerConfig(impl="pallas_interpret"),
        use_wiener=use_wiener,
        shifts=1,
    )
    tcfg = EngineConfig(
        model=ModelConfig(hidden_size=HIDDEN),
        segment=SegmentConfig(segment_secs=1.0, streaming=streaming),
        use_wiener=use_wiener,
        shifts=1,
    )
    return jcfg, tcfg


# bf16 operands in the recurrence plus FFT and matmul summation order.
# Measured max|Δ|/max|stem| on these cases: 2.5e-5 to 4.8e-5, so the cap,
# 2e-4, keeps a 4x margin (the a-priori cap for this class was 2e-3).
SLICE_RTOL = 2e-4


@pytest.mark.parametrize("streaming", [True, False])
def test_demix_track_matches_jax(track, jax_params, streaming):
    jcfg, tcfg = _cfgs(streaming=streaming)
    ref = JSeparator(jax_params, jcfg).demix_track(track, seed=0)
    ours = tsep.Separator(params_from_jax(jax_params), tcfg).demix_track(track, seed=0)
    assert ours.shape == ref.shape == (4, 2, track.shape[1])
    assert ours.dtype == np.float32 and np.isfinite(ours).all()
    err = float(np.max(np.abs(ours - ref)) / np.max(np.abs(ref)))
    assert err <= SLICE_RTOL, f"max|Δ|/max|stem| = {err:.3g}"


def test_demix_without_wiener_and_shifts_matches_jax(track, jax_params):
    jcfg, tcfg = _cfgs(use_wiener=False)
    jcfg, tcfg = jcfg.replace(shifts=0), tcfg.replace(shifts=0)
    ref = JSeparator(jax_params, jcfg).demix_track(track[:, : SR + 123], seed=0)
    ours = tsep.Separator(params_from_jax(jax_params), tcfg).demix_track(
        track[:, : SR + 123], seed=0
    )
    err = float(np.max(np.abs(ours - ref)) / np.max(np.abs(ref)))
    assert err <= SLICE_RTOL, f"max|Δ|/max|stem| = {err:.3g}"


@pytest.mark.parametrize("n", [10, 11, 44100, 44101])
def test_transition_weight_matches_jax(n):
    # exact: the same f32 arange/concat/divide on both sides (odd lengths
    # get the one-sample plateau)
    np.testing.assert_array_equal(
        tsep.transition_weight(n, 1.0).numpy(), np.asarray(jtransition_weight(n, 1.0))
    )


def test_cuda_device_without_gpu_raises(jax_params):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU error path cannot be reached")
    _, tcfg = _cfgs()
    with pytest.raises(RuntimeError, match="cuda"):
        tsep.Separator(params_from_jax(jax_params), tcfg, device="cuda")
