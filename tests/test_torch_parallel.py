"""The batched whole-track demix: non-streaming chunk groups at every
width, batched shift passes (streaming and not), the overlap-add kernel's
arm and the Cooley-Tukey iSTFT, each against the JAX ``Separator`` on the
same weights and track (BLSTM and Wiener kernels in Pallas interpret
mode); and the streaming default, bit-equal to the chunk loop it
replaced."""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from umx_tpu.config import DSPConfig as JDSPConfig
from umx_tpu.config import EngineConfig as JEngineConfig
from umx_tpu.config import ModelConfig as JModelConfig
from umx_tpu.config import SegmentConfig as JSegmentConfig
from umx_tpu.config import WienerConfig as JWienerConfig
from umx_tpu.engine.separator import Separator as JSeparator
from umx_tpu.models.umx import synthetic_params
from umx_tpu_torch.config import DSPConfig, EngineConfig, ModelConfig, SegmentConfig
from umx_tpu_torch.engine import fleet
from umx_tpu_torch.engine import separator as tsep
from umx_tpu_torch.models.umx import init_lstm_state, params_from_jax

HIDDEN = 32
SR = 44100
# bf16 operands in the recurrence plus FFT and matmul summation order: the
# class of tests/test_torch_separator.py (max|Δ|/max|stem|)
SLICE_RTOL = 2e-4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def track():
    # 2.6 s: with 1 s segments at 25 % overlap that is 4 chunks (5 with
    # the shift pad), so groups of 3 leave a remainder group
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


@pytest.fixture(scope="module")
def params(jax_params):
    return params_from_jax(jax_params)


def _cfgs(streaming=True, shifts=1, chunk_batch=0, ola_impl="auto", ct2=False):
    jdsp = (JDSPConfig(fft_impl="matmul", dft_precision="highest", idft_precision="highest",
                       istft_algo="ct2_interpret") if ct2 else JDSPConfig())
    jcfg = JEngineConfig(
        dsp=jdsp,
        model=JModelConfig(hidden_size=HIDDEN, lstm_impl="pallas_interpret"),
        segment=JSegmentConfig(segment_secs=1.0, streaming=streaming, window_chunks=-1,
                               chunk_batch=chunk_batch),
        wiener=JWienerConfig(impl="pallas_interpret"),
        shifts=shifts,
        ola_impl="pallas_interpret" if ola_impl == "pallas" else ola_impl,
    )
    tcfg = EngineConfig(
        dsp=DSPConfig(istft_algo="ct2" if ct2 else "auto"),
        model=ModelConfig(hidden_size=HIDDEN),
        segment=SegmentConfig(segment_secs=1.0, streaming=streaming, chunk_batch=chunk_batch),
        shifts=shifts,
        ola_impl=ola_impl,
    )
    return jcfg, tcfg


def _rel(ours, ref):
    assert ours.shape == ref.shape
    assert ours.dtype == np.float32 and np.isfinite(ours).all()
    return float(np.max(np.abs(ours - ref)) / np.max(np.abs(ref)))


@pytest.fixture(scope="module")
def jax_nonstreaming(track, jax_params):
    jcfg, _ = _cfgs(streaming=False, shifts=0)
    return np.asarray(JSeparator(jax_params, jcfg).demix(track))


@pytest.mark.parametrize("width", [1, 2, 3])
def test_demix_fused_parallel_widths_match_jax(track, params, jax_nonstreaming, width):
    # 4 chunks: width 3 runs a group of 3 and a remainder group of 1
    _, tcfg = _cfgs(streaming=False, shifts=0)
    sep = tsep.Separator(params, tcfg, "cpu")
    seg, stride, n_chunks, padded_len = sep._geometry(track.shape[1])
    assert n_chunks == 4
    audio_p = torch.nn.functional.pad(torch.from_numpy(track), (0, padded_len - track.shape[1]))
    with torch.inference_mode():
        out = tsep.demix_fused_parallel(params, audio_p, tcfg, n_chunks, seg, stride, width)
    ours = out[..., : track.shape[1]].numpy()
    err = _rel(ours, jax_nonstreaming)
    assert err <= SLICE_RTOL, f"width {width}: max|Δ|/max|stem| = {err:.3g}"


def test_nonstreaming_auto_width_matches_jax(track, params, jax_nonstreaming, monkeypatch):
    # chunk_batch = 0: the planner's width (every chunk in one group here)
    seen = []
    real = tsep.demix_fused_parallel

    def spy(*args):
        seen.append(args[-1])
        return real(*args)

    monkeypatch.setattr(tsep, "demix_fused_parallel", spy)
    _, tcfg = _cfgs(streaming=False, shifts=0, chunk_batch=0)
    ours = tsep.Separator(params, tcfg, "cpu").demix_track(track, seed=0)
    assert seen == [4]
    err = _rel(ours, jax_nonstreaming)
    assert err <= SLICE_RTOL, f"max|Δ|/max|stem| = {err:.3g}"


@pytest.mark.parametrize("streaming", [True, False])
def test_batched_shifts_match_jax(track, jax_params, params, streaming, monkeypatch):
    jcfg, tcfg = _cfgs(streaming=streaming, shifts=2)
    calls = []
    real = tsep.Separator._demix_shifts_batched

    def spy(self, audio, offsets, max_shift, max_batch):
        calls.append((len(offsets), max_batch))
        return real(self, audio, offsets, max_shift, max_batch)

    monkeypatch.setattr(tsep.Separator, "_demix_shifts_batched", spy)
    ref = JSeparator(jax_params, jcfg).demix_track(track, seed=0)
    ours = tsep.Separator(params, tcfg, "cpu").demix_track(track, seed=0)
    assert calls and calls[0][0] == 2 and calls[0][1] >= 2  # both passes in one batch
    err = _rel(ours, ref)
    assert err <= SLICE_RTOL, f"max|Δ|/max|stem| = {err:.3g}"


def test_batched_shifts_equal_sequential_passes(track, params):
    # the batched program computes what the pass-by-pass loop computes
    _, tcfg = _cfgs(streaming=True, shifts=2)
    sep = tsep.Separator(params, tcfg, "cpu")
    batched = sep.demix_track(track, seed=3)
    max_shift = tcfg.segment.max_shift_samples(SR)
    offsets = [int(o) for o in np.random.default_rng(3).integers(0, max_shift, size=2)]
    acc = 0
    for off in offsets:
        shifted = np.pad(track, ((0, 0), (off, max_shift - off)))
        acc = acc + sep.demix(shifted)[..., off : off + track.shape[1]].numpy()
    np.testing.assert_allclose(batched, acc / 2, atol=1e-5 * np.abs(batched).max(), rtol=0)


def test_ola_kernel_arm_matches_jax(track, jax_params, params):
    jcfg, tcfg = _cfgs(streaming=True, shifts=0, ola_impl="pallas")
    ref = np.asarray(JSeparator(jax_params, jcfg).demix(track))
    ours = tsep.Separator(params, tcfg, "cpu").demix(track).numpy()
    err = _rel(ours, ref)
    assert err <= SLICE_RTOL, f"max|Δ|/max|stem| = {err:.3g}"


def test_ct2_istft_matches_jax(track, jax_params, params):
    jcfg, tcfg = _cfgs(streaming=False, shifts=0, ct2=True)
    ref = np.asarray(JSeparator(jax_params, jcfg).demix(track))
    ours = tsep.Separator(params, tcfg, "cpu").demix(track).numpy()
    err = _rel(ours, ref)
    assert err <= SLICE_RTOL, f"max|Δ|/max|stem| = {err:.3g}"


def test_streaming_auto_stems_equal_the_chunk_loop(track, params):
    # "auto" = one slice-add per chunk, then / weight sum: bit-equal to the
    # accumulate-as-you-go loop, which sums the same <= 2 addends per sample
    _, tcfg = _cfgs(streaming=True, shifts=0)
    sep = tsep.Separator(params, tcfg, "cpu")
    ours = sep.demix(track)
    seg, stride, n_chunks, padded_len = sep._geometry(track.shape[1])
    audio_p = torch.nn.functional.pad(torch.from_numpy(track), (0, padded_len - track.shape[1]))
    weight = tsep.transition_weight(seg, tcfg.segment.transition_power)
    out = torch.zeros((4, 2, padded_len))
    sum_weight = torch.zeros((padded_len,))
    state = init_lstm_state(tcfg.model)
    with torch.inference_mode():
        for i in range(n_chunks):
            off = i * stride
            chunk_out, state = tsep.segment_forward(params, audio_p[:, off : off + seg], state,
                                                    tcfg, seg)
            out[..., off : off + seg] += weight * chunk_out
            sum_weight[off : off + seg] += weight
    assert torch.equal(ours, (out / sum_weight)[..., : track.shape[1]])


def test_segment_forward_rows_are_independent(track, params):
    # a batch of rows gives each row's single-row result (the Wiener
    # scaling is per row): row 1 alone equals row 1 of the batch
    _, tcfg = _cfgs(streaming=False)
    seg = tcfg.segment.segment_samples(SR)
    rows = torch.from_numpy(np.stack([track[:, :seg], 3.0 * track[:, -seg:]]))
    state = init_lstm_state(tcfg.model, batch=2)
    with torch.inference_mode():
        both, _ = tsep.segment_forward_batched(params, rows, state, tcfg, seg)
        one, _ = tsep.segment_forward(params, rows[1], init_lstm_state(tcfg.model), tcfg, seg)
    np.testing.assert_allclose(both[1].numpy(), one.numpy(), atol=1e-6 * float(one.abs().max()),
                               rtol=0)


def test_resolve_batched_width():
    _, tcfg = _cfgs(streaming=False, chunk_batch=0)
    assert fleet.resolve_batched_width(tcfg, 5, 44100, 33075, batch=2, device="cpu") == 5
    # the 16-row cap
    assert fleet.resolve_batched_width(tcfg, 40, 44100, 33075, batch=4, device="cpu") == 4
    fixed = dataclasses.replace(tcfg, segment=dataclasses.replace(tcfg.segment, chunk_batch=3))
    assert fleet.resolve_batched_width(fixed, 40, 44100, 33075, batch=4) == 3
    assert fleet.resolve_batched_width(fixed, 2, 44100, 33075) == 2
