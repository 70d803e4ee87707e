"""Windowed long tracks: a track chained through W-chunk windows (the
LSTM state and the unnormalized overlap-add tail carried between them)
equals the single whole-track program bit for bit at 25 % overlap,
streaming or not, from a host array or a tensor on the device, for W
that does and does not divide the chunk count; the planner's windowing
decision; and the port against the JAX ``Separator`` with the window
forced, dense and as the whole catalogue slice (quantized weights, the
per-target recurrence, windowed)."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from umx_tpu.config import EngineConfig as JEngineConfig
from umx_tpu.config import ModelConfig as JModelConfig
from umx_tpu.config import SegmentConfig as JSegmentConfig
from umx_tpu.config import WienerConfig as JWienerConfig
from umx_tpu.engine.separator import Separator as JSeparator
from umx_tpu.models.umx import synthetic_params
from umx_tpu_torch.config import EngineConfig, ModelConfig, SegmentConfig
from umx_tpu_torch.engine import memory
from umx_tpu_torch.engine import separator as tsep
from umx_tpu_torch.io.ggml import write_ggml
from umx_tpu_torch.models.umx import params_from_jax, synthetic_state_dicts
from umx_tpu_torch.ops.qmatmul import QTensor

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
    # 2.1 s at 0.5 s segments and 25 % overlap: 6 chunks, so W = 4 gives a
    # full window and one padded with silent chunks, W = 3 and 2 divide
    rng = np.random.default_rng(7)
    return rng.uniform(-0.5, 0.5, (2, int(2.1 * SR))).astype(np.float32)


@pytest.fixture(scope="module")
def jax_params():
    return synthetic_params(JModelConfig(hidden_size=HIDDEN), seed=0)


@pytest.fixture(scope="module")
def params(jax_params):
    return params_from_jax(jax_params)


def _cfg(W=-1, streaming=True, chunk_batch=0, **model):
    return EngineConfig(
        model=ModelConfig(hidden_size=HIDDEN, **model),
        segment=SegmentConfig(segment_secs=0.5, streaming=streaming, window_chunks=W,
                              chunk_batch=chunk_batch),
        shifts=0,
    )


@pytest.fixture(scope="module")
def single(track, params):
    return {s: tsep.Separator(params, _cfg(streaming=s, chunk_batch=1), "cpu").demix(track)
            for s in (True, False)}


@pytest.mark.parametrize("W", [1, 2, 3, 4])
@pytest.mark.parametrize("streaming", [True, False])
def test_windowed_equals_single_program_bit_for_bit(track, params, single, W, streaming):
    sep = tsep.Separator(params, _cfg(W, streaming, chunk_batch=1), "cpu")
    assert sep._geometry(track.shape[1])[2] == 6
    out = sep.demix(track)
    assert out.shape == (4, 2, track.shape[1]) and out.device.type == "cpu"
    assert torch.equal(out, single[streaming]), f"W={W}"


def test_windowed_device_tensor_equals_host_array(track, params, single):
    """A tensor that already lies on the separator's device takes the
    in-place result buffer and comes back as a tensor on that device."""
    sep = tsep.Separator(params, _cfg(4), "cpu")
    out = sep.demix(torch.from_numpy(track))
    assert isinstance(out, torch.Tensor) and out.device == sep.device
    assert torch.equal(out, single[True])


def test_windowed_nonstreaming_group_width(track, params, single):
    # groups of 2 inside windows of 4: other batch widths through the
    # matmuls than the single program's groups of 1, so not bit for bit
    out = tsep.Separator(params, _cfg(4, streaming=False, chunk_batch=2), "cpu").demix(track)
    ref = single[False]
    assert float((out - ref).abs().max() / ref.abs().max()) <= 1e-6


def test_windowed_auto_follows_the_planner(track, params, monkeypatch):
    """window_chunks=0 keeps the single program while the planner says the
    track fits and windows beyond that, at the even split of the chunks."""
    calls = []
    real = tsep.Separator._demix_windowed

    def spy(self, audio, n_chunks, seg, stride, W, chunk_batch, progress=None):
        calls.append(W)
        return real(self, audio, n_chunks, seg, stride, W, chunk_batch, progress)

    monkeypatch.setattr(tsep.Separator, "_demix_windowed", spy)
    monkeypatch.setattr(tsep, "suggest_window_chunks", lambda *a, **kw: 10_000)
    ref = tsep.Separator(params, _cfg(0), "cpu").demix(track)
    assert calls == []
    # the planner allows 4: 6 chunks make 2 windows, evenly 3 + 3
    monkeypatch.setattr(tsep, "suggest_window_chunks", lambda *a, **kw: 4)
    sep = tsep.Separator(params, _cfg(0), "cpu")
    out = sep.demix(track)
    assert calls == [3]
    assert torch.equal(out, ref)
    sep.demix(track[:, : int(1.4 * SR)])  # 4 chunks fit the planner's 4
    assert calls == [3]
    assert list(sep._window_plans) == [0]  # memoised per 256 MB bucket of resident bytes


def test_window_planner_estimates():
    umxl = EngineConfig()
    cap = 80 * 2**30
    w = memory.suggest_window_chunks(umxl, hbm_bytes=cap)
    assert w >= 2
    # the window it picks fits, the next one does not
    def est(n):
        secs = n * umxl.segment.stride_samples(SR) / SR
        return (memory.fused_track_hbm_bytes(umxl, 1, secs)["total"]
                + 4 * 2 * n * umxl.segment.stride_samples(SR) * 4)
    assert est(w) <= 0.9 * cap < est(w + 1)
    # bytes the caller keeps resident shrink it; a smaller card shrinks it
    assert memory.suggest_window_chunks(umxl, hbm_bytes=cap, resident_bytes=20 * 2**30) < w
    assert memory.suggest_window_chunks(umxl, hbm_bytes=16 * 2**30) < w
    ns = dataclasses.replace(umxl, segment=SegmentConfig(streaming=False))
    assert 1 <= memory.suggest_window_chunks(ns, hbm_bytes=cap) <= w
    # fleet batches: streaming = the shift-batch planner, non-streaming at
    # the width each batch would run at
    assert (memory.suggest_max_fleet_batch(umxl, 100.0, hbm_bytes=cap)
            == memory.suggest_max_batch(umxl, 100.0, hbm_bytes=cap))
    b = memory.suggest_max_fleet_batch(ns, 100.0, hbm_bytes=cap)
    wid = memory.suggest_chunk_batch(ns, 100.0, hbm_bytes=cap, batch=b)
    assert b >= 1
    assert memory.parallel_track_hbm_bytes(ns, wid, 100.0, batch=b)["total"] <= 0.9 * cap


def _rel(ours, ref):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape and np.isfinite(ours).all()
    return float(np.max(np.abs(ours - ref)) / np.max(np.abs(ref)))


@pytest.mark.parametrize("streaming", [True, False])
def test_windowed_matches_jax_windowed(track, jax_params, params, streaming):
    jcfg = JEngineConfig(
        model=JModelConfig(hidden_size=HIDDEN, lstm_impl="pallas_interpret"),
        segment=JSegmentConfig(segment_secs=0.5, streaming=streaming, window_chunks=4,
                               chunk_batch=2),
        wiener=JWienerConfig(impl="pallas_interpret"),
        shifts=0,
    )
    ref = np.asarray(JSeparator(jax_params, jcfg).demix(track))
    ours = tsep.Separator(params, _cfg(4, streaming, chunk_batch=2), "cpu").demix(track).numpy()
    err = _rel(ours, ref)
    assert err <= SLICE_RTOL, f"max|Δ|/max|stem| = {err:.3g}"


@pytest.fixture(scope="module")
def tonal():
    t = np.arange(int(2.1 * SR)) / SR
    rng = np.random.default_rng(0)
    return np.stack([
        0.4 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.standard_normal(t.size),
        0.3 * np.sin(2 * np.pi * 330 * t) + 0.05 * rng.standard_normal(t.size),
    ]).astype(np.float32)


def test_catalogue_slice_matches_jax(tonal, tmp_path):
    """The slice as a whole: weights from a ggml file, the per-target
    recurrence, a forced window, shifts 1, against the JAX ``Separator``
    loading the same file with its per-target kernel in interpret mode:
    dense weights, then quantized ones."""
    path = str(tmp_path / "model.bin")
    write_ggml(path, HIDDEN, synthetic_state_dicts(ModelConfig(hidden_size=HIDDEN), seed=0))
    jcfg = JEngineConfig(
        model=JModelConfig(hidden_size=HIDDEN, lstm_impl="pallas_interpret"),
        segment=JSegmentConfig(segment_secs=0.5, window_chunks=4),
        wiener=JWienerConfig(impl="pallas_interpret"),
        shifts=1,
    )
    tcfg = dataclasses.replace(_cfg(4, lstm_impl="pallas"), shifts=1)
    ref = JSeparator.from_ggml(path, jcfg).demix_track(tonal, seed=3)
    ours = tsep.Separator.from_ggml(path, tcfg, "cpu").demix_track(tonal, seed=3)
    err = _rel(ours, ref)
    assert err <= SLICE_RTOL, f"dense: max|Δ|/max|stem| = {err:.3g}"

    jsep = JSeparator.from_ggml(path, jcfg, quantized_hbm=True)
    qref = jsep.demix_track(tonal, seed=3)
    qours = tsep.Separator.from_ggml(path, tcfg, "cpu", quantized_hbm=True).demix_track(
        tonal, seed=3)
    err = _rel(qours, qref)
    # The quantized network rounds its activations to bf16 before every
    # product (and takes offset * rowsum from the unrounded ones), so a
    # last-bit difference in the STFT flips roundings and the stems move
    # by bf16 noise: the JAX package's own quantized stems move by ~2e-2
    # of max|stem| when the track is scaled by 1 + 1e-6, measured below.
    # The port may differ from it by no more than three times that, and
    # 1e-1 at most; 1.6e-2 to 2.9e-2 measured.  The arithmetic itself is
    # held tight in tests/test_torch_qmatmul.py (phases on the same
    # inputs) and, with dense weights, at 2e-4 above.
    own = _rel(jsep.demix_track(tonal * np.float32(1 + 1e-6), seed=3), qref)
    gate = min(3 * own, 1e-1)
    assert err <= gate, f"quantized: {err:.3g} against the reference's own {own:.3g}"

    # What that gate still sees: a fault planted in one target's slice of
    # one quantized tensor (offset * rowsum dropped; hi and lo planes
    # swapped) fails it.  A fault in one LSTM input projection does not
    # reach the stems above bf16 noise with these weights; the phase gates
    # of tests/test_torch_qmatmul.py catch those.
    qsep = tsep.Separator.from_ggml(path, tcfg, "cpu", quantized_hbm=True)
    w = qsep.params.fc2_w
    no_offset = QTensor(w.planes, w.scale, w.offset * torch.tensor([1.0, 0.0, 1.0, 1.0]))
    w = qsep.params.fc3_w
    swapped = QTensor(tuple(torch.cat([b[:1], a[1:]]) for a, b in (w.planes, w.planes[::-1])),
                      w.scale, w.offset)
    for field, bad in (("fc2_w", no_offset), ("fc3_w", swapped)):
        faulty = tsep.Separator(dataclasses.replace(qsep.params, **{field: bad}), tcfg, "cpu")
        err = _rel(faulty.demix_track(tonal, seed=3), qref)
        assert err > gate, f"a planted fault in {field} passes the gate: {err:.3g} <= {gate:.3g}"
