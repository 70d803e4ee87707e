"""The port's memory planner against the JAX planner's liveness terms, and
the properties its callers rely on (monotone in capacity, the 16-row cap,
exact parameter bytes)."""

from __future__ import annotations

import dataclasses

import pytest

from umx_tpu.config import EngineConfig as JEngineConfig
from umx_tpu.config import ModelConfig as JModelConfig
from umx_tpu.config import SegmentConfig as JSegmentConfig
from umx_tpu.engine import memory as jmem
from umx_tpu_torch.config import DSPConfig, EngineConfig, ModelConfig, SegmentConfig
from umx_tpu_torch.engine import memory
from umx_tpu_torch.models.umx import synthetic_params

TERMS = ("ys", "stems", "audio", "seg_transients")


def _cfgs(hidden=1024, seg_secs=60.0):
    # "auto" stacks: the JAX planner resolves them on its CPU backend, the
    # port's by the device it is given (float32 on the CPU)
    jcfg = JEngineConfig(model=JModelConfig(hidden_size=hidden),
                         segment=JSegmentConfig(segment_secs=seg_secs))
    tcfg = EngineConfig(model=ModelConfig(hidden_size=hidden),
                        segment=SegmentConfig(segment_secs=seg_secs))
    return jcfg, tcfg


@pytest.mark.parametrize("batch, secs", [(1, 100.0), (3, 420.0), (2, 7.5)])
def test_fused_track_terms_equal_jax(batch, secs):
    jcfg, tcfg = _cfgs()
    ref = jmem.fused_track_hbm_bytes(jcfg, batch, secs)
    ours = memory.fused_track_hbm_bytes(tcfg, batch, secs, device="cpu")
    for k in TERMS:
        assert ours[k] == ref[k], k


@pytest.mark.parametrize("width, batch, secs", [(1, 1, 100.0), (3, 1, 100.0), (4, 2, 420.0),
                                                (16, 1, 30.0)])
def test_parallel_track_terms_equal_jax(width, batch, secs):
    jcfg, tcfg = _cfgs()
    ref = jmem.parallel_track_hbm_bytes(jcfg, width, secs, batch=batch)
    ours = memory.parallel_track_hbm_bytes(tcfg, width, secs, batch=batch, device="cpu")
    for k in TERMS:
        assert ours[k] == ref[k], k


def test_ct2_counts_the_whole_frames_buffer():
    """What the planner counts of the iSTFT frames: the dense inverse a
    quarter of them, the ct2 kernel none (it once kept the whole buffer
    between two launches; it now overlap-adds on chip and has no frames in
    device memory), and the other terms are the same for both."""
    _, tcfg = _cfgs()
    ct2 = dataclasses.replace(tcfg, dsp=DSPConfig(istft_algo="ct2"))
    t = tcfg.dsp.n_frames(tcfg.segment.segment_samples(44100))
    frames = 4 * 2 * t * 4096 * 4
    planes = (2 * 4 * 2 + 2 * 2 + 4 * 2) * t * 2049 * 4  # y, mix, masks
    assert memory._segment_transient_bytes(ct2) == planes
    assert memory._segment_transient_bytes(tcfg) == planes + frames // 4
    # the ct2 estimate of a track is below the dense one by its rows' frames share
    dense_est = memory.parallel_track_hbm_bytes(tcfg, 2, 100.0)
    ct2_est = memory.parallel_track_hbm_bytes(ct2, 2, 100.0)
    assert ct2_est["seg_transients"] == dense_est["seg_transients"] - 2 * (frames // 4)


@pytest.mark.parametrize("batch", [1, 2, 3])
def test_suggest_chunk_batch_monotone_and_capped(batch):
    _, tcfg = _cfgs()
    widths = [memory.suggest_chunk_batch(tcfg, 420.0, hbm_bytes=g * 2**30, batch=batch)
              for g in (4, 8, 16, 32, 80, 1024)]
    assert widths == sorted(widths) and widths[0] >= 1
    assert all(w * batch <= 16 for w in widths)
    assert widths[-1] == 16 // batch


def test_suggest_max_batch_monotone():
    _, tcfg = _cfgs()
    fits = [memory.suggest_max_batch(tcfg, 100.0, hbm_bytes=g * 2**30) for g in (2, 8, 16, 80, 400)]
    assert fits == sorted(fits) and fits[0] == 1 and fits[-1] > fits[2]


def test_estimates_grow_with_width_and_batch():
    _, tcfg = _cfgs()
    tot = [memory.parallel_track_hbm_bytes(tcfg, w, 420.0)["total"] for w in (1, 2, 4, 8)]
    assert tot == sorted(tot) and len(set(tot)) == 4
    tot = [memory.fused_track_hbm_bytes(tcfg, b, 100.0)["total"] for b in (1, 2, 4)]
    assert tot == sorted(tot) and len(set(tot)) == 3


def test_params_bytes_exact_when_given():
    _, tcfg = _cfgs(hidden=64)
    params = synthetic_params(tcfg.model, seed=0)
    exact = sum(getattr(params, f.name).numel() * 4 for f in dataclasses.fields(params))
    assert memory.params_hbm_bytes(tcfg, params) == exact
    # the shape-derived estimate counts the same float32 tensors
    assert memory.params_hbm_bytes(tcfg) == int(exact * memory._PARAMS_OVERHEAD)


def test_device_capacity_on_cpu_is_physical_ram():
    assert memory.device_hbm_bytes("cpu") > 2**30


@pytest.mark.parametrize("device", [None, "cuda", "cuda:0"])
def test_device_capacity_defaults_to_the_card_and_raises_without_one(device, monkeypatch):
    """No silent answer with the host's RAM: the default is the GPU, and a
    machine without one raises unless the CPU is asked for."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        memory.device_hbm_bytes(device)
    _, tcfg = _cfgs(hidden=64)
    with pytest.raises(RuntimeError, match="is_available"):
        memory.suggest_max_batch(tcfg, 100.0, device=device)
    assert memory.suggest_max_batch(tcfg, 100.0, device="cpu") >= 1


def test_device_capacity_of_a_card_is_its_total_memory(monkeypatch):
    import torch

    asked = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda dev: asked.append(dev) or (1 * 2**30, 80 * 2**30))
    assert memory.device_hbm_bytes() == 80 * 2**30
    assert memory.device_hbm_bytes("cuda:1") == 80 * 2**30
    assert [d.type for d in asked] == ["cuda", "cuda"] and asked[1].index == 1


def test_peak_counts_the_recurrence_kernels_exchange_buffer():
    """UMX-L: 8 chains x 2 step parities x 16 rows x 256 words of 8 bytes."""
    _, tcfg = _cfgs()
    assert memory._lstm_exchange_bytes(tcfg) == 512 * 1024
    est = memory.fused_track_hbm_bytes(tcfg, 1, 100.0)
    parts = est["ys"] + est["stems"] + est["audio"] + int(
        est["seg_transients"] * memory._TRANSIENT_FACTOR["dense"])
    assert est["boundary"] == parts + 512 * 1024


@pytest.mark.parametrize("batch", [1, 4, 32])
def test_segment_batch_terms_equal_jax(batch):
    """The batched segment call's raw terms are the JAX planner's: the
    audio in and waveforms out, and the rows' transients (the ct2 inverse
    keeps no frames, so its rows count exactly the JAX package's planes;
    the dense inverse adds its frames share)."""
    jcfg, tcfg = _cfgs()
    ref = jmem.segment_batch_hbm_bytes(jcfg, batch)
    ours = memory.segment_batch_hbm_bytes(tcfg, batch)
    assert ours["io"] == ref["io"]
    ct2 = dataclasses.replace(tcfg, dsp=DSPConfig(istft_algo="ct2"))
    assert memory.segment_batch_hbm_bytes(ct2, batch)["seg_transients"] == ref["transients"]
    assert ours["seg_transients"] == batch * memory._segment_transient_bytes(tcfg)
    parts = ours["transients"] + ours["io"] + ours["fixed"] + ours["params"]
    assert ours["total"] == parts
    assert ours["fixed"] >= memory._lstm_exchange_bytes(tcfg)


def test_suggest_max_segment_batch_monotone():
    """The widest batch whose estimate fits 0.9 of the capacity, and never
    fewer than one row."""
    _, tcfg = _cfgs()
    caps = (1, 8, 16, 80, 400)
    fits = [memory.suggest_max_segment_batch(tcfg, hbm_bytes=g * 2**30) for g in caps]
    assert fits == sorted(fits) and fits[0] == 1 and fits[-1] > fits[2]

    def total(b):
        return memory.segment_batch_hbm_bytes(tcfg, b)["total"]

    for g, b in zip(caps[1:], fits[1:]):
        assert total(b) <= 0.9 * g * 2**30 < total(b + 1)
    # the quantized parameters are smaller, so no fewer rows fit
    assert memory.suggest_max_segment_batch(tcfg, hbm_bytes=8 * 2**30, quantized=True) >= fits[1]


def test_quantized_params_bytes_derived_and_exact(tmp_path):
    """The shape-derived quantized size against the exact resident bytes of
    quantized parameters (bf16 planes, per-tensor scale and offset)."""
    from umx_tpu_torch.io.ggml import read_ggml, write_ggml
    from umx_tpu_torch.models.umx import quantized_params_from_ggml, synthetic_state_dicts

    _, tcfg = _cfgs(hidden=64)
    path = str(tmp_path / "m.bin")
    write_ggml(path, 64, synthetic_state_dicts(tcfg.model, seed=0))
    q = quantized_params_from_ggml(read_ggml(path, keep_quantized=True), tcfg.model)
    exact = memory.params_hbm_bytes(tcfg, q)
    derived = memory.params_hbm_bytes(tcfg, quantized=True)
    assert exact <= derived <= exact * 1.01
    assert derived < memory.params_hbm_bytes(tcfg)
