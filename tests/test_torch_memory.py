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
    # the port keeps the stacked chunk outputs in float32
    jcfg = JEngineConfig(model=JModelConfig(hidden_size=hidden),
                         segment=JSegmentConfig(segment_secs=seg_secs),
                         stems_stack_dtype="float32")
    tcfg = EngineConfig(model=ModelConfig(hidden_size=hidden),
                        segment=SegmentConfig(segment_secs=seg_secs))
    return jcfg, tcfg


@pytest.mark.parametrize("batch, secs", [(1, 100.0), (3, 420.0), (2, 7.5)])
def test_fused_track_terms_equal_jax(batch, secs):
    jcfg, tcfg = _cfgs()
    ref = jmem.fused_track_hbm_bytes(jcfg, batch, secs)
    ours = memory.fused_track_hbm_bytes(tcfg, batch, secs)
    for k in TERMS:
        assert ours[k] == ref[k], k


@pytest.mark.parametrize("width, batch, secs", [(1, 1, 100.0), (3, 1, 100.0), (4, 2, 420.0),
                                                (16, 1, 30.0)])
def test_parallel_track_terms_equal_jax(width, batch, secs):
    jcfg, tcfg = _cfgs()
    ref = jmem.parallel_track_hbm_bytes(jcfg, width, secs, batch=batch)
    ours = memory.parallel_track_hbm_bytes(tcfg, width, secs, batch=batch)
    for k in TERMS:
        assert ours[k] == ref[k], k


def test_ct2_counts_the_whole_frames_buffer():
    _, tcfg = _cfgs()
    ct2 = dataclasses.replace(tcfg, dsp=DSPConfig(istft_algo="ct2"))
    t = tcfg.dsp.n_frames(tcfg.segment.segment_samples(44100))
    frames = 4 * 2 * t * 4096 * 4
    assert (memory._segment_transient_bytes(ct2) - memory._segment_transient_bytes(tcfg)
            == frames - frames // 4)


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
