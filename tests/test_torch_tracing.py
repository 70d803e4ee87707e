"""The program's spans (``utils.profiling.span``): which ``umx.`` spans the
fleet runner, the single-track demix and a training step put on a
``torch.profiler`` timeline, that an untraced run never builds a
``record_function``, and that tracing leaves every output bit-equal."""

from __future__ import annotations

from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from umx_tpu_torch.config import EngineConfig, ModelConfig, SegmentConfig
from umx_tpu_torch.engine.fleet import demix_tracks
from umx_tpu_torch.engine.separator import Separator
from umx_tpu_torch.models.umx import synthetic_params
from umx_tpu_torch.train import TrainConfig, init_train_state, make_train_step
from umx_tpu_torch.utils import profiling

HIDDEN, B, T = 32, 2, 12


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def params():
    return synthetic_params(ModelConfig(hidden_size=HIDDEN), seed=0)


@pytest.fixture(scope="module")
def tracks():
    # 0.5 s segments at 25 % overlap: 30k samples are 2 chunks (3 with the
    # shift pad), 50k are 4 (5): two buckets
    rng = np.random.default_rng(7)
    return [(0.3 * rng.standard_normal((2, n))).astype(np.float32)
            for n in (30_000, 50_000, 30_000)]


def _cfg(shifts: int) -> EngineConfig:
    return EngineConfig(model=ModelConfig(hidden_size=HIDDEN),
                        segment=SegmentConfig(segment_secs=0.5, window_chunks=-1), shifts=shifts)


def _spans(fn):
    """``fn()``'s result and the count of each ``umx.`` span it emitted
    under the CPU profiler."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    names = Counter(e.name() for e in prof.profiler.kineto_results.events()
                    if e.name().startswith("umx."))
    return out, names


@pytest.mark.parametrize("shifts", [1, 2])
def test_demix_tracks_emits_its_spans(params, tracks, shifts):
    stats = {}
    _, names = _spans(lambda: demix_tracks(params, tracks, _cfg(shifts), seeds=[1, 2, 3],
                                           stats=stats))
    passes, buckets, dispatches = shifts, 2, stats["dispatches"]
    assert dispatches == passes * buckets
    # the call's set-up (with the bucketing and the planner's caps), then
    # each dispatch's batch built on the device
    assert names["umx.prepare"] == 1 + dispatches
    assert names["umx.program"] == names["umx.combine"] == dispatches
    # one copy out a real track a pass, never the padded batch
    assert names["umx.to_host"] == passes * len(tracks)
    assert set(names) == {"umx.prepare", "umx.program", "umx.to_host", "umx.combine"}


def test_demix_track_emits_its_spans(params, tracks):
    _, names = _spans(lambda: Separator(params, _cfg(1), "cpu").demix_track(tracks[1], seed=4))
    # the shift pad, then the track's move onto the device
    assert names == {"umx.prepare": 2, "umx.program": 1, "umx.to_host": 1}


def _batch(cfg: ModelConfig) -> dict:
    rng = np.random.default_rng(5)
    return {
        "x": torch.from_numpy(rng.uniform(0, 1, (B, T, cfg.n_features)).astype(np.float32)),
        "mix_mag": torch.from_numpy(rng.uniform(0, 1, (B, 2, T, cfg.n_bins)).astype(np.float32)),
        "target_mag": torch.from_numpy(
            rng.uniform(0, 1, (B, 4, 2, T, cfg.n_bins)).astype(np.float32)),
    }


def _train_once(params, traced: bool):
    cfg = ModelConfig(hidden_size=HIDDEN)
    state = init_train_state(params, TrainConfig())
    step = make_train_step(cfg)
    if not traced:
        return step(state, _batch(cfg)), Counter()
    return _spans(lambda: step(state, _batch(cfg)))


def test_train_step_emits_its_spans(params):
    _, names = _train_once(params, traced=True)
    assert names == {"umx.train.backward": 1, "umx.train.optimizer": 2}


def test_span_is_free_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) built with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert profiling.span("umx.program") is profiling.span("umx.prepare")
    with profiling.span("umx.program"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(AssertionError, match="umx.program"):
            profiling.span("umx.program")


def test_span_is_on_the_timeline_of_the_legacy_profiler():
    with torch.autograd.profiler.profile() as prof:
        with profiling.span("umx.combine"):
            torch.ones(3).sum()
    assert any(e.name == "umx.combine" for e in prof.function_events)


def test_tracing_leaves_the_outputs_bit_equal(params, tracks):
    cfg = _cfg(1)
    plain = demix_tracks(params, tracks, cfg, seeds=[1, 2, 3])
    traced, _ = _spans(lambda: demix_tracks(params, tracks, cfg, seeds=[1, 2, 3]))
    for a, b in zip(plain, traced):
        np.testing.assert_array_equal(a, b)
    sep = Separator(params, cfg, "cpu")
    plain = sep.demix_track(tracks[0], seed=9)
    traced, _ = _spans(lambda: sep.demix_track(tracks[0], seed=9))
    np.testing.assert_array_equal(plain, traced)
    (s0, loss0), _ = _train_once(params, traced=False)
    (s1, loss1), _ = _train_once(params, traced=True)
    assert torch.equal(loss0, loss1)
    for name in ("fc1_w", "lstm_hh_w", "fc3_w"):
        assert torch.equal(getattr(s0.params, name), getattr(s1.params, name))
