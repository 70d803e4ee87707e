"""The port's SegmentBatcher: the cases of tests/test_batcher.py (fairness
to a minority shape, coalescing, the reset's generation guard), run
without the ``slow`` mark (the JAX tests are slow for their XLA compiles;
eager PyTorch compiles nothing), and what the port adds: a batched
group's rows have the bits of ``segment_forward`` on each row alone (a
call runs exactly its rows, no padding), the worker runs in inference
mode, and ``close`` fails the jobs still queued."""

from __future__ import annotations

import threading
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from umx_tpu_torch.config import EngineConfig, ModelConfig, SegmentConfig
from umx_tpu_torch.engine import batcher as batcher_mod
from umx_tpu_torch.engine.batcher import SegmentBatcher, device_cfg
from umx_tpu_torch.engine.separator import segment_forward
from umx_tpu_torch.models.umx import LSTMState, init_lstm_state, synthetic_params


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def setup():
    cfg = EngineConfig(model=ModelConfig(hidden_size=64), segment=SegmentConfig(segment_secs=0.5))
    params = synthetic_params(cfg.model, seed=0)
    state = init_lstm_state(cfg.model)
    rng = np.random.default_rng(0)
    n_a, n_b = 22528, 11264
    audio_a = torch.from_numpy(rng.uniform(-0.5, 0.5, (2, n_a)).astype(np.float32))
    audio_b = torch.from_numpy(rng.uniform(-0.5, 0.5, (2, n_b)).astype(np.float32))
    return cfg, params, state, (n_a, audio_a), (n_b, audio_b)


def test_minority_shape_not_starved(setup):
    """A minority-shape job queued mid-stream runs before every
    majority-shape job queued after it (the oldest job seeds each group).
    Jobs go into the queue directly, in a known order: the worker drains
    it in arrival order, so the assertion is deterministic."""
    cfg, params, state, (n_a, audio_a), (n_b, audio_b) = setup
    batcher = SegmentBatcher(max_batch=2, max_wait_ms=20.0)
    try:
        order: list[str] = []
        lock = threading.Lock()

        def submit(name, audio, n):
            fut: Future = Future()

            def record(_f, name=name):
                with lock:
                    order.append(name)

            fut.add_done_callback(record)
            batcher._q.put(((device_cfg(cfg), n, id(params)), params, audio, state, fut))
            return fut

        futs = [submit(f"a{i}", audio_a, n_a) for i in range(6)]
        futs.append(submit("b", audio_b, n_b))  # the minority job, mid-stream
        futs += [submit(f"a{i}", audio_a, n_a) for i in range(6, 12)]
        for f in futs:
            f.result(timeout=300)
        assert len(order) == 13
        late = [order.index(f"a{i}") for i in range(6, 12)]
        assert order.index("b") < min(late), f"minority-shape job starved: {order}"
    finally:
        batcher.close()


def test_coalesces_same_shape(setup):
    cfg, params, state, (n_a, audio_a), _ = setup
    batcher = SegmentBatcher(max_batch=4, max_wait_ms=50.0)
    try:
        batcher.run(params, audio_a, state, cfg, n_a)
        batcher.reset_stats()
        threads = [threading.Thread(target=batcher.run, args=(params, audio_a, state, cfg, n_a))
                   for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
        assert batcher.stats.jobs == 4
        assert batcher.stats.device_calls < 4  # coalescing happened
        assert 0.0 <= batcher.utilization() <= 1.0
    finally:
        batcher.close()


def test_reset_stats_discards_inflight_sample(setup):
    """A reset racing a call in flight does not book the pre-reset call's
    time against the fresh clock."""
    cfg, params, state, (n_a, audio_a), _ = setup
    batcher = SegmentBatcher(max_batch=1)
    try:
        batcher.run(params, audio_a, state, cfg, n_a)
        t = threading.Thread(target=batcher.run, args=(params, audio_a, state, cfg, n_a))
        t.start()
        batcher.reset_stats()  # while the job is (likely) in its call
        t.join(timeout=300)
        assert not t.is_alive()
        assert batcher.utilization() <= 1.0
        # the job either landed wholly after the reset or was dropped
        assert batcher.stats.jobs in (0, 1)
        assert batcher.stats.device_calls == batcher.stats.jobs
    finally:
        batcher.close()


def test_group_rows_are_bit_equal_to_rows_alone(setup):
    """Three requests' segments, each with its own audio and state, run as
    one batched call of exactly three rows; each row's waveform and new
    state have the bits of ``segment_forward`` on that row alone."""
    cfg, params, _, (n_a, _), _ = setup
    rng = np.random.default_rng(5)
    jobs = []
    for _ in range(3):
        audio = torch.from_numpy(rng.uniform(-0.5, 0.5, (2, n_a)).astype(np.float32))
        shape = init_lstm_state(cfg.model).h.shape
        state = LSTMState(h=torch.from_numpy(rng.uniform(-0.5, 0.5, shape).astype(np.float32)),
                          c=torch.from_numpy(rng.uniform(-0.5, 0.5, shape).astype(np.float32)))
        jobs.append((audio, state))
    batcher = SegmentBatcher(max_batch=3, max_wait_ms=5000.0)
    results = [None] * 3
    try:
        def post(i):
            results[i] = batcher.run(params, jobs[i][0], jobs[i][1], cfg, n_a)

        threads = [threading.Thread(target=post, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert batcher.stats.device_calls == 1 and batcher.stats.max_batch_observed == 3
    finally:
        batcher.close()
    with torch.inference_mode():
        for (audio, state), (out, new_state) in zip(jobs, results):
            want, want_state = segment_forward(params, audio, state, cfg, n_a)
            assert out.is_inference()  # the worker's own inference mode
            assert torch.equal(out, want)
            assert torch.equal(new_state.h, want_state.h)
            assert torch.equal(new_state.c, want_state.c)


def test_key_separates_configs_and_params(setup):
    """Jobs of another Wiener setting or another parameter set never share
    a call; host-only fields (shifts, the shift pad) do not split a key."""
    cfg, params, _, _, _ = setup
    assert device_cfg(cfg) == device_cfg(cfg.replace(shifts=3))
    assert device_cfg(cfg) != device_cfg(cfg.replace(use_wiener=False))
    state = init_lstm_state(cfg.model)
    audio = torch.zeros((2, 11264))
    other = synthetic_params(cfg.model, seed=0)
    batcher = SegmentBatcher(max_batch=4, max_wait_ms=200.0)
    try:
        threads = [threading.Thread(target=batcher.run, args=(p, audio, state, c, 11264))
                   for p, c in ((params, cfg), (other, cfg), (params, cfg.replace(use_wiener=False)))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert batcher.stats.jobs == 3 and batcher.stats.device_calls == 3
    finally:
        batcher.close()


def test_queue_depth_and_close_fail_waiting_jobs(setup, monkeypatch):
    """While the worker is held in a call, queued jobs count in
    ``queue_depth``; ``close`` fails them, and later runs raise."""
    cfg, params, state, (n_a, audio_a), _ = setup
    entered, release = threading.Event(), threading.Event()
    real = batcher_mod.segment_forward_batched

    def held(*a, **kw):
        entered.set()
        release.wait(timeout=60)
        return real(*a, **kw)

    monkeypatch.setattr(batcher_mod, "segment_forward_batched", held)
    batcher = SegmentBatcher(max_batch=1)
    errors = []

    def post():
        try:
            batcher.run(params, audio_a, state, cfg, n_a)
        except RuntimeError as e:
            errors.append(str(e))

    first = threading.Thread(target=post)
    first.start()
    assert entered.wait(timeout=60)
    waiting = [threading.Thread(target=post) for _ in range(2)]
    for t in waiting:
        t.start()
    for _ in range(200):
        if batcher.queue_depth() == 2:
            break
        threading.Event().wait(0.01)
    assert batcher.queue_depth() == 2
    closer = threading.Thread(target=batcher.close)
    closer.start()
    for _ in range(200):  # the worker sees the stop before its call returns
        if batcher._stop:
            break
        threading.Event().wait(0.01)
    release.set()
    for t in (first, *waiting, closer):
        t.join(timeout=60)
        assert not t.is_alive()
    assert errors == ["SegmentBatcher closed"] * 2
    with pytest.raises(RuntimeError, match="closed"):
        batcher.run(params, audio_a, state, cfg, n_a)
