"""Cross-request segment batching for serving.

Every request in flight splits into per-segment jobs (an audio chunk and
its own LSTM state).  One worker thread coalesces the jobs of different
requests into one batched device call, ``segment_forward_batched`` over
the stacked rows and states, and hands each request its row back.  A
request has one job in flight at a time, so its state chain stays intact.

Why this batches well on the card: the recurrence kernel (K1) takes the
rows of a call as rows of each chain, so several tracks' segments cost
little more than one.  A row's result is bit-equal whatever rows run
beside it, so a call runs exactly the rows it was given.

All serving launches, from this worker and from streaming sessions on
request threads, stay on the device's one default stream.  K1 is a
resident launch that needs all of its blocks on the card at once
(``ops/lstm_cuda.py``); two of its launches running side by side on two
streams could each hold part of the card and wait for the rest.
"""

from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass

import torch

from umx_tpu_torch.config import EngineConfig
from umx_tpu_torch.engine.separator import segment_forward_batched
from umx_tpu_torch.models.umx import LSTMState


def device_cfg(cfg: EngineConfig) -> EngineConfig:
    """``cfg`` with the fields that only the host-side loops read (shifts,
    the shift pad, the chunk-group width, the window) set to fixed values:
    configs that give the same segment call coalesce."""
    return dataclasses.replace(
        cfg,
        shifts=0,
        segment=dataclasses.replace(
            cfg.segment, max_shift_secs=0.0, chunk_batch=4, window_chunks=0
        ),
    )


@dataclass
class BatcherStats:
    jobs: int = 0
    device_calls: int = 0
    max_batch_observed: int = 0
    # wall seconds the worker spent inside device calls, up to each call's
    # completion: the utilization numerator for autoscaling
    busy_s: float = 0.0


class SegmentBatcher:
    """Coalesces ``segment_forward`` jobs from concurrent requests into
    batched device calls.

    ``out, new_state = batcher.run(params, audio, state, cfg, n)`` is a
    drop-in for ``segment_forward`` (and for ``Separator.demix``'s
    ``segment_fn``) that may share its device call with other threads'
    jobs of the same (config, n, parameters)."""

    def __init__(self, max_batch: int = 4, max_wait_ms: float = 5.0):
        self.max_batch = max(1, int(max_batch))
        self.max_wait_s = max_wait_ms / 1000.0
        self._q: queue.Queue = queue.Queue()
        # worker-local FIFO of jobs the coalescing pass skipped; an
        # attribute, so that queue_depth() counts them
        self._pending: list = []
        self.stats = BatcherStats()
        self._stats_lock = threading.Lock()
        self._stats_gen = 0
        self._started = time.monotonic()
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._stop = False
        self._worker.start()

    def close(self):
        self._stop = True
        self._q.put(None)
        self._worker.join(timeout=5)
        # fail the jobs still queued (or queued after close) instead of
        # leaving their callers blocked in fut.result()
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                item[-1].set_exception(RuntimeError("SegmentBatcher closed"))

    # -- request side -------------------------------------------------------

    def run(self, params, audio, state: LSTMState, cfg: EngineConfig, n_samples: int):
        if self._stop:
            raise RuntimeError("SegmentBatcher closed")
        fut: Future = Future()
        # the parameters' identity is part of the key: jobs with different
        # weights (a server hosting two models) never share a call
        key = (device_cfg(cfg), n_samples, id(params))
        self._q.put((key, params, audio, state, fut))
        return fut.result()

    # -- worker side --------------------------------------------------------

    def _loop(self):
        """Worker loop with a fairness bound: jobs the coalescing pass
        skips (another key) move to the worker-local FIFO, and every group
        is seeded from the oldest waiting job, so a job of a minority shape
        waits at most one group and the coalescing wait, even at batch 1.
        The worker runs under its own ``torch.inference_mode()`` (thread
        local, as the separator's is)."""
        pending = self._pending
        with torch.inference_mode():
            while not self._stop:
                if not pending:
                    item = self._q.get()
                    if item is None:
                        continue
                    pending.append(item)
                # drain what is queued, so that age order is global
                while True:
                    try:
                        nxt = self._q.get_nowait()
                    except queue.Empty:
                        break
                    if nxt is not None:
                        pending.append(nxt)
                seed = pending.pop(0)  # the oldest job seeds the group
                key = seed[0]
                group = [seed]
                rest = []
                for it in pending:
                    if it[0] == key and len(group) < self.max_batch:
                        group.append(it)
                    else:
                        rest.append(it)
                pending[:] = rest
                if len(group) < self.max_batch and self.max_batch > 1 and not pending:
                    # a short wait for same-key arrivals, skipped whenever
                    # older jobs of another key are waiting
                    deadline = time.monotonic() + self.max_wait_s
                    while len(group) < self.max_batch:
                        timeout = deadline - time.monotonic()
                        if timeout <= 0:
                            break
                        try:
                            nxt = self._q.get(timeout=timeout)
                        except queue.Empty:
                            break
                        if nxt is None:
                            continue
                        if nxt[0] == key:
                            group.append(nxt)
                        else:
                            pending.append(nxt)
                try:
                    self._execute(key, group)
                except Exception as e:  # noqa: BLE001 — the callers get it
                    for *_, fut in group:
                        if not fut.done():
                            fut.set_exception(e)
        for it in pending:
            it[-1].set_exception(RuntimeError("SegmentBatcher closed"))

    def reset_stats(self) -> None:
        """Zero the counters and the utilization clock (after a warm-up).
        The generation bump makes a call in flight, whose start precedes
        the reset, drop its sample instead of booking pre-reset time
        against the fresh clock."""
        with self._stats_lock:
            self.stats = BatcherStats()
            self._stats_gen += 1
            self._started = time.monotonic()

    def utilization(self) -> float:
        """Share of wall time the worker has spent in device calls since
        the start or the last reset: the first autoscaling signal."""
        with self._stats_lock:
            up = time.monotonic() - self._started
            frac = self.stats.busy_s / up if up > 0 else 0.0
        return min(frac, 1.0)

    def queue_depth(self) -> int:
        """Waiting jobs: those still queued and those the fairness pass
        moved to the worker-local FIFO."""
        return self._q.qsize() + len(self._pending)

    def _execute(self, key, group):
        with self._stats_lock:
            gen0 = self._stats_gen
        t0 = time.monotonic()
        B = len(group)
        params, cfg, n = group[0][1], key[0], key[1]
        audio_b = torch.stack([torch.as_tensor(g[2]) for g in group]).float()
        state_b = LSTMState(h=torch.stack([g[3].h for g in group]),
                            c=torch.stack([g[3].c for g in group]))
        dev = audio_b.device
        on_card = dev.type == "cuda"
        with torch.cuda.device(dev) if on_card else contextlib.nullcontext():
            out_b, new_b = segment_forward_batched(params, audio_b, state_b, cfg, n)
            if on_card:
                # completion barrier: an event after this call, so that
                # busy_s is device time and not the time to queue launches
                # (torch.cuda.synchronize would also wait for other
                # threads' work)
                done = torch.cuda.Event()
                done.record()
                done.synchronize()
        dt = time.monotonic() - t0
        with self._stats_lock:
            if self._stats_gen == gen0:  # drop samples that span a reset
                self.stats.jobs += B
                self.stats.device_calls += 1
                self.stats.max_batch_observed = max(self.stats.max_batch_observed, B)
                self.stats.busy_s += dt
        for i, (*_, fut) in enumerate(group):
            fut.set_result((out_b[i], LSTMState(h=new_b.h[i], c=new_b.c[i])))
