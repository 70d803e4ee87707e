"""The fleet runner: ``demix_tracks`` over tracks of mixed lengths equals
per-track ``Separator.demix_track`` (shifts 0, 1 and 2, streaming or
not), gives the arrays of its earlier host staging bit for bit and moves
each track's own bytes, routes a track beyond the window through the
windowed path, splits a bucket at the planner's cap, and matches the JAX
``demix_tracks``."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from umx_tpu.config import EngineConfig as JEngineConfig
from umx_tpu.config import ModelConfig as JModelConfig
from umx_tpu.config import SegmentConfig as JSegmentConfig
from umx_tpu.config import WienerConfig as JWienerConfig
from umx_tpu.engine.fleet import demix_tracks as jdemix_tracks
from umx_tpu.models.umx import synthetic_params
from fleet_host_staging import host_staged_demix_tracks
from umx_tpu_torch.config import EngineConfig, ModelConfig, SegmentConfig
from umx_tpu_torch.engine import fleet
from umx_tpu_torch.engine.separator import Separator
from umx_tpu_torch.models.umx import params_from_jax
from umx_tpu_torch.parallel.mesh import make_mesh

HIDDEN = 32
SLICE_RTOL = 2e-4  # the class of tests/test_torch_separator.py


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jax_params():
    return synthetic_params(JModelConfig(hidden_size=HIDDEN), seed=0)


@pytest.fixture(scope="module")
def params(jax_params):
    return params_from_jax(jax_params)


@pytest.fixture(scope="module")
def tracks():
    # 0.5 s segments at 25 % overlap: 30k samples = 2 chunks, 50k = 4;
    # tones in noise, as the tracks of tests/test_torch_parallel.py
    rng = np.random.default_rng(81)
    out = []
    for k, n in enumerate((30_000, 30_000, 50_000, 30_000, 50_000)):
        t = np.arange(n) / 44100
        out.append(np.stack([
            0.4 * np.sin(2 * np.pi * (220 + 40 * k) * t) + 0.05 * rng.standard_normal(n),
            0.3 * np.sin(2 * np.pi * (330 + 60 * k) * t) + 0.05 * rng.standard_normal(n),
        ]).astype(np.float32))
    return out


def _cfg(shifts=0, streaming=True, W=-1, chunk_batch=0):
    return EngineConfig(
        model=ModelConfig(hidden_size=HIDDEN),
        segment=SegmentConfig(segment_secs=0.5, streaming=streaming, window_chunks=W,
                              chunk_batch=chunk_batch),
        shifts=shifts,
    )


def _close(out, ref):
    # batch rows pass through the same matmuls at another batch width, and
    # shift passes are averaged in another order: 1e-5 of max|stem|
    assert out.shape == ref.shape and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("shifts, streaming", [(0, True), (1, True), (2, True), (0, False),
                                               (2, False)])
def test_fleet_equals_per_track(params, tracks, shifts, streaming):
    cfg = _cfg(shifts, streaming)
    seeds = [1, 2, 3, 4, 5]
    stats: dict = {}
    outs = fleet.demix_tracks(params, tracks, cfg, seeds=seeds, stats=stats)
    # two buckets (2 and 4 chunks; the shift pad adds one chunk to each) per pass
    assert stats["dispatches"] == 2 * max(1, shifts) and stats["rows"] == 5 * max(1, shifts)
    assert "windowed_tracks" not in stats
    assert all(stats[k] >= 0 for k in ("upload_s", "compute_s", "download_s"))
    sep = Separator(params, cfg, "cpu")
    for seed, track, out in zip(seeds, tracks, outs):
        _close(out, sep.demix_track(track, seed=seed))


@pytest.mark.parametrize("shifts, streaming, dp", [
    (0, True, 1), (1, True, 1), (2, True, 1), (3, True, 1),
    (0, False, 1), (1, False, 1), (2, False, 1), (3, False, 1),
    (3, True, 2),  # a CPU mesh, the device repeated: a silent row pads the 50k track's bucket
])
def test_fleet_is_bit_equal_to_host_staging(params, tracks, shifts, streaming, dp):
    cfg, sub, seeds = _cfg(shifts, streaming), tracks[1:4], [11, 12, 13]
    mesh = None if dp == 1 else make_mesh(dp=dp, devices=[torch.device("cpu")] * dp)
    outs = fleet.demix_tracks(params, sub, cfg, seeds=seeds, mesh=mesh)
    ref = host_staged_demix_tracks(params, sub, cfg, seeds, mesh=mesh)
    for out, r in zip(outs, ref):
        assert out.dtype == np.float32 and out.flags.c_contiguous
        np.testing.assert_array_equal(out, r)


@pytest.mark.parametrize("shifts", [1, 2])
def test_fleet_counts_the_bytes_each_track_moves(params, tracks, shifts):
    stats: dict = {}
    outs = fleet.demix_tracks(params, tracks, _cfg(shifts), seeds=[1, 2, 3, 4, 5], stats=stats)
    n = sum(t.shape[1] for t in tracks)  # 190k samples; padded, 391k a pass
    assert stats["upload_bytes"] == shifts * 2 * n * 4
    assert stats["download_bytes"] == shifts * 4 * 2 * n * 4 == shifts * sum(o.nbytes for o in outs)
    # the bucketing is unchanged: 2 and 4 chunks (3 and 5 with the shift pad)
    assert stats["rows"] == 5 * shifts and stats["dispatches"] == 2 * shifts


def test_fleet_takes_a_separator_and_default_seeds(params, tracks):
    sep = Separator(params, _cfg(shifts=1), "cpu")
    outs = fleet.demix_tracks(sep, tracks[:2])
    for track, out in zip(tracks, outs):
        _close(out, sep.demix_track(track))  # seed 0 on both sides


def test_fleet_routes_long_tracks_through_the_windowed_path(params, tracks):
    # window of 2 chunks: the 50k tracks (4 chunks) go windowed one by
    # one, the 30k ones stay in their bucket
    mixed = [tracks[0], tracks[2], tracks[1]]
    stats: dict = {}
    outs = fleet.demix_tracks(params, mixed, _cfg(W=2), stats=stats)
    assert stats["windowed_tracks"] == 1 and stats["rows"] == 2 and stats["dispatches"] == 1
    sep = Separator(params, _cfg(), "cpu")  # the single program, no window
    for track, out in zip(mixed, outs):
        _close(out, sep.demix_track(track))


def test_fleet_splits_a_bucket_at_the_planners_cap(params, tracks, monkeypatch):
    monkeypatch.setattr(fleet, "suggest_max_fleet_batch", lambda *a, **kw: 2)
    stats: dict = {}
    short = [tracks[0], tracks[1], tracks[3]]
    outs = fleet.demix_tracks(params, short, _cfg(), stats=stats)
    assert stats["dispatches"] == 2 and stats["rows"] == 3  # sub-batches of 2 and 1
    sep = Separator(params, _cfg(), "cpu")
    for track, out in zip(short, outs):
        _close(out, sep.demix_track(track))


def test_fleet_auto_window_asks_the_planner(params, tracks, monkeypatch):
    seen = []

    def plan(cfg, **kw):
        seen.append(kw.get("device"))
        return 3

    monkeypatch.setattr(fleet, "suggest_window_chunks", plan)
    stats: dict = {}
    fleet.demix_tracks(params, tracks[1:3], _cfg(W=0), stats=stats)
    assert seen == [torch.device("cpu")]
    assert stats["windowed_tracks"] == 1 and stats["rows"] == 1


@pytest.mark.parametrize("shifts, streaming", [(1, True), (0, False)])
def test_fleet_matches_jax_fleet(jax_params, params, tracks, shifts, streaming):
    jcfg = JEngineConfig(
        model=JModelConfig(hidden_size=HIDDEN, lstm_impl="pallas_interpret"),
        segment=JSegmentConfig(segment_secs=0.5, streaming=streaming, window_chunks=-1),
        wiener=JWienerConfig(impl="pallas_interpret"),
        shifts=shifts,
    )
    sub, seeds = tracks[1:4], [7, 8, 9]
    ref = jdemix_tracks(jax_params, sub, jcfg, mesh=None, seeds=seeds)
    ours = fleet.demix_tracks(params, sub, _cfg(shifts, streaming), seeds=seeds)
    for o, r in zip(ours, ref):
        r = np.asarray(r)
        assert o.shape == r.shape and np.isfinite(o).all()
        err = float(np.max(np.abs(o - r)) / np.max(np.abs(r)))
        assert err <= SLICE_RTOL, f"max|Δ|/max|stem| = {err:.3g}"
