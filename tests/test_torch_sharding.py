"""The port's device mesh (``umx_tpu_torch.parallel.{mesh,sharding}``)
against the JAX package's (``umx_tpu.parallel``), on the CPU.

The port's grid is ``[torch.device("cpu")] * 8`` (one process, a device
repeated; a tensor moved to its own device is not copied); the JAX side
runs on the conftest's 8 virtual CPU devices with the recurrence kernel
in interpret mode (bf16 operands, as the port's).  The cases of
``tests/test_parallel.py``: mesh shapes, dp and dp x tp demix against
the unsharded pass, the combine audit; then a quantized tree under tp,
the fleet and the multi-process fleet over a mesh."""

import jax
import numpy as np
import pytest
import torch

from umx_tpu.config import EngineConfig as JEngineConfig
from umx_tpu.config import ModelConfig as JModelConfig
from umx_tpu.config import SegmentConfig as JSegmentConfig
from umx_tpu.engine.fleet import demix_tracks as jdemix_tracks
from umx_tpu.models.umx import synthetic_params as jsynthetic_params
from umx_tpu.parallel import mesh as jmesh
from umx_tpu.parallel import sharding as jsharding
from umx_tpu_torch.config import EngineConfig, ModelConfig, SegmentConfig
from umx_tpu_torch.engine.fleet import demix_tracks
from umx_tpu_torch.engine.separator import segment_forward, segment_forward_batched
from umx_tpu_torch.models.umx import init_lstm_state, params_from_jax
from umx_tpu_torch.parallel.mesh import dp_sharding, make_mesh, replicated, tp_sharding
from umx_tpu_torch.parallel.multihost import demix_tracks_multihost
from umx_tpu_torch.parallel.sharding import (
    audit_collectives,
    batched_lstm_state,
    demix_segments_batch,
    shard_params,
)

SR = 44100
CPU8 = [torch.device("cpu")] * 8
# the port against itself: the same operations on each row or target, so
# 1e-6 of max|stem| (the class of tests/test_torch_parallel.py)
SELF_RTOL = 1e-6
SLICE_RTOL = 2e-4  # against the JAX package, as tests/test_torch_fleet.py


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def cfg():
    return EngineConfig(model=ModelConfig(hidden_size=64), segment=SegmentConfig(segment_secs=0.5),
                        shifts=0)


@pytest.fixture(scope="module")
def jcfg():
    return JEngineConfig(model=JModelConfig(hidden_size=64, lstm_impl="pallas_interpret"),
                         segment=JSegmentConfig(segment_secs=0.5), shifts=0)


@pytest.fixture(scope="module")
def jax_params():
    return jsynthetic_params(JModelConfig(hidden_size=64), seed=0)


@pytest.fixture(scope="module")
def params(jax_params):
    return params_from_jax(jax_params)


def _tones(n: int, k: int, seed: int):
    """Tones in noise (on uniform noise the Wiener-EM 2x2 inverse amplifies
    the recurrence's bf16 rounding differences in both packages)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    return np.stack([
        0.4 * np.sin(2 * np.pi * (220 + 40 * k) * t) + 0.05 * rng.standard_normal(n),
        0.3 * np.sin(2 * np.pi * (330 + 60 * k) * t) + 0.05 * rng.standard_normal(n),
    ]).astype(np.float32)


@pytest.fixture(scope="module")
def batch(cfg):
    n = cfg.segment.segment_samples(SR)
    return np.stack([_tones(n, k, 50 + k) for k in range(8)])


@pytest.fixture(scope="module")
def unsharded(cfg, params, batch):
    n = batch.shape[-1]
    with torch.inference_mode():
        return segment_forward_batched(params, torch.from_numpy(batch), batched_lstm_state(cfg, 8),
                                       cfg, n)


def _rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@pytest.mark.parametrize("dp,tp,n", [(None, 1, 8), (None, 2, 8), (2, 4, 8), (4, 2, 8), (3, 1, 8),
                                     (None, 1, 1), (2, 1, 2)])
def test_make_mesh_shapes_equal_jax(dp, tp, n):
    ours = make_mesh(dp, tp, CPU8[:n])
    theirs = jmesh.make_mesh(dp, tp, jax.devices()[:n])
    assert dict(ours.shape) == dict(theirs.shape)
    assert ours.axis_names == tuple(theirs.axis_names)
    assert ours.devices.shape == theirs.devices.shape
    assert len(ours.devices.flat) == len(theirs.devices.flat)
    assert all(d == torch.device("cpu") for d in ours.devices.flat)


def test_make_mesh_errors_as_jax():
    msg = "mesh 4x4 needs 16 devices, have 8"
    with pytest.raises(ValueError, match=msg):
        make_mesh(4, 4, CPU8)
    with pytest.raises(ValueError, match=msg):
        jmesh.make_mesh(4, 4, jax.devices())
    # a tp that does not divide the devices: both raise (JAX by assert)
    with pytest.raises(ValueError, match="not divisible by tp=3"):
        make_mesh(tp=3, devices=CPU8)
    with pytest.raises(AssertionError):
        jmesh.make_mesh(tp=3, devices=jax.devices())


def test_make_mesh_without_devices_takes_the_cards_or_raises():
    if torch.cuda.is_available():
        mesh = make_mesh()
        assert len(mesh.devices.flat) == torch.cuda.device_count()
        assert all(d.type == "cuda" for d in mesh.devices.flat)
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            make_mesh()


def test_placements_split_and_do_not_copy_on_their_device():
    mesh = make_mesh(4, 2, CPU8)
    x = torch.arange(8 * 6, dtype=torch.float32).view(8, 6)
    rep = replicated(mesh)(x)
    assert rep.shape == (4, 2) and all(t is x for t in rep.flat)
    dps = dp_sharding(mesh)(x)
    tps = tp_sharding(mesh, axis=1)(x)
    for (i, j), t in np.ndenumerate(dps):
        assert torch.equal(t, x[2 * i : 2 * i + 2]) and t.data_ptr() == x[2 * i].data_ptr()
        assert torch.equal(tps[i, j], x[:, 3 * j : 3 * j + 3])
    with pytest.raises(ValueError, match="dp=4"):
        dp_sharding(mesh)(x[:6])


def test_shard_params_slices_the_target_axis(params):
    grid = shard_params(params, make_mesh(2, 4, CPU8), tp=True)
    for (i, j), p in np.ndenumerate(grid):
        assert torch.equal(p.lstm_hh_w, params.lstm_hh_w[j : j + 1])
        assert torch.equal(p.output_mean, params.output_mean[j : j + 1])
    whole = shard_params(params, make_mesh(2, 4, CPU8))
    assert all(p.fc3_w is params.fc3_w for p in whole.flat)
    with pytest.raises(ValueError, match="tp=8 does not divide the 4 targets"):
        shard_params(params, make_mesh(1, 8, CPU8), tp=True)


def test_dp8_rows_equal_segment_forward(cfg, params, batch):
    out, st = demix_segments_batch(params, batch, batched_lstm_state(cfg, 8), cfg,
                                   make_mesh(8, 1, CPU8))
    assert out.shape == (8, 4, 2, batch.shape[-1]) and st.h.shape == (8, 4, 3, 2, 32)
    with torch.inference_mode():
        for i in range(8):
            ref, _ = segment_forward(params, torch.from_numpy(batch[i]), init_lstm_state(cfg.model),
                                     cfg, batch.shape[-1])
            assert _rel(out[i], ref) <= SELF_RTOL


@pytest.mark.parametrize("dp,tp", [(2, 4), (4, 2)])
def test_dp_tp_demix_equals_the_unsharded_pass(cfg, params, batch, unsharded, dp, tp):
    ref, ref_st = unsharded
    out, st = demix_segments_batch(params, batch, batched_lstm_state(cfg, 8), cfg,
                                   make_mesh(dp, tp, CPU8), tp=True)
    assert _rel(out, ref) <= SELF_RTOL
    torch.testing.assert_close(st.h, ref_st.h, rtol=0, atol=1e-6)
    torch.testing.assert_close(st.c, ref_st.c, rtol=0, atol=1e-6)


@pytest.mark.parametrize("dp,tp", [(8, 1), (2, 4), (4, 2)])
def test_sharded_demix_equals_jax(cfg, jcfg, params, jax_params, batch, dp, tp):
    ours, _ = demix_segments_batch(params, batch, batched_lstm_state(cfg, 8), cfg,
                                   make_mesh(dp, tp, CPU8), tp=tp > 1)
    theirs, _ = jsharding.demix_segments_batch(
        jax_params, batch, jsharding.batched_lstm_state(jcfg, 8), jcfg, jmesh.make_mesh(dp, tp),
        tp=tp > 1)
    assert _rel(ours, theirs) <= SLICE_RTOL


def test_uneven_batch_raises_by_name(cfg, params, batch):
    with pytest.raises(ValueError, match="dp=4"):
        demix_segments_batch(params, batch[:6], batched_lstm_state(cfg, 6), cfg,
                             make_mesh(4, 2, CPU8))


def test_dp_audit_finds_no_combine(cfg, params, batch):
    assert audit_collectives(params, batch, batched_lstm_state(cfg, 8), cfg,
                             make_mesh(8, 1, CPU8)) == []
    # a tp axis the pass does not shard over: the rows still need nothing
    assert audit_collectives(params, batch, batched_lstm_state(cfg, 8), cfg,
                             make_mesh(4, 2, CPU8)) == []


@pytest.mark.parametrize("dp,tp", [(4, 2), (2, 4)])
def test_tp_audit_finds_small_gathers_only(cfg, params, batch, dp, tp):
    found = audit_collectives(params, batch[:dp], batched_lstm_state(cfg, dp), cfg,
                              make_mesh(dp, tp, CPU8), tp=True)
    assert found and all(s.startswith(("all-gather", "all-reduce")) for s in found), found
    assert len(found) <= 4, found
    # each gathers the masks of the other tp devices' targets: one segment
    # row x T#/tp targets x T frames x 2F floats from each
    T, n_out = 22, ModelConfig(hidden_size=64).n_outputs
    per_target = T * n_out * 4
    assert all(s.endswith(f"{(tp - 1) * (4 // tp) * per_target} bytes") for s in found), found


def test_quantized_tree_under_tp(cfg, batch, tmp_path):
    from umx_tpu_torch.io.ggml import read_ggml, write_ggml
    from umx_tpu_torch.models.umx import quantized_params_from_ggml, synthetic_state_dicts

    path = str(tmp_path / "q.bin")
    write_ggml(path, 64, synthetic_state_dicts(cfg.model, seed=0))
    qparams = quantized_params_from_ggml(read_ggml(path, keep_quantized=True), cfg.model)
    grid = shard_params(qparams, make_mesh(1, 2, CPU8), tp=True)
    assert grid[0, 1].fc1_w.planes[0].shape[0] == 2 and grid[0, 1].fc1_w.scale.shape == (2,)
    st = batched_lstm_state(cfg, 4)
    with torch.inference_mode():
        ref, _ = segment_forward_batched(qparams, torch.from_numpy(batch[:4]), st, cfg,
                                         batch.shape[-1])
    out, _ = demix_segments_batch(qparams, batch[:4], st, cfg, make_mesh(2, 2, CPU8), tp=True)
    assert _rel(out, ref) <= SELF_RTOL


@pytest.fixture(scope="module")
def bucket():
    # three tracks of one chunk count: one bucket, padded to 4 rows at dp 2
    return [_tones(30_000, k, 70 + k) for k in range(3)]


def test_fleet_over_a_mesh_equals_the_fleet_without(cfg, params, bucket):
    ref = demix_tracks(params, bucket, cfg, seeds=[0, 1, 2])
    stats: dict = {}
    ours = demix_tracks(params, bucket, cfg, seeds=[0, 1, 2], stats=stats,
                        mesh=make_mesh(dp=2, devices=CPU8[:2]))
    assert stats["rows"] % 2 == 0 and stats["rows"] >= 4  # a silent row pads the bucket
    for a, b in zip(ours, ref):
        assert a.shape == b.shape
        assert _rel(a, b) <= SELF_RTOL


def test_fleet_over_a_mesh_equals_jax(cfg, jcfg, params, jax_params, bucket):
    ours = demix_tracks(params, bucket, cfg, mesh=make_mesh(dp=2, devices=CPU8[:2]))
    theirs = jdemix_tracks(jax_params, bucket, jcfg, mesh=jmesh.make_mesh(
        dp=2, devices=jax.devices()[:2]))
    for a, b in zip(ours, theirs):
        assert _rel(a, b) <= SLICE_RTOL


def test_multihost_passes_its_mesh_on(cfg, params, bucket):
    ref = demix_tracks(params, bucket, cfg)
    res = demix_tracks_multihost(params, bucket, cfg, process_id=0, process_count=2,
                                 mesh=make_mesh(dp=2, devices=CPU8[:2]))
    assert res.owned_indices() == [0, 2]
    for i in res.owned_indices():
        assert _rel(res.local[i], ref[i]) <= SELF_RTOL
