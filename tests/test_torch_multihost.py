"""The port's multi-process input distribution
(``umx_tpu_torch.parallel.multihost``): every case of
``tests/test_multihost.py`` at hidden 64 on the CPU (each simulated
process's slice run in-process with explicit ids, the union against the
plain fleet), the partition and one process's slice against the JAX
package's, and a real two-process gloo group for ``allgather_metrics``."""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from umx_tpu.config import EngineConfig as JEngineConfig
from umx_tpu.config import ModelConfig as JModelConfig
from umx_tpu.config import SegmentConfig as JSegmentConfig
from umx_tpu.models.umx import synthetic_params as jsynthetic_params
from umx_tpu.parallel import multihost as jmultihost
from umx_tpu_torch.config import EngineConfig, ModelConfig, SegmentConfig
from umx_tpu_torch.engine.fleet import demix_tracks
from umx_tpu_torch.models.umx import params_from_jax
from umx_tpu_torch.parallel.multihost import (
    allgather_metrics,
    demix_tracks_multihost,
    init_distributed,
    partition_tracks,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def cfg():
    return EngineConfig(
        model=ModelConfig(hidden_size=64),
        segment=SegmentConfig(segment_secs=0.5),
        shifts=0,
    )


@pytest.fixture(scope="module")
def jax_params():
    return jsynthetic_params(JModelConfig(hidden_size=64), seed=0)


@pytest.fixture(scope="module")
def params(jax_params):
    return params_from_jax(jax_params)


@pytest.fixture(scope="module")
def tracks():
    rng = np.random.default_rng(7)
    return [
        rng.uniform(-0.5, 0.5, (2, n)).astype(np.float32)
        for n in (30_000, 50_000, 30_000)
    ]


def test_partition_disjoint_covering_balanced():
    for n_tracks, num in ((10, 3), (3, 4), (8, 1), (5, 5)):
        slices = [partition_tracks(n_tracks, p, num) for p in range(num)]
        flat = sorted(i for s in slices for i in s)
        assert flat == list(range(n_tracks))  # disjoint + covering
        sizes = [len(s) for s in slices]
        assert max(sizes) - min(sizes) <= 1  # balanced
    with pytest.raises(ValueError):
        partition_tracks(4, 3, 2)


def test_partition_defaults_to_one_process_without_a_group():
    assert partition_tracks(6) == list(range(6))  # 1 process owns all
    assert init_distributed() is False  # nothing to join: a single-process run


def test_partition_equals_jax():
    for n_tracks, num in ((10, 3), (3, 4), (8, 1), (5, 5), (0, 2)):
        for p in range(num):
            assert partition_tracks(n_tracks, p, num) == jmultihost.partition_tracks(
                n_tracks, p, num)


def test_two_simulated_hosts_union_equals_single_fleet(cfg, params, tracks):
    ref = demix_tracks(params, tracks, cfg)
    combined: dict[int, np.ndarray] = {}
    for pid in range(2):
        res = demix_tracks_multihost(
            params, tracks, cfg, process_id=pid, process_count=2
        )
        assert res.process_id == pid and res.process_count == 2
        assert res.owned_indices() == partition_tracks(len(tracks), pid, 2)
        assert not set(res.local) & set(combined)  # no overlap across hosts
        combined.update(res.local)
    assert sorted(combined) == list(range(len(tracks)))
    for i, want in enumerate(ref):
        np.testing.assert_allclose(combined[i], want, atol=2e-4)


def test_lazy_track_loaders_only_called_for_owned(cfg, params, tracks):
    calls: list[int] = []

    def loader(i):
        def load():
            calls.append(i)
            return tracks[i]

        return load

    lazy = [loader(i) for i in range(len(tracks))]
    res = demix_tracks_multihost(
        params, lazy, cfg, process_id=1, process_count=2
    )
    assert sorted(calls) == res.owned_indices() == [1]


def test_allgather_metrics_single_process_identity():
    vals = {0: 1.5, 2: -3.25}
    assert allgather_metrics(vals) == vals


def test_one_process_slice_matches_jax(cfg, params, jax_params):
    # tones in noise (on uniform noise the Wiener-EM 2x2 inverse amplifies
    # the recurrence's bf16 rounding differences in both packages);
    # 2e-4 of max|stem|, the class of tests/test_torch_fleet.py
    rng = np.random.default_rng(8)
    tracks = []
    for k, n in enumerate((30_000, 30_000, 50_000)):
        t = np.arange(n) / 44100
        tracks.append(np.stack([
            0.4 * np.sin(2 * np.pi * (220 + 40 * k) * t) + 0.05 * rng.standard_normal(n),
            0.3 * np.sin(2 * np.pi * (330 + 60 * k) * t) + 0.05 * rng.standard_normal(n),
        ]).astype(np.float32))
    # the JAX recurrence kernel (interpret mode): bf16 operands, as the port
    jcfg = JEngineConfig(model=JModelConfig(hidden_size=64, lstm_impl="pallas_interpret"),
                         segment=JSegmentConfig(segment_secs=0.5), shifts=0)
    ours = demix_tracks_multihost(params, tracks, cfg, process_id=0, process_count=2)
    theirs = jmultihost.demix_tracks_multihost(jax_params, tracks, jcfg, process_id=0,
                                               process_count=2)
    assert ours.owned_indices() == theirs.owned_indices() == [0, 2]
    for i in ours.owned_indices():
        want = np.asarray(theirs.local[i])
        err = float(np.max(np.abs(ours.local[i] - want)) / np.max(np.abs(want)))
        assert err <= 2e-4, (i, err)


_WORKER = textwrap.dedent("""
    import datetime, json, sys
    import torch.distributed as dist
    from umx_tpu_torch.parallel.multihost import (
        allgather_metrics, init_distributed, partition_tracks)
    rank = int(sys.argv[2])
    dist.init_process_group("gloo", init_method=sys.argv[1], world_size=2, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    try:
        assert init_distributed() is True  # the group that is up is kept
        owned = partition_tracks(5)
        got = allgather_metrics({i: 10.0 * i + 0.5 for i in owned})
        print(json.dumps({"owned": owned, "got": {str(k): v for k, v in got.items()}}))
    finally:
        dist.destroy_process_group()
""")


def test_allgather_metrics_over_two_gloo_processes(tmp_path):
    # a file rendezvous: no TCP port shared between test workers
    init = f"file://{tmp_path / 'rendezvous'}"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.pop("MASTER_ADDR", None)
    procs = [
        subprocess.Popen([sys.executable, "-c", _WORKER, init, str(rank)], cwd=REPO, env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-2000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [o["owned"] for o in outs] == [[0, 2, 4], [1, 3]]
    want = {str(i): 10.0 * i + 0.5 for i in range(5)}
    assert outs[0]["got"] == outs[1]["got"] == want
