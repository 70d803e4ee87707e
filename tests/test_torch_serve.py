"""The port's HTTP service over a real socket, on the CPU: the cases of
tests/test_serve.py (health, info and autoscaling signals, stats reset,
a demix round trip, FLAC/OGG/MP3 bodies, bad requests, coalesced
concurrent requests, a streaming session, session TTL eviction), a served
``/demix`` against the JAX ``Separator.demix_track`` with the same seed,
the device default, and the serving modules' imports with jax blocked."""

from __future__ import annotations

import io
import json
import subprocess
import sys
import threading
import urllib.error
import urllib.request
import zipfile

import numpy as np
import pytest
import torch

from umx_tpu_torch.config import ModelConfig
from umx_tpu_torch.io.ggml import write_ggml
from umx_tpu_torch.models.umx import synthetic_state_dicts

HIDDEN = 64
SR = 44100


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("serve") / "model.bin.gz")
    write_ggml(path, HIDDEN, synthetic_state_dicts(ModelConfig(hidden_size=HIDDEN), 0))
    return path


@pytest.fixture(scope="module")
def server(model_path):
    from umx_tpu_torch.serve import serve

    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    # port 0: a free one; a 50 ms coalescing wait keeps the concurrency test
    # deterministic on a loaded host
    srv = serve(model_path, port=0, segment_secs=1.0, device="cpu", batch_wait_ms=50.0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()
    srv.service.batcher.close()
    thread.join(timeout=30)
    torch.set_num_threads(prev)


def _get(url):
    with urllib.request.urlopen(url, timeout=300) as r:
        return r.status, json.loads(r.read())


def _post(url, body=b""):
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=600) as r:
        return r.status, dict(r.headers), r.read()


def _wav_bytes(audio_nc):
    from scipy.io import wavfile

    buf = io.BytesIO()
    wavfile.write(buf, SR, audio_nc)
    return buf.getvalue()


def _stems(payload):
    """The ZIP of a /demix response → (4, 2, n) float32."""
    from scipy.io import wavfile

    with zipfile.ZipFile(io.BytesIO(payload)) as zf:
        names = sorted(zf.namelist())
        assert names == [f"target_{i}.wav" for i in range(4)]
        assert all(i.compress_type == zipfile.ZIP_STORED for i in zf.infolist())
        out = []
        for name in names:
            rate, data = wavfile.read(io.BytesIO(zf.read(name)))
            assert rate == SR and data.ndim == 2 and data.shape[1] == 2
            out.append(data.T)
    return np.stack(out)


def _tone(n, seed=0):
    t = np.arange(n) / SR
    rng = np.random.default_rng(seed)
    return np.stack([
        0.4 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.standard_normal(n),
        0.3 * np.sin(2 * np.pi * 330 * t) + 0.05 * rng.standard_normal(n),
    ]).astype(np.float32)


def test_healthz(server):
    status, body = _get(server + "/healthz")
    assert status == 200 and body["status"] == "ok"


def test_info(server):
    status, body = _get(server + "/info")
    assert status == 200
    assert body["hidden_size"] == HIDDEN
    assert body["targets"] == ["bass", "drums", "other", "vocals"]
    assert body["device"] == "cpu"
    assert body["batching"]["max_batch"] == 4  # the planner's cap is far above on the CPU


def test_info_autoscaling_signals(server):
    _, body = _get(server + "/info")
    auto = body["autoscaling"]
    assert set(auto) == {
        "busy_fraction", "queue_depth", "avg_batch_fill", "batch_headroom", "scale_hint"
    }
    assert 0.0 <= auto["busy_fraction"] <= 1.0
    assert auto["queue_depth"] >= 0
    assert auto["scale_hint"] in ("up", "steady", "down")
    # an idle server with no sessions never asks to scale up
    if auto["queue_depth"] == 0 and body["streaming_sessions"] == 0:
        assert auto["scale_hint"] in ("steady", "down")


def test_stats_reset(server):
    status, _, body = _post(server + "/stats/reset")
    assert status == 200 and json.loads(body)["status"] == "reset"
    _, info = _get(server + "/info")
    b = info["batching"]
    assert b["jobs"] == 0 and b["device_calls"] == 0 and b["busy_s"] == 0.0


def test_demix_round_trip(server):
    rng = np.random.default_rng(0)
    audio = rng.uniform(-0.5, 0.5, (SR, 2)).astype(np.float32)
    status, headers, payload = _post(server + "/demix?shifts=0&wiener=1", _wav_bytes(audio))
    assert status == 200 and headers["Content-Type"] == "application/zip"
    stems = _stems(payload)
    assert stems.shape == (4, 2, SR)
    # Wiener partition: the stems sum back to about the mix
    corr = np.corrcoef(stems.astype(np.float64).sum(0).ravel(), audio.T.ravel())[0, 1]
    assert corr > 0.98


def test_served_demix_matches_jax(server, model_path):
    """A served /demix (shift pass with seed 3, through the batcher) against
    the JAX package's ``Separator.demix_track`` on the same ggml weights,
    its Pallas kernels in interpret mode: within 2e-4 of max|stem|."""
    from umx_tpu.config import EngineConfig as JEngineConfig
    from umx_tpu.config import ModelConfig as JModelConfig
    from umx_tpu.config import SegmentConfig as JSegmentConfig
    from umx_tpu.config import WienerConfig as JWienerConfig
    from umx_tpu.engine.separator import Separator as JSeparator
    from umx_tpu.io.ggml import read_ggml_bytes
    from umx_tpu.models.umx import params_from_ggml

    audio = _tone(int(1.3 * SR), seed=3)
    _, _, payload = _post(server + "/demix?shifts=1&wiener=1&seed=3",
                          _wav_bytes(np.ascontiguousarray(audio.T)))
    ours = _stems(payload)
    mcfg = JModelConfig(hidden_size=HIDDEN, lstm_impl="pallas_interpret")
    with open(model_path, "rb") as fh:
        jparams = params_from_ggml(read_ggml_bytes(fh.read()), mcfg)
    jcfg = JEngineConfig(model=mcfg, segment=JSegmentConfig(segment_secs=1.0, window_chunks=-1),
                         wiener=JWienerConfig(impl="pallas_interpret"), shifts=1)
    ref = np.asarray(JSeparator(jparams, jcfg).demix_track(audio, seed=3))
    assert ours.shape == ref.shape == (4, 2, audio.shape[1])
    assert np.max(np.abs(ours - ref)) / np.max(np.abs(ref)) <= 2e-4


def test_demix_accepts_flac_ogg_and_mp3_bytes(server, tmp_path):
    """/demix sniffs the container magic: FLAC, OGG and MP3 bodies demix
    like WAV."""
    from umx_tpu_torch.io import mp3, ogg

    flac_writer = pytest.importorskip("flac_writer")
    tone = _tone(SR, seed=1).T
    bodies = {}
    flac_path = str(tmp_path / "m.flac")
    flac_writer.write_flac(flac_path, np.round(tone * 32767.0).astype(np.int32), sample_rate=SR)
    bodies["flac"] = open(flac_path, "rb").read()
    if ogg.available():
        ogg_writer = pytest.importorskip("ogg_writer")
        ogg_path = str(tmp_path / "m.ogg")
        ogg_writer.write_ogg(ogg_path, tone.astype(np.float32), SR)
        bodies["ogg"] = open(ogg_path, "rb").read()
    if mp3.available():
        mp3_writer = pytest.importorskip("mp3_writer")
        if mp3_writer.available():
            mp3_path = str(tmp_path / "m.mp3")
            mp3_writer.write_mp3(mp3_path, tone.astype(np.float32), SR)
            bodies["mp3"] = open(mp3_path, "rb").read()
    for kind, body in bodies.items():
        status, _, payload = _post(server + "/demix?shifts=0&wiener=1", body)
        assert status == 200, kind
        total = _stems(payload).astype(np.float64).sum(0).T
        n = min(len(total), len(tone))
        corr = np.corrcoef(total[:n].ravel(), tone[:n].ravel())[0, 1]
        assert corr > 0.97, (kind, corr)


def test_bad_requests(server):
    # another sample rate
    from scipy.io import wavfile

    buf = io.BytesIO()
    wavfile.write(buf, 48000, np.zeros((1000, 2), np.float32))
    for body in (buf.getvalue(), b"", b"JUNK" + bytes(60)):
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(server + "/demix", body)
        assert exc.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as exc:
        urllib.request.urlopen(server + "/nope", timeout=60)
    assert exc.value.code == 404


def test_concurrent_requests_batch_on_device(server):
    """Four simultaneous /demix requests all succeed, and the batcher puts
    segments of different requests into shared device calls."""
    rng = np.random.default_rng(9)
    payloads = [_wav_bytes(rng.uniform(-0.5, 0.5, (55125, 2)).astype(np.float32))
                for _ in range(4)]
    urllib.request.urlopen(server + "/warmup", timeout=600).read()
    _, before = _get(server + "/info")
    results = [None] * 4

    def post(i):
        results[i] = _post(server + "/demix?shifts=0", payloads[i])

    threads = [threading.Thread(target=post, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert all(r is not None and r[0] == 200 for r in results)
    _, after = _get(server + "/info")
    new_jobs = after["batching"]["jobs"] - before["batching"]["jobs"]
    new_calls = after["batching"]["device_calls"] - before["batching"]["device_calls"]
    assert new_calls < new_jobs, (before, after)
    assert after["batching"]["max_batch_observed"] >= 2


def test_streaming_session_over_http(server):
    """/stream/start, pushes of odd sizes, /stream/close reproduce the
    port's offline host-loop demix of the same audio on the server's own
    weights (the ggml round trip)."""
    from umx_tpu_torch.config import EngineConfig, SegmentConfig
    from umx_tpu_torch.engine.separator import Separator
    from umx_tpu_torch.io.ggml import read_ggml_bytes, write_ggml_bytes
    from umx_tpu_torch.models.umx import params_from_ggml

    n = int(1.3 * SR)
    audio = np.random.default_rng(17).uniform(-0.5, 0.5, (2, n)).astype(np.float32)
    _, _, body = _post(server + "/stream/start?wiener=1")
    sid = json.loads(body)["session"]
    _, info = _get(server + "/info")
    assert info["streaming_sessions"] >= 1

    got = []
    pos = 0
    for size in (5000, 30000, 44100, n):  # odd sizes, then the rest
        chunk = audio[:, pos : min(pos + size, n)]
        pos += chunk.shape[1]
        _, headers, payload = _post(server + f"/stream/push?session={sid}",
                                    np.ascontiguousarray(chunk.T).tobytes())
        m = int(headers["X-Stems-Samples"])
        if m:
            got.append(np.frombuffer(payload, np.float32).reshape(4, 2, m))
        if pos >= n:
            break
    _, headers, payload = _post(server + f"/stream/close?session={sid}")
    m = int(headers["X-Stems-Samples"])
    if m:
        got.append(np.frombuffer(payload, np.float32).reshape(4, 2, m))
    stems = np.concatenate(got, axis=-1)
    assert stems.shape == (4, 2, n)

    mcfg = ModelConfig(hidden_size=HIDDEN)
    params = params_from_ggml(
        read_ggml_bytes(write_ggml_bytes(HIDDEN, synthetic_state_dicts(mcfg, 0))), mcfg)
    cfg = EngineConfig(model=mcfg, segment=SegmentConfig(segment_secs=1.0), shifts=0)
    want = Separator(params, cfg, "cpu").demix(audio, fused=False).numpy()
    np.testing.assert_allclose(stems, want, atol=1e-5)

    _, info = _get(server + "/info")
    assert info["streaming_sessions"] == 0  # the session is freed
    with pytest.raises(urllib.error.HTTPError) as exc:
        _post(server + "/stream/push?session=nope", b"\x00" * 8)
    assert exc.value.code == 404


def test_streaming_session_ttl_eviction(model_path):
    """Idle sessions past ``session_ttl_s`` are evicted when the table is
    next touched, so abandoned clients cannot fill it; the abandoning
    client's next push reads "expired", a never-issued id "unknown"."""
    import time

    from umx_tpu_torch.serve import DemixService

    svc = DemixService(model_path, segment_secs=1.0, session_ttl_s=0.25, device="cpu")
    try:
        sids = [svc.stream_start(wiener=True) for _ in range(svc.max_sessions)]
        with pytest.raises(RuntimeError, match="too many streaming sessions"):
            svc.stream_start(wiener=True)
        time.sleep(0.35)  # every session is now past the TTL
        fresh = svc.stream_start(wiener=True)
        assert len(svc._sessions) == 1
        with pytest.raises(KeyError, match="expired"):
            svc.stream_push(sids[0], b"\x00" * 8)
        with pytest.raises(KeyError, match="unknown"):
            svc.stream_push("deadbeef0000", b"\x00" * 8)
        assert fresh in svc._sessions
        svc.stream_close(fresh)
        assert not svc._sessions
    finally:
        svc.batcher.close()


def test_service_defaults_to_the_gpu_and_raises_without_one(model_path, monkeypatch):
    from umx_tpu_torch.serve import DemixService, main, serve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        DemixService(model_path)
    with pytest.raises(RuntimeError, match="cuda"):
        serve(model_path, port=0)
    with pytest.raises(RuntimeError, match="cuda"):
        main([model_path, "--port", "0"])
    with pytest.raises(SystemExit) as exc:
        main([])
    assert exc.value.code == 2


def test_serving_imports_without_jax():
    """The serving modules and the audio formats import with jax and the
    JAX package blocked."""
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['umx_tpu'] = None\n"
        "import umx_tpu_torch.serve, umx_tpu_torch.engine.streaming, "
        "umx_tpu_torch.engine.batcher, umx_tpu_torch.engine.memory, umx_tpu_torch.io.audio, "
        "umx_tpu_torch.io.native, umx_tpu_torch.io.ogg, umx_tpu_torch.io.mp3\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in ('jax', 'umx_tpu') "
        "and sys.modules[m] is not None]\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
