"""Port io and parameter loading against the JAX package: the ggml reader
and writer, WAV io, params_from_ggml / params_from_jax.  All comparisons
are exact — the same numpy arithmetic runs on both sides."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from umx_tpu.config import ModelConfig as JModelConfig
from umx_tpu.io import ggml as jggml
from umx_tpu.models import umx as jumx
from umx_tpu_torch.config import ModelConfig
from umx_tpu_torch.io import audio as taudio
from umx_tpu_torch.io import ggml as tggml
from umx_tpu_torch.models import umx as tumx

HIDDEN = 32


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def state_dicts():
    return jumx.synthetic_state_dicts(JModelConfig(hidden_size=HIDDEN), seed=3)


@pytest.fixture(scope="module")
def jax_written(tmp_path_factory, state_dicts):
    path = str(tmp_path_factory.mktemp("ggml") / "model.bin.gz")
    jggml.write_ggml(path, HIDDEN, state_dicts)
    return path


def _assert_models_equal(a, b):
    assert a.hidden_size == b.hidden_size
    assert list(a.targets) == list(b.targets)
    for t in a.targets:
        assert set(a.targets[t]) == set(b.targets[t])
        for name, arr in a.targets[t].items():
            np.testing.assert_array_equal(arr, b.targets[t][name], err_msg=f"{t}/{name}")


def test_synthetic_state_dicts_match_jax(state_dicts):
    ours = tumx.synthetic_state_dicts(ModelConfig(hidden_size=HIDDEN), seed=3)
    assert list(ours) == list(state_dicts)
    for t in ours:
        for name, arr in ours[t].items():
            np.testing.assert_array_equal(arr, state_dicts[t][name])


def test_read_jax_written_ggml(jax_written):
    # the JAX package's pure-Python parser is the reference
    with open(jax_written, "rb") as fh:
        ref = jggml.read_ggml_bytes(fh.read())
    _assert_models_equal(tggml.read_ggml(jax_written), ref)


@pytest.mark.parametrize("suffix", [".bin", ".bin.gz"])
def test_writer_round_trips_and_matches_jax_bytes(tmp_path, state_dicts, suffix):
    ours = tggml.write_ggml_bytes(HIDDEN, state_dicts)
    assert ours == jggml.write_ggml_bytes(HIDDEN, state_dicts)
    path = str(tmp_path / f"m{suffix}")
    tggml.write_ggml(path, HIDDEN, state_dicts)
    _assert_models_equal(tggml.read_ggml(path), jggml.read_ggml_bytes(ours))


@pytest.mark.parametrize(
    "data, message",
    [
        (b"\x00\x00", "too short"),
        (b"\x00\x00\x00\x00\x20\x00\x00\x00", "bad ggml magic"),
    ],
)
def test_reader_errors(data, message):
    with pytest.raises(ValueError, match=message):
        tggml.read_ggml_bytes(data)


def test_reader_truncated_and_target_count(state_dicts):
    good = tggml.write_ggml_bytes(HIDDEN, state_dicts)
    with pytest.raises(ValueError, match="truncated payload"):
        tggml.read_ggml_bytes(good[:-3])
    one_target = {k: state_dicts["bass"] for k in ("bass", "drums", "other", "vocals")}
    data = tggml.write_ggml_bytes(HIDDEN, one_target)
    # cut after the first target: 8-byte header + one target's records
    per_target = (len(data) - 8) // 4
    with pytest.raises(ValueError, match="expected 4 targets, got 1"):
        tggml.read_ggml_bytes(data[: 8 + per_target])


def test_writer_rejects_missing_tensor(state_dicts):
    broken = {t: dict(d) for t, d in state_dicts.items()}
    del broken["drums"]["fc2.weight"]
    with pytest.raises(ValueError, match="missing tensors"):
        tggml.write_ggml_bytes(HIDDEN, broken)


def test_params_from_ggml_match_jax(jax_written):
    jmodel = jggml.read_ggml(jax_written)
    jp = jumx.params_from_ggml(jmodel, JModelConfig(hidden_size=HIDDEN))
    tp = tumx.params_from_ggml(tggml.read_ggml(jax_written), ModelConfig(hidden_size=HIDDEN))
    for f in dataclasses.fields(tp):
        ours = getattr(tp, f.name)
        assert ours.dtype == torch.float32
        np.testing.assert_array_equal(ours.numpy(), np.asarray(getattr(jp, f.name)), err_msg=f.name)


def test_params_from_jax_exact(jax_written):
    jp = jumx.params_from_ggml(jggml.read_ggml(jax_written), JModelConfig(hidden_size=HIDDEN))
    tp = tumx.params_from_jax(jp)
    for f in dataclasses.fields(tp):
        np.testing.assert_array_equal(
            getattr(tp, f.name).numpy(), np.asarray(getattr(jp, f.name)), err_msg=f.name
        )
    assert tp.lstm_hh_w.shape == (4, 3, 2, HIDDEN // 2, 2 * HIDDEN)


def test_wav_load_matches_jax_and_rejects_bad_input(tmp_path):
    from umx_tpu.io.audio import load_audio as jload

    rng = np.random.default_rng(0)
    stereo = (rng.standard_normal((1000, 2)) * 0.1).astype(np.float32)
    p = str(tmp_path / "s.wav")
    wavfile.write(p, 44100, stereo)
    ours = taudio.load_audio(p)
    assert ours.shape == (2, 1000) and ours.dtype == np.float32
    np.testing.assert_array_equal(ours, jload(p))

    mono16 = (rng.standard_normal(500) * 3000).astype(np.int16)
    pm = str(tmp_path / "m.wav")
    wavfile.write(pm, 44100, mono16)
    m = taudio.load_audio(pm)
    assert m.shape == (2, 500)
    np.testing.assert_array_equal(m[0], m[1])
    np.testing.assert_array_equal(m, jload(pm))

    p48 = str(tmp_path / "r.wav")
    wavfile.write(p48, 48000, stereo)
    with pytest.raises(taudio.UnsupportedAudio, match="48000"):
        taudio.load_audio(p48)
    notwav = tmp_path / "x.flac"
    notwav.write_bytes(b"fLaC" + bytes(64))
    with pytest.raises(taudio.UnsupportedAudio, match="WAV"):
        taudio.load_audio(str(notwav))


def test_write_audio_float32_round_trip(tmp_path):
    wave = np.random.default_rng(1).standard_normal((2, 300)).astype(np.float32)
    p = str(tmp_path / "o.wav")
    taudio.write_audio(p, wave)
    rate, data = wavfile.read(p)
    assert rate == 44100 and data.dtype == np.float32
    np.testing.assert_array_equal(data.T, wave)
