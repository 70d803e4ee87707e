"""The port's audio formats: its own build of the native IO library
(``io/native.py``: ggml reader, WAV codec, FLAC decoder), the system
libvorbisfile (``io/ogg.py``) and libmpg123 (``io/mp3.py``) bindings, and
``load_audio``'s magic dispatch.  The cases of tests/test_native.py,
test_flac.py, test_ogg.py and test_mp3.py, each decode also held against
the JAX package's decoder on the same file (equal).

The JAX package's native decoders run here on the port's build of the
same sources (``native/``), through the JAX module's own bindings, so
that these tests never run ``make`` in ``native/`` beside the JAX tests."""

from __future__ import annotations

import ctypes
import os
import zlib

import numpy as np
import pytest

from umx_tpu.io import audio as jaudio
from umx_tpu.io import mp3 as jmp3
from umx_tpu.io import native as jnative
from umx_tpu.io import ogg as jogg
from umx_tpu_torch.config import ModelConfig
from umx_tpu_torch.io import mp3, native, ogg
from umx_tpu_torch.io.audio import UnsupportedAudio, load_audio, write_audio
from umx_tpu_torch.io.ggml import read_ggml_bytes, write_ggml, write_ggml_bytes
from umx_tpu_torch.models.umx import synthetic_state_dicts

flac_writer = pytest.importorskip("flac_writer")  # tests/ is on sys.path via rootdir
ogg_writer = pytest.importorskip("ogg_writer")
mp3_writer = pytest.importorskip("mp3_writer")
write_flac = flac_writer.write_flac

DATA = os.path.join(os.path.dirname(__file__), "data")


@pytest.fixture(scope="module")
def lib():
    if not native.available():
        pytest.skip(f"the native IO library could not be built: {native.build_error()}")
    return native


@pytest.fixture
def jax_native(lib, monkeypatch):
    """The JAX package's native bindings over the port's build of the
    same sources."""
    handle = ctypes.CDLL(str(lib.library_path()))
    jnative._declare(handle)
    monkeypatch.setattr(jnative, "_load_lib", lambda: handle)
    return jnative


@pytest.fixture(scope="module")
def vorbis():
    if not (ogg.available() and ogg_writer.available()):
        pytest.skip("system libvorbis not available")


@pytest.fixture(scope="module")
def mpeg():
    if not (mp3.available() and mp3_writer.available()):
        pytest.skip("system libmpg123/libmp3lame not available")


def _random_pcm(rng, n, ch, bps):
    lim = 1 << (bps - 1)
    t = np.arange(n)
    base = 0.5 * np.sin(2 * np.pi * 220 * t / 44100)[:, None]
    x = np.clip(base + rng.uniform(-0.3, 0.3, (n, ch)), -0.99, 0.99)
    return np.round(x * (lim - 1)).astype(np.int64)


def _tone(rate: int, secs: float, freqs=(440.0, 523.25), amp=0.45) -> np.ndarray:
    t = np.arange(int(rate * secs)) / rate
    return np.stack([amp * np.sin(2 * np.pi * f * t) for f in freqs], axis=1).astype(np.float32)


def _corr(a: np.ndarray, b: np.ndarray) -> float:
    n = min(len(a), len(b))
    a, b = a[:n], b[:n]
    return float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))


# -- the native library: its build, the ggml reader, the WAV codec -----------


def test_build_is_cached_by_source_hash(lib):
    path = lib.library_path()
    assert path.is_file() and path.parent.name == "umx_tpu_torch"
    assert lib.build() == path  # built once; a second call finds it


def test_native_ggml_matches_python(lib, jax_native, tmp_path):
    cfg = ModelConfig(hidden_size=32)
    targets = synthetic_state_dicts(cfg, seed=71)
    path = str(tmp_path / "m.bin.gz")
    write_ggml(path, cfg.hidden_size, targets)
    nat = lib.read_ggml_native(path)
    py = read_ggml_bytes(write_ggml_bytes(cfg.hidden_size, targets))
    jnat = jax_native.read_ggml_native(path)
    assert nat.hidden_size == py.hidden_size == 32
    assert set(nat.targets) == set(py.targets)
    for t in py.targets:
        assert set(nat.targets[t]) == set(py.targets[t])
        for name, arr in py.targets[t].items():
            got = nat.targets[t][name]
            assert got.shape == arr.shape, (t, name)
            np.testing.assert_allclose(got, arr, atol=1e-6, err_msg=f"{t}/{name}")
            np.testing.assert_array_equal(got, jnat.targets[t][name])


def test_native_ggml_uncompressed(lib, tmp_path):
    path = str(tmp_path / "m.bin")
    write_ggml(path, 32, synthetic_state_dicts(ModelConfig(hidden_size=32), seed=72))
    nat = lib.read_ggml_native(path)
    assert nat is not None and nat.hidden_size == 32


def test_native_ggml_rejects_garbage(lib, tmp_path):
    path = str(tmp_path / "bad.bin")
    with open(path, "wb") as f:
        f.write(b"\x00" * 64)
    with pytest.raises(IOError):
        lib.read_ggml_native(path)


def test_native_gunzip_rejects_truncated(lib, tmp_path):
    path = str(tmp_path / "m.bin.gz")
    write_ggml(path, 32, synthetic_state_dicts(ModelConfig(hidden_size=32), seed=76))
    blob = open(path, "rb").read()
    trunc = str(tmp_path / "trunc.bin.gz")
    with open(trunc, "wb") as f:
        f.write(blob[: len(blob) // 2])
    with pytest.raises((IOError, ValueError)):
        lib.read_ggml_native(trunc)


def test_native_short_uncompressed_raises_missing_tensors(lib, tmp_path):
    path = str(tmp_path / "m.bin")
    write_ggml(path, 32, synthetic_state_dicts(ModelConfig(hidden_size=32), seed=77))
    blob = open(path, "rb").read()
    short = str(tmp_path / "short.bin")
    with open(short, "wb") as f:
        f.write(blob[: int(len(blob) * 0.8)])
    with pytest.raises((IOError, ValueError)):
        lib.read_ggml_native(short)


def test_native_wav_write_read_round_trip(lib, tmp_path):
    data = np.random.default_rng(73).uniform(-1, 1, (1000, 2)).astype(np.float32)
    path = str(tmp_path / "t.wav")
    assert lib.write_wav_native(path, data, 44100)
    out, rate = lib.read_wav_native(path)
    assert rate == 44100
    np.testing.assert_array_equal(out, data)
    np.testing.assert_array_equal(load_audio(path), data.T)


def test_native_wav_read_matches_scipy_and_jax(lib, jax_native, tmp_path):
    from scipy.io import wavfile

    rng = np.random.default_rng(74)
    for dtype, scale in ((np.int16, 32768.0), (np.float32, 1.0)):
        stored = (rng.uniform(-0.9, 0.9, (500, 2)) * scale).astype(dtype)
        path = str(tmp_path / f"t_{np.dtype(dtype).name}.wav")
        wavfile.write(path, 44100, stored)
        out, rate = lib.read_wav_native(path)
        assert rate == 44100
        np.testing.assert_allclose(out, stored.astype(np.float64) / scale, atol=1e-6)
        np.testing.assert_array_equal(out, jax_native.read_wav_native(path)[0])
        # the port's load_audio reads WAV through scipy: the same values
        np.testing.assert_allclose(load_audio(path), out.T, atol=1e-6)


def test_wav_write_then_load(tmp_path):
    wave = np.random.default_rng(75).uniform(-1, 1, (2, 800)).astype(np.float32)
    path = str(tmp_path / "w.wav")
    write_audio(path, wave)
    np.testing.assert_allclose(load_audio(path), wave, atol=1e-6)


# -- FLAC (native/flac.cpp), bit-exact against the spec-based encoder --------


@pytest.mark.parametrize(
    "kinds",
    [
        ["verbatim"],
        ["constant"],
        [("fixed", 0)],
        [("fixed", 1)],
        [("fixed", 2)],
        [("fixed", 3)],
        [("fixed", 4)],
        [("lpc", 1, 5, [32])],
        [("lpc", 2, 6, [120, -56])],
        [("lpc", 8, 7, [90, 20, -10, 5, -3, 2, -1, 1])],
        ["verbatim", ("fixed", 2), ("lpc", 2, 6, [120, -56]), ("fixed", 4)],
    ],
)
def test_flac_subframe_kinds_bit_exact(lib, tmp_path, kinds):
    rng = np.random.default_rng(zlib.crc32(str(kinds).encode()))
    n = 4096 * 2 + 777  # a short final frame (16-bit block-size header)
    pcm = _random_pcm(rng, n, 2, 16)
    if kinds == ["constant"]:
        pcm[:] = -1234
    path = str(tmp_path / "t.flac")
    write_flac(path, pcm, frame_kinds=kinds)
    data, rate = lib.read_flac_native(path)
    assert rate == 44100 and data.shape == (n, 2)
    np.testing.assert_array_equal(np.round(data * 32768.0).astype(np.int64), pcm)


@pytest.mark.parametrize("mode", ["left_side", "right_side", "mid_side"])
def test_flac_stereo_decorrelation_modes(lib, tmp_path, mode):
    pcm = _random_pcm(np.random.default_rng(11), 4096 + 500, 2, 16)
    path = str(tmp_path / f"{mode}.flac")
    write_flac(path, pcm, frame_kinds=[("fixed", 2)], stereo_mode=mode)
    data, _ = lib.read_flac_native(path)
    np.testing.assert_array_equal(np.round(data * 32768.0).astype(np.int64), pcm)


def test_flac_24bit_mono(lib, tmp_path):
    pcm = _random_pcm(np.random.default_rng(12), 3000, 1, 24)
    path = str(tmp_path / "m24.flac")
    write_flac(path, pcm, bps=24, frame_kinds=[("fixed", 1)])
    data, _ = lib.read_flac_native(path)
    assert data.shape == (3000, 1)
    np.testing.assert_array_equal(np.round(data * float(1 << 23)).astype(np.int64), pcm)


def test_load_audio_flac_mono_duplicates_to_stereo(lib, tmp_path):
    pcm = _random_pcm(np.random.default_rng(13), 5000, 1, 16)
    path = str(tmp_path / "m.flac")
    write_flac(path, pcm)
    out = load_audio(path)
    assert out.shape == (2, 5000)
    np.testing.assert_array_equal(out[0], out[1])


def test_load_audio_flac_equals_jax(jax_native, tmp_path):
    pcm = _random_pcm(np.random.default_rng(18), 9000, 2, 16)
    path = str(tmp_path / "s.flac")
    write_flac(path, pcm, frame_kinds=[("fixed", 2), ("lpc", 2, 6, [120, -56])])
    np.testing.assert_array_equal(load_audio(path), jaudio.load_audio(path))


def test_load_audio_rejects_non_vorbis_ogg(tmp_path):
    path = str(tmp_path / "x.ogg")
    with open(path, "wb") as f:
        f.write(b"OggS" + b"\x00" * 100)
    with pytest.raises(ValueError, match="Vorbis"):
        load_audio(path)


def test_truncated_flac_raises(lib, tmp_path):
    pcm = _random_pcm(np.random.default_rng(14), 9000, 2, 16)
    path = str(tmp_path / "t.flac")
    write_flac(path, pcm)
    blob = open(path, "rb").read()
    short = str(tmp_path / "short.flac")
    with open(short, "wb") as f:
        f.write(blob[: len(blob) * 2 // 3])
    with pytest.raises(IOError):
        lib.read_flac_native(short)
    with pytest.raises(IOError):
        load_audio(short)


def test_gspi_fixture_flac_round_trip(lib, tmp_path):
    """The glockenspiel recording survives a FLAC encode/decode cycle and
    matches the WAV-decoded samples."""
    wav = load_audio(os.path.join(DATA, "gspi_stereo.wav"))
    pcm = np.clip(np.round(wav.T * 32768.0).astype(np.int64), -32768, 32767)
    path = str(tmp_path / "gspi.flac")
    write_flac(path, pcm, frame_kinds=[("fixed", 2), ("lpc", 2, 6, [120, -56])])
    np.testing.assert_allclose(load_audio(path), wav, atol=1.0 / 32768.0)


def test_flac_unknown_length_stream_with_trailing_bytes(lib, tmp_path):
    pcm = _random_pcm(np.random.default_rng(15), 4096 + 100, 2, 16)
    path = str(tmp_path / "nolen.flac")
    write_flac(path, pcm, total_samples_zero=True, trailing_bytes=b"TAGJUNK" * 16)
    data, _ = lib.read_flac_native(path)
    assert data.shape == (4096 + 100, 2)
    np.testing.assert_array_equal(np.round(data * 32768.0).astype(np.int64), pcm)


def test_flac_frame_sample_size_overrides_streaminfo(lib, tmp_path):
    pcm24 = _random_pcm(np.random.default_rng(16), 3000, 2, 24)
    path = str(tmp_path / "f24.flac")
    write_flac(path, pcm24, bps=16, frame_bps=24, frame_kinds=[("fixed", 1)])
    data, _ = lib.read_flac_native(path)
    np.testing.assert_array_equal(np.round(data * float(1 << 23)).astype(np.int64), pcm24)


def test_flac_without_the_library_names_it(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "_load_lib", lambda: None)
    path = str(tmp_path / "x.flac")
    with open(path, "wb") as fh:
        fh.write(b"fLaC" + b"\x00" * 16)
    with pytest.raises(UnsupportedAudio, match="FLAC decoding requires the native library"):
        load_audio(path)


# -- OGG/Vorbis (system libvorbisfile) ---------------------------------------


def test_ogg_stereo_roundtrip_equals_jax(vorbis, tmp_path):
    sig = _tone(44100, 1.5)
    path = str(tmp_path / "tone.ogg")
    ogg_writer.write_ogg(path, sig, 44100)
    out = load_audio(path)
    assert out.shape == (2, sig.shape[0]) and out.dtype == np.float32
    for c in range(2):
        assert _corr(out[c], sig[:, c]) > 0.99
        assert 0.95 < np.linalg.norm(out[c]) / np.linalg.norm(sig[:, c]) < 1.05
    np.testing.assert_array_equal(out, jaudio.load_audio(path))
    np.testing.assert_array_equal(ogg.decode_ogg(path)[0], jogg.decode_ogg(path)[0])


def test_ogg_mono_duplicated_to_stereo(vorbis, tmp_path):
    sig = _tone(44100, 0.8, freqs=(330.0,))
    path = str(tmp_path / "mono.ogg")
    ogg_writer.write_ogg(path, sig, 44100)
    out = load_audio(path)
    assert out.shape == (2, sig.shape[0])
    np.testing.assert_array_equal(out[0], out[1])
    assert _corr(out[0], sig[:, 0]) > 0.99


def test_ogg_foreign_rate_rejected_then_resampled(vorbis, tmp_path):
    sig = _tone(48000, 0.7)
    path = str(tmp_path / "tone48k.ogg")
    ogg_writer.write_ogg(path, sig, 48000)
    with pytest.raises(UnsupportedAudio, match="48000"):
        load_audio(path)
    out = load_audio(path, resample=True)
    assert out.shape[0] == 2
    assert abs(out.shape[1] - round(sig.shape[0] * 44100 / 48000)) <= 2
    assert _corr(out[0], _tone(44100, 0.7)[: out.shape[1], 0]) > 0.98
    np.testing.assert_array_equal(out, jaudio.load_audio(path, resample=True))


def test_corrupt_ogg_raises(vorbis, tmp_path):
    path = str(tmp_path / "bad.ogg")
    with open(path, "wb") as fh:
        fh.write(b"OggS" + b"\x00" * 64)
    with pytest.raises(ValueError, match="Vorbis"):
        load_audio(path)


def test_truncated_ogg_still_decodes_prefix(vorbis, tmp_path):
    sig = _tone(44100, 1.0)
    path = str(tmp_path / "full.ogg")
    ogg_writer.write_ogg(path, sig, 44100, page_per_packet=True)
    blob = open(path, "rb").read()
    cut = str(tmp_path / "cut.ogg")
    with open(cut, "wb") as fh:
        fh.write(blob[: len(blob) * 2 // 3])
    data, r = ogg.decode_ogg(cut)
    assert r == 44100
    assert 0 < data.shape[0] < sig.shape[0]
    assert _corr(data[:, 0], sig[: data.shape[0], 0]) > 0.98
    np.testing.assert_array_equal(data, jogg.decode_ogg(cut)[0])


def test_ogg_decoder_reports_unavailable_gracefully(monkeypatch, tmp_path):
    monkeypatch.setattr(ogg, "_lib", None)
    monkeypatch.setattr(ogg, "_lib_tried", True)
    path = str(tmp_path / "x.ogg")
    with open(path, "wb") as fh:
        fh.write(b"OggS" + b"\x00" * 16)
    with pytest.raises(UnsupportedAudio, match="libvorbisfile"):
        load_audio(path)


# -- MP3 (system libmpg123) --------------------------------------------------


def test_mp3_stereo_roundtrip_equals_jax(mpeg, tmp_path):
    sig = _tone(44100, 1.5)
    path = str(tmp_path / "tone.mp3")
    mp3_writer.write_mp3(path, sig, 44100)
    out = load_audio(path)
    assert out.dtype == np.float32 and out.shape[0] == 2
    # gapless: the LAME tag's delay and padding trim to the original length
    assert abs(out.shape[1] - sig.shape[0]) <= 576
    for c in range(2):
        assert _corr(out[c], sig[:, c]) > 0.98
        assert 0.9 < np.linalg.norm(out[c][: sig.shape[0]]) / np.linalg.norm(sig[:, c]) < 1.1
    np.testing.assert_array_equal(out, jaudio.load_audio(path))
    np.testing.assert_array_equal(mp3.decode_mp3(path)[0], jmp3.decode_mp3(path)[0])


def test_mp3_mono_duplicated_to_stereo(mpeg, tmp_path):
    sig = _tone(44100, 0.8, freqs=(330.0,))
    path = str(tmp_path / "mono.mp3")
    mp3_writer.write_mp3(path, sig, 44100)
    out = load_audio(path)
    assert out.shape[0] == 2
    np.testing.assert_array_equal(out[0], out[1])
    assert _corr(out[0], sig[:, 0]) > 0.98


def test_mp3_foreign_rate_rejected_then_resampled(mpeg, tmp_path):
    sig = _tone(32000, 0.7)  # an MPEG-1 layer III rate other than 44.1 kHz
    path = str(tmp_path / "tone32k.mp3")
    mp3_writer.write_mp3(path, sig, 32000)
    with pytest.raises(UnsupportedAudio, match="32000"):
        load_audio(path)
    out = load_audio(path, resample=True)
    assert out.shape[0] == 2
    assert abs(out.shape[1] - round(sig.shape[0] * 44100 / 32000)) <= 1024
    ref = _tone(44100, 0.7)
    n = min(out.shape[1], ref.shape[0])
    assert _corr(out[0][:n], ref[:n, 0]) > 0.95
    np.testing.assert_array_equal(out, jaudio.load_audio(path, resample=True))


def test_mp3_decode_is_deterministic(mpeg, tmp_path):
    """Repeated decodes are identical (a temporary's buffer freed before
    the decoder reads it would show as nondeterminism)."""
    path = str(tmp_path / "det.mp3")
    mp3_writer.write_mp3(path, _tone(44100, 0.5), 44100)
    ref = mp3.decode_mp3(path)
    for _ in range(3):
        again = mp3.decode_mp3(path)
        np.testing.assert_array_equal(again[0], ref[0])
        assert again[1] == ref[1]


def test_mp3_id3_and_sync_sniff():
    assert mp3.looks_like_mp3(b"ID3\x04")
    assert mp3.looks_like_mp3(bytes([0xFF, 0xFB, 0x90, 0x00]))
    for magic in (b"RIFF", b"fLaC", b"OggS", bytes([0xFF, 0x01, 0x00, 0x00])):
        assert not mp3.looks_like_mp3(magic)
        assert mp3.looks_like_mp3(magic) == jmp3.looks_like_mp3(magic)


def test_mp3_garbage_rejected(mpeg, tmp_path):
    path = str(tmp_path / "junk.mp3")
    with open(path, "wb") as fh:
        fh.write(b"ID3" + bytes(64))  # an ID3 header, then no frames
    with pytest.raises(ValueError):
        load_audio(path)


def test_mp3_decoder_reports_unavailable_gracefully(monkeypatch, tmp_path):
    monkeypatch.setattr(mp3, "_lib", None)
    monkeypatch.setattr(mp3, "_lib_tried", True)
    path = str(tmp_path / "x.mp3")
    with open(path, "wb") as fh:
        fh.write(b"ID3" + b"\x00" * 16)
    with pytest.raises(UnsupportedAudio, match="libmpg123"):
        load_audio(path)


def test_unknown_magic_is_rejected_by_name(tmp_path):
    path = str(tmp_path / "x.bin")
    with open(path, "wb") as fh:
        fh.write(b"JUNK" + bytes(64))
    with pytest.raises(UnsupportedAudio, match="not a WAV, FLAC, OGG or MP3 file"):
        load_audio(path)


def test_smoke_flac_encoder_round_trips(lib, tmp_path):
    """The numpy FLAC encoder of chip_smoke.py (verbatim subframes, a short
    last frame, one- and two-byte frame numbers) decodes to its 16-bit
    samples through the native decoder; its header CRC-8 is the spec-based
    test encoder's and its frame CRC-16 a bitwise one's (polynomial
    0x8005)."""
    import chip_smoke

    def crc16(data: bytes) -> int:
        c = 0
        for b in data:
            c ^= b << 8
            for _ in range(8):
                c = ((c << 1) ^ 0x8005) & 0xFFFF if c & 0x8000 else (c << 1) & 0xFFFF
        return c

    n = 130 * 4096 + 1234
    mix = np.random.default_rng(19).uniform(-1.0, 1.0, (2, n)).astype(np.float32)
    path = str(tmp_path / "smoke.flac")
    blob = chip_smoke.flac_bytes(mix)
    with open(path, "wb") as fh:
        fh.write(blob)
    pcm = np.clip(np.round(mix * 32767.0), -32768, 32767)
    data, rate = lib.read_flac_native(path)
    assert rate == chip_smoke.SR and data.shape == (n, 2)
    np.testing.assert_array_equal(np.round(data * 32768.0), pcm.T)
    pos = 42  # "fLaC", the metadata block header and STREAMINFO
    for k in range(131):
        head = 5 if k < 0x80 else 6
        size = head + 1 + 2 * (1 + 2 * (4096 if k < 130 else 1234)) + (2 if k == 130 else 0)
        frame = blob[pos : pos + size]
        hlen = head + (2 if k == 130 else 0)
        assert frame[hlen] == flac_writer.crc8(frame[:hlen]), k
        assert int.from_bytes(blob[pos + size : pos + size + 2], "big") == crc16(frame), k
        pos += size + 2
    assert pos == len(blob)
