"""Audio decode/encode.

44.1 kHz enforcement (or, asked for, polyphase resampling to it),
mono→stereo duplication, (2, n) channel-major float32 layout, float32 PCM
output.  The format is sniffed from the file's first bytes, as the JAX
package does: ``fLaC`` → the native FLAC decoder (``io/native.py``),
``OggS`` → the system libvorbisfile (``io/ogg.py``), an ID3 tag or an MPEG
frame sync → the system libmpg123 (``io/mp3.py``), a RIFF header → scipy's
WAV reader.
"""

from __future__ import annotations

import numpy as np

_WAV_MAGICS = (b"RIFF", b"RIFX", b"RF64")


class UnsupportedAudio(ValueError):
    pass


def _decode_scipy(path: str) -> tuple[np.ndarray, int]:
    from scipy.io import wavfile

    rate, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim == 1:
        data = data[:, None]
    return data, rate


def _decode(path: str) -> tuple[np.ndarray, int]:
    """(data (frames, channels) float32, rate) by the file's magic."""
    with open(path, "rb") as fh:
        magic = fh.read(4)
    if magic == b"fLaC":
        from umx_tpu_torch.io import native

        decoded = native.read_flac_native(path)
        if decoded is None:
            raise UnsupportedAudio(
                f"{path}: FLAC decoding requires the native library, which could not be "
                f"built: {native.build_error()}"
            )
        return decoded
    if magic == b"OggS":
        from umx_tpu_torch.io import ogg

        decoded = ogg.decode_ogg(path)
        if decoded is None:
            raise UnsupportedAudio(
                f"{path}: OGG decoding requires the system libvorbisfile "
                "(not found); supply WAV or FLAC"
            )
        return decoded
    from umx_tpu_torch.io import mp3

    if mp3.looks_like_mp3(magic):
        # after the fixed magics: MP3 has none, only an ID3 tag or a frame sync
        decoded = mp3.decode_mp3(path)
        if decoded is None:
            raise UnsupportedAudio(
                f"{path}: MP3 decoding requires the system libmpg123 "
                "(not found); supply WAV or FLAC"
            )
        return decoded
    if magic not in _WAV_MAGICS:
        raise UnsupportedAudio(f"{path}: not a WAV, FLAC, OGG or MP3 file")
    return _decode_scipy(path)


def load_audio(path: str, expected_rate: int = 44100, resample: bool = False) -> np.ndarray:
    """Load a WAV, FLAC, OGG/Vorbis or MP3 file into a float32 (2,
    n_samples) array.  Another sample rate raises, unless ``resample``:
    then the decoded samples are polyphase-resampled to ``expected_rate``
    in float64."""
    data, rate = _decode(path)
    if rate != expected_rate:
        if not resample:
            raise UnsupportedAudio(
                f"{path}: sample rate {rate} Hz unsupported; only {expected_rate} Hz "
                "(pass resample=True / --resample to convert)"
            )
        from math import gcd

        from scipy.signal import resample_poly

        g = gcd(expected_rate, rate)
        data = resample_poly(
            data.astype(np.float64), expected_rate // g, rate // g, axis=0
        ).astype(np.float32)
    n_ch = data.shape[1]
    if n_ch == 1:
        data = np.repeat(data, 2, axis=1)
    elif n_ch != 2:
        raise UnsupportedAudio(f"{path}: {n_ch} channels unsupported; mono/stereo only")
    return np.ascontiguousarray(data.T, dtype=np.float32)


def write_audio(path: str, waveform: np.ndarray, rate: int = 44100) -> None:
    """Write a (2, n_samples) float32 waveform as a float32 PCM WAV to
    ``path`` (a file name or a binary file)."""
    from scipy.io import wavfile

    wavfile.write(path, rate, np.ascontiguousarray(np.asarray(waveform, np.float32).T))
