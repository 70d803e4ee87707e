"""WAV decode/encode through scipy.

44.1 kHz enforcement (or, asked for, polyphase resampling to it),
mono→stereo duplication, (2, n) channel-major float32 layout, float32 PCM
output.  FLAC, OGG and MP3 are not read by the port yet.
"""

from __future__ import annotations

import numpy as np

_WAV_MAGICS = (b"RIFF", b"RIFX", b"RF64")


class UnsupportedAudio(ValueError):
    pass


def load_audio(path: str, expected_rate: int = 44100, resample: bool = False) -> np.ndarray:
    """Load a WAV into a float32 (2, n_samples) array.  Another sample
    rate raises, unless ``resample``: then the samples are
    polyphase-resampled to ``expected_rate`` in float64."""
    from scipy.io import wavfile

    with open(path, "rb") as fh:
        magic = fh.read(4)
    if magic not in _WAV_MAGICS:
        raise UnsupportedAudio(f"{path}: not a WAV file; the port reads WAV only")
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
    """Write a (2, n_samples) float32 waveform as a float32 PCM WAV."""
    from scipy.io import wavfile

    wavfile.write(path, rate, np.ascontiguousarray(np.asarray(waveform, np.float32).T))
