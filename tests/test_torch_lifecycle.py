"""The port's model lifecycle (counterpart of ``tests/test_lifecycle.py``):
train → export ggml → load → demix → eval, on the CPU.

A tiny UMX trained briefly on synthetic band-separated stems must demix a
held-out mixture better than its untrained initialization (correlation
with the true stems, and the BSS-eval v4 SDR), after passing through
ggml quantization and the whole engine (STFT → masks → Wiener → iSTFT →
overlap-add)."""

import numpy as np
import pytest
import torch

from umx_tpu_torch.config import DSPConfig, EngineConfig, ModelConfig, SegmentConfig
from umx_tpu_torch.engine.separator import Separator
from umx_tpu_torch.eval.bss import bss_eval_images_framewise
from umx_tpu_torch.models.umx import synthetic_params
from umx_tpu_torch.train import (
    TrainConfig,
    export_ggml,
    init_train_state,
    make_batch_from_audio,
    make_train_step,
)

SR = 44100


def band_noise(rng, n, lo, hi):
    """Stereo noise band-limited to [lo, hi) Hz via rFFT masking."""
    x = rng.standard_normal((2, n)).astype(np.float32)
    spec = np.fft.rfft(x, axis=-1)
    freqs = np.fft.rfftfreq(n, 1 / SR)
    spec[:, (freqs < lo) | (freqs >= hi)] = 0
    out = np.fft.irfft(spec, n, axis=-1).astype(np.float32)
    return out / (np.abs(out).max() + 1e-9) * 0.5


BANDS = [(40, 300), (300, 1200), (1200, 4000), (4000, 12000)]


def make_stems(rng, n):
    return np.stack([band_noise(rng, n, lo, hi) for lo, hi in BANDS])


def stem_correlation(est, ref):
    """Mean per-stem correlation between estimates and references."""
    cors = []
    for j in range(ref.shape[0]):
        a, b = est[j].ravel(), ref[j].ravel()
        cors.append(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))
    return float(np.mean(cors))


@pytest.mark.slow
def test_train_export_demix_improves(tmp_path):
    torch.manual_seed(0)
    cfg = ModelConfig(hidden_size=32)
    tcfg = TrainConfig(seq_len=24, learning_rate=2e-3)
    dsp = DSPConfig()
    rng = np.random.default_rng(7)

    # training data: fresh random stems each batch, mixed additively
    n = dsp.hop * (tcfg.seq_len - 1)
    step = make_train_step(cfg)
    params0 = synthetic_params(cfg, seed=3)
    state = init_train_state(params0, tcfg)

    losses = []
    for _ in range(60):
        stems = np.stack([make_stems(rng, n) for _ in range(2)])  # (B, 4, 2, n)
        mix = stems.sum(axis=1)
        batch = make_batch_from_audio(mix, stems, cfg, dsp, tcfg.seq_len, "cpu")
        state, loss = step(state, batch)
        losses.append(float(loss))
    assert losses[-1] < 0.5 * losses[0], losses[::10]

    # export trained weights through the quantized ggml format
    path = str(tmp_path / "trained.bin.gz")
    export_ggml(state.params, path, cfg)

    ecfg = EngineConfig(model=cfg, segment=SegmentConfig(segment_secs=1.0), shifts=0)
    sep_trained = Separator.from_ggml(path, ecfg, "cpu")
    sep_untrained = Separator(params0, ecfg, "cpu")

    # held-out mixture
    stems = make_stems(np.random.default_rng(99), int(1.5 * SR))
    mix = stems.sum(axis=0)
    est_trained = sep_trained.demix_track(mix)
    est_untrained = sep_untrained.demix_track(mix)

    c_trained = stem_correlation(est_trained, stems)
    c_untrained = stem_correlation(est_untrained, stems)
    assert c_trained > c_untrained + 0.1, (c_trained, c_untrained)
    assert c_trained > 0.5, c_trained

    # and the evaluator sees it: v4 median SDR, mean over stems
    sdr = {}
    for name, est in (("trained", est_trained), ("untrained", est_untrained)):
        res = bss_eval_images_framewise(stems.astype(np.float64), est.astype(np.float64),
                                        flen=64)
        sdr[name] = float(np.mean(res["median_SDR"]))
    assert sdr["trained"] > sdr["untrained"], sdr
