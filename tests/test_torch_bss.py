"""The port's BSS-eval (``umx_tpu_torch.eval.bss``): every case of
``tests/test_bss.py`` against the port (the batched float32 solves run
with torch on the CPU), the port against ``umx_tpu.eval.bss`` on the
same inputs, and a Gram that is not positive definite, which the batched
solve turns into NaN and a float64 re-solve where ``torch.linalg.cholesky``
would raise."""

import numpy as np
import pytest
import torch

from umx_tpu.eval import bss as jbss
from umx_tpu_torch.eval import bss
from umx_tpu_torch.eval.bss import (
    bss_eval_images_framewise,
    bss_eval_window,
    bss_eval_window_batch,
)


@pytest.fixture(scope="module")
def sources():
    rng = np.random.default_rng(61)
    J, C, T = 3, 2, 8000
    # independent-ish band-limited sources
    s = rng.standard_normal((J, C, T))
    for j in range(J):
        k = 50 * (j + 1)
        t = np.arange(T)
        s[j] += 2.0 * np.sin(2 * np.pi * k * t / T)[None, :]
    return s.astype(np.float64)


def test_perfect_estimate_high_sdr(sources):
    sdr, isr, sir, sar = bss_eval_window(sources, sources.copy(), flen=16)
    assert (sdr > 60).all(), sdr
    assert (isr > 60).all()
    assert (sir > 60).all()


def test_additive_noise_sdr_tracks_snr(sources):
    rng = np.random.default_rng(62)
    target_snr_db = 20.0
    est = sources.copy()
    for j in range(sources.shape[0]):
        p = np.mean(sources[j] ** 2)
        noise = rng.standard_normal(sources[j].shape)
        noise *= np.sqrt(p / np.mean(noise**2) * 10 ** (-target_snr_db / 10))
        est[j] = sources[j] + noise
    sdr, isr, sir, sar = bss_eval_window(sources, est, flen=16)
    # white noise is mostly artifact: SDR should sit near the SNR
    np.testing.assert_allclose(sdr, target_snr_db, atol=2.0)
    # ...and SAR should approximate SDR while SIR stays high
    assert (sir > sdr + 6).all()


def test_interference_detected(sources):
    est = sources.copy()
    est[0] = sources[0] + 0.3 * sources[1]
    sdr, isr, sir, sar = bss_eval_window(sources, est, flen=16)
    assert sir[0] < 30
    assert sar[0] > sir[0] + 10  # contamination is interference, not artifact
    assert sir[1] > 60


def test_filtered_estimate_forgiven_by_projection(sources):
    from scipy.signal import lfilter

    est = sources.copy()
    est[0] = lfilter([0.9, 0.3, -0.1], [1.0], sources[0], axis=-1)
    sdr, isr, sir, sar = bss_eval_window(sources, est, flen=16)
    assert sar[0] > 40, sar
    assert isr[0] < sar[0]


def test_batched_solver_matches_per_window(sources):
    rng = np.random.default_rng(64)
    est = sources + 0.05 * rng.standard_normal(sources.shape)
    W = 2
    refs_w = np.stack([sources[..., :4000], sources[..., 4000:8000]])
    ests_w = np.stack([est[..., :4000], est[..., 4000:8000]])
    batched = bss_eval_window_batch(refs_w, ests_w, flen=16, device="cpu")
    for w in range(W):
        single = bss_eval_window(refs_w[w], ests_w[w], flen=16)
        for m_b, m_s in zip(batched, single):
            # f32 torch solves vs f64 host solves: sub-0.1 dB agreement
            np.testing.assert_allclose(m_b[w], m_s, atol=0.1)


def test_framewise_torch_accelerator_matches_numpy(sources):
    rng = np.random.default_rng(65)
    est = sources + 0.05 * rng.standard_normal(sources.shape)
    a = bss_eval_images_framewise(
        sources, est, window=4000, hop=4000, flen=16, accelerator="numpy", mode="v3"
    )
    b = bss_eval_images_framewise(
        sources, est, window=4000, hop=4000, flen=16, accelerator="torch", mode="v3",
        device="cpu",
    )
    np.testing.assert_allclose(a["median_SDR"], b["median_SDR"], atol=0.1)
    np.testing.assert_allclose(a["median_SIR"], b["median_SIR"], atol=0.3)
    assert a["float64_resolves"] == b["float64_resolves"] == 0


def test_framewise_shapes_and_median(sources):
    J, C, T = sources.shape
    est = sources + 0.01 * np.random.default_rng(63).standard_normal(sources.shape)
    res = bss_eval_images_framewise(sources, est, window=4000, hop=4000, flen=16)
    assert res["SDR"].shape[0] == J
    assert res["SDR"].shape[1] == 2  # two full windows
    assert res["median_SDR"].shape == (J,)
    assert np.isfinite(res["median_SDR"]).all()


def test_torch_path_falls_back_to_float64_on_nonfinite(monkeypatch):
    # NaNs from a float32 solve on near-singular Grams must not be
    # silently absorbed by nanmedian: those windows re-solve in float64 on
    # the host path, and are counted
    rng = np.random.default_rng(19)
    refs = rng.normal(size=(2, 2, 2 * 44100)).astype(np.float32) * 0.1
    ests = refs + 0.01 * rng.normal(size=refs.shape).astype(np.float32)

    real_batch = bss.bss_eval_window_batch

    def poisoned_batch(references, estimates, flen=512, max_windows=8, device=None):
        out = real_batch(references, estimates, flen, max_windows, device)
        return tuple(np.full_like(o, np.nan) for o in out)

    monkeypatch.setattr(bss, "bss_eval_window_batch", poisoned_batch)
    got = bss.bss_eval_images_framewise(refs, ests, flen=64, accelerator="torch", mode="v3",
                                        device="cpu")
    want = bss.bss_eval_images_framewise(refs, ests, flen=64, accelerator="numpy", mode="v3")
    for key in ("SDR", "ISR", "SIR", "SAR"):
        assert np.isfinite(got[key]).all(), key
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6, atol=1e-6)
    assert got["float64_resolves"] == 2 and want["float64_resolves"] == 0


def _not_positive_definite(n: int, seed: int) -> np.ndarray:
    """A symmetric matrix with one negative eigenvalue."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    ev = np.linspace(1.0, 2.0, n)
    ev[n // 2] = -0.5
    return (q * ev) @ q.T


def test_batched_solve_turns_a_gram_that_is_not_positive_definite_into_nan():
    n = 24
    rng = np.random.default_rng(5)
    a = rng.standard_normal((n, n))
    spd = a @ a.T + n * np.eye(n)
    bad = _not_positive_definite(n, 6)
    rhs = rng.standard_normal((3, n, 2))
    with pytest.raises(torch.linalg.LinAlgError):
        torch.linalg.cholesky(torch.as_tensor(bad, dtype=torch.float32))
    x = bss._solve_cholesky_batched(np.stack([spd, bad, spd]), rhs, "cpu")
    assert np.isnan(x[1]).all()
    # the positive definite systems beside it solve as in float64
    for w in (0, 2):
        np.testing.assert_allclose(x[w], np.linalg.solve(spd, rhs[w]), rtol=1e-4, atol=1e-5)


def test_a_window_whose_gram_is_not_positive_definite_is_re_solved(monkeypatch):
    # the real batched solve gets window 0's Gram negated (not positive
    # definite: torch.linalg.cholesky would raise on it); its window comes
    # back NaN and is re-solved in float64, and the other window is the
    # float32 solve's
    rng = np.random.default_rng(23)
    refs = rng.normal(size=(2, 2, 2 * 4000)) * 0.1
    ests = refs + 0.01 * rng.normal(size=refs.shape)
    real_solve = bss._solve_cholesky_batched

    def break_first(Gs, Bs, device=None):
        Gs = Gs.copy()
        Gs[0] = -Gs[0]
        return real_solve(Gs, Bs, device)

    monkeypatch.setattr(bss, "_solve_cholesky_batched", break_first)
    got = bss.bss_eval_images_framewise(refs, ests, window=4000, hop=4000, flen=16,
                                        accelerator="torch", mode="v3", device="cpu")
    want = bss.bss_eval_images_framewise(refs, ests, window=4000, hop=4000, flen=16,
                                         accelerator="numpy", mode="v3")
    assert got["float64_resolves"] == 1
    for key in ("SDR", "ISR", "SIR", "SAR"):
        assert np.isfinite(got[key]).all(), key
        # window 0 re-solved on the host path: its bits; window 1 in float32
        np.testing.assert_array_equal(got[key][:, 0], want[key][:, 0])
        np.testing.assert_allclose(got[key][:, 1], want[key][:, 1], atol=0.1)


def test_accelerator_and_mode_are_checked(sources):
    with pytest.raises(ValueError, match="accelerator"):
        bss_eval_images_framewise(sources, sources, flen=16, accelerator="jax", mode="v3")
    with pytest.raises(ValueError, match="mode"):
        bss_eval_images_framewise(sources, sources, flen=16, mode="v2")


def test_v3_auto_runs_on_the_gpu_and_raises_without_one(sources):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU error path cannot be reached")
    with pytest.raises(RuntimeError, match="cuda"):
        bss_eval_images_framewise(sources, sources, window=4000, hop=4000, flen=16, mode="v3")
    # v4 (the default) touches no device
    res = bss_eval_images_framewise(sources, sources + 0.01, window=4000, hop=4000, flen=16)
    assert np.isfinite(res["median_SDR"]).all()


class TestMusevalConventions:
    """The museval conventions the evaluator transcribes: v4 global filters
    vs v3 per-window filters, 1 s non-overlapping windows with the trailing
    partial dropped, silent source-frames NaN, nanmedian aggregation,
    filter length capture behavior (the cases of ``tests/test_bss.py``)."""

    def test_v4_global_filters_vs_v3_framewise_filters(self):
        rng = np.random.default_rng(70)
        J, C, T = 2, 2, 6 * 4000
        refs = rng.standard_normal((J, C, T))
        gains = np.repeat([1.0, 2.0, 0.5, 1.5, 0.8, 1.2], 4000)
        ests = refs * gains[None, None, :]
        v3 = bss_eval_images_framewise(
            refs, ests, window=4000, hop=4000, flen=16, accelerator="numpy", mode="v3"
        )
        v4 = bss_eval_images_framewise(
            refs, ests, window=4000, hop=4000, flen=16, mode="v4"
        )
        assert np.nanmin(v3["median_SAR"]) > 40.0  # per-window filter adapts
        assert np.nanmax(v4["median_SAR"]) < 25.0  # global filter cannot
        np.testing.assert_allclose(v3["median_SDR"], v4["median_SDR"], atol=0.1)
        ests2 = 1.3 * refs
        v3b = bss_eval_images_framewise(
            refs, ests2, window=4000, hop=4000, flen=16, accelerator="numpy", mode="v3"
        )
        v4b = bss_eval_images_framewise(
            refs, ests2, window=4000, hop=4000, flen=16, mode="v4"
        )
        np.testing.assert_allclose(v3b["median_SAR"], v4b["median_SAR"], atol=1.0)
        np.testing.assert_allclose(v3b["median_ISR"], v4b["median_ISR"], atol=1.0)

    def test_trailing_partial_window_dropped(self):
        rng = np.random.default_rng(71)
        refs = rng.standard_normal((2, 2, 3 * 4000 + 1999))
        ests = refs + 0.1 * rng.standard_normal(refs.shape)
        res = bss_eval_images_framewise(refs, ests, window=4000, hop=4000, flen=16)
        assert res["SDR"].shape[1] == 3  # museval floors the window count

    def test_track_shorter_than_window_is_one_frame(self):
        rng = np.random.default_rng(72)
        refs = rng.standard_normal((2, 2, 2500))
        ests = refs + 0.1 * rng.standard_normal(refs.shape)
        res = bss_eval_images_framewise(refs, ests, window=4000, hop=4000, flen=16)
        assert res["SDR"].shape[1] == 1

    def test_silent_source_frame_is_nan_and_excluded_from_median(self):
        rng = np.random.default_rng(73)
        J, C, T = 2, 2, 4 * 4000
        refs = rng.standard_normal((J, C, T))
        refs[0, :, 4000:8000] = 0.0  # source 0 silent in window 1
        ests = refs + 0.05 * rng.standard_normal(refs.shape)
        res = bss_eval_images_framewise(refs, ests, window=4000, hop=4000, flen=16)
        assert np.isnan(res["SDR"][0, 1])
        assert np.isfinite(res["SDR"][1]).all()
        expect = np.nanmedian(res["SDR"][0])
        np.testing.assert_allclose(res["median_SDR"][0], expect)
        assert np.isfinite(res["median_SDR"][0])

    def test_filters_capture_fir_within_flen(self):
        from scipy.signal import lfilter

        rng = np.random.default_rng(74)
        J, C, T = 2, 2, 3 * 4000
        refs = rng.standard_normal((J, C, T))
        short_fir = rng.standard_normal(8) * 0.3
        long_fir = rng.standard_normal(200) * 0.3
        est_short = np.stack(
            [np.stack([lfilter(short_fir, [1.0], refs[j, c]) for c in range(C)])
             for j in range(J)]
        )
        est_long = np.stack(
            [np.stack([lfilter(long_fir, [1.0], refs[j, c]) for c in range(C)])
             for j in range(J)]
        )
        res_s = bss_eval_images_framewise(refs, est_short, window=4000, hop=4000, flen=16)
        res_l = bss_eval_images_framewise(refs, est_long, window=4000, hop=4000, flen=16)
        assert np.nanmin(res_s["median_SAR"]) > 40.0  # fully captured
        assert np.nanmax(res_l["median_SAR"]) < 20.0  # exceeds flen -> artifacts


# ---- the port against the JAX package on the same inputs -------------------

METRICS = ("SDR", "ISR", "SIR", "SAR")


@pytest.fixture(scope="module")
def noisy(sources):
    rng = np.random.default_rng(66)
    est = sources + 0.05 * rng.standard_normal(sources.shape)
    est[0] += 0.2 * sources[1]
    return est


def test_window_equals_jax(sources, noisy):
    # the same float64 host code: within 1e-9 dB
    for got, want in zip(bss_eval_window(sources, noisy, flen=16),
                         jbss.bss_eval_window(sources, noisy, flen=16)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)


@pytest.mark.parametrize("mode", ["v4", "v3"])
def test_framewise_host_modes_equal_jax(sources, noisy, mode):
    got = bss_eval_images_framewise(sources, noisy, window=3000, hop=3000, flen=16,
                                    accelerator="numpy", mode=mode)
    want = jbss.bss_eval_images_framewise(sources, noisy, window=3000, hop=3000, flen=16,
                                          accelerator="numpy", mode=mode)
    for m in METRICS:
        np.testing.assert_allclose(got[m], want[m], rtol=0, atol=1e-9)
        np.testing.assert_allclose(got[f"median_{m}"], want[f"median_{m}"], rtol=0, atol=1e-9)


def test_window_batch_torch_cpu_matches_jax_cpu(sources, noisy):
    # torch f32 on the CPU against jax f32 on the CPU: within 0.1 dB
    refs_w = np.stack([sources[..., :4000], sources[..., 4000:8000]])
    ests_w = np.stack([noisy[..., :4000], noisy[..., 4000:8000]])
    got = bss_eval_window_batch(refs_w, ests_w, flen=16, device="cpu")
    want = jbss.bss_eval_window_batch(refs_w, ests_w, flen=16)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (2, 3)
        np.testing.assert_allclose(g, w, atol=0.1)
