"""BSS-eval v4 image metrics (SDR/ISR/SIR/SAR), museval-equivalent
(counterpart of ``umx_tpu.eval.bss``, whose float64 host code this module
carries as its own copy).

bss_eval_images with least-squares multichannel FIR projections (filter
length 512), framewise energy ratios over 1-second windows,
median-aggregated, from the BSS-eval definitions (Vincent et al.; SiSEC
2018 v4 conventions).  museval itself is not a dependency; its conventions
are transcribed here and pinned by tests
(tests/test_torch_bss.py::TestMusevalConventions):

* ``mode="v4"`` (museval's default): the distortion filters are
  estimated ONCE over the FULL track, then SDR/ISR/SIR/SAR are
  per-window energy ratios of the globally decomposed error signals.
  Host code only (numpy/scipy float64): no device is touched.
* ``mode="v3"`` (museval's framewise_filters=True): filters re-estimated
  inside every window (slower, more forgiving of time-varying gains).
  The per-window linear solves run batched in float32 on a torch device
  (:func:`_solve_cholesky_batched`), or window by window in float64 on
  the host (``accelerator="numpy"``).
* windows: 1 s, hop 1 s, TRAILING PARTIAL WINDOW DROPPED (museval
  floors the window count); a track shorter than one window is one
  whole-signal frame.
* a source whose reference is silent within a window scores NaN for
  that window; track scores are nanmedian over windows.

Definitions per source image s_i and estimate e_i (stereo, (T, C)):

    P_s  e = LS projection of e onto {delayed copies of s_i channels}
    P_all e = LS projection of e onto {delayed copies of ALL sources}
    e_spat   = P_s e - s_i
    e_interf = P_all e - P_s e
    e_artif  = e - P_all e

    SDR = 10 log10 ||s_i||^2 / ||e_spat + e_interf + e_artif||^2
    ISR = 10 log10 ||s_i||^2 / ||e_spat||^2
    SIR = 10 log10 ||s_i + e_spat||^2 / ||e_interf||^2
    SAR = 10 log10 ||s_i + e_spat + e_interf||^2 / ||e_artif||^2

The Gram matrix over all (source, channel, lag) regressors is built
from FFT cross-correlations and Cholesky-factorized once per window,
then reused for every estimate.
"""

from __future__ import annotations

import numpy as np
from scipy.linalg import cho_factor, cho_solve
from scipy.signal import fftconvolve


def _correlations(refs: np.ndarray, flen: int):
    """refs: (K, n) regressor channels.  Returns
    G (K*flen, K*flen) Gram matrix of all delayed regressors via FFT
    cross-correlations (delays 0..flen-1)."""
    K, n = refs.shape
    nfft = int(2 ** np.ceil(np.log2(n + flen - 1)))
    sf = np.fft.rfft(refs, nfft, axis=1)
    # cross-correlation r_{ab}(m) = sum_t a(t-m) b(t),  m in (-flen, flen)
    G = np.empty((K, flen, K, flen))
    for a in range(K):
        for b in range(a, K):
            r = np.fft.irfft(np.conj(sf[a]) * sf[b], nfft)
            # G[a, l, b, l'] = sum_t a(t-l) b(t-l') = r_ab(l - l')
            # with r_ab(m) = sum_t a(t) b(t+m)
            idx = np.arange(flen)
            lag = idx[:, None] - idx[None, :]  # l - l'
            blk = r[lag % nfft]
            G[a, :, b, :] = blk
            if a != b:
                G[b, :, a, :] = blk.T
    return G.reshape(K * flen, K * flen)


def _cross_terms(refs: np.ndarray, est: np.ndarray, flen: int):
    """d[(k, l), c] = sum_t refs_k(t - l) est_c(t)."""
    K, n = refs.shape
    C = est.shape[0]
    nfft = int(2 ** np.ceil(np.log2(n + flen - 1)))
    sf = np.fft.rfft(refs, nfft, axis=1)
    ef = np.fft.rfft(est, nfft, axis=1)
    d = np.empty((K, flen, C))
    for k in range(K):
        for c in range(C):
            r = np.fft.irfft(np.conj(sf[k]) * ef[c], nfft)
            d[k, :, c] = r[:flen]
    return d.reshape(K * flen, C)


def _project(refs: np.ndarray, coeffs: np.ndarray, flen: int, n: int):
    """Apply the fitted FIR filters: y_c(t) = sum_k sum_l h[k,l,c] refs_k(t-l)."""
    K = refs.shape[0]
    C = coeffs.shape[-1]
    h = coeffs.reshape(K, flen, C)
    y = np.zeros((C, n + flen - 1))
    for k in range(K):
        for c in range(C):
            y[c] += fftconvolve(refs[k], h[k, :, c])[: n + flen - 1]
    return y[:, :n]


def _db(num: float, den: float, eps: float = 1e-12) -> float:
    return 10.0 * np.log10((num + eps) / (den + eps))


def bss_eval_window(references: np.ndarray, estimates: np.ndarray, flen: int = 512):
    """One-window bss_eval_images.

    references, estimates: (J, C, n).  Returns (SDR, ISR, SIR, SAR)
    arrays of shape (J,).
    """
    J, C, n = references.shape
    refs_all = references.reshape(J * C, n)
    G = _correlations(refs_all, flen)
    # regularize tiny diagonals for silent channels
    G[np.diag_indices_from(G)] += 1e-9 * max(1.0, np.trace(G) / G.shape[0])
    cho_all = cho_factor(G, check_finite=False)

    # per-source sub-Gram factorizations
    chos = []
    for j in range(J):
        sl = slice(j * C * flen, (j + 1) * C * flen)
        Gj = G[sl, sl].copy()
        chos.append(cho_factor(Gj, check_finite=False))

    sdr = np.empty(J)
    isr = np.empty(J)
    sir = np.empty(J)
    sar = np.empty(J)
    for j in range(J):
        e = estimates[j]
        d_all = _cross_terms(refs_all, e, flen)
        h_all = cho_solve(cho_all, d_all, check_finite=False)
        p_all = _project(refs_all, h_all, flen, n)

        sl = slice(j * C * flen, (j + 1) * C * flen)
        d_j = d_all[sl]
        h_j = cho_solve(chos[j], d_j, check_finite=False)
        p_j = _project(references[j], h_j, flen, n)

        s_true = references[j]
        e_spat = p_j - s_true
        e_interf = p_all - p_j
        e_artif = e - p_all

        s2 = float(np.sum(s_true**2))
        sdr[j] = _db(s2, float(np.sum((e_spat + e_interf + e_artif) ** 2)))
        isr[j] = _db(s2, float(np.sum(e_spat**2)))
        sir[j] = _db(float(np.sum((s_true + e_spat) ** 2)), float(np.sum(e_interf**2)))
        sar[j] = _db(
            float(np.sum((s_true + e_spat + e_interf) ** 2)), float(np.sum(e_artif**2))
        )
    return sdr, isr, sir, sar


def _solve_cholesky_batched(Gs: np.ndarray, Bs: np.ndarray, device=None):
    """Batched SPD solves in float32 on ``device`` (default: the GPU,
    which raises without one): Gs (W, N, N), Bs (W, N, M) → (W, N, M)
    float64 on the host.  The N = J*C*flen = 4096 factorizations are the
    evaluator's hot spot (museval grinds them one by one on the CPU).

    ``torch.linalg.cholesky`` raises on a Gram that is not positive
    definite, where the JAX package's ``jnp.linalg.cholesky`` returns NaNs;
    ``cholesky_ex`` reports such a system in ``info`` instead, and its
    solution is set to NaN here, so the caller re-solves that window in
    float64 on the host as the JAX evaluator does."""
    import torch

    from umx_tpu_torch.engine.separator import resolve_device

    dev = resolve_device(device)
    G = torch.as_tensor(np.asarray(Gs, np.float32), device=dev)
    B = torch.as_tensor(np.asarray(Bs, np.float32), device=dev)
    L, info = torch.linalg.cholesky_ex(G)
    y = torch.linalg.solve_triangular(L, B, upper=False)
    x = torch.linalg.solve_triangular(L.mT, y, upper=True)
    x[info > 0] = float("nan")
    return x.double().cpu().numpy()


def bss_eval_window_batch(references, estimates, flen: int = 512, max_windows: int = 8,
                          device=None):
    """bss_eval_images for a BATCH of windows with the linear solves
    executed as batched float32 calls on ``device`` (default: the GPU).

    references, estimates: (W, J, C, n).  Returns (SDR, ISR, SIR, SAR)
    arrays of shape (W, J).

    Windows are processed in groups of ``max_windows``: at the default
    J=4, C=2, flen=512 one window's Gram is a (4096, 4096) matrix
    (~67 MB f32), so a full track batched at once would exhaust both
    host RAM and the card's memory: one group is 8 x 4096^2 float32
    (537 MB) on the device and 1.07 GB of float64 Grams on the host.
    A window whose Gram the float32 factorization rejects gets NaN
    metrics (see :func:`_solve_cholesky_batched`)."""
    W, J, C, n = references.shape
    if W > max_windows:
        parts = [
            bss_eval_window_batch(
                references[s : s + max_windows],
                estimates[s : s + max_windows],
                flen,
                max_windows,
                device,
            )
            for s in range(0, W, max_windows)
        ]
        return tuple(np.concatenate([p[m] for p in parts]) for m in range(4))
    K = J * C * flen

    Gs = np.empty((W, K, K), np.float64)
    # per-window, per-estimate right-hand sides: all sources' cross terms
    # (the per-source sub-problem reuses rows of the same RHS)
    d_all = np.empty((W, K, J * C), np.float64)
    for w in range(W):
        refs = references[w].reshape(J * C, n)
        G = _correlations(refs, flen)
        G[np.diag_indices_from(G)] += 1e-9 * max(1.0, np.trace(G) / K)
        Gs[w] = G
        for j in range(J):
            d_all[w, :, j * C : (j + 1) * C] = _cross_terms(refs, estimates[w, j], flen)

    h_all = _solve_cholesky_batched(Gs, d_all, device)  # (W, K, J*C)

    # per-source sub-Gram solves, batched as (W*J)
    sub = C * flen
    Gsub = np.empty((W * J, sub, sub), np.float64)
    dsub = np.empty((W * J, sub, C), np.float64)
    for w in range(W):
        for j in range(J):
            sl = slice(j * sub, (j + 1) * sub)
            Gsub[w * J + j] = Gs[w][sl, sl]
            dsub[w * J + j] = d_all[w, sl, j * C : (j + 1) * C]
    h_sub = _solve_cholesky_batched(Gsub, dsub, device)

    sdr = np.empty((W, J))
    isr = np.empty((W, J))
    sir = np.empty((W, J))
    sar = np.empty((W, J))
    for w in range(W):
        refs_all = references[w].reshape(J * C, n)
        for j in range(J):
            e = estimates[w, j]
            p_all = _project(refs_all, h_all[w, :, j * C : (j + 1) * C], flen, n)
            p_j = _project(references[w, j], h_sub[w * J + j], flen, n)
            s_true = references[w, j]
            e_spat = p_j - s_true
            e_interf = p_all - p_j
            e_artif = e - p_all
            s2 = float(np.sum(s_true**2))
            sdr[w, j] = _db(s2, float(np.sum((e_spat + e_interf + e_artif) ** 2)))
            isr[w, j] = _db(s2, float(np.sum(e_spat**2)))
            sir[w, j] = _db(
                float(np.sum((s_true + e_spat) ** 2)), float(np.sum(e_interf**2))
            )
            sar[w, j] = _db(
                float(np.sum((s_true + e_spat + e_interf) ** 2)),
                float(np.sum(e_artif**2)),
            )
    return sdr, isr, sir, sar


def _global_decomposition(references: np.ndarray, estimates: np.ndarray, flen: int):
    """Full-signal least-squares decomposition (the museval v4 filter
    convention: one filter fit per source over the whole track).

    references, estimates: (J, C, T).  Returns (e_spat, e_interf,
    e_artif), each (J, C, T), such that
    estimate = reference + e_spat + e_interf + e_artif.
    """
    J, C, T = references.shape
    refs_all = references.reshape(J * C, T).astype(np.float64)
    G = _correlations(refs_all, flen)
    G[np.diag_indices_from(G)] += 1e-9 * max(1.0, np.trace(G) / G.shape[0])
    cho_all = cho_factor(G, check_finite=False)

    e_spat = np.empty_like(references, dtype=np.float64)
    e_interf = np.empty_like(e_spat)
    e_artif = np.empty_like(e_spat)
    for j in range(J):
        e = estimates[j].astype(np.float64)
        d_all = _cross_terms(refs_all, e, flen)
        h_all = cho_solve(cho_all, d_all, check_finite=False)
        p_all = _project(refs_all, h_all, flen, T)

        sl = slice(j * C * flen, (j + 1) * C * flen)
        Gj = G[sl, sl].copy()
        h_j = cho_solve(cho_factor(Gj, check_finite=False), d_all[sl], check_finite=False)
        p_j = _project(refs_all[j * C : (j + 1) * C], h_j, flen, T)

        e_spat[j] = p_j - references[j]
        e_interf[j] = p_all - p_j
        e_artif[j] = e - p_all
    return e_spat, e_interf, e_artif


def _window_spans(T: int, window: int, hop: int) -> list[tuple[int, int]]:
    """museval window layout: full windows only (trailing partial
    dropped); a too-short track is one whole-signal frame."""
    if T < window:
        return [(0, T)] if T > 0 else []
    n_win = int(np.floor((T - window + hop) / hop))
    return [(i * hop, i * hop + window) for i in range(n_win)]


def _framewise_from_global(
    references: np.ndarray, estimates: np.ndarray, window: int, hop: int, flen: int
):
    """museval v4 mode: global filters, per-window energy ratios."""
    J, C, T = references.shape
    e_spat, e_interf, e_artif = _global_decomposition(references, estimates, flen)
    spans = _window_spans(T, window, hop)
    n = len(spans)
    sdr = np.full((J, n), np.nan)
    isr = np.full((J, n), np.nan)
    sir = np.full((J, n), np.nan)
    sar = np.full((J, n), np.nan)
    refs = references.astype(np.float64)
    for i, (a, b) in enumerate(spans):
        s = refs[:, :, a:b]
        sp = e_spat[:, :, a:b]
        it = e_interf[:, :, a:b]
        ar = e_artif[:, :, a:b]
        s2 = np.sum(s**2, axis=(1, 2))
        silent = s2 < 1e-12
        tot = np.sum((sp + it + ar) ** 2, axis=(1, 2))
        eps = 1e-12
        sdr[:, i] = 10.0 * np.log10((s2 + eps) / (tot + eps))
        isr[:, i] = 10.0 * np.log10((s2 + eps) / (np.sum(sp**2, axis=(1, 2)) + eps))
        sir[:, i] = 10.0 * np.log10(
            (np.sum((s + sp) ** 2, axis=(1, 2)) + eps)
            / (np.sum(it**2, axis=(1, 2)) + eps)
        )
        sar[:, i] = 10.0 * np.log10(
            (np.sum((s + sp + it) ** 2, axis=(1, 2)) + eps)
            / (np.sum(ar**2, axis=(1, 2)) + eps)
        )
        for arr in (sdr, isr, sir, sar):
            arr[silent, i] = np.nan
    all_frames = np.stack([sdr, isr, sir, sar])
    med = np.nanmedian(all_frames, axis=-1)
    return {
        "SDR": sdr,
        "ISR": isr,
        "SIR": sir,
        "SAR": sar,
        "median_SDR": med[0],
        "median_ISR": med[1],
        "median_SIR": med[2],
        "median_SAR": med[3],
    }


def bss_eval_images_framewise(
    references: np.ndarray,
    estimates: np.ndarray,
    window: int = 44100,
    hop: int = 44100,
    flen: int = 512,
    accelerator: str = "auto",
    mode: str = "v4",
    device=None,
):
    """Framewise bss_eval (museval conventions: 1 s windows, trailing
    partial dropped, nanmedian aggregation, silent source-frames NaN).

    references, estimates: (J, C, T).  Returns dict with per-frame
    arrays (J, n_frames), per-source medians (J,) and
    ``float64_resolves``, the number of windows whose float32 solve was
    not finite and that were re-solved in float64 on the host.

    ``mode="v4"`` (museval default) fits the distortion filters globally
    over the track and computes per-window energy ratios (host code, no
    device); ``mode="v3"`` re-fits the filters inside each window
    (museval's framewise_filters).

    ``accelerator`` (v3 mode only): "torch" batches the full windows'
    linear solves in float32 on ``device`` (default: the GPU, which raises
    without one; ~0.01 dB-level differences vs the float64 host path);
    "auto" is "torch", as every entry point of the port runs on the card
    unless the host is asked for; "numpy" solves window by window in
    float64 on the host.
    """
    J, C, T = references.shape
    if estimates.shape != references.shape:
        raise ValueError(f"estimates {estimates.shape} != references {references.shape}")
    if accelerator not in ("auto", "torch", "numpy"):
        raise ValueError(f"accelerator must be auto, torch or numpy, got {accelerator!r}")

    if mode == "v4":
        res = _framewise_from_global(references, estimates, window, hop, flen)
        res["float64_resolves"] = 0
        return res
    if mode != "v3":
        raise ValueError(f"mode must be v4 or v3, got {mode!r}")

    if accelerator != "numpy":
        from umx_tpu_torch.engine.separator import resolve_device

        device = resolve_device(device)

    spans = _window_spans(T, window, hop)

    frames = [None] * len(spans)
    silent = [None] * len(spans)
    batch_idx, batch_ref, batch_est = [], [], []
    for i, (pos, end) in enumerate(spans):
        ref_w = references[..., pos:end]
        est_w = estimates[..., pos:end]
        # museval convention: a silent reference source is NaN for THAT
        # source only; the other sources in the frame still evaluate
        # (the regularized Gram keeps the solve well-posed)
        silent[i] = np.sum(ref_w**2, axis=(1, 2)) < 1e-12
        if silent[i].all():
            frames[i] = np.full((4, J), np.nan)
        elif accelerator != "numpy" and end - pos == window:
            batch_idx.append(i)
            batch_ref.append(ref_w)
            batch_est.append(est_w)
        else:
            frames[i] = np.stack(bss_eval_window(ref_w, est_w, flen))

    n_refallback = 0
    if batch_idx:
        res = bss_eval_window_batch(
            np.stack(batch_ref), np.stack(batch_est), flen, device=device
        )  # 4 x (W, J)
        for k, i in enumerate(batch_idx):
            frames[i] = np.stack([res[0][k], res[1][k], res[2][k], res[3][k]])
            # a float32 Cholesky fails on near-singular Grams
            # (quiet-but-not-silent frames); those NaNs must not be
            # silently absorbed by nanmedian as if the frame were silent.
            # Re-solve such windows on the float64 host path.
            bad = ~np.isfinite(frames[i]) & ~silent[i][None, :]
            if bad.any():
                n_refallback += 1
                frames[i] = np.stack(
                    bss_eval_window(batch_ref[k], batch_est[k], flen)
                )
        if n_refallback:
            from umx_tpu_torch.utils import logging as _log

            _log.info(
                f"bss_eval: {n_refallback}/{len(batch_idx)} windows fell back "
                "to float64 (non-finite float32 solve)"
            )

    for i in range(len(spans)):
        frames[i] = np.where(silent[i][None, :], np.nan, frames[i])

    all_frames = np.stack(frames, axis=-1)  # (4, J, n_frames)
    med = np.nanmedian(all_frames, axis=-1)
    return {
        "SDR": all_frames[0],
        "ISR": all_frames[1],
        "SIR": all_frames[2],
        "SAR": all_frames[3],
        "median_SDR": med[0],
        "median_ISR": med[1],
        "median_SIR": med[2],
        "median_SAR": med[3],
        "float64_resolves": n_refallback,
    }
