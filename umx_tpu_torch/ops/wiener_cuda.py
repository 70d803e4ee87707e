"""The two fused Wiener-EM passes (kernels in ``csrc/wiener.cu``) and
their plain PyTorch versions.

One EM iteration is two passes over (T, F) planes:

* :func:`wiener_reduce` — per source s and bin f, the time sums of the
  2x2 Hermitian covariance of the working-frame estimates
  (R00, R11, Re R01, Im R01) → racc (4S, F);
* :func:`wiener_apply` — per (t, f), the source PSDs, the mix covariance
  and its analytic inverse, and the new estimates y (S, 2, T, F), scaled
  back by max_abs.

Each takes an input mode: ``"masks"`` reads the network-layout masks
(S, T, 2F) with x (first iteration: y = mask * x), ``"y"`` reads the
previous iteration's y planes, already divided by max_abs.  They replace
``umx_tpu/ops/wiener_pallas.py`` rows: reduce ← ``_make_reduce_kernel_masks``
and ``_make_reduce_kernel(from_mags=False)``; apply ←
``_make_apply_kernel_masks`` and ``_make_apply_kernel(from_mags=False)``
with ``_apply_common``.
"""

from __future__ import annotations

import torch

from umx_tpu_torch import _build

N_SOURCES = 4  # the kernels are specialized to 4 sources and stereo
_MODES = {"masks": 0, "y": 1}
_T_CHUNK = 64  # time rows per reduce block (pass 1)
_MAX_GRID_Y = 65535


def inv_max_abs(xre, xim, scale_factor: float):
    """1 / max(1, max|x| / scale_factor) as a (1,) f32 tensor on x's
    device — computed with tensor ops, so no host sync."""
    max_abs = torch.clamp(torch.sqrt(xre * xre + xim * xim).max() / scale_factor, min=1.0)
    return (1.0 / max_abs).reshape(1).float()


def _planes(mode, a_re, a_im):
    """Per-channel views (x0re, x0im, x1re, x1im) of mode 'masks' x
    planes, or per-source (yre0, yim0, yre1, yim1) of mode 'y' planes."""
    if mode == "masks":
        return a_re[0], a_im[0], a_re[1], a_im[1]
    return a_re[:, 0], a_im[:, 0], a_re[:, 1], a_im[:, 1]


def wiener_reduce_plain(mode: str, a_re, a_im, masks, inv_ma):
    """Plain version of :func:`wiener_reduce` (same operation order as the
    TPU kernels' per-block sums)."""
    if mode == "masks":
        F = a_re.shape[-1]
        x0r, x0i, x1r, x1i = _planes(mode, a_re, a_im)
        ax0 = x0r * x0r + x0i * x0i
        ax1 = x1r * x1r + x1i * x1i
        cr = x0r * x1r + x0i * x1i
        ci = x0i * x1r - x0r * x1i
        m0, m1 = masks[..., :F], masks[..., F:]  # (S, T, F)
        m01 = m0 * m1
        sq = inv_ma[0] * inv_ma[0]
        rows = [
            (m0 * m0 * ax0).sum(1) * sq,
            (m1 * m1 * ax1).sum(1) * sq,
            (m01 * cr).sum(1) * sq,
            (m01 * ci).sum(1) * sq,
        ]
    else:
        yr0, yi0, yr1, yi1 = _planes(mode, a_re, a_im)  # (S, T, F)
        rows = [
            (yr0 * yr0 + yi0 * yi0).sum(1),
            (yr1 * yr1 + yi1 * yi1).sum(1),
            (yr0 * yr1 + yi0 * yi1).sum(1),
            (yi0 * yr1 - yr0 * yi1).sum(1),
        ]
    # (4, S, F) -> (S, 4, F) -> (4S, F): row 4s+k is statistic k of source s
    return torch.stack(rows).transpose(0, 1).reshape(-1, rows[0].shape[-1])


def wiener_apply_plain(mode: str, xre, xim, m_or_yre, y_im, racc, inv_ma, eps: float):
    """Plain version of :func:`wiener_apply` (operation order of the TPU
    kernels' ``_apply_common``)."""
    reg = float(eps) ** 0.5
    inv = inv_ma[0]
    if mode == "masks":
        F = xre.shape[-1]
        sq = inv * inv
        ax0 = xre[0] * xre[0] + xim[0] * xim[0]
        ax1 = xre[1] * xre[1] + xim[1] * xim[1]
        m0, m1 = m_or_yre[..., :F], m_or_yre[..., F:]
        v = 0.5 * sq * (m0 * m0 * ax0 + m1 * m1 * ax1)  # (S, T, F)
    else:
        a, b = m_or_yre[:, 0], y_im[:, 0]
        c, d = m_or_yre[:, 1], y_im[:, 1]
        v = 0.5 * (a * a + b * b + c * c + d * d)
    x0re, x0im = xre[0] * inv, xim[0] * inv
    x1re, x1im = xre[1] * inv, xim[1] * inv

    S = v.shape[0]
    r = racc.view(S, 4, -1)  # (S, 4, F)
    w = eps + 0.5 * (r[:, 0] + r[:, 1])
    inv_w = 1.0 / w
    r00 = (r[:, 0] * inv_w)[:, None]  # (S, 1, F), broadcast over time
    r11 = (r[:, 1] * inv_w)[:, None]
    r01re = (r[:, 2] * inv_w)[:, None]
    r01im = (r[:, 3] * inv_w)[:, None]
    c00 = torch.full_like(x0re, reg)
    c11 = torch.full_like(x0re, reg)
    c01re = torch.zeros_like(x0re)
    c01im = torch.zeros_like(x0re)
    for s in range(S):
        c00 = c00 + v[s] * r00[s]
        c11 = c11 + v[s] * r11[s]
        c01re = c01re + v[s] * r01re[s]
        c01im = c01im + v[s] * r01im[s]

    det = c00 * c11 - (c01re * c01re + c01im * c01im)
    idet = 1.0 / det
    z0re = (c11 * x0re - (c01re * x1re - c01im * x1im)) * idet
    z0im = (c11 * x0im - (c01re * x1im + c01im * x1re)) * idet
    z1re = (c00 * x1re - (c01re * x0re + c01im * x0im)) * idet
    z1im = (c00 * x1im - (c01re * x0im - c01im * x0re)) * idet

    vs = v * (1.0 / inv)
    yre = torch.stack(
        [
            vs * (r00 * z0re + r01re * z1re - r01im * z1im),
            vs * (r01re * z0re + r01im * z0im + r11 * z1re),
        ],
        dim=1,
    )
    yim = torch.stack(
        [
            vs * (r00 * z0im + r01re * z1im + r01im * z1re),
            vs * (r01re * z0im - r01im * z0re + r11 * z1im),
        ],
        dim=1,
    )
    return yre, yim


def _check(mode, xre, xim, m_or_yre, y_im, inv_ma, racc=None):
    """Validate the pass inputs; returns (T, F)."""
    if mode not in _MODES:
        raise ValueError(f"mode must be one of {sorted(_MODES)}, got {mode!r}")
    if xre.dim() != 3 or xre.shape[0] != 2 or tuple(xim.shape) != tuple(xre.shape):
        raise ValueError(f"x planes must both be (2, T, F), got {tuple(xre.shape)}, {tuple(xim.shape)}")
    _, T, F = xre.shape
    S = N_SOURCES
    if mode == "masks":
        if tuple(m_or_yre.shape) != (S, T, 2 * F):
            raise ValueError(f"masks must be ({S}, {T}, {2 * F}), got {tuple(m_or_yre.shape)}")
        tensors = [xre, xim, m_or_yre, inv_ma]
    else:
        for y in (m_or_yre, y_im):
            if tuple(y.shape) != (S, 2, T, F):
                raise ValueError(f"y planes must be ({S}, 2, {T}, {F}), got {tuple(y.shape)}")
        tensors = [xre, xim, m_or_yre, y_im, inv_ma]
    if tuple(inv_ma.shape) != (1,):
        raise ValueError(f"inv_ma must have shape (1,), got {tuple(inv_ma.shape)}")
    if racc is not None:
        if tuple(racc.shape) != (4 * S, F):
            raise ValueError(f"racc must be ({4 * S}, {F}), got {tuple(racc.shape)}")
        tensors.append(racc)
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"wiener planes must be float32, got {t.dtype}")
        if t.device != xre.device:
            raise ValueError(f"inputs on {t.device} and {xre.device}")
        if not t.is_contiguous():
            raise ValueError("wiener inputs must be contiguous")
    if xre.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {xre.device}")
    return T, F


def wiener_reduce(mode: str, xre, xim, m_or_yre, y_im, inv_ma):
    """Covariance statistics racc (4S, F) of one EM iteration.

    mode "masks": xre/xim (2, T, F) mix planes, m_or_yre the (S, T, 2F)
    masks, y_im unused.  mode "y": m_or_yre/y_im the previous y planes
    (S, 2, T, F) divided by max_abs.  CUDA tensors launch the kernel (or
    raise); CPU tensors run :func:`wiener_reduce_plain`."""
    T, F = _check(mode, xre, xim, m_or_yre, y_im, inv_ma)
    a_re, a_im = (xre, xim) if mode == "masks" else (m_or_yre, y_im)
    masks = m_or_yre if mode == "masks" else None
    if xre.device.type == "cpu":
        return wiener_reduce_plain(mode, a_re, a_im, masks, inv_ma)

    lib = _build.library()
    n_chunks = -(-T // _T_CHUNK)
    if n_chunks > _MAX_GRID_Y:
        raise ValueError(f"T={T} exceeds the reduce grid")
    partials = torch.empty((n_chunks, 4 * N_SOURCES, F), dtype=torch.float32, device=xre.device)
    racc = torch.empty((4 * N_SOURCES, F), dtype=torch.float32, device=xre.device)
    err = lib.umx_wiener_reduce(
        _MODES[mode], a_re.data_ptr(), a_im.data_ptr(),
        masks.data_ptr() if masks is not None else None,
        inv_ma.data_ptr(), partials.data_ptr(), racc.data_ptr(),
        T, F, _T_CHUNK, torch.cuda.current_stream(xre.device).cuda_stream,
    )
    _build.check(err, "umx_wiener_reduce")
    wiener_reduce.launches += 1
    return racc


wiener_reduce.launches = 0


def wiener_apply(mode: str, xre, xim, m_or_yre, y_im, racc, inv_ma, eps: float):
    """New estimates (yre, yim), each (S, 2, T, F) f32, from the
    statistics ``racc`` of :func:`wiener_reduce` (same modes).  CUDA
    tensors launch the kernel (or raise); CPU tensors run
    :func:`wiener_apply_plain`."""
    T, F = _check(mode, xre, xim, m_or_yre, y_im, inv_ma, racc)
    if xre.device.type == "cpu":
        return wiener_apply_plain(mode, xre, xim, m_or_yre, y_im, racc, inv_ma, eps)

    lib = _build.library()
    if T > _MAX_GRID_Y:
        raise ValueError(f"T={T} exceeds the apply grid")
    shape = (N_SOURCES, 2, T, F)
    yre = torch.empty(shape, dtype=torch.float32, device=xre.device)
    yim = torch.empty(shape, dtype=torch.float32, device=xre.device)
    err = lib.umx_wiener_apply(
        _MODES[mode], xre.data_ptr(), xim.data_ptr(), m_or_yre.data_ptr(),
        y_im.data_ptr() if y_im is not None else None,
        racc.data_ptr(), inv_ma.data_ptr(), yre.data_ptr(), yim.data_ptr(),
        T, F, float(eps), float(eps) ** 0.5,
        torch.cuda.current_stream(xre.device).cuda_stream,
    )
    _build.check(err, "umx_wiener_apply")
    wiener_apply.launches += 1
    return yre, yim


wiener_apply.launches = 0


def wiener_planes_from_masks(xre, xim, masks, cfg):
    """EM-refined estimates (yre, yim), each (S, 2, T, F), straight from
    the network-layout masks (S, T, 2F): ``cfg.iterations`` (≥ 1)
    reduce/apply pairs, psd "correct" semantics."""
    inv_ma = inv_max_abs(xre, xim, cfg.scale_factor)
    racc = wiener_reduce("masks", xre, xim, masks, None, inv_ma)
    yre, yim = wiener_apply("masks", xre, xim, masks, None, racc, inv_ma, cfg.eps)
    for _ in range(cfg.iterations - 1):
        # later iterations read the previous y in the working frame
        # (divided by max_abs); apply emits y * max_abs
        yre_s = yre * inv_ma
        yim_s = yim * inv_ma
        racc = wiener_reduce("y", xre, xim, yre_s, yim_s, inv_ma)
        yre, yim = wiener_apply("y", xre, xim, yre_s, yim_s, racc, inv_ma, cfg.eps)
    return yre, yim
