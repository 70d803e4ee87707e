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
(S, T, 2F) with x (first iteration: y = mask * x), ``"mags"`` reads the
target magnitudes (S, 2, T, F) with x (first iteration: y = mag * unit(x),
unit(0) = 1 + 0i), ``"y"`` reads the previous iteration's y planes,
already divided by max_abs.  They replace ``umx_tpu/ops/wiener_pallas.py``
rows: reduce ← ``_make_reduce_kernel_masks`` and ``_make_reduce_kernel``
(``from_mags`` False: mode y, True: mode mags); apply ←
``_make_apply_kernel_masks`` and ``_make_apply_kernel`` (the same two
modes) with ``_apply_common``.

The passes take the TPU kernels' storage dtypes: the masks of mode
"masks" may be bfloat16 (``EngineConfig.mask_dtype``), read as they are
and upcast in registers, and the apply pass writes its planes in
``out_dtype`` (float32 or bfloat16, rounded to nearest even after the
float32 arithmetic; ``WienerConfig.out_dtype`` for the last EM iteration,
float32 for the others).  The magnitudes of mode "mags", the y planes of
mode "y", x, racc and 1/max_abs are float32.  On a CUDA tensor a wrapper
launches the kernel of the given dtypes or raises naming the dtype; the
plain versions take the same dtypes (upcast, float32 arithmetic, the
output rounded).  Each wrapper counts its launches in all and by form
(:func:`form`: the input mode and the storage dtypes).
"""

from __future__ import annotations

import torch

from umx_tpu_torch import _build

N_SOURCES = 4  # the kernels are specialized to 4 sources and stereo
_MODES = {"masks": 0, "y": 1, "mags": 2}
_MAX_GRID_Y = 65535  # the apply pass's grid: one block row per time row
# the element types the kernels store: the masks of mode "masks" and the
# apply pass's y planes
STORAGE = (torch.float32, torch.bfloat16)


def form(mode: str, in_dtype=torch.float32, out_dtype=None) -> str:
    """A pass's form: its mode, "_bf16" for bfloat16 masks, and (apply
    only, ``out_dtype`` given) "_out_bf16" for bfloat16 planes, e.g.
    "masks_bf16_out_bf16"."""
    name = mode + ("_bf16" if in_dtype == torch.bfloat16 else "")
    return name + ("_out_bf16" if out_dtype == torch.bfloat16 else "")


REDUCE_FORMS = ("masks", "masks_bf16", "y", "mags")
APPLY_FORMS = ("masks", "masks_out_bf16", "masks_bf16", "masks_bf16_out_bf16",
               "y", "y_out_bf16", "mags", "mags_out_bf16")


def inv_max_abs(xre, xim, scale_factor: float):
    """1 / max(1, max|x| / scale_factor) as a (1,) f32 tensor on x's
    device — computed with tensor ops, so no host sync."""
    max_abs = torch.clamp(torch.sqrt(xre * xre + xim * xim).max() / scale_factor, min=1.0)
    return (1.0 / max_abs).reshape(1).float()


def _planes(mode, a_re, a_im):
    """Per-channel views (x0re, x0im, x1re, x1im) of the x planes (modes
    'masks' and 'mags'), or per-source (yre0, yim0, yre1, yim1) of mode
    'y' planes."""
    if mode == "y":
        return a_re[:, 0], a_im[:, 0], a_re[:, 1], a_im[:, 1]
    return a_re[0], a_im[0], a_re[1], a_im[1]


def unit_phasors(re, im):
    """x / |x| as (re, im) planes, with |x| = 0 → 1 + 0i and rsqrt
    elsewhere (``umx_tpu.ops.stft.unit_phasors``)."""
    a2 = re * re + im * im
    nz = a2 > 0.0
    rs = torch.rsqrt(torch.where(nz, a2, torch.ones_like(a2)))
    one, zero = torch.ones_like(re), torch.zeros_like(im)
    return torch.where(nz, re * rs, one), torch.where(nz, im * rs, zero)


def _y_stats(yr0, yi0, yr1, yi1):
    """Time sums of R00, R11, Re R01, Im R01 of estimates (S, T, F)."""
    return [
        (yr0 * yr0 + yi0 * yi0).sum(1),
        (yr1 * yr1 + yi1 * yi1).sum(1),
        (yr0 * yr1 + yi0 * yi1).sum(1),
        (yi0 * yr1 - yr0 * yi1).sum(1),
    ]


def wiener_reduce_plain(mode: str, a_re, a_im, masks, inv_ma):
    """Plain version of :func:`wiener_reduce` (same operation order as the
    TPU kernels' per-block sums); bfloat16 masks are upcast exactly."""
    if mode == "masks":
        masks = masks.float()
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
    elif mode == "mags":
        x0r, x0i, x1r, x1i = _planes(mode, a_re, a_im)
        u0r, u0i = unit_phasors(x0r, x0i)
        u1r, u1i = unit_phasors(x1r, x1i)
        m0 = masks[:, 0] * inv_ma[0]  # (S, T, F); `masks` holds the magnitudes
        m1 = masks[:, 1] * inv_ma[0]
        rows = _y_stats(m0 * u0r, m0 * u0i, m1 * u1r, m1 * u1i)
    else:
        rows = _y_stats(*_planes(mode, a_re, a_im))  # (S, T, F) each
    # (4, S, F) -> (S, 4, F) -> (4S, F): row 4s+k is statistic k of source s
    return torch.stack(rows).transpose(0, 1).reshape(-1, rows[0].shape[-1])


def wiener_apply_plain(mode: str, xre, xim, m_or_yre, y_im, racc, inv_ma, eps: float,
                       out_dtype=torch.float32):
    """Plain version of :func:`wiener_apply` (operation order of the TPU
    kernels' ``_apply_common``): bfloat16 masks upcast exactly, float32
    arithmetic, the planes rounded to ``out_dtype``."""
    reg = float(eps) ** 0.5
    inv = inv_ma[0]
    if mode == "masks":
        m_or_yre = m_or_yre.float()
        F = xre.shape[-1]
        sq = inv * inv
        ax0 = xre[0] * xre[0] + xim[0] * xim[0]
        ax1 = xre[1] * xre[1] + xim[1] * xim[1]
        m0, m1 = m_or_yre[..., :F], m_or_yre[..., F:]
        v = 0.5 * sq * (m0 * m0 * ax0 + m1 * m1 * ax1)  # (S, T, F)
    elif mode == "mags":
        m0, m1 = m_or_yre[:, 0], m_or_yre[:, 1]
        v = 0.5 * (inv * inv) * (m0 * m0 + m1 * m1)
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
    return yre.to(out_dtype), yim.to(out_dtype)


def _check(mode, xre, xim, m_or_yre, y_im, inv_ma, racc=None, out_dtype=torch.float32):
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
        if m_or_yre.dtype not in STORAGE:
            raise TypeError(f"wiener masks must be float32 or bfloat16, got {m_or_yre.dtype}")
        tensors = [xre, xim, inv_ma]
    elif mode == "mags":
        if tuple(m_or_yre.shape) != (S, 2, T, F):
            raise ValueError(f"mags must be ({S}, 2, {T}, {F}), got {tuple(m_or_yre.shape)}")
        tensors = [xre, xim, m_or_yre, inv_ma]
    else:
        for y in (m_or_yre, y_im):
            if tuple(y.shape) != (S, 2, T, F):
                raise ValueError(f"y planes must be ({S}, 2, {T}, {F}), got {tuple(y.shape)}")
        tensors = [xre, xim, m_or_yre, y_im, inv_ma]
    if out_dtype not in STORAGE:
        raise TypeError(f"wiener out_dtype must be float32 or bfloat16, got {out_dtype}")
    if tuple(inv_ma.shape) != (1,):
        raise ValueError(f"inv_ma must have shape (1,), got {tuple(inv_ma.shape)}")
    if racc is not None:
        if tuple(racc.shape) != (4 * S, F):
            raise ValueError(f"racc must be ({4 * S}, {F}), got {tuple(racc.shape)}")
        tensors.append(racc)
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"wiener planes must be float32, got {t.dtype}")
    for t in (*tensors, m_or_yre):
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
    masks (float32 or bfloat16), y_im unused.  mode "mags": m_or_yre the
    (S, 2, T, F) target magnitudes, y_im unused.  mode "y": m_or_yre/y_im
    the previous y planes (S, 2, T, F) divided by max_abs.  CUDA tensors launch the kernel once
    (or raise); CPU tensors run :func:`wiener_reduce_plain`."""
    T, F = _check(mode, xre, xim, m_or_yre, y_im, inv_ma)
    a_re, a_im = (m_or_yre, y_im) if mode == "y" else (xre, xim)
    masks = None if mode == "y" else m_or_yre
    if xre.device.type == "cpu":
        return wiener_reduce_plain(mode, a_re, a_im, masks, inv_ma)

    racc = torch.empty((4 * N_SOURCES, F), dtype=torch.float32, device=xre.device)
    mask_bf16 = mode == "masks" and masks.dtype == torch.bfloat16
    err = _build.library().umx_wiener_reduce(
        _MODES[mode], int(mask_bf16), a_re.data_ptr(), a_im.data_ptr(),
        masks.data_ptr() if masks is not None else None,
        inv_ma.data_ptr(), racc.data_ptr(), T, F,
        torch.cuda.current_stream(xre.device).cuda_stream,
    )
    _build.check(err, "umx_wiener_reduce")
    wiener_reduce.launches += 1
    wiener_reduce.form_launches[form(mode, m_or_yre.dtype)] += 1
    return racc


wiener_reduce.launches = 0
wiener_reduce.form_launches = dict.fromkeys(REDUCE_FORMS, 0)  # the same launches, by form


def wiener_apply(mode: str, xre, xim, m_or_yre, y_im, racc, inv_ma, eps: float,
                 out_dtype=torch.float32):
    """New estimates (yre, yim), each (S, 2, T, F) in ``out_dtype``
    (float32 or bfloat16), from the statistics ``racc`` of
    :func:`wiener_reduce` (same modes and mask dtypes).  CUDA tensors
    launch the kernel (or raise); CPU tensors run
    :func:`wiener_apply_plain`."""
    T, F = _check(mode, xre, xim, m_or_yre, y_im, inv_ma, racc, out_dtype)
    if xre.device.type == "cpu":
        return wiener_apply_plain(mode, xre, xim, m_or_yre, y_im, racc, inv_ma, eps, out_dtype)

    lib = _build.library()
    if T > _MAX_GRID_Y:
        raise ValueError(f"T={T} exceeds the apply grid")
    shape = (N_SOURCES, 2, T, F)
    yre = torch.empty(shape, dtype=out_dtype, device=xre.device)
    yim = torch.empty(shape, dtype=out_dtype, device=xre.device)
    mask_bf16 = mode == "masks" and m_or_yre.dtype == torch.bfloat16
    err = lib.umx_wiener_apply(
        _MODES[mode], int(mask_bf16), int(out_dtype == torch.bfloat16), xre.data_ptr(),
        xim.data_ptr(), m_or_yre.data_ptr(),
        y_im.data_ptr() if y_im is not None else None,
        racc.data_ptr(), inv_ma.data_ptr(), yre.data_ptr(), yim.data_ptr(),
        T, F, float(eps), float(eps) ** 0.5,
        torch.cuda.current_stream(xre.device).cuda_stream,
    )
    _build.check(err, "umx_wiener_apply")
    wiener_apply.launches += 1
    wiener_apply.form_launches[form(mode, m_or_yre.dtype, out_dtype)] += 1
    return yre, yim


wiener_apply.launches = 0
wiener_apply.form_launches = dict.fromkeys(APPLY_FORMS, 0)


def _wiener_planes(mode, xre, xim, first, cfg, out_dtype):
    """``cfg.iterations`` (≥ 1) reduce/apply pairs; the first pair reads
    ``first`` in ``mode`` ("masks" or "mags"), later ones the previous y
    (float32); the last apply writes ``out_dtype``."""
    inv_ma = inv_max_abs(xre, xim, cfg.scale_factor)
    racc = wiener_reduce(mode, xre, xim, first, None, inv_ma)
    last = cfg.iterations == 1
    yre, yim = wiener_apply(mode, xre, xim, first, None, racc, inv_ma, cfg.eps,
                            out_dtype if last else torch.float32)
    for it in range(cfg.iterations - 1):
        # later iterations read the previous y in the working frame
        # (divided by max_abs); apply emits y * max_abs
        yre_s = yre * inv_ma
        yim_s = yim * inv_ma
        racc = wiener_reduce("y", xre, xim, yre_s, yim_s, inv_ma)
        last = it == cfg.iterations - 2
        yre, yim = wiener_apply("y", xre, xim, yre_s, yim_s, racc, inv_ma, cfg.eps,
                                out_dtype if last else torch.float32)
    return yre, yim


def wiener_planes_from_masks(xre, xim, masks, cfg, out_dtype=torch.float32):
    """EM-refined estimates (yre, yim), each (S, 2, T, F) in ``out_dtype``,
    straight from the network-layout masks (S, T, 2F), float32 or
    bfloat16: ``cfg.iterations`` (≥ 1) reduce/apply pairs, psd "correct"
    semantics."""
    return _wiener_planes("masks", xre, xim, masks, cfg, out_dtype)


def wiener_planes_from_mags(xre, xim, target_mags, cfg, out_dtype=torch.float32):
    """EM-refined estimates (yre, yim), each (S, 2, T, F) in ``out_dtype``,
    from the target magnitudes (S, 2, T, F) and the mix planes (2, T, F):
    the first estimate is mag × the mix's unit phasor
    (``wiener_planes_pallas``)."""
    return _wiener_planes("mags", xre, xim, target_mags, cfg, out_dtype)
