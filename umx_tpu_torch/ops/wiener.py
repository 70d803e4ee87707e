"""Multichannel Wiener-EM post-filter: the plain einsum reference and the
dispatch onto the fused two-pass kernels.

Algorithm (a port of ``openunmix.filtering.wiener``): initial estimates
y_j = target magnitude × mix phase; scale down by
``max(1, max|x| / scale_factor)``; per EM iteration the source PSD
v_j = mean_c |y_j|², spatial covariance R_j = Σ_t y y* / (eps + Σ_t v_j),
mix covariance Cxx = sqrt(eps)·I + Σ_j v_j R_j, analytic 2×2 inverse, new
estimate y_j = v_j R_j Cxx⁻¹ x; scale back up.
"""

from __future__ import annotations

import torch

from umx_tpu_torch.config import WienerConfig, storage_dtype
from umx_tpu_torch.ops.stft import masks_to_planes, polar_to_complex
from umx_tpu_torch.ops.wiener_cuda import wiener_planes_from_mags, wiener_planes_from_masks


def wiener_filter(mix_stft, target_mags, cfg: WienerConfig):
    """EM-refined complex source estimates (einsum formulation).

    mix_stft: complex (2, T, F); target_mags: float (S, 2, T, F).
    Returns complex (S, 2, T, F)."""
    x = mix_stft
    y = polar_to_complex(target_mags, mix_stft[None])

    max_abs = torch.clamp(x.abs().max() / cfg.scale_factor, min=1.0)
    x = x / max_abs
    y = y / max_abs

    for _ in range(cfg.iterations):
        if cfg.psd == "umxcpp":  # the reference's (re+im)^2 quirk
            s = y.real + y.imag
            v = (s * s).mean(dim=1)
        else:
            v = (y.real * y.real + y.imag * y.imag).mean(dim=1)  # (S, T, F)

        weight = cfg.eps + v.sum(dim=1)  # (S, F)
        R = torch.einsum("sctf,sdtf->scdf", y, y.conj()) / weight[:, None, None, :]

        reg = cfg.eps**0.5
        Cxx = torch.einsum("stf,scdf->cdtf", v.to(R.dtype), R)
        Cxx[0, 0] += reg
        Cxx[1, 1] += reg

        a, b, c, d = Cxx[0, 0], Cxx[0, 1], Cxx[1, 0], Cxx[1, 1]
        det = a * d - b * c
        inv_det = det.conj() / (det.real * det.real + det.imag * det.imag)
        inv = torch.stack(
            [torch.stack([d * inv_det, -b * inv_det]), torch.stack([-c * inv_det, a * inv_det])]
        )  # (K, D, T, F)
        # z = Cxx^-1 x is source-independent: y_j(c) = v_j Σ_k R_j(c,k) z(k)
        z = torch.einsum("kdtf,dtf->ktf", inv, x)
        y = torch.einsum("sckf,ktf->sctf", R, z) * v[:, None]

    return y * max_abs


def _fused_eligible(cfg: WienerConfig) -> bool:
    # the fused passes implement the correct PSD only, and zero iterations
    # is the raw first estimate: both run the einsum reference by semantics
    return cfg.impl != "einsum" and cfg.psd == "correct" and cfg.iterations >= 1


def wiener_out_dtype(cfg: WienerConfig, device) -> torch.dtype:
    """The dtype of the planes the Wiener entries give on ``device``:
    ``out_dtype`` resolved for the device on the fused path (the last apply
    pass writes it), float32 on the einsum path."""
    return storage_dtype(cfg.out_dtype, device) if _fused_eligible(cfg) else torch.float32


def wiener_filter_planes(xre, xim, target_mags, cfg: WienerConfig):
    """Planes-form Wiener filter: mix planes (2, T, F) and target
    magnitudes (S, 2, T, F) → (yre, yim), each (S, 2, T, F).

    ``psd="correct"`` with ``iterations >= 1`` runs the fused reduce/apply
    passes in mode "mags" (kernels for CUDA tensors) unless ``impl`` is
    "einsum", and its last apply writes the planes in ``out_dtype``
    (:func:`wiener_out_dtype`); ``psd="umxcpp"``, ``iterations=0`` or
    ``impl="einsum"`` runs the einsum reference on any device, in
    float32."""
    if _fused_eligible(cfg):
        return wiener_planes_from_mags(xre.float().contiguous(), xim.float().contiguous(),
                                       target_mags.float().contiguous(), cfg,
                                       wiener_out_dtype(cfg, xre.device))
    y = wiener_filter(torch.complex(xre, xim), target_mags, cfg)
    return y.real.contiguous(), y.imag.contiguous()


def wiener_filter_masks(xre, xim, masks, n_bins: int, cfg: WienerConfig):
    """Wiener filter fed the network-layout masks (S, T, 2*n_bins), float32
    or bfloat16.

    ``psd="correct"`` with ``iterations >= 1`` runs the fused reduce/apply
    passes (kernels for CUDA tensors), which read the masks in their
    dtype, unless ``impl`` is "einsum", and its last apply writes the
    planes in ``out_dtype`` (:func:`wiener_out_dtype`); ``psd="umxcpp"`` or
    ``iterations=0`` runs the einsum reference on any device, by
    semantics — the kernels implement the correct PSD only, and zero
    iterations is the raw mask estimate — as ``impl="einsum"`` does by
    choice, on the masks upcast, in float32.  Returns (yre, yim), each
    (S, 2, T, F)."""
    if _fused_eligible(cfg):
        return wiener_planes_from_masks(xre, xim, masks.contiguous(), cfg,
                                        wiener_out_dtype(cfg, xre.device))
    m = masks_to_planes(masks.float(), n_bins)
    mag = torch.sqrt(xre * xre + xim * xim)
    y = wiener_filter(torch.complex(xre, xim), m * mag[None], cfg)
    return y.real.contiguous(), y.imag.contiguous()
