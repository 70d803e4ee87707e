"""The Wiener passes fed target magnitudes (mode "mags"): their plain
versions against ``wiener_planes_pallas`` in Pallas interpret mode, with
exact zeros in the mix (the |x| = 0 branch of the unit phasor), and the
public ``wiener_filter_planes`` against the JAX one on every dispatch
arm."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from umx_tpu.config import WienerConfig as JWienerConfig
from umx_tpu.ops import wiener as jwiener
from umx_tpu.ops.wiener_pallas import wiener_planes_pallas
from umx_tpu_torch.config import WienerConfig
from umx_tpu_torch.ops import wiener as twiener
from umx_tpu_torch.ops import wiener_cuda

S, T, F = 4, 19, 2049


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    xre = (30 * rng.standard_normal((2, T, F))).astype(np.float32)
    xim = (30 * rng.standard_normal((2, T, F))).astype(np.float32)
    # bins where the mix is exactly 0 in one or both channels
    xre[0, 3, 5:40] = xim[0, 3, 5:40] = 0.0
    xre[:, 7, 100:130] = xim[:, 7, 100:130] = 0.0
    mags = (40 * rng.random((S, 2, T, F))).astype(np.float32)
    return xre, xim, mags


def _rel(ours, ref):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert ours.shape == ref.shape
    return float(np.max(np.abs(ours - ref)) / np.max(np.abs(ref)))


@pytest.mark.parametrize("iterations", [1, 2])
def test_mags_passes_match_pallas_interpret(data, iterations):
    xre, xim, mags = data
    jre, jim = wiener_planes_pallas(
        jnp.asarray(xre), jnp.asarray(xim), jnp.asarray(mags),
        JWienerConfig(iterations=iterations), time_block=8, interpret=True,
    )
    before = (wiener_cuda.wiener_reduce.launches, wiener_cuda.wiener_apply.launches)
    tre, tim = wiener_cuda.wiener_planes_from_mags(
        *map(torch.from_numpy, (xre, xim, mags)), WienerConfig(iterations=iterations)
    )
    assert (wiener_cuda.wiener_reduce.launches, wiener_cuda.wiener_apply.launches) == before
    assert tre.shape == (S, 2, T, F) and tre.dtype == torch.float32
    # same f32 operation order per element; only the time sums are taken
    # in another order (TPU: per 8-row block) → 1e-5 of max|y|
    assert _rel(tre.numpy(), jre) <= 1e-5
    assert _rel(tim.numpy(), jim) <= 1e-5
    assert np.isfinite(tre.numpy()).all() and np.isfinite(tim.numpy()).all()


def test_mags_reduce_alone_matches_pallas_statistics(data):
    """racc of mode "mags" = the statistics of y = mag * unit(x) / max_abs,
    which mode "y" computes from those planes."""
    xre, xim, mags = map(torch.from_numpy, data)
    inv = wiener_cuda.inv_max_abs(xre, xim, 10.0)
    racc = wiener_cuda.wiener_reduce("mags", xre, xim, mags, None, inv)
    ure, uim = wiener_cuda.unit_phasors(xre, xim)
    assert ure[0, 3, 10] == 1.0 and uim[0, 3, 10] == 0.0  # |x| = 0 -> 1 + 0i
    yre = (mags * inv[0]) * ure[None]
    yim = (mags * inv[0]) * uim[None]
    ref = wiener_cuda.wiener_reduce("y", xre, xim, yre.contiguous(), yim.contiguous(), inv)
    assert racc.shape == (4 * S, F)
    assert torch.equal(racc, ref)


@pytest.mark.parametrize(
    "cfg", [WienerConfig(), WienerConfig(iterations=2), WienerConfig(psd="umxcpp"),
            WienerConfig(iterations=0)]
)
def test_filter_planes_matches_jax_dispatch(data, cfg):
    """psd "correct" with iterations >= 1 runs the fused passes, the rest
    the einsum path, on both sides."""
    xre, xim, mags = data
    jcfg = JWienerConfig(
        iterations=cfg.iterations, psd=cfg.psd,
        impl="pallas_interpret" if cfg.psd == "correct" else "einsum",
    )
    jre, jim = jwiener.wiener_filter_planes(
        jnp.asarray(xre), jnp.asarray(xim), jnp.asarray(mags), jcfg)
    tre, tim = twiener.wiener_filter_planes(*map(torch.from_numpy, (xre, xim, mags)), cfg)
    assert tre.shape == (S, 2, T, F) and tre.dtype == torch.float32
    assert _rel(tre.numpy(), jre) <= 1e-5
    assert _rel(tim.numpy(), jim) <= 1e-5


def test_planes_and_masks_entries_agree():
    """The same first estimate through both entries: mags = mask * |x|."""
    rng = np.random.default_rng(3)
    xre = torch.from_numpy((30 * rng.standard_normal((2, T, F))).astype(np.float32))
    xim = torch.from_numpy((30 * rng.standard_normal((2, T, F))).astype(np.float32))
    masks = torch.from_numpy(rng.random((S, T, 2 * F)).astype(np.float32))
    mag = torch.sqrt(xre * xre + xim * xim)
    mags = masks.reshape(S, T, 2, F).permute(0, 2, 1, 3) * mag[None]
    a = twiener.wiener_filter_masks(xre, xim, masks, F, WienerConfig())
    b = twiener.wiener_filter_planes(xre, xim, mags, WienerConfig())
    # mask * x against (mask * |x|) * (x * rsqrt(|x|^2)): a few f32 roundings
    assert _rel(b[0].numpy(), a[0].numpy()) <= 1e-5
    assert _rel(b[1].numpy(), a[1].numpy()) <= 1e-5


def test_mags_wrapper_rejects_bad_inputs(data):
    xre, xim, mags = map(torch.from_numpy, data)
    inv = torch.ones(1)
    with pytest.raises(ValueError, match="mags must be"):
        wiener_cuda.wiener_reduce("mags", xre, xim, mags[:, :1], None, inv)
    with pytest.raises(TypeError, match="float32"):
        wiener_cuda.wiener_reduce("mags", xre, xim, mags.double(), None, inv)
    racc = wiener_cuda.wiener_reduce("mags", xre, xim, mags, None, inv)
    with pytest.raises(ValueError, match="mags must be"):
        wiener_cuda.wiener_apply("mags", xre, xim, mags.reshape(S, T, 2 * F), None, racc, inv, 1e-10)


# ---------------------------------------------------------------------------
# A numpy mirror of the reduce kernel's order of summation (csrc/wiener.cu):
# slabs of T in cluster-rank order, time lanes in a slab, rows in a lane
# ---------------------------------------------------------------------------


# The reduce's order of summation: a block of LANES time lanes owns 32 bins
# and one of the CLUSTER slabs of T; lane w sums its slab's rows w,
# w + LANES, ... in order, the lanes are added in lane order, the slabs in
# slab order (RB_LANES, RB_CLUSTER).
LANES, CLUSTER = 8, 8


def _slab(rank, T):
    """The time rows [t_lo, t_hi) of slab ``rank`` (wiener_reduce_kernel)."""
    return rank * T // CLUSTER, (rank + 1) * T // CLUSTER


def _unit(re, im):
    a2 = re * re + im * im
    nz = a2 > 0
    rs = (np.float32(1) / np.sqrt(np.where(nz, a2, np.float32(1)))).astype(np.float32)
    return np.where(nz, re * rs, np.float32(1)), np.where(nz, im * rs, np.float32(0))


def _row_stats(mode, a_re, a_im, first, inv, t):
    """The 4S statistics (S, 4, F) that one time row adds, float32."""
    F = a_re.shape[-1]
    if mode == "masks":
        x0r, x0i, x1r, x1i = a_re[0, t], a_im[0, t], a_re[1, t], a_im[1, t]
        ax0, ax1 = x0r * x0r + x0i * x0i, x1r * x1r + x1i * x1i
        cr, ci = x0r * x1r + x0i * x1i, x0i * x1r - x0r * x1i
        m0, m1 = first[:, t, :F], first[:, t, F:]
        m01 = m0 * m1
        return np.stack([m0 * m0 * ax0, m1 * m1 * ax1, m01 * cr, m01 * ci], axis=1)
    if mode == "mags":
        u0r, u0i = _unit(a_re[0, t], a_im[0, t])
        u1r, u1i = _unit(a_re[1, t], a_im[1, t])
        m0, m1 = first[:, 0, t] * inv, first[:, 1, t] * inv
        yr0, yi0, yr1, yi1 = m0 * u0r, m0 * u0i, m1 * u1r, m1 * u1i
    else:
        yr0, yi0, yr1, yi1 = a_re[:, 0, t], a_im[:, 0, t], a_re[:, 1, t], a_im[:, 1, t]
    return np.stack([yr0 * yr0 + yi0 * yi0, yr1 * yr1 + yi1 * yi1,
                     yr0 * yr1 + yi0 * yi1, yi0 * yr1 - yr0 * yi1], axis=1)


def _reduce_mirror(mode, a_re, a_im, first, inv):
    T, F = a_re.shape[-2:]
    rows, slabs = [], []
    for rank in range(CLUSTER):
        t_lo, t_hi = _slab(rank, T)
        lanes = []
        for w in range(LANES):
            acc = np.zeros((S, 4, F), np.float32)
            for t in range(t_lo + w, t_hi, LANES):
                acc = acc + _row_stats(mode, a_re, a_im, first, inv, t)
                rows.append(t)
            lanes.append(acc)
        slab = lanes[0]
        for acc in lanes[1:]:
            slab = slab + acc
        slabs.append(slab)
    out = slabs[0]
    for slab in slabs[1:]:
        out = out + slab
    if mode == "masks":
        out = out * (inv * inv)
    assert sorted(rows) == list(range(T))  # every row once
    return out.reshape(4 * S, F)


@pytest.mark.parametrize("mode", ["masks", "y", "mags"])
@pytest.mark.parametrize("T, F", [(1, 1), (37, 1), (64, 5), (65, 5), (2584, 5), (1, 2049),
                                  (37, 2049), (64, 2049), (65, 2049), (2584, 1)])
def test_reduce_mirror_matches_plain(mode, T, F):
    rng = np.random.default_rng(T * 7 + F)
    x = (30 * rng.standard_normal((2, 2, T, F))).astype(np.float32)
    x[:, 0, 0, : F // 2] = 0.0  # |x| = 0 in one channel of the first row
    if mode == "masks":
        first, second = rng.random((S, T, 2 * F), dtype=np.float32), None
    elif mode == "mags":
        first, second = (40 * rng.random((S, 2, T, F))).astype(np.float32), None
    else:
        first, second = (rng.standard_normal((2, S, 2, T, F)) / 3).astype(np.float32)
    inv = np.float32(1 / 7.5)
    a_re, a_im = (first, second) if mode == "y" else (x[0], x[1])
    mirror = _reduce_mirror(mode, a_re, a_im, first, inv)
    xre, xim = torch.from_numpy(x[0]), torch.from_numpy(x[1])
    plain = wiener_cuda.wiener_reduce(
        mode, xre, xim, torch.from_numpy(first),
        None if second is None else torch.from_numpy(second), torch.tensor([inv]))
    assert plain.shape == mirror.shape == (4 * S, F)
    # float32 sums in another order: a lane's rows in sequence, then lanes
    # and slabs, against torch's summation along T
    assert _rel(mirror, plain.numpy()) <= 1e-5

