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
