"""The port's Wiener-EM against the JAX package: the plain versions of the
reduce/apply kernels against ``wiener_planes_from_masks`` in Pallas
interpret mode (iterations 1 and 2), the einsum reference against
``umx_tpu.ops.wiener.wiener_filter`` (both PSD conventions), and the
dispatch rule."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from umx_tpu.config import WienerConfig as JWienerConfig
from umx_tpu.ops import wiener as jwiener
from umx_tpu.ops.wiener_pallas import wiener_planes_from_masks as jplanes_from_masks
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
    # mix amplitudes well above scale_factor so max_abs > 1 is exercised
    xre = (30 * rng.standard_normal((2, T, F))).astype(np.float32)
    xim = (30 * rng.standard_normal((2, T, F))).astype(np.float32)
    masks = rng.random((S, T, 2 * F)).astype(np.float32)
    return xre, xim, masks


def _rel(ours, ref):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert ours.shape == ref.shape
    return float(np.max(np.abs(ours - ref)) / np.max(np.abs(ref)))


@pytest.mark.parametrize("iterations", [1, 2])
def test_fused_passes_match_pallas_interpret(data, iterations):
    xre, xim, masks = data
    jcfg = JWienerConfig(iterations=iterations)
    jre, jim = jplanes_from_masks(
        jnp.asarray(xre), jnp.asarray(xim), jnp.asarray(masks), F, jcfg,
        time_block=8, interpret=True,
    )
    tre, tim = wiener_cuda.wiener_planes_from_masks(
        *map(torch.from_numpy, (xre, xim, masks)), WienerConfig(iterations=iterations)
    )
    # same f32 operation order per element; only the time sums are taken
    # in another order (TPU: per 8-row block) → 1e-5 of max|y|
    assert _rel(tre.numpy(), jre) <= 1e-5
    assert _rel(tim.numpy(), jim) <= 1e-5


@pytest.mark.parametrize("psd", ["correct", "umxcpp"])
@pytest.mark.parametrize("iterations", [0, 1, 2])
def test_einsum_reference_matches_jax(data, psd, iterations):
    xre, xim, masks = data
    mix = (xre + 1j * xim).astype(np.complex64)
    mags = (np.abs(mix)[None] * masks.reshape(S, T, 2, F).transpose(0, 2, 1, 3)).astype(np.float32)
    jcfg = JWienerConfig(iterations=iterations, psd=psd, impl="einsum")
    ref = np.asarray(jwiener.wiener_filter(jnp.asarray(mix), jnp.asarray(mags), jcfg))
    ours = twiener.wiener_filter(
        torch.from_numpy(mix), torch.from_numpy(mags), WienerConfig(iterations=iterations, psd=psd)
    ).numpy()
    # complex64 einsums in another summation order → 1e-5 of max|y|
    assert _rel(ours.real, ref.real) <= 1e-5
    assert _rel(ours.imag, ref.imag) <= 1e-5


@pytest.mark.parametrize(
    "cfg", [WienerConfig(), WienerConfig(psd="umxcpp"), WienerConfig(iterations=0)]
)
def test_masks_dispatch_matches_jax_dispatch(data, cfg):
    """psd 'correct' with iterations >= 1 runs the fused passes, the rest
    the einsum path — on both sides the same numbers come out."""
    xre, xim, masks = data
    jcfg = JWienerConfig(
        iterations=cfg.iterations, psd=cfg.psd,
        impl="pallas_interpret" if cfg.psd == "correct" else "einsum",
    )
    jre, jim = jwiener.wiener_filter_masks(
        jnp.asarray(xre), jnp.asarray(xim), jnp.asarray(masks), F, jcfg
    )
    before = (wiener_cuda.wiener_reduce.launches, wiener_cuda.wiener_apply.launches)
    tre, tim = twiener.wiener_filter_masks(*map(torch.from_numpy, (xre, xim, masks)), F, cfg)
    assert tre.shape == (S, 2, T, F) and tre.dtype == torch.float32
    assert _rel(tre.numpy(), jre) <= 1e-5
    assert _rel(tim.numpy(), jim) <= 1e-5
    # the CPU route runs the plain versions and launches no kernel
    assert (wiener_cuda.wiener_reduce.launches, wiener_cuda.wiener_apply.launches) == before


def test_fused_passes_partition_the_mix(data):
    """With masks the EM estimates sum back to (nearly) the mix."""
    xre, xim, masks = data
    yre, yim = wiener_cuda.wiener_planes_from_masks(
        *map(torch.from_numpy, (xre, xim, masks)), WienerConfig()
    )
    assert _rel(yre.sum(0).numpy(), xre) < 1e-3
    assert _rel(yim.sum(0).numpy(), xim) < 1e-3


def test_inv_max_abs_matches_jax(data):
    xre, xim, _ = data
    ours = wiener_cuda.inv_max_abs(torch.from_numpy(xre), torch.from_numpy(xim), 10.0)
    ref = 1.0 / jnp.maximum(1.0, jnp.max(jnp.sqrt(xre * xre + xim * xim)) / 10.0)
    assert ours.shape == (1,)
    np.testing.assert_allclose(ours.numpy()[0], float(ref), rtol=1e-6)
    small = wiener_cuda.inv_max_abs(torch.zeros(2, 3, 5), torch.zeros(2, 3, 5), 10.0)
    assert small.item() == 1.0


def test_wrappers_reject_bad_inputs(data):
    xre, xim, masks = map(torch.from_numpy, data)
    inv = torch.ones(1)
    with pytest.raises(ValueError, match="masks must be"):
        wiener_cuda.wiener_reduce("masks", xre, xim, masks[:3], None, inv)
    with pytest.raises(TypeError, match="float32"):
        wiener_cuda.wiener_reduce("masks", xre, xim, masks.double(), None, inv)
    with pytest.raises(ValueError, match="mode"):
        wiener_cuda.wiener_reduce("mags", xre, xim, masks, None, inv)
    with pytest.raises(ValueError, match="contiguous"):
        wiener_cuda.wiener_reduce("masks", xre, xim, masks.transpose(0, 1).contiguous().transpose(0, 1), None, inv)
    racc = wiener_cuda.wiener_reduce("masks", xre, xim, masks, None, inv)
    with pytest.raises(ValueError, match="racc must be"):
        wiener_cuda.wiener_apply("masks", xre, xim, masks, None, racc[:4], inv, 1e-10)
    with pytest.raises(ValueError, match="inv_ma"):
        wiener_cuda.wiener_apply("masks", xre, xim, masks, None, racc, torch.ones(1, 1), 1e-10)
