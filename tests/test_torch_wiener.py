"""The port's Wiener-EM against the JAX package: the plain versions of the
reduce/apply kernels against ``wiener_planes_from_masks`` in Pallas
interpret mode (iterations 1 and 2), also in the TPU kernels' storage
dtypes (bfloat16 masks, bfloat16 output planes, and the magnitudes entry
``wiener_planes_pallas``), the einsum reference against
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
from umx_tpu.ops.wiener_pallas import wiener_planes_pallas as jplanes_from_mags
from umx_tpu_torch.config import WienerConfig
from umx_tpu_torch.ops import wiener as twiener
from umx_tpu_torch.ops import wiener_cuda

S, T, F = 4, 19, 2049
# bfloat16 planes against the JAX package's on the same bfloat16 inputs:
# the float32 values agree within the dense 1e-5 of max|y| (above), so an
# element's rounding flips where that difference crosses a rounding
# boundary, and each flip is one bf16 step of the element.  Measured at
# this shape: 3.2e-5 to 2.0e-4 of the elements flip (10 to 61 of 311,448),
# the largest difference 1.5e-4 to 1.2e-3 of max|y| (one step of a large
# element); the seam's own effect against float32 is 2.1e-3 to 2.4e-3.
BF16_FLIP_RATE = 1e-3
DENSE = 2e-4  # of max|y|: the port against JAX in float32 (test_torch_separator.py)


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


def _bf16_step(v):
    """One bf16 step (2^-7 of the binade) of each element of ``v``."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(v), 1e-30))) - 7)


def _hold_bf16(ours, theirs, f32):
    """bf16 planes ``ours`` against the JAX package's ``theirs``: the dtype,
    the flip rate, each element within the dense tolerance plus one bf16
    step, and something rounded against the float32 planes ``f32``."""
    scale = float(np.abs(f32).max())
    assert ours.dtype == torch.bfloat16 and str(theirs.dtype) == "bfloat16"
    o, j = ours.float().numpy(), np.asarray(theirs, np.float32)
    flips = o != j
    assert flips.mean() <= BF16_FLIP_RATE
    step = _bf16_step(np.maximum(np.abs(o), np.abs(j)))
    assert np.all(np.abs(o - j) <= DENSE * scale + step)
    assert np.abs(o - f32).max() > 0.0


@pytest.mark.parametrize("iterations", [1, 2])
def test_storage_dtypes_match_pallas_interpret(data, iterations):
    """The TPU kernels' storage dtypes: bfloat16 masks read by both passes
    and bfloat16 planes from the last apply, the plain versions against
    ``wiener_planes_from_masks`` (interpret mode) fed the same bfloat16
    masks with ``out_dtype=bfloat16``; intermediate iterations float32 on
    both sides."""
    xre, xim, masks = data
    m16 = torch.from_numpy(masks).to(torch.bfloat16)
    jcfg = JWienerConfig(iterations=iterations)
    jre, jim = jplanes_from_masks(
        jnp.asarray(xre), jnp.asarray(xim), jnp.asarray(masks, jnp.bfloat16), F, jcfg,
        time_block=8, interpret=True, out_dtype=jnp.bfloat16,
    )
    x = (torch.from_numpy(xre), torch.from_numpy(xim))
    cfg = WienerConfig(iterations=iterations)
    tre, tim = wiener_cuda.wiener_planes_from_masks(*x, m16, cfg, torch.bfloat16)
    # the float32 planes of the upcast masks: the bf16 planes are their RNE
    # rounding, bit for bit (the upcast is exact, the arithmetic the same)
    fre, fim = wiener_cuda.wiener_planes_from_masks(*x, m16.float(), cfg)
    assert torch.equal(tre, fre.to(torch.bfloat16)) and torch.equal(tim, fim.to(torch.bfloat16))
    _hold_bf16(tre, jre, fre.numpy())
    _hold_bf16(tim, jim, fim.numpy())


@pytest.mark.parametrize("iterations", [1, 2])
def test_mags_entry_bf16_output_matches_pallas_interpret(data, iterations):
    """The magnitudes entry with bfloat16 output planes against
    ``wiener_planes_pallas`` (interpret mode, ``out_dtype=bfloat16``)."""
    xre, xim, masks = data
    mags = (np.abs(xre + 1j * xim)[None]
            * masks.reshape(S, T, 2, F).transpose(0, 2, 1, 3)).astype(np.float32)
    jre, jim = jplanes_from_mags(
        jnp.asarray(xre), jnp.asarray(xim), jnp.asarray(mags), JWienerConfig(iterations=iterations),
        time_block=8, interpret=True, out_dtype=jnp.bfloat16,
    )
    x = (torch.from_numpy(xre), torch.from_numpy(xim), torch.from_numpy(mags))
    cfg = WienerConfig(iterations=iterations)
    tre, tim = wiener_cuda.wiener_planes_from_mags(*x, cfg, torch.bfloat16)
    fre, fim = wiener_cuda.wiener_planes_from_mags(*x, cfg)
    assert torch.equal(tre, fre.to(torch.bfloat16)) and torch.equal(tim, fim.to(torch.bfloat16))
    _hold_bf16(tre, jre, fre.numpy())
    _hold_bf16(tim, jim, fim.numpy())


def test_passes_take_bf16_masks_and_bf16_output(data):
    """Each pass alone: the reduce and the apply on bfloat16 masks equal
    them on the exact upcast, and the apply's bfloat16 planes are the RNE
    rounding of its float32 planes, in every mode; the pass counts no
    launch on the CPU."""
    xre, xim, masks = map(torch.from_numpy, data)
    m16 = masks.to(torch.bfloat16)
    inv = wiener_cuda.inv_max_abs(xre, xim, 10.0)
    launches = (wiener_cuda.wiener_reduce.launches, wiener_cuda.wiener_apply.launches)
    racc = wiener_cuda.wiener_reduce("masks", xre, xim, m16, None, inv)
    assert torch.equal(racc, wiener_cuda.wiener_reduce("masks", xre, xim, m16.float(), None, inv))
    mags = (masks.view(S, T, 2, F).transpose(1, 2)
            * torch.sqrt(xre * xre + xim * xim)[None]).contiguous()
    y32 = wiener_cuda.wiener_apply("masks", xre, xim, m16.float(), None, racc, inv, 1e-10)
    yre_s, yim_s = (y32[0] * inv).contiguous(), (y32[1] * inv).contiguous()
    for mode, first, second in (("masks", m16, None), ("mags", mags, None),
                                ("y", yre_s, yim_s)):
        ref = first.float() if mode == "masks" else first
        f32 = wiener_cuda.wiener_apply(mode, xre, xim, ref, second, racc, inv, 1e-10)
        b16 = wiener_cuda.wiener_apply(mode, xre, xim, first, second, racc, inv, 1e-10,
                                       torch.bfloat16)
        for a, b in zip(f32, b16):
            assert a.dtype == torch.float32 and b.dtype == torch.bfloat16
            assert torch.equal(b, a.to(torch.bfloat16))
    assert (wiener_cuda.wiener_reduce.launches, wiener_cuda.wiener_apply.launches) == launches


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
        wiener_cuda.wiener_reduce("magnitudes", xre, xim, masks, None, inv)
    with pytest.raises(ValueError, match="contiguous"):
        wiener_cuda.wiener_reduce("masks", xre, xim, masks.transpose(0, 1).contiguous().transpose(0, 1), None, inv)
    racc = wiener_cuda.wiener_reduce("masks", xre, xim, masks, None, inv)
    with pytest.raises(ValueError, match="racc must be"):
        wiener_cuda.wiener_apply("masks", xre, xim, masks, None, racc[:4], inv, 1e-10)
    with pytest.raises(ValueError, match="inv_ma"):
        wiener_cuda.wiener_apply("masks", xre, xim, masks, None, racc, torch.ones(1, 1), 1e-10)


@pytest.mark.parametrize("what", ["masks", "out", "mags", "x"])
def test_unsupported_storage_dtypes_raise_by_name(data, what):
    """float32 and bfloat16 are the masks' and the planes' storage dtypes;
    anything else, and bfloat16 where the TPU kernels read float32 (the
    magnitudes, x), raises naming the dtype."""
    xre, xim, masks = map(torch.from_numpy, data)
    inv = torch.ones(1)
    racc = wiener_cuda.wiener_reduce("masks", xre, xim, masks, None, inv)
    mags = torch.ones((S, 2, T, F), dtype=torch.bfloat16)
    calls = {
        "masks": (r"torch\.float16", lambda: wiener_cuda.wiener_reduce(
            "masks", xre, xim, masks.half(), None, inv)),
        "out": (r"torch\.float16", lambda: wiener_cuda.wiener_apply(
            "masks", xre, xim, masks, None, racc, inv, 1e-10, torch.float16)),
        "mags": (r"torch\.bfloat16", lambda: wiener_cuda.wiener_apply(
            "mags", xre, xim, mags, None, racc, inv, 1e-10)),
        "x": (r"torch\.bfloat16", lambda: wiener_cuda.wiener_reduce(
            "masks", xre.bfloat16(), xim, masks, None, inv)),
    }
    pattern, call = calls[what]
    with pytest.raises(TypeError, match=pattern):
        call()
