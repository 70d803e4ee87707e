"""The port's STFT/iSTFT (torch.stft / torch.istft) against
``umx_tpu.ops.stft`` on the CPU, where the JAX package runs its XLA FFT
path; plus the layout helpers crop_stack and masks_to_planes."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from umx_tpu.config import DSPConfig as JDSPConfig
from umx_tpu.engine.separator import crop_stack as jcrop_stack
from umx_tpu.engine.separator import masks_to_planes as jmasks_to_planes
from umx_tpu.ops import stft as jstft
from umx_tpu_torch.config import DSPConfig
from umx_tpu_torch.ops import stft as tstft

# both sides are f32 FFTs with different summation orders; 1e-4 of the
# spectrum's (or signal's) scale bounds that with a wide margin
RTOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _assert_normwise(ours, ref, rtol=RTOL):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert ours.shape == ref.shape
    err = np.max(np.abs(ours - ref)) / np.max(np.abs(ref))
    assert err <= rtol, f"normwise error {err:.3g} > {rtol}"


@pytest.mark.parametrize("n", [22050, 22050 + 517])
def test_stft_planes_match_jax(n):
    x = np.random.default_rng(n).standard_normal((2, n)).astype(np.float32)
    jre, jim = jstft.stft_planes(jnp.asarray(x), JDSPConfig(fft_impl="xla"))
    tre, tim = tstft.stft_planes(torch.from_numpy(x), DSPConfig())
    assert tre.shape == (2, n // 1024 + 1, 2049) and tre.dtype == torch.float32
    scale = max(np.abs(np.asarray(jre)).max(), np.abs(np.asarray(jim)).max())
    for o, r in ((tre, jre), (tim, jim)):
        assert np.max(np.abs(o.numpy() - np.asarray(r))) <= RTOL * scale


@pytest.mark.parametrize("n", [22050, 22050 + 517])
def test_istft_planes_match_jax(n):
    rng = np.random.default_rng(n + 1)
    T = n // 1024 + 1
    re = rng.standard_normal((3, 2, T, 2049)).astype(np.float32)
    im = rng.standard_normal((3, 2, T, 2049)).astype(np.float32)
    ref = jstft.istft_planes(jnp.asarray(re), jnp.asarray(im), n, JDSPConfig(fft_impl="xla"))
    ours = tstft.istft_planes(torch.from_numpy(re), torch.from_numpy(im), n, DSPConfig())
    assert ours.shape == (3, 2, n)
    _assert_normwise(ours.numpy(), ref)


def test_stft_istft_round_trip():
    x = np.random.default_rng(5).standard_normal((2, 30000)).astype(np.float32)
    re, im = tstft.stft_planes(torch.from_numpy(x), DSPConfig())
    back = tstft.istft_planes(re, im, x.shape[1], DSPConfig())
    _assert_normwise(back.numpy(), x, 1e-5)


def test_layout_helpers_match_jax():
    rng = np.random.default_rng(3)
    mag = rng.random((2, 7, 2049)).astype(np.float32)
    np.testing.assert_array_equal(
        tstft.crop_stack(torch.from_numpy(mag), 1487).numpy(),
        np.asarray(jcrop_stack(jnp.asarray(mag), 1487)),
    )
    masks = rng.random((4, 7, 2 * 2049)).astype(np.float32)
    np.testing.assert_array_equal(
        tstft.masks_to_planes(torch.from_numpy(masks), 2049).numpy(),
        np.asarray(jmasks_to_planes(jnp.asarray(masks), 2049)),
    )


def test_polar_to_complex_matches_jax():
    rng = np.random.default_rng(4)
    ref = (rng.standard_normal((2, 5, 9)) + 1j * rng.standard_normal((2, 5, 9))).astype(np.complex64)
    ref[0, 0, :3] = 0  # |ref| = 0 → unit phasor 1 + 0i
    mag = rng.random((3, 2, 5, 9)).astype(np.float32)
    ours = tstft.polar_to_complex(torch.from_numpy(mag), torch.from_numpy(ref)[None]).numpy()
    theirs = np.asarray(jstft.polar_to_complex(jnp.asarray(mag), jnp.asarray(ref)[None]))
    np.testing.assert_allclose(ours, theirs, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(ours[:, 0, 0, :3], mag[:, 0, 0, :3])
