"""The fused Cooley-Tukey iSTFT: the port's plain version of the kernel
(K8) against the JAX ``istft_ct2_fused`` in Pallas interpret mode, the
port's ``istft_planes(istft_algo="ct2")`` against the JAX one, and the
pieces around it (``overlap_add``, ``window_sumsquare``, the geometry the
kernel refuses)."""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from umx_tpu.config import DSPConfig as JDSPConfig
from umx_tpu.ops import istft_ct as j_istft_ct
from umx_tpu.ops import stft as j_stft
from umx_tpu_torch.config import DSPConfig
from umx_tpu_torch.ops import istft_ct, istft_ct_cuda
from umx_tpu_torch.ops import stft as t_stft

# The JAX package's own bound between its CT forms on unit-normal planes
# (tests/test_istft_ct.py): f32 sums in another order over 2049 bins.
CT_ATOL = 1e-5


def _planes(t, lead=(), n_bins=2049, seed=0):
    rng = np.random.default_rng(seed)
    re = rng.standard_normal((*lead, t, n_bins)).astype(np.float32)
    im = rng.standard_normal((*lead, t, n_bins)).astype(np.float32)
    return re, im


@pytest.mark.parametrize("t, lead, windowed", [(6, (), True), (12, (2,), False), (6, (2,), True)])
def test_plain_ct_matches_jax_fused_interpret(t, lead, windowed):
    re, im = _planes(t, lead, seed=t)
    win = j_stft.hann_window(4096) if windowed else None
    ref = j_istft_ct.istft_ct2_fused(jnp.asarray(re), jnp.asarray(im), 4096, 1024, window=win,
                                     kf=4, interpret=True)
    ours = istft_ct_cuda.istft_ct2(torch.from_numpy(re), torch.from_numpy(im), 4096, 1024,
                                   t_stft.hann_window(4096, "cpu") if windowed else None)
    assert ours.shape == (*lead, (t - 1) * 1024 + 4096)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=CT_ATOL, rtol=0)


def test_istft_planes_ct2_matches_jax():
    # the JAX ct2 arm needs the matmul DFT; both precisions at highest
    jcfg = JDSPConfig(fft_impl="matmul", dft_precision="highest", idft_precision="highest",
                      istft_algo="ct2_interpret")
    rng = np.random.default_rng(7)
    n = 16384
    x = rng.standard_normal((2, n)).astype(np.float32)
    re, im = j_stft.stft_planes(jnp.asarray(x), jcfg)
    ref = j_stft.istft_planes(re, im, n, jcfg)
    ours = t_stft.istft_planes(torch.from_numpy(np.array(re)), torch.from_numpy(np.array(im)),
                               n, DSPConfig(istft_algo="ct2"))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=CT_ATOL, rtol=0)
    # and the round trip stays within the STFT class of the dense inverse
    np.testing.assert_allclose(ours.numpy(), x, atol=1e-4, rtol=0)


def test_ct2_and_dense_inverse_agree():
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 3, 20000)).astype(np.float32))
    re, im = t_stft.stft_planes(x, DSPConfig())
    dense = t_stft.istft_planes(re, im, 20000, DSPConfig())
    ct2 = t_stft.istft_planes(re, im, 20000, DSPConfig(istft_algo="ct2"))
    # the same transform by two routes: f32 rounding of ~1e-6 on |x| ~ 4
    np.testing.assert_allclose(ct2.numpy(), dense.numpy(), atol=1e-5, rtol=0)


def test_overlap_add_and_window_sumsquare_match_jax():
    # exact: the same zero-padded piece grids summed in the same order
    frames = np.random.default_rng(1).standard_normal((2, 7, 4096)).astype(np.float32)
    np.testing.assert_array_equal(
        t_stft.overlap_add(torch.from_numpy(frames), 1024).numpy(),
        np.asarray(j_stft.overlap_add(jnp.asarray(frames), 1024)),
    )
    np.testing.assert_array_equal(
        t_stft.window_sumsquare(t_stft.hann_window(4096, "cpu"), 9, 1024, 11000).numpy(),
        np.asarray(j_stft.window_sumsquare(j_stft.hann_window(4096), 9, 1024, 11000)),
    )


def test_dc_and_nyquist_imaginary_parts_drop_out():
    re, im = _planes(5, seed=2)
    im2 = im.copy()
    im2[..., 0] = 0.0
    im2[..., -1] = 0.0
    a = istft_ct.istft_ct2_plain(torch.from_numpy(re), torch.from_numpy(im), 4096, 1024)
    b = istft_ct.istft_ct2_plain(torch.from_numpy(re), torch.from_numpy(im2), 4096, 1024)
    assert torch.equal(a, b)


def test_kernel_wrapper_route_and_geometry():
    re, im = (torch.from_numpy(a) for a in _planes(3, (2,), seed=4))
    before = istft_ct_cuda.istft_ct2.launches
    out = istft_ct_cuda.istft_ct2(re, im, 4096, 1024)
    assert torch.equal(out, istft_ct.istft_ct2_plain(re, im, 4096, 1024))
    assert istft_ct_cuda.istft_ct2.launches == before  # no kernel ran on the CPU
    with pytest.raises(ValueError, match="hop == n_fft/4"):
        istft_ct_cuda.istft_ct2(re, im, 4096, 512)
    small = torch.zeros((3, 1001))
    with pytest.raises(ValueError, match="1024 | n_fft"):
        istft_ct_cuda.istft_ct2(small, small, 2000, 500)
    big = torch.zeros((3, 4097))
    with pytest.raises(ValueError, match="n_fft = 4096"):  # the kernel's one size, either route
        istft_ct_cuda.istft_ct2(big, big, 8192, 2048)
    with pytest.raises(ValueError, match="one-sided bins"):
        istft_ct_cuda.istft_ct2(re[..., :-1], im[..., :-1], 4096, 1024)
    with pytest.raises(ValueError, match="istft_algo"):
        DSPConfig(istft_algo="ct2_xla")
    with pytest.raises(ValueError, match="hop == n_fft/4"):
        t_stft.istft_planes(re, im, 4096, dataclasses.replace(DSPConfig(istft_algo="ct2"), hop=512))
