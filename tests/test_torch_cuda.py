"""The port's CUDA kernels against their plain PyTorch versions on the
card, at ragged shapes the main path does not reach (B > 1, G not a
multiple of the block's units, T not a multiple of the reduce chunk).

Marked ``cuda``; each test skips where ``torch.cuda.is_available()`` is
false.  On a machine with a GPU and no jax, run them without the
repository's conftest (which configures jax for the JAX tests):

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

from __future__ import annotations

import pytest
import torch

from umx_tpu_torch.config import WienerConfig
from umx_tpu_torch.ops import lstm_cuda, wiener_cuda

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU or interpret mode)")
    return torch.device("cuda")


def _lstm_inputs(dev, T, R, B, G, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    xp = torch.randn((T, R * B, 4 * G), generator=g, device=dev)
    whh = (torch.randn((R, G, 4 * G), generator=g, device=dev) / G**0.5).to(torch.bfloat16)
    h0 = 0.5 * torch.randn((R * B, G), generator=g, device=dev)
    c0 = 0.5 * torch.randn((R * B, G), generator=g, device=dev)
    return xp, whh, h0, c0


@pytest.mark.parametrize("T, R, B, G", [(37, 3, 3, 40), (9, 8, 1, 512), (5, 2, 6, 24)])
def test_lstm_kernel_matches_plain(dev, T, R, B, G):
    xp, whh, h0, c0 = _lstm_inputs(dev, T, R, B, G, seed=T)
    before = lstm_cuda.lstm_merged.launches
    out_k = lstm_cuda.lstm_merged(xp, whh, h0, c0, B)
    torch.cuda.synchronize()
    assert lstm_cuda.lstm_merged.launches == before + 1
    out_p = lstm_cuda.lstm_merged_plain(xp, whh, h0, c0, B)
    # bf16 operands, f32 sums in another order: a flipped bf16 rounding of
    # h moves a gate by ~1e-3 at most over these few steps
    for k, p in zip(out_k, out_p):
        assert (k - p).abs().max().item() <= 5e-3
    assert torch.equal(c0, _lstm_inputs(dev, T, R, B, G, seed=T)[3])  # c0 untouched


def test_lstm_kernel_rejects_mixed_devices(dev):
    xp, whh, h0, c0 = _lstm_inputs(dev, 3, 2, 1, 16, seed=0)
    with pytest.raises(ValueError, match="h0 is on"):
        lstm_cuda.lstm_merged(xp, whh, h0.cpu(), c0, 1)


@pytest.mark.parametrize("T", [19, 64, 130])
@pytest.mark.parametrize("iterations", [1, 3])
def test_wiener_kernels_match_plain(dev, T, iterations):
    g = torch.Generator(device=dev).manual_seed(T)
    F = 2049
    xre = 30 * torch.randn((2, T, F), generator=g, device=dev)
    xim = 30 * torch.randn((2, T, F), generator=g, device=dev)
    masks = torch.rand((4, T, 2 * F), generator=g, device=dev)
    yk = wiener_cuda.wiener_planes_from_masks(xre, xim, masks, WienerConfig(iterations=iterations))
    ycpu = wiener_cuda.wiener_planes_from_masks(
        xre.cpu(), xim.cpu(), masks.cpu(), WienerConfig(iterations=iterations)
    )
    # same f32 operations per element; summation order and FMA differ
    for k, p in zip(yk, ycpu):
        assert (k.cpu() - p).abs().max().item() <= 1e-4 * p.abs().max().item()


def test_wiener_reduce_is_bit_stable_and_counted(dev):
    g = torch.Generator(device=dev).manual_seed(5)
    xre = torch.randn((2, 200, 2049), generator=g, device=dev)
    xim = torch.randn((2, 200, 2049), generator=g, device=dev)
    masks = torch.rand((4, 200, 4098), generator=g, device=dev)
    inv = wiener_cuda.inv_max_abs(xre, xim, 10.0)
    before = wiener_cuda.wiener_reduce.launches
    a = wiener_cuda.wiener_reduce("masks", xre, xim, masks, None, inv)
    b = wiener_cuda.wiener_reduce("masks", xre, xim, masks, None, inv)
    assert torch.equal(a, b)
    assert wiener_cuda.wiener_reduce.launches == before + 2


@pytest.mark.parametrize(
    "cfg", [WienerConfig(psd="umxcpp"), WienerConfig(iterations=0), WienerConfig(iterations=2)]
)
def test_wiener_dispatch_on_the_card_matches_cpu(dev, cfg):
    """The einsum routes (psd umxcpp, 0 iterations) run on any device;
    the kernel route agrees with the CPU's plain versions."""
    from umx_tpu_torch.ops.wiener import wiener_filter_masks

    g = torch.Generator(device=dev).manual_seed(9)
    xre = 30 * torch.randn((2, 23, 2049), generator=g, device=dev)
    xim = 30 * torch.randn((2, 23, 2049), generator=g, device=dev)
    masks = torch.rand((4, 23, 2 * 2049), generator=g, device=dev)
    ours = wiener_filter_masks(xre, xim, masks, 2049, cfg)
    ref = wiener_filter_masks(xre.cpu(), xim.cpu(), masks.cpu(), 2049, cfg)
    for k, p in zip(ours, ref):
        assert k.is_cuda
        assert (k.cpu() - p).abs().max().item() <= 1e-4 * p.abs().max().item()


def test_separator_on_the_card_matches_cpu(dev):
    """The whole slice at a small width: every kernel on the card against
    every plain version on the CPU, same weights and track."""
    import numpy as np

    from umx_tpu_torch.config import EngineConfig, ModelConfig, SegmentConfig
    from umx_tpu_torch.engine.separator import Separator
    from umx_tpu_torch.io.ggml import GGMLModel
    from umx_tpu_torch.models.umx import params_from_ggml, synthetic_state_dicts

    cfg = EngineConfig(model=ModelConfig(hidden_size=48), segment=SegmentConfig(segment_secs=1.0))
    model = GGMLModel(48, synthetic_state_dicts(cfg.model, seed=2))
    track = np.random.default_rng(2).standard_normal((2, 100_000)).astype(np.float32) * 0.1
    gpu = Separator(params_from_ggml(model, cfg.model, dev), cfg, dev).demix_track(track, seed=1)
    cpu = Separator(params_from_ggml(model, cfg.model), cfg).demix_track(track, seed=1)
    # bf16 recurrence operands and cuFFT/cuBLAS summation order
    assert np.max(np.abs(gpu - cpu)) <= 2e-3 * np.max(np.abs(cpu))
