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


@pytest.mark.parametrize(
    "T, R, B, G",
    [(37, 3, 3, 40), (9, 8, 1, 512), (5, 2, 6, 24), (7, 8, 16, 512), (5, 8, 32, 512)],
)
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


def test_lstm_kernel_takes_b64_and_refuses_what_it_cannot_hold(dev):
    xp, whh, h0, c0 = _lstm_inputs(dev, 2, 2, 64, 512, seed=1)
    out_k = lstm_cuda.lstm_merged(xp, whh, h0, c0, 64)
    out_p = lstm_cuda.lstm_merged_plain(xp, whh, h0, c0, 64)
    for k, p in zip(out_k, out_p):
        assert (k - p).abs().max().item() <= 5e-3
    # the resident kernels take rows beyond one launch's 16 as further row
    # groups: no upper B
    xp, whh, h0, c0 = _lstm_inputs(dev, 2, 1, 100, 512, seed=2)
    out_k = lstm_cuda.lstm_merged(xp, whh, h0, c0, 100)
    assert lstm_cuda.lstm_merged.form[3] == 7
    out_p = lstm_cuda.lstm_merged_plain(xp, whh, h0, c0, 100)
    for k, p in zip(out_k, out_p):
        assert (k - p).abs().max().item() <= 5e-3
    wrappers = (lstm_cuda.lstm_merged, lstm_cuda.lstm_merged_train_fwd,
                lstm_cuda.lstm_merged_bwd_step)
    before = [f.launches for f in wrappers]
    # a width whose W_hh slice does not fit a warp's registers is refused
    wide = _lstm_inputs(dev, 2, 1, 1, 520, seed=3)
    with pytest.raises(RuntimeError, match="G <= 512"):
        lstm_cuda.lstm_merged(*wide, 1)
    with pytest.raises(RuntimeError, match="G <= 512"):
        lstm_cuda.lstm_merged_train_fwd(*wide, 1)
    z = torch.zeros((2, 1, 520), device=dev)
    with pytest.raises(RuntimeError, match="G <= 512"):
        lstm_cuda.lstm_merged_bwd_step(torch.zeros((2, 1, 2080), device=dev), z, z[0], wide[1],
                                       z, z[0], z[0], 1)
    assert [f.launches for f in wrappers] == before


def test_train_kernels_take_b96(dev):
    """K4 and K5 above the 81 rows per chain that K4's earlier form could
    hold: six row groups each, against plain."""
    T, R, B, G = 5, 2, 96, 512
    (xp, whh, h0, c0), (dhs, dhT, dcT) = _train_case(dev, T, R, B, G, seed=96)
    fwd_k = lstm_cuda.lstm_merged_train_fwd(xp, whh, h0, c0, B)
    assert lstm_cuda.lstm_merged_train_fwd.form[3] == 6
    fwd_p = lstm_cuda.lstm_merged_train_fwd_plain(xp, whh, h0, c0, B)
    for name, k, p in zip(("hs", "hT", "cT", "gates", "cs"), fwd_k, fwd_p):
        assert (k - p).abs().max().item() <= 5e-3, name
    _, _, _, gates, cs = fwd_p
    bwd_k = lstm_cuda.lstm_merged_bwd_step(gates, cs, c0, whh, dhs, dhT, dcT, B)
    assert lstm_cuda.lstm_merged_bwd_step.form[3] == 6
    bwd_p = lstm_cuda.lstm_merged_bwd_step_plain(gates, cs, c0, whh, dhs, dhT, dcT, B)
    for name, k, p in zip(("dxp", "dh0", "dc0"), bwd_k, bwd_p):
        assert _rel(k, p) <= 5e-3, name


@pytest.mark.parametrize("G", [256, 512])
@pytest.mark.parametrize("T, B", [(1, 1), (37, 3), (130, 6), (29, 16), (11, 17), (7, 40)])
def test_resident_lstm_kernel_at_ragged_lengths_and_row_groups(dev, G, T, B):
    """K1 at both UMX widths, ragged T, the rows the paths give it (1, 3,
    6, 16) and rows beyond one launch (17: a second group of one row; 40:
    three groups)."""
    xp, whh, h0, c0 = _lstm_inputs(dev, T, 8, B, G, seed=T + B)
    out_k = lstm_cuda.lstm_merged(xp, whh, h0, c0, B)
    torch.cuda.synchronize()
    blocks, capacity, chain_groups, row_groups = lstm_cuda.lstm_merged.form
    assert blocks == G // 32 and row_groups == -(-B // 16)
    assert chain_groups == -(-8 // (capacity // blocks))
    out_p = lstm_cuda.lstm_merged_plain(xp, whh, h0, c0, B)
    for k, p in zip(out_k, out_p):
        assert torch.isfinite(k).all()
        assert (k - p).abs().max().item() <= 5e-3


@pytest.mark.parametrize("G", [40, 512])
def test_resident_lstm_rows_do_not_depend_on_the_batch(dev, G):
    """A row's result is bit-equal whatever rows run beside it: alone, in
    a group of 3 or 6, in the second n-tile of 16, or in a later row group
    of 20 (one mma column per row, the same order of summation)."""
    T, R, B = 23, 8, 20
    xp, whh, h0, c0 = _lstm_inputs(dev, T, R, B, G, seed=G)
    hs, hT, cT = lstm_cuda.lstm_merged(xp, whh, h0, c0, B)
    for picks in ([0], [11], [19], [2, 9, 17], [0, 1, 5, 8, 13, 19], list(range(4, 20))):
        rows = torch.tensor([r * B + b for r in range(R) for b in picks], device=dev)
        sub = lstm_cuda.lstm_merged(xp[:, rows].contiguous(), whh, h0[rows].contiguous(),
                                    c0[rows].contiguous(), len(picks))
        assert torch.equal(sub[0], hs[:, rows]), picks
        assert torch.equal(sub[1], hT[rows]) and torch.equal(sub[2], cT[rows]), picks
    again = lstm_cuda.lstm_merged(xp, whh, h0, c0, B)
    assert all(torch.equal(a, b) for a, b in zip(again, (hs, hT, cT)))  # bit-stable


def _train_case(dev, T, R, B, G, seed):
    xp, whh, h0, c0 = _lstm_inputs(dev, T, R, B, G, seed)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    cts = [torch.randn(s, generator=g, device=dev) for s in ((T, R * B, G), (R * B, G), (R * B, G))]
    return (xp, whh, h0, c0), cts


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


@pytest.mark.parametrize("G", [256, 512])
@pytest.mark.parametrize("T, B", [(1, 1), (37, 3), (130, 6), (29, 16), (11, 17), (7, 40)])
def test_resident_train_kernels_at_ragged_lengths_and_row_groups(dev, G, T, B):
    """K4 and K5 at both UMX widths, ragged T, the rows training gives them
    and rows beyond one launch: K4's hs/hT/cT are K1's bits, its residuals
    and K5's sweep agree with plain, and each takes the planned launches."""
    (xp, whh, h0, c0), (dhs, dhT, dcT) = _train_case(dev, T, 8, B, G, seed=T + B)
    k1 = lstm_cuda.lstm_merged(xp, whh, h0, c0, B)
    fwd_k = lstm_cuda.lstm_merged_train_fwd(xp, whh, h0, c0, B)
    torch.cuda.synchronize()
    for a, b in zip(fwd_k[:3], k1):
        assert torch.equal(a, b)
    blocks, capacity, chain_groups, row_groups = lstm_cuda.lstm_merged_train_fwd.form
    assert blocks == G // 32 and row_groups == -(-B // 16)
    assert chain_groups == -(-8 // (capacity // blocks))
    fwd_p = lstm_cuda.lstm_merged_train_fwd_plain(xp, whh, h0, c0, B)
    for name, k, p in zip(("hs", "hT", "cT", "gates", "cs"), fwd_k, fwd_p):
        assert (k - p).abs().max().item() <= 5e-3, name
    _, _, _, gates, cs = fwd_p
    bwd_k = lstm_cuda.lstm_merged_bwd_step(gates, cs, c0, whh, dhs, dhT, dcT, B)
    torch.cuda.synchronize()
    blocks, capacity, chain_groups, row_groups = lstm_cuda.lstm_merged_bwd_step.form
    assert blocks == G // 32 and row_groups == -(-B // 16)
    assert chain_groups == -(-8 // (capacity // blocks))
    bwd_p = lstm_cuda.lstm_merged_bwd_step_plain(gates, cs, c0, whh, dhs, dhT, dcT, B)
    for name, k, p in zip(("dxp", "dh0", "dc0"), bwd_k, bwd_p):
        assert torch.isfinite(k).all()
        assert _rel(k, p) <= 5e-3, name


@pytest.mark.parametrize("G", [40, 512])
def test_resident_train_rows_do_not_depend_on_the_batch(dev, G):
    """A row of K4 and of K5 is bit-equal whatever rows run beside it (one
    mma column per row, partial sums added in a fixed order), and both are
    bit-stable from run to run."""
    T, R, B = 23, 8, 20
    (xp, whh, h0, c0), (dhs, dhT, dcT) = _train_case(dev, T, R, B, G, seed=G)
    fwd = lstm_cuda.lstm_merged_train_fwd(xp, whh, h0, c0, B)
    _, _, _, gates, cs = fwd
    bwd = lstm_cuda.lstm_merged_bwd_step(gates, cs, c0, whh, dhs, dhT, dcT, B)
    for picks in ([0], [11], [19], [2, 9, 17], [0, 1, 5, 8, 13, 19], list(range(4, 20))):
        rows = torch.tensor([r * B + b for r in range(R) for b in picks], device=dev)
        n = len(picks)
        sub = lstm_cuda.lstm_merged_train_fwd(xp[:, rows].contiguous(), whh, h0[rows].contiguous(),
                                              c0[rows].contiguous(), n)
        for s_, full in zip(sub, fwd):
            assert torch.equal(s_, full[:, rows] if full.dim() == 3 else full[rows]), picks
        sub = lstm_cuda.lstm_merged_bwd_step(
            gates[:, rows].contiguous(), cs[:, rows].contiguous(), c0[rows].contiguous(), whh,
            dhs[:, rows].contiguous(), dhT[rows].contiguous(), dcT[rows].contiguous(), n)
        for s_, full in zip(sub, bwd):
            assert torch.equal(s_, full[:, rows] if full.dim() == 3 else full[rows]), picks
    again = lstm_cuda.lstm_merged_bwd_step(gates, cs, c0, whh, dhs, dhT, dcT, B)
    assert all(torch.equal(a, b) for a, b in zip(again, bwd))


@pytest.mark.parametrize("T, R, B, G", [(1, 2, 3, 40), (37, 3, 3, 40), (37, 8, 16, 512)])
def test_train_kernels_match_plain(dev, T, R, B, G):
    (xp, whh, h0, c0), (dhs, dhT, dcT) = _train_case(dev, T, R, B, G, seed=T + G)
    counts = [f.launches for f in (lstm_cuda.lstm_merged_train_fwd,
                                   lstm_cuda.lstm_merged_bwd_step, lstm_cuda.lstm_merged_dw)]
    fwd_k = lstm_cuda.lstm_merged_train_fwd(xp, whh, h0, c0, B)
    fwd_p = lstm_cuda.lstm_merged_train_fwd_plain(xp, whh, h0, c0, B)
    # as K1: bf16 operands, f32 sums in another order
    for name, k, p in zip(("hs", "hT", "cT", "gates", "cs"), fwd_k, fwd_p):
        assert (k - p).abs().max().item() <= 5e-3, name
    hs, _, _, gates, cs = fwd_p  # the same residuals into both backwards
    dxp_k, dh0_k, dc0_k = lstm_cuda.lstm_merged_bwd_step(gates, cs, c0, whh, dhs, dhT, dcT, B)
    dw_k = lstm_cuda.lstm_merged_dw(hs, h0, dxp_k, B)
    torch.cuda.synchronize()
    assert [f.launches for f in (lstm_cuda.lstm_merged_train_fwd, lstm_cuda.lstm_merged_bwd_step,
                                 lstm_cuda.lstm_merged_dw)] == [c + 1 for c in counts]
    dxp_p, dw_p, dh0_p, dc0_p = lstm_cuda.lstm_merged_bwd_plain(
        gates, cs, hs, h0, c0, whh, dhs, dhT, dcT, B
    )
    # f32 carries on both sides, but where the f32 sums differ in order the
    # bf16 rounding of a gate cotangent flips, and the reverse chain carries
    # it on: at (37, 8, 16, 512) the plain version on the card against the
    # same plain version on the CPU differs by up to 1.9e-3 of max|ref|
    # (dW), as much as the kernels do; the bound is 5e-3
    for name, k, p in (("dxp", dxp_k, dxp_p), ("dW", dw_k, dw_p), ("dh0", dh0_k, dh0_p),
                       ("dc0", dc0_k, dc0_p)):
        assert _rel(k, p) <= 5e-3, name
    # K6 alone, on the plain dxp: identical bf16 operands, f32 sums in
    # another order
    assert _rel(lstm_cuda.lstm_merged_dw(hs, h0, dxp_p, B), dw_p) <= 1e-5


def test_weight_gradient_is_bit_stable(dev):
    (xp, whh, h0, c0), _ = _train_case(dev, 64, 8, 16, 512, seed=3)
    hs = lstm_cuda.lstm_merged(xp, whh, h0, c0, 16)[0]
    dxp = torch.randn((64, 8 * 16, 2048), device=dev)
    assert torch.equal(lstm_cuda.lstm_merged_dw(hs, h0, dxp, 16),
                       lstm_cuda.lstm_merged_dw(hs, h0, dxp, 16))


@pytest.mark.parametrize(
    "T, R, B, G",
    [(1, 1, 1, 8), (3, 2, 5, 40), (37, 3, 3, 72), (33, 1, 7, 136), (5, 2, 1, 130), (64, 8, 16, 512)],
)
def test_weight_gradient_kernel_at_ragged_shapes(dev, T, R, B, G):
    """K6 alone on the tensor cores: G and 4G that are no multiples of its
    128 x 128 tile (and one G that is no multiple of 4, which takes the
    scalar loads), T*B that is no multiple of its stage of 32; identical
    bf16 operands as the plain version, f32 sums in another order; and the
    same bits from run to run."""
    g = torch.Generator(device=dev).manual_seed(T * G + B)
    hs = torch.randn((T, R * B, G), generator=g, device=dev)
    h0 = torch.randn((R * B, G), generator=g, device=dev)
    dxp = torch.randn((T, R * B, 4 * G), generator=g, device=dev)
    before = lstm_cuda.lstm_merged_dw.launches
    dw = lstm_cuda.lstm_merged_dw(hs, h0, dxp, B)
    torch.cuda.synchronize()
    assert lstm_cuda.lstm_merged_dw.launches == before + 1
    ref = lstm_cuda.lstm_merged_dw_plain(hs, h0, dxp, B)
    assert dw.shape == ref.shape == (R, G, 4 * G)
    assert _rel(dw, ref) <= 1e-5
    assert torch.equal(dw, lstm_cuda.lstm_merged_dw(hs, h0, dxp, B))


def test_training_loss_and_grads_on_the_card_match_cpu(dev):
    """mask_loss and its gradients at a small width: K4/K5/K6 on the card
    against every plain version on the CPU, same weights and batch."""
    import dataclasses

    import numpy as np

    from umx_tpu_torch.config import ModelConfig
    from umx_tpu_torch.models.umx import UMXParams, synthetic_params
    from umx_tpu_torch.train import FROZEN, mask_loss

    cfg = ModelConfig(hidden_size=48)
    rng = np.random.default_rng(4)
    batch = {
        "x": rng.uniform(0, 1, (3, 12, cfg.n_features)),
        "mix_mag": rng.uniform(0, 1, (3, 2, 12, cfg.n_bins)),
        "target_mag": rng.uniform(0, 1, (3, 4, 2, 12, cfg.n_bins)),
    }
    grads = {}
    for d in ("cpu", dev):
        p = synthetic_params(cfg, seed=4, device=d)
        names = [f.name for f in dataclasses.fields(UMXParams) if f.name not in FROZEN]
        for n in names:
            getattr(p, n).requires_grad_(True)
        b = {k: torch.tensor(v, dtype=torch.float32, device=d) for k, v in batch.items()}
        before = lstm_cuda.lstm_merged_dw.launches
        loss = mask_loss(p, b, cfg)
        loss.backward()
        if d != "cpu":
            assert lstm_cuda.lstm_merged_dw.launches == before + cfg.n_lstm_layers
        grads[str(d)] = (loss.item(), {n: getattr(p, n).grad.cpu() for n in names})
    (l_cpu, g_cpu), (l_gpu, g_gpu) = grads["cpu"], grads[str(dev)]
    assert abs(l_gpu - l_cpu) <= 1e-4 * abs(l_cpu)
    # bf16 recurrence operands, cuBLAS summation order: 1e-3 of each max|g|
    for n, g in g_cpu.items():
        assert _rel(g_gpu[n], g) <= 1e-3, n


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
    cpu = Separator(params_from_ggml(model, cfg.model), cfg, "cpu").demix_track(track, seed=1)
    # bf16 recurrence operands and cuFFT/cuBLAS summation order
    assert np.max(np.abs(gpu - cpu)) <= 2e-3 * np.max(np.abs(cpu))


@pytest.mark.parametrize(
    "n_chunks, M, seg, stride",
    [(3, 8, 2646, 1985), (4, 7, 1000, 777), (1, 5, 640, 480), (3, 3, 384, 384), (5, 1, 96, 48)],
)
def test_ola_kernel_bit_equal_to_plain(dev, n_chunks, M, seg, stride):
    """K7 at ragged shapes: odd M, strides that are not multiples of 32,
    one chunk, no overlap, exactly 50 %: bit-equal to the plain version."""
    from umx_tpu_torch.ops import ola, ola_cuda

    g = torch.Generator(device=dev).manual_seed(n_chunks * M)
    ys = torch.randn((n_chunks, M, seg), generator=g, device=dev)
    L = n_chunks * stride + seg - stride
    inv = 1.0 / (torch.rand(L, generator=g, device=dev) + 0.5)
    before = ola_cuda.ola_normalized.launches
    out = ola_cuda.ola_normalized(ys, inv, stride)
    torch.cuda.synchronize()
    assert ola_cuda.ola_normalized.launches == before + 1
    assert torch.equal(out, ola.ola_normalized_plain(ys, inv, stride))
    assert torch.equal(out, ola_cuda.ola_normalized(ys, inv, stride))  # bit-stable


@pytest.mark.parametrize("seg, stride", [(5000, 4099), (64, 48)])
def test_pallas_overlap_add_runs_the_kernel_at_every_stride(dev, seg, stride):
    """ola_impl="pallas" on the card launches K7 also where the stride has
    no divisor in [128, 4096] (where the CPU route, like the JAX package,
    falls back to the slice-adds), and raises above 50 % overlap."""
    from umx_tpu_torch.config import EngineConfig
    from umx_tpu_torch.engine.separator import _normalized_overlap_add, _overlap_add_chunks
    from umx_tpu_torch.ops import ola, ola_cuda

    g = torch.Generator(device=dev).manual_seed(seg)
    n_chunks, mid = 3, (2, 4, 2)
    ys = torch.randn((n_chunks, *mid, seg), generator=g, device=dev)
    w = torch.rand(seg, generator=g, device=dev) + 0.5
    padded_len = (n_chunks - 1) * stride + seg
    cfg = EngineConfig(ola_impl="pallas")
    before = ola_cuda.ola_normalized.launches
    out = _normalized_overlap_add(ys, w, stride, padded_len, cfg)
    torch.cuda.synchronize()
    assert ola_cuda.ola_normalized.launches == before + 1
    inv_sw = 1.0 / _overlap_add_chunks(w.expand(n_chunks, seg), stride, padded_len)
    plain = ola.ola_normalized_plain(ys.reshape(n_chunks, 16, seg), inv_sw, stride)
    assert torch.equal(out, plain.reshape(*mid, padded_len))
    # the CPU's slice-adds / sw: the same sums, then / sw against × 1/sw
    cpu = _normalized_overlap_add(ys.cpu(), w.cpu(), stride, padded_len, cfg)
    assert torch.allclose(out.cpu(), cpu, rtol=1e-6, atol=0)
    with pytest.raises(ValueError, match="at most 50 %"):
        _normalized_overlap_add(ys, w, seg // 3, 2 * (seg // 3) + seg, cfg)
    assert ola_cuda.ola_normalized.launches == before + 1


def test_ola_kernel_refuses_what_it_cannot_take(dev):
    from umx_tpu_torch.ops import ola_cuda

    ys = torch.zeros((3, 2, 512), device=dev)
    with pytest.raises(ValueError, match="seg - stride"):
        ola_cuda.ola_normalized(ys, torch.zeros(3 * 128 + 384, device=dev), 128)
    with pytest.raises(ValueError, match="is on"):
        ola_cuda.ola_normalized(ys, torch.zeros(3 * 384 + 128), 384)


@pytest.mark.parametrize("rows, T, windowed", [
    (1, 1, True), (3, 37, True), (5, 9, False), (2, 200, True), (1, 1, False), (1, 3, True),
    (1, 3, False), (3, 37, False), (5, 9, True), (48, 130, True), (48, 130, False), (500, 2, True),
])
def test_istft_ct_kernel_matches_plain(dev, rows, T, windowed):
    """K8 at ragged frame counts against its plain version (cuFFT irfft
    and the same overlap-add) and a float64 CPU reference: rows shorter
    than the overlap-add ring, runs that end inside a row, more rows than
    the card holds blocks; one launch, the same bits from run to run."""
    from umx_tpu_torch.ops import istft_ct, istft_ct_cuda
    from umx_tpu_torch.ops.stft import hann_window

    g = torch.Generator(device=dev).manual_seed(rows * T)
    re = torch.randn((rows, T, 2049), generator=g, device=dev)
    im = torch.randn((rows, T, 2049), generator=g, device=dev)
    w = hann_window(4096, dev) if windowed else None
    before = istft_ct_cuda.istft_ct2.launches
    out = istft_ct_cuda.istft_ct2(re, im, 4096, 1024, w)
    torch.cuda.synchronize()
    assert istft_ct_cuda.istft_ct2.launches == before + 1
    assert out.shape == (rows, (T - 1) * 1024 + 4096)
    per_row, hops_per_run = istft_ct_cuda.istft_ct2.form
    assert per_row * hops_per_run >= T + 3 > (per_row - 1) * hops_per_run
    plain = istft_ct.istft_ct2_plain(re, im, 4096, 1024, w)
    f64 = istft_ct.istft_ct2_plain(re.cpu().double(), im.cpu().double(), 4096, 1024,
                                   w.cpu().double() if windowed else None)
    # unit-normal planes: f32 sums over 2049 bins in other orders
    assert (out - plain).abs().max().item() <= 1e-5
    assert (out.cpu().double() - f64).abs().max().item() <= 1e-6
    assert torch.equal(out, istft_ct_cuda.istft_ct2(re, im, 4096, 1024, w))


def test_istft_ct_kernel_allocates_no_frames_buffer(dev):
    """One launch keeps every frame on chip: beyond its inputs the call
    holds the output signal and nothing of the frames' size."""
    from umx_tpu_torch.ops import istft_ct_cuda

    rows, T = 8, 300
    re = torch.randn((rows, T, 2049), device=dev)
    im = torch.randn((rows, T, 2049), device=dev)
    istft_ct_cuda.istft_ct2(re, im, 4096, 1024)  # the table and the capacity are cached
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = istft_ct_cuda.istft_ct2(re, im, 4096, 1024)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    frames = rows * T * 4096 * 4
    assert extra < out.numel() * 4 + frames // 8, (extra, frames)


def test_istft_ct_kernel_refuses_other_geometry(dev):
    from umx_tpu_torch.ops import istft_ct_cuda

    re = torch.zeros((2, 4, 2049), device=dev)
    before = istft_ct_cuda.istft_ct2.launches
    with pytest.raises(ValueError, match="hop == n_fft/4"):
        istft_ct_cuda.istft_ct2(re, re, 4096, 512)
    small = torch.zeros((2, 4, 751), device=dev)
    with pytest.raises(ValueError, match="1024 | n_fft"):
        istft_ct_cuda.istft_ct2(small, small, 1500, 375)
    big = torch.zeros((2, 4, 4097), device=dev)
    with pytest.raises(ValueError, match="n_fft = 4096"):
        istft_ct_cuda.istft_ct2(big, big, 8192, 2048)
    assert istft_ct_cuda.istft_ct2.launches == before


def test_dense_istft_on_the_card_ignores_dc_and_nyquist_imaginary_parts(dev):
    """cuFFT's C2R assumes the DC and Nyquist imaginary parts are 0; the
    inverse sets them so, and agrees with the CPU where they are not."""
    from umx_tpu_torch.config import DSPConfig
    from umx_tpu_torch.ops.stft import istft_planes

    g = torch.Generator(device=dev).manual_seed(11)
    re = torch.randn((8, 300, 2049), generator=g, device=dev)
    im = torch.randn((8, 300, 2049), generator=g, device=dev)
    gpu = istft_planes(re, im, 300 * 1024, DSPConfig())
    cpu = istft_planes(re.cpu(), im.cpu(), 300 * 1024, DSPConfig())
    assert (gpu.cpu() - cpu).abs().max().item() <= 1e-5


def test_batched_whole_track_on_the_card_matches_cpu(dev):
    """Non-streaming chunk groups, two batched shift passes, K7 and K8 on
    the card against the CPU's plain versions, same weights and track."""
    import numpy as np

    from umx_tpu_torch.config import DSPConfig, EngineConfig, ModelConfig, SegmentConfig
    from umx_tpu_torch.engine.separator import Separator
    from umx_tpu_torch.io.ggml import GGMLModel
    from umx_tpu_torch.models.umx import params_from_ggml, synthetic_state_dicts
    from umx_tpu_torch.ops import istft_ct_cuda, ola_cuda

    cfg = EngineConfig(
        dsp=DSPConfig(istft_algo="ct2"), model=ModelConfig(hidden_size=48),
        segment=SegmentConfig(segment_secs=1.0, streaming=False, chunk_batch=0),
        shifts=2, ola_impl="pallas",
    )
    model = GGMLModel(48, synthetic_state_dicts(cfg.model, seed=3))
    track = np.random.default_rng(3).standard_normal((2, 100_000)).astype(np.float32) * 0.1
    k7, k8 = ola_cuda.ola_normalized.launches, istft_ct_cuda.istft_ct2.launches
    gpu = Separator(params_from_ggml(model, cfg.model, dev), cfg, dev).demix_track(track, seed=1)
    assert ola_cuda.ola_normalized.launches > k7 and istft_ct_cuda.istft_ct2.launches > k8
    cpu = Separator(params_from_ggml(model, cfg.model), cfg, "cpu").demix_track(track, seed=1)
    assert np.max(np.abs(gpu - cpu)) <= 2e-3 * np.max(np.abs(cpu))


def _pertarget_inputs(dev, T, G, seed, n_targets=4, D=2):
    g = torch.Generator(device=dev).manual_seed(seed)
    x_proj = torch.randn((n_targets, T, D, 4 * G), generator=g, device=dev)
    whh = (torch.randn((n_targets, D, G, 4 * G), generator=g, device=dev) / G**0.5).to(
        torch.bfloat16)
    h0 = 0.5 * torch.randn((n_targets, D, G), generator=g, device=dev)
    c0 = 0.5 * torch.randn((n_targets, D, G), generator=g, device=dev)
    return x_proj, whh, h0, c0


@pytest.mark.parametrize("G", [64, 256, 512])
@pytest.mark.parametrize("T", [1, 2, 37, 300])
def test_pertarget_lstm_kernel_matches_plain(dev, G, T):
    args = _pertarget_inputs(dev, T, G, seed=G + T)
    before = lstm_cuda.lstm_layer_pertarget.launches
    out_k = lstm_cuda.lstm_layer_pertarget(*args)
    torch.cuda.synchronize()
    assert lstm_cuda.lstm_layer_pertarget.launches == before + 1
    cluster, held, waves = lstm_cuda.lstm_layer_pertarget.form
    assert cluster >= 1 and held >= 1 and waves == -(-8 // held)
    out_p = lstm_cuda.lstm_pertarget_plain(*args)
    # as the merged kernel: bf16 operands, f32 sums in another order; a
    # flipped bf16 rounding of h moves a gate by ~1e-3 at most
    for k, p in zip(out_k, out_p):
        assert k.shape == p.shape
        assert (k - p).abs().max().item() <= 5e-3
    # h0/c0 are inputs only
    assert torch.equal(args[3], _pertarget_inputs(dev, T, G, seed=G + T)[3])


@pytest.mark.parametrize("G", [16, 40, 72, 128, 200, 256, 512, 640])
def test_pertarget_lstm_kernel_cluster_sizes(dev, G):
    """Widths that take clusters from 1 to 16 blocks, some with a last
    block that owns fewer units than the others (G = 72 in two blocks of
    40): idle warps and blocks still keep the barriers.  The form that ran
    is the chooser's pick among what the device reports, and the result
    has the same bits from run to run."""
    n_targets, D = 2, 2
    args = _pertarget_inputs(dev, 29, G, seed=11, n_targets=n_targets, D=D)
    ref = lstm_cuda.lstm_pertarget_plain(*args)
    out = lstm_cuda.lstm_layer_pertarget(*args)
    torch.cuda.synchronize()
    cluster, held, waves = lstm_cuda.lstm_layer_pertarget.form
    placeable = lstm_cuda._pertarget_placeable(dev.index or 0, G, n_targets * D)
    assert placeable[cluster] == held and waves == -(-n_targets * D // held)
    assert (cluster, lstm_cuda.pertarget_units_per_block(G, cluster), waves) == (
        lstm_cuda.pertarget_cluster_choice(G, n_targets * D, placeable))
    assert all(1 <= cl <= 16 and n >= 1 for cl, n in placeable.items())
    for k, p in zip(out, ref):
        assert (k - p).abs().max().item() <= 5e-3
    again = lstm_cuda.lstm_layer_pertarget(*args)
    assert all(torch.equal(a, b) for a, b in zip(again, out))


def test_pertarget_lstm_kernel_is_bit_stable_at_the_segment_shape(dev):
    """UMX-L's 8 chains at G = 512: fixed order of every sum, so two runs
    agree bit for bit; and they run in as few waves as the device allows."""
    args = _pertarget_inputs(dev, 300, 512, seed=5)
    a = lstm_cuda.lstm_layer_pertarget(*args)
    b = lstm_cuda.lstm_layer_pertarget(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    cluster, held, waves = lstm_cuda.lstm_layer_pertarget.form
    placeable = lstm_cuda._pertarget_placeable(dev.index or 0, 512, 8)
    fewest = min(-(-8 // n) for cl, n in placeable.items()
                 if lstm_cuda.pertarget_units_per_block(512, cl) <= lstm_cuda.PERTARGET_MAX_UNITS)
    assert waves == fewest


def test_pertarget_lstm_kernel_agrees_with_the_merged_kernel(dev):
    x_proj, whh, h0, c0 = _pertarget_inputs(dev, 50, 512, seed=3)
    hs, hT, cT = lstm_cuda.lstm_layer_pertarget(x_proj, whh, h0, c0)
    mhs, mhT, mcT = lstm_cuda.lstm_layer_merged_batched(x_proj[None], whh, h0[None], c0[None])
    for k, m in ((hs, mhs[0]), (hT, mhT[0]), (cT, mcT[0])):
        assert (k - m).abs().max().item() <= 5e-3


def test_pertarget_lstm_kernel_refuses_what_it_cannot_take(dev):
    before = lstm_cuda.lstm_layer_pertarget.launches
    # a block of 64 units cannot hold its share of 1024 x 4096 bf16 in registers and
    # shared memory
    with pytest.raises(RuntimeError, match="no cluster of up to 16 blocks"):
        lstm_cuda.lstm_layer_pertarget(*_pertarget_inputs(dev, 3, 1024, seed=1, n_targets=1, D=1))
    x_proj, whh, h0, c0 = _pertarget_inputs(dev, 3, 512, seed=1, n_targets=1, D=1)
    with pytest.raises(ValueError, match="h0 is on"):
        lstm_cuda.lstm_layer_pertarget(x_proj, whh, h0.cpu(), c0)
    x20 = _pertarget_inputs(dev, 3, 20, seed=1, n_targets=1, D=1)
    with pytest.raises(ValueError, match="G % 8"):
        lstm_cuda.lstm_layer_pertarget(*x20)
    assert lstm_cuda.lstm_layer_pertarget.launches == before


@pytest.mark.parametrize("T, F", [(19, 2049), (130, 2049), (67, 300)])
@pytest.mark.parametrize("iterations", [1, 2])
def test_wiener_mags_kernels_match_plain(dev, T, F, iterations):
    g = torch.Generator(device=dev).manual_seed(T + F)
    xre = 30 * torch.randn((2, T, F), generator=g, device=dev)
    xim = 30 * torch.randn((2, T, F), generator=g, device=dev)
    xre[0, 3, 5:40] = 0.0
    xim[0, 3, 5:40] = 0.0  # |x| = 0: the unit phasor is 1 + 0i
    mags = 40 * torch.rand((4, 2, T, F), generator=g, device=dev)
    cfg = WienerConfig(iterations=iterations)
    before = (wiener_cuda.wiener_reduce.launches, wiener_cuda.wiener_apply.launches)
    yk = wiener_cuda.wiener_planes_from_mags(xre, xim, mags, cfg)
    torch.cuda.synchronize()
    assert (wiener_cuda.wiener_reduce.launches, wiener_cuda.wiener_apply.launches) == (
        before[0] + iterations, before[1] + iterations)
    ycpu = wiener_cuda.wiener_planes_from_mags(xre.cpu(), xim.cpu(), mags.cpu(), cfg)
    # same f32 operations per element; rsqrtf against torch.rsqrt differs
    # in the last place, summation order and FMA differ: 1e-4 of max|y|
    for k, p in zip(yk, ycpu):
        assert torch.isfinite(k).all()
        assert (k.cpu() - p).abs().max().item() <= 1e-4 * p.abs().max().item()
    # each pass alone against its plain version on the card
    inv = wiener_cuda.inv_max_abs(xre, xim, 10.0)
    racc = wiener_cuda.wiener_reduce("mags", xre, xim, mags, None, inv)
    racc_p = wiener_cuda.wiener_reduce_plain("mags", xre, xim, mags, inv)
    assert _rel(racc, racc_p) <= 1e-4
    y_k = wiener_cuda.wiener_apply("mags", xre, xim, mags, None, racc_p, inv, 1e-10)
    y_p = wiener_cuda.wiener_apply_plain("mags", xre, xim, mags, None, racc_p, inv, 1e-10)
    for k, p in zip(y_k, y_p):
        assert _rel(k, p) <= 1e-4


def test_catalogue_slice_on_the_card_matches_cpu(dev):
    """The per-target kernel, a forced window and the fleet runner at a
    small width, dense and quantized weights: the card against the CPU's
    plain versions."""
    import numpy as np

    from umx_tpu_torch.config import EngineConfig, ModelConfig, SegmentConfig
    from umx_tpu_torch.engine.fleet import demix_tracks
    from umx_tpu_torch.engine.separator import Separator
    from umx_tpu_torch.io.ggml import read_ggml_bytes, write_ggml_bytes
    from umx_tpu_torch.models.umx import (
        params_from_ggml, quantized_params_from_ggml, synthetic_state_dicts,
    )

    cfg = EngineConfig(model=ModelConfig(hidden_size=128, lstm_impl="pallas"),
                       segment=SegmentConfig(segment_secs=1.0, window_chunks=2), shifts=1)
    model = read_ggml_bytes(write_ggml_bytes(128, synthetic_state_dicts(cfg.model, seed=0)),
                            keep_quantized=True)
    t = np.arange(int(2.6 * 44100)) / 44100
    rng = np.random.default_rng(0)
    tracks = [np.stack([0.4 * np.sin(2 * np.pi * 220 * t[:n]) + 0.05 * rng.standard_normal(n),
                        0.3 * np.sin(2 * np.pi * 330 * t[:n]) + 0.05 * rng.standard_normal(n)]
                       ).astype(np.float32) for n in (t.size, 40_000)]
    for build in (params_from_ggml, quantized_params_from_ggml):
        outs = {}
        for d in ("cpu", dev):
            sep = Separator(build(model, cfg.model, d), cfg, d)
            before = lstm_cuda.lstm_layer_pertarget.launches
            stats: dict = {}
            outs[str(d)] = demix_tracks(sep, tracks, stats=stats)
            assert stats["windowed_tracks"] == 1 and stats["rows"] == 1
            if d != "cpu":
                assert lstm_cuda.lstm_layer_pertarget.launches > before
        for a, b in zip(outs[str(dev)], outs["cpu"]):
            assert np.isfinite(a).all()
            err = np.abs(a - b).max() / np.abs(b).max()
            db = 20 * np.log10(np.linalg.norm(a - b) / np.linalg.norm(b))
            if build is params_from_ggml:
                # bf16 recurrence operands, cuFFT/cuBLAS summation order
                assert err <= 2e-3, f"dense: max|err|/max|stem| {err:.3g} ({db:.1f} dB)"
            else:
                # The quantized network rounds its activations to bf16 before
                # every product, so those last-bit differences flip roundings
                # and the stems differ by bf16 noise, not by the dense path's
                # f32 class.  The gate is on the error's energy: 20 dB below
                # the stems' at this width, where one flipped rounding weighs
                # eight times what it does among UMX-L's 1024 units.
                assert db <= -20.0, f"quantized: {db:.1f} dB, max|err|/max|stem| {err:.3g}"


def test_windowed_device_tensor_on_the_card(dev):
    """A track already on the card runs windowed into one resident result
    buffer and equals the host-array route and the single program."""
    import numpy as np

    from umx_tpu_torch.config import EngineConfig, ModelConfig, SegmentConfig
    from umx_tpu_torch.engine.separator import Separator
    from umx_tpu_torch.models.umx import synthetic_params

    rng = np.random.default_rng(7)
    track = rng.uniform(-0.5, 0.5, (2, int(2.1 * 44100))).astype(np.float32)
    model = ModelConfig(hidden_size=64)
    params = synthetic_params(model, seed=0, device=dev)

    def sep(W):
        return Separator(params, EngineConfig(model=model, segment=SegmentConfig(
            segment_secs=0.5, window_chunks=W), shifts=0), dev)

    single = sep(-1).demix(track)
    on_card = sep(4).demix(torch.from_numpy(track).to(dev))
    from_host = sep(4).demix(track)
    assert on_card.is_cuda and single.is_cuda and from_host.device.type == "cpu"
    assert torch.equal(on_card, single)
    assert torch.equal(from_host, single.cpu())


# ---------------------------------------------------------------------------
# K7 at the geometries of its CPU mirror (tests/test_torch_ola.py): strides
# that take the vector body or only scalars, no tail or a tail of a stride
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("M", [1, 3, 16])
@pytest.mark.parametrize("with_tail", [False, True])
@pytest.mark.parametrize("stride", [1, 3, 4, 1023, 1_984_500])
def test_ola_kernel_at_the_mirror_geometries(dev, stride, with_tail, M):
    from umx_tpu_torch.ops import ola, ola_cuda

    n_chunks = 3
    seg = stride * (2 if with_tail else 1)
    g = torch.Generator(device=dev).manual_seed(stride + M)
    ys = torch.randn((n_chunks, M, seg), generator=g, device=dev)
    L = n_chunks * stride + seg - stride
    inv = 1.0 / (torch.rand(L, generator=g, device=dev) + 0.5)
    before = ola_cuda.ola_normalized.launches
    out = ola_cuda.ola_normalized(ys, inv, stride)
    torch.cuda.synchronize()
    assert ola_cuda.ola_normalized.launches == before + 1
    assert torch.equal(out, ola.ola_normalized_plain(ys, inv, stride))
    assert torch.equal(out, ola_cuda.ola_normalized(ys, inv, stride))  # bit-stable


# ---------------------------------------------------------------------------
# K2 in all three modes at the shapes of its CPU mirror
# (tests/test_torch_wiener_mags.py): one launch a call, bit-stable
# ---------------------------------------------------------------------------


def _device_kernels(fn):
    """The names of the kernels that ``fn()`` launched on the card."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]


@pytest.mark.parametrize("mode", ["masks", "y", "mags"])
@pytest.mark.parametrize("T", [1, 37, 64, 65, 2584])
@pytest.mark.parametrize("F", [1, 5, 2049])
def test_wiener_reduce_one_launch_bit_stable(dev, mode, T, F):
    g = torch.Generator(device=dev).manual_seed(T * 7 + F)
    xre = 30 * torch.randn((2, T, F), generator=g, device=dev)
    xim = 30 * torch.randn((2, T, F), generator=g, device=dev)
    xre[0, 0, : F // 2] = 0.0
    xim[0, 0, : F // 2] = 0.0  # |x| = 0: the unit phasor is 1 + 0i
    inv = wiener_cuda.inv_max_abs(xre, xim, 10.0)
    if mode == "masks":
        first, second = torch.rand((4, T, 2 * F), generator=g, device=dev), None
        plain_in = (xre, xim, first)
    elif mode == "mags":
        first, second = 40 * torch.rand((4, 2, T, F), generator=g, device=dev), None
        plain_in = (xre, xim, first)
    else:
        first = torch.randn((4, 2, T, F), generator=g, device=dev) / 3
        second = torch.randn((4, 2, T, F), generator=g, device=dev) / 3
        plain_in = (first, second, None)
    before = wiener_cuda.wiener_reduce.launches
    racc, kernels = _device_kernels(
        lambda: wiener_cuda.wiener_reduce(mode, xre, xim, first, second, inv))
    assert wiener_cuda.wiener_reduce.launches == before + 1
    assert len(kernels) == 1 and "wiener_reduce_kernel" in kernels[0], kernels
    plain = wiener_cuda.wiener_reduce_plain(mode, *plain_in, inv)
    # float32 sums in another order than torch's along T, and FMA: 1e-4
    assert _rel(racc, plain) <= 1e-4
    assert torch.equal(racc, wiener_cuda.wiener_reduce(mode, xre, xim, first, second, inv))


def test_host_loop_demix_on_the_card_matches_cpu(dev):
    """demix(fused=False): one segment call per chunk on the card, against
    the same loop on the CPU's plain versions."""
    import numpy as np

    from umx_tpu_torch.config import EngineConfig, ModelConfig, SegmentConfig
    from umx_tpu_torch.engine.separator import Separator
    from umx_tpu_torch.models.umx import synthetic_params

    cfg = EngineConfig(model=ModelConfig(hidden_size=64), segment=SegmentConfig(segment_secs=1.0))
    track = np.random.default_rng(4).uniform(-0.5, 0.5, (2, int(2.6 * 44100))).astype(np.float32)
    seen = []
    gpu = Separator(synthetic_params(cfg.model, seed=0, device=dev), cfg, dev).demix(
        track, progress=seen.append, fused=False)
    cpu = Separator(synthetic_params(cfg.model, seed=0), cfg, "cpu").demix(track, fused=False)
    assert gpu.is_cuda and len(seen) > 1 and seen[-1] == 1.0
    # bf16 recurrence operands and cuFFT/cuBLAS summation order
    assert (gpu.cpu() - cpu).abs().max().item() <= 2e-3 * cpu.abs().max().item()


def _serving_setup(dev, n_jobs, seed):
    import numpy as np

    from umx_tpu_torch.config import EngineConfig, ModelConfig, SegmentConfig
    from umx_tpu_torch.models.umx import LSTMState, init_lstm_state, synthetic_params

    cfg = EngineConfig(model=ModelConfig(hidden_size=64), segment=SegmentConfig(segment_secs=1.0))
    params = synthetic_params(cfg.model, seed=0, device=dev)
    n = cfg.segment.segment_samples(44100)
    rng = np.random.default_rng(seed)
    shape = init_lstm_state(cfg.model).h.shape
    jobs = [
        (torch.from_numpy(rng.uniform(-0.5, 0.5, (2, n)).astype(np.float32)).to(dev),
         LSTMState(h=torch.from_numpy(rng.uniform(-0.5, 0.5, shape).astype(np.float32)).to(dev),
                   c=torch.from_numpy(rng.uniform(-0.5, 0.5, shape).astype(np.float32)).to(dev)))
        for _ in range(n_jobs)
    ]
    return cfg, params, n, jobs


def test_served_rows_on_the_card_are_bit_equal_to_rows_alone(dev):
    """Three requests' segments coalesced by the batcher into one call of
    exactly three rows (K1 at three rows per chain) have the bits of each
    segment run alone (K1 at one row)."""
    import threading

    from umx_tpu_torch.engine.batcher import SegmentBatcher
    from umx_tpu_torch.engine.separator import segment_forward

    cfg, params, n, jobs = _serving_setup(dev, 3, seed=6)
    batcher = SegmentBatcher(max_batch=3, max_wait_ms=5000.0)
    results = [None] * 3
    before = lstm_cuda.lstm_merged.launches
    try:
        def post(i):
            results[i] = batcher.run(params, jobs[i][0], jobs[i][1], cfg, n)

        threads = [threading.Thread(target=post, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert batcher.stats.device_calls == 1 and batcher.stats.max_batch_observed == 3
    finally:
        batcher.close()
    assert lstm_cuda.lstm_merged.launches == before + cfg.model.n_lstm_layers
    with torch.inference_mode():
        for (audio, state), (out, new_state) in zip(jobs, results):
            want, want_state = segment_forward(params, audio, state, cfg, n)
            assert out.is_cuda and torch.equal(out, want)
            assert torch.equal(new_state.h, want_state.h)
            assert torch.equal(new_state.c, want_state.c)


def test_batcher_waits_on_an_event_not_the_device(dev, monkeypatch):
    """The batcher's completion barrier is an event recorded after its
    call: when ``run`` returns the call's work is done (the stream is
    idle), ``busy_s`` counts it, and ``torch.cuda.synchronize`` (which
    would wait for other threads' work as well) is never called."""
    from umx_tpu_torch.engine.batcher import SegmentBatcher

    cfg, params, n, jobs = _serving_setup(dev, 1, seed=7)

    def no_sync(*a, **kw):
        raise AssertionError("the batcher called torch.cuda.synchronize")

    batcher = SegmentBatcher(max_batch=1)
    try:
        batcher.run(params, *jobs[0], cfg, n)  # the first call builds the kernels
        batcher.reset_stats()
        monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
        out, _ = batcher.run(params, *jobs[0], cfg, n)
        assert torch.cuda.current_stream(dev).query()
        assert batcher.stats.device_calls == 1 and batcher.stats.busy_s > 0.0
        assert 0.0 < batcher.utilization() <= 1.0
    finally:
        batcher.close()


def test_streaming_on_the_card_matches_offline(dev):
    """A stream pushed in odd pieces on the card against the offline host
    loop on the card: the same segment calls, so within 1e-5."""
    import numpy as np

    from umx_tpu_torch.config import EngineConfig, ModelConfig, SegmentConfig
    from umx_tpu_torch.engine.separator import Separator
    from umx_tpu_torch.engine.streaming import StreamingDemixer
    from umx_tpu_torch.models.umx import synthetic_params

    cfg = EngineConfig(model=ModelConfig(hidden_size=64), segment=SegmentConfig(segment_secs=1.0),
                       shifts=0)
    params = synthetic_params(cfg.model, seed=0, device=dev)
    track = np.random.default_rng(8).uniform(-0.5, 0.5, (2, int(2.6 * 44100))).astype(np.float32)
    sd = StreamingDemixer(params, cfg, dev)
    pieces = [sd.push(track[:, s : s + 30_000]) for s in range(0, track.shape[1], 30_000)]
    stems = np.concatenate([*pieces, sd.flush()], axis=-1)
    want = Separator(params, cfg, dev).demix(track, fused=False).cpu().numpy()
    assert stems.shape == want.shape
    assert np.max(np.abs(stems - want)) <= 1e-5 * np.max(np.abs(want))


def _bss_sources(J, C, T, seed):
    """Noise plus one tone per source, as the sources of tests/test_bss.py."""
    import numpy as np

    rng = np.random.default_rng(seed)
    s = rng.standard_normal((J, C, T))
    t = np.arange(T)
    for j in range(J):
        s[j] += 2.0 * np.sin(2 * np.pi * 50 * (j + 1) * t / T)[None, :]
    return s, s + 0.05 * rng.standard_normal(s.shape)


@pytest.mark.parametrize("J, T, window, flen", [(3, 8000, 4000, 16), (4, 2 * 44100, 44100, 512)])
def test_bss_batched_solve_on_the_card_matches_float64(dev, J, T, window, flen):
    """The v3 evaluator's batched float32 solves on the card against the
    float64 host evaluation of each window: within 0.1 dB (the bound of
    tests/test_bss.py); at J = 4, flen 512 the museval shape (N = 4096)."""
    import numpy as np

    from umx_tpu_torch.eval.bss import bss_eval_window, bss_eval_window_batch

    refs, ests = _bss_sources(J, 2, T, seed=J)
    W = T // window
    refs_w = np.stack([refs[..., w * window : (w + 1) * window] for w in range(W)])
    ests_w = np.stack([ests[..., w * window : (w + 1) * window] for w in range(W)])
    batched = bss_eval_window_batch(refs_w, ests_w, flen=flen)  # no device given: the card
    for w in range(W):
        single = bss_eval_window(refs_w[w], ests_w[w], flen=flen)
        for m_b, m_s in zip(batched, single):
            assert np.isfinite(m_b[w]).all()
            np.testing.assert_allclose(m_b[w], m_s, atol=0.1)


def test_stage_timer_block_on_waits_for_the_tensor(dev):
    from umx_tpu_torch.utils.profiling import StageTimer

    a = torch.randn((4096, 4096), device=dev)
    torch.cuda.synchronize(dev)
    timer = StageTimer()
    done = torch.cuda.Event(enable_timing=True)
    start = torch.cuda.Event(enable_timing=True)
    start.record()
    with timer.stage("matmuls", block_on={"out": [a]}):
        for _ in range(20):
            a = a @ a / 64.0
        done.record()
    assert done.query(), "the stage ended before the tensor's work did"
    # the stage's wall time holds the device time of its work
    assert timer.totals["matmuls"] * 1000 >= start.elapsed_time(done) * 0.99


def test_device_trace_records_a_cuda_kernel(dev, tmp_path):
    import json
    import os

    from umx_tpu_torch.utils.profiling import device_trace

    a = torch.randn((512, 512), device=dev)
    with device_trace(str(tmp_path / "trace")) as prof:  # no device given: the card
        (a @ a).sum()
    files = [f for f in os.listdir(tmp_path / "trace") if f.endswith(".pt.trace.json")]
    assert len(files) == 1
    events = json.load(open(tmp_path / "trace" / files[0]))["traceEvents"]
    assert any(e.get("cat") == "kernel" for e in events), "no CUDA kernel in the trace"
    assert sum(e.device_time_total for e in prof.key_averages()) > 0


def test_evaluate_musdb_runs_on_the_card_by_default(dev, tmp_path, capsys):
    import json

    import numpy as np
    from scipy.io import wavfile

    from umx_tpu_torch.config import TARGETS, ModelConfig
    from umx_tpu_torch.io.ggml import write_ggml
    from umx_tpu_torch.models.umx import synthetic_state_dicts
    from umx_tpu_torch.scripts import evaluate_musdb

    rng = np.random.default_rng(3)
    track = tmp_path / "test" / "track_0"
    track.mkdir(parents=True)
    stems = [0.2 * rng.standard_normal((3 * 44100, 2)).astype(np.float32) for _ in TARGETS]
    for name, s in zip(TARGETS, stems):
        wavfile.write(str(track / f"{name}.wav"), 44100, s)
    wavfile.write(str(track / "mixture.wav"), 44100, np.sum(stems, axis=0))
    model = str(tmp_path / "model.bin")
    write_ggml(model, 64, synthetic_state_dicts(ModelConfig(hidden_size=64), seed=0))
    before = lstm_cuda.lstm_merged.launches
    out = tmp_path / "res.json"
    assert evaluate_musdb.main([model, str(tmp_path / "test"), "--segment-secs", "1.0",
                                "--flen", "64", "--out", str(out)]) == 0
    assert lstm_cuda.lstm_merged.launches > before  # the recurrence ran on the card
    res = json.loads(out.read_text())
    assert all(np.isfinite(v) for m in res["median"].values() for v in m.values())
