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


def _f32_seams(cfg):
    """``cfg`` with the three storage seams pinned to float32: where the
    card is held against the CPU's plain versions, both sides store what
    the CPU's "auto" stores (the card's "auto" is bfloat16)."""
    import dataclasses

    return dataclasses.replace(cfg, mask_dtype="float32", stems_stack_dtype="float32",
                               wiener=dataclasses.replace(cfg.wiener, out_dtype="float32"))


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
    # a width whose W_hh slice does not fit a warp's registers takes the
    # wide form: one launch each, against plain
    wide = _lstm_inputs(dev, 2, 1, 1, 520, seed=3)
    for k, p in zip(lstm_cuda.lstm_merged(*wide, 1), lstm_cuda.lstm_merged_plain(*wide, 1)):
        assert (k - p).abs().max().item() <= 5e-3
    assert lstm_cuda.lstm_merged.form[0] == "wide"
    fwd = lstm_cuda.lstm_merged_train_fwd(*wide, 1)
    z = torch.zeros((2, 1, 520), device=dev)
    args = (fwd[3], fwd[4], wide[3], wide[1], z, z[0], z[0], 1)
    for k, p in zip(lstm_cuda.lstm_merged_bwd_step(*args),
                    lstm_cuda.lstm_merged_bwd_step_plain(*args)):
        assert (k - p).abs().max().item() <= 5e-3
    assert [f.launches for f in wrappers] == [n + 1 for n in before]
    # what no form takes is still refused before any launch
    with pytest.raises(ValueError, match="h0 is on"):
        lstm_cuda.lstm_merged(wide[0], wide[1], wide[2].cpu(), wide[3], 1)
    assert [f.launches for f in wrappers] == [n + 1 for n in before]


# (T, R, B, G): zero-unit padding (G 18, 20: the resident form at 24) and
# the wide forms (G 520, 640: 13 and 16 blocks of 40 units a chain, R 8 in
# one wave; G 1024: 32 blocks of 32 units, two chain groups of four)
_WIDTHS = [(9, 8, 1, 18), (11, 8, 3, 20), (7, 2, 17, 18), (6, 2, 3, 520), (5, 8, 1, 640),
           (4, 2, 17, 640), (3, 8, 2, 1024)]


@pytest.mark.parametrize("T, R, B, G", _WIDTHS)
def test_merged_kernels_take_every_width(dev, T, R, B, G):
    """K1, K4 and K5 at widths the resident kernels do not hold as they
    are: against their plain versions (5e-3), K4's hs/hT/cT K1's bits,
    rows bit-equal to themselves run alone, and the form chosen from G."""
    (xp, whh, h0, c0), (dhs, dhT, dcT) = _train_case(dev, T, R, B, G, seed=G + B)
    wide = lstm_cuda.merged_form(G) == "wide"
    k1 = lstm_cuda.lstm_merged(xp, whh, h0, c0, B)
    fwd = lstm_cuda.lstm_merged_train_fwd(xp, whh, h0, c0, B)
    torch.cuda.synchronize()
    for wrapper in (lstm_cuda.lstm_merged, lstm_cuda.lstm_merged_train_fwd):
        assert (wrapper.form[0] == "wide") == wide
        assert wide or wrapper.form[0] == lstm_cuda.resident_blocks_per_chain(
            lstm_cuda.merged_width(G))
    for a, b in zip(fwd[:3], k1):
        assert torch.equal(a, b)
    for name, k, p in zip(("hs", "hT", "cT", "gates", "cs"), fwd,
                          lstm_cuda.lstm_merged_train_fwd_plain(xp, whh, h0, c0, B)):
        assert k.shape == p.shape and (k - p).abs().max().item() <= 5e-3, name
    _, _, _, gates, cs = fwd
    bwd = lstm_cuda.lstm_merged_bwd_step(gates, cs, c0, whh, dhs, dhT, dcT, B)
    torch.cuda.synchronize()
    assert (lstm_cuda.lstm_merged_bwd_step.form[0] == "wide") == wide
    for name, k, p in zip(("dxp", "dh0", "dc0"), bwd, lstm_cuda.lstm_merged_bwd_step_plain(
            gates, cs, c0, whh, dhs, dhT, dcT, B)):
        assert k.shape == p.shape and _rel(k, p) <= 5e-3, name
    for picks in ([0], [B - 1], sorted({0, B // 2, B - 1})):
        rows = torch.tensor([r * B + b for r in range(R) for b in picks], device=dev)

        def sub(x):
            return (x[:, rows] if x.dim() == 3 else x[rows]).contiguous()

        one = lstm_cuda.lstm_merged(sub(xp), whh, sub(h0), sub(c0), len(picks))
        assert all(torch.equal(a, sub(b)) for a, b in zip(one, k1)), picks
        one = lstm_cuda.lstm_merged_bwd_step(sub(gates), sub(cs), sub(c0), whh, sub(dhs),
                                             sub(dhT), sub(dcT), len(picks))
        assert all(torch.equal(a, sub(b)) for a, b in zip(one, bwd)), picks
    again = lstm_cuda.lstm_merged(xp, whh, h0, c0, B)
    assert all(torch.equal(a, b) for a, b in zip(again, k1))  # bit-stable


@pytest.mark.parametrize("G", [520, 640, 1024, 1600])
def test_wide_block_forms_hold_w_hh_on_the_chip(dev, G):
    """The wide K1 and K4 (G above 512) in the block form
    ``merged_wide_plan`` picks from the card's figures: its shared memory
    as the kernel reports it, against plain (5e-3) and against the streaming
    yardstick run by name (5e-3: both bf16(h) x bf16(W_hh) summed in f32, in
    other orders), K4's hs/hT/cT the same bits, rows bit-equal alone, every
    row group and chain group of the plan."""
    T, R, B = 6, 8, 17
    xp, whh, h0, c0 = _lstm_inputs(dev, T, R, B, G, seed=G)
    plan = lstm_cuda.merged_wide_plan(G, R, *lstm_cuda.device_limits(dev.index))
    assert plan is not None and plan.kreg + plan.ksmem == -(-G // 16)
    blocks, smem = lstm_cuda.merged_layout(dev.index, G, False, plan.warps, plan.rows)
    assert smem == plan.smem and blocks >= plan.blocks_per_chain * plan.chains_per_group
    k1 = lstm_cuda.lstm_merged(xp, whh, h0, c0, B)
    torch.cuda.synchronize()
    form = lstm_cuda.lstm_merged.form
    assert form[0] == "wide" and form[1] == plan.blocks_per_chain and form[5] == plan.units
    assert form[4] == len(lstm_cuda.resident_row_groups(B, plan.rows))
    fwd = lstm_cuda.lstm_merged_train_fwd(xp, whh, h0, c0, B)
    assert lstm_cuda.lstm_merged_train_fwd.form[0] == "wide"
    assert all(torch.equal(a, b) for a, b in zip(fwd[:3], k1))
    for name, k, p in zip(("hs", "hT", "cT", "gates", "cs"), fwd,
                          lstm_cuda.lstm_merged_train_fwd_plain(xp, whh, h0, c0, B)):
        assert (k - p).abs().max().item() <= 5e-3, name
    streaming = lstm_cuda.lstm_merged(xp, whh, h0, c0, B, _form="wide_streaming")
    assert lstm_cuda.lstm_merged.form[0] == "wide_streaming"
    for k, y in zip(k1, streaming):
        assert (k - y).abs().max().item() <= 5e-3
    for picks in ([0], [B - 1], [1, 8, 9, 16]):
        rows = torch.tensor([r * B + b for r in range(R) for b in picks], device=dev)

        def sub(x):
            return (x[:, rows] if x.dim() == 3 else x[rows]).contiguous()

        one = lstm_cuda.lstm_merged(sub(xp), whh, sub(h0), sub(c0), len(picks))
        assert all(torch.equal(a, sub(b)) for a, b in zip(one, k1)), picks
    assert all(torch.equal(a, b) for a, b in zip(lstm_cuda.lstm_merged(xp, whh, h0, c0, B), k1))


def test_wide_forms_are_chosen_from_the_width(dev):
    """Above the widest G a block form holds a chain of, the wide K1
    streams W_hh, as the planner says; a wide form by name is refused at a
    width that has none, and so is a form the wrapper does not know."""
    limits = lstm_cuda.device_limits(dev.index)
    assert lstm_cuda.merged_wide_plan(lstm_cuda.MERGED_WIDE_G_MAX, 1, *limits) is not None
    G = lstm_cuda.MERGED_WIDE_G_MAX + 8
    assert lstm_cuda.merged_wide_plan(G, 1, *limits) is None
    xp, whh, h0, c0 = _lstm_inputs(dev, 2, 1, 1, G, seed=7)
    out = lstm_cuda.lstm_merged(xp, whh, h0, c0, 1)
    assert lstm_cuda.lstm_merged.form[0] == "wide_streaming"
    for k, p in zip(out, lstm_cuda.lstm_merged_plain(xp, whh, h0, c0, 1)):
        assert (k - p).abs().max().item() <= 5e-3
    with pytest.raises(RuntimeError, match="no block form"):
        lstm_cuda.lstm_merged(xp, whh, h0, c0, 1, _form="wide")
    small = _lstm_inputs(dev, 2, 1, 1, 512, seed=7)
    with pytest.raises(ValueError, match="form must be"):
        lstm_cuda.lstm_merged(*small, 1, _form="wide")


@pytest.mark.parametrize("G, B", [(520, 16), (640, 16), (640, 3), (644, 9), (1024, 17)])
def test_wide_k5_block_form_holds_w_hh_on_the_chip(dev, G, B):
    """The wide K5 (G above 512) in the block form ``merged_bwd_wide_plan``
    picks from the card's figures (padded to the next multiple of 8): its
    shared memory as the kernel reports it, its form fields the plan's,
    against plain and against the streaming yardstick run by name (5e-3 of
    each output's largest entry), rows bit-equal alone, a repeat bit-equal."""
    T, R = 6, 8
    (xp, whh, h0, c0), (dhs, dhT, dcT) = _train_case(dev, T, R, B, G, seed=G + B)
    _, _, _, gates, cs = lstm_cuda.lstm_merged_train_fwd_plain(xp, whh, h0, c0, B)
    args = (gates, cs, c0, whh, dhs, dhT, dcT, B)
    Gp = lstm_cuda.merged_width(G)
    plan = lstm_cuda.merged_bwd_wide_plan(Gp, R, *lstm_cuda.device_limits(dev.index))
    assert plan is not None and plan.kreg + plan.ksmem == plan.mtw * plan.units // 4
    blocks, smem = lstm_cuda.bwd_block_layout(dev.index, plan.mtw, plan.units, plan.rows)
    assert smem == plan.smem and blocks >= plan.blocks_per_chain * plan.chains_per_group
    before = lstm_cuda.lstm_merged_bwd_step.launches
    out = lstm_cuda.lstm_merged_bwd_step(*args)
    torch.cuda.synchronize()
    assert lstm_cuda.lstm_merged_bwd_step.launches == before + 1
    form = lstm_cuda.lstm_merged_bwd_step.form
    groups = lstm_cuda.chain_groups(R, plan.blocks_per_chain, form[2], "K5")
    assert form == ("wide", plan.blocks_per_chain, blocks, len(groups),
                    len(lstm_cuda.resident_row_groups(B, plan.rows)), plan.units)
    ref = lstm_cuda.lstm_merged_bwd_step_plain(*args)
    for name, k, p in zip(("dxp", "dh0", "dc0"), out, ref):
        assert k.shape == p.shape and _rel(k, p) <= 5e-3, name
    streaming = lstm_cuda.lstm_merged_bwd_step(*args, _form="wide_streaming")
    assert lstm_cuda.lstm_merged_bwd_step.form[0] == "wide_streaming"
    for k, p in zip(streaming, ref):
        assert _rel(k, p) <= 5e-3
    for picks in ([0], [B - 1], sorted({1, B // 2, B - 1})):
        rows = torch.tensor([r * B + b for r in range(R) for b in picks], device=dev)

        def sub(x):
            return (x[:, rows] if x.dim() == 3 else x[rows]).contiguous()

        one = lstm_cuda.lstm_merged_bwd_step(sub(gates), sub(cs), sub(c0), whh, sub(dhs),
                                             sub(dhT), sub(dcT), len(picks))
        assert all(torch.equal(a, sub(b)) for a, b in zip(one, out)), picks
    assert all(torch.equal(a, b) for a, b in zip(lstm_cuda.lstm_merged_bwd_step(*args), out))


def test_wide_k5_streams_above_the_block_forms(dev):
    """Above ``BWD_WIDE_G_MAX`` the wide K5 streams W_hh, chosen from the
    width; the block form by name is refused there, and a wide form by name
    at a resident width."""
    limits = lstm_cuda.device_limits(dev.index)
    G = lstm_cuda.BWD_WIDE_G_MAX + 8
    assert lstm_cuda.merged_bwd_wide_plan(lstm_cuda.BWD_WIDE_G_MAX, 1, *limits) is not None
    assert lstm_cuda.merged_bwd_wide_plan(G, 1, *limits) is None
    (xp, whh, h0, c0), (dhs, dhT, dcT) = _train_case(dev, 2, 1, 1, G, seed=3)
    _, _, _, gates, cs = lstm_cuda.lstm_merged_train_fwd_plain(xp, whh, h0, c0, 1)
    args = (gates, cs, c0, whh, dhs, dhT, dcT, 1)
    out = lstm_cuda.lstm_merged_bwd_step(*args)
    assert lstm_cuda.lstm_merged_bwd_step.form[0] == "wide_streaming"
    for k, p in zip(out, lstm_cuda.lstm_merged_bwd_step_plain(*args)):
        assert _rel(k, p) <= 5e-3
    with pytest.raises(RuntimeError, match="no block form"):
        lstm_cuda.lstm_merged_bwd_step(*args, _form="wide")
    (xp, whh, h0, c0), (dhs, dhT, dcT) = _train_case(dev, 2, 1, 1, 512, seed=3)
    _, _, _, gates, cs = lstm_cuda.lstm_merged_train_fwd_plain(xp, whh, h0, c0, 1)
    with pytest.raises(ValueError, match="form must be"):
        lstm_cuda.lstm_merged_bwd_step(gates, cs, c0, whh, dhs, dhT, dcT, 1, _form="wide")


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
    tiles (and one G that is no multiple of 4, which TMA cannot stride: the
    Hopper form at the padded width), T*B that is no multiple of its stage
    of 32; identical bf16 operands as the plain version, f32 sums in another
    order; and the same bits from run to run.  Each shape in the form
    :func:`dw_form` gives it, and each form by name."""
    g = torch.Generator(device=dev).manual_seed(T * G + B)
    hs = torch.randn((T, R * B, G), generator=g, device=dev)
    h0 = torch.randn((R * B, G), generator=g, device=dev)
    dxp = torch.randn((T, R * B, 4 * G), generator=g, device=dev)
    ref = lstm_cuda.lstm_merged_dw_plain(hs, h0, dxp, B)
    forms = [None, *lstm_cuda.DW_FORMS]
    for form in forms:
        before = lstm_cuda.lstm_merged_dw.launches
        dw = lstm_cuda.lstm_merged_dw(hs, h0, dxp, B, _form=form)
        torch.cuda.synchronize()
        assert lstm_cuda.lstm_merged_dw.launches == before + 1
        assert lstm_cuda.lstm_merged_dw.form[0] == (form or lstm_cuda.dw_form(G)), form
        assert dw.shape == ref.shape == (R, G, 4 * G)
        assert _rel(dw, ref) <= 1e-5, form
        assert torch.equal(dw, lstm_cuda.lstm_merged_dw(hs, h0, dxp, B, _form=form)), form


@pytest.mark.parametrize("T, R, B, G", [(256, 8, 16, 512), (256, 8, 32, 512), (256, 8, 16, 640),
                                        (256, 8, 4, 256), (256, 4, 8, 512)],
                         ids=["umxl_train", "umxl_batch32", "hidden1280", "umxhq_train_umx",
                              "mesh_cell"])
def test_weight_gradient_hopper_form_at_path_shapes(dev, T, R, B, G):
    """K6's Hopper form at the shapes the paths give it: one launch, the
    plan's form (columns a block, clusters, clusters the card holds,
    waves), within 1e-5 of the plain version on the same operands (the
    tensor cores' sums go into dW every DW_PROMOTE stages, so B 32's 8192
    pairs stay inside it) and the same bits from run to run."""
    g = torch.Generator(device=dev).manual_seed(T + B + G)
    hs = torch.tanh(torch.randn((T, R * B, G), generator=g, device=dev))
    h0 = torch.tanh(torch.randn((R * B, G), generator=g, device=dev))
    dxp = 0.1 * torch.randn((T, R * B, 4 * G), generator=g, device=dev)
    before = dict(lstm_cuda.lstm_merged_dw.form_launches)
    dw = lstm_cuda.lstm_merged_dw(hs, h0, dxp, B)
    torch.cuda.synchronize()
    assert lstm_cuda.lstm_merged_dw.form_launches["wgmma"] == before["wgmma"] + 1
    held = {bn: c for bn, (c, _) in lstm_cuda.dw_capacity(dev.index or 0).items()}
    plan = lstm_cuda.dw_plan(T, R, B, G, held)
    assert lstm_cuda.lstm_merged_dw.form == ("wgmma", plan.bn, plan.clusters, plan.held,
                                             plan.waves)
    assert _rel(dw, lstm_cuda.lstm_merged_dw_plain(hs, h0, dxp, B)) <= 1e-5
    assert torch.equal(dw, lstm_cuda.lstm_merged_dw(hs, h0, dxp, B))


@pytest.mark.parametrize("T, R, B, G", [(256, 8, 16, 18), (256, 8, 16, 24), (12, 8, 3, 24),
                                        (256, 1, 16, 24), (9, 2, 3, 22)],
                         ids=["hidden36", "hidden48", "grad_test", "r1", "g22"])
def test_weight_gradient_split_over_slices(dev, T, R, B, G):
    """K6 where its tiles alone leave the card nearly empty: the Hopper form
    (at the padded width where G % 4 != 0) with its contraction split into
    the plan's slices, their partial tiles added in slice order: within
    1e-5 of the plain version, the same bits from run to run, no mma_sync
    launch."""
    g = torch.Generator(device=dev).manual_seed(T * G + R)
    hs = torch.tanh(torch.randn((T, R * B, G), generator=g, device=dev))
    h0 = torch.tanh(torch.randn((R * B, G), generator=g, device=dev))
    dxp = 0.1 * torch.randn((T, R * B, 4 * G), generator=g, device=dev)
    before = dict(lstm_cuda.lstm_merged_dw.form_launches)
    dw = lstm_cuda.lstm_merged_dw(hs, h0, dxp, B)
    torch.cuda.synchronize()
    assert lstm_cuda.lstm_merged_dw.form_launches == {**before, "wgmma": before["wgmma"] + 1}
    held = {bn: c for bn, (c, _) in lstm_cuda.dw_capacity(dev.index or 0).items()}
    plan = lstm_cuda.dw_plan(T, R, B, lstm_cuda.dw_width(G), held)
    assert lstm_cuda.lstm_merged_dw.plan == plan and plan.slices > 1
    assert _rel(dw, lstm_cuda.lstm_merged_dw_plain(hs, h0, dxp, B)) <= 1e-5
    assert torch.equal(dw, lstm_cuda.lstm_merged_dw(hs, h0, dxp, B))


@pytest.mark.parametrize("n_fft", [1024, 2048, 3072, 5120, 6144, 7168, 8192, 10240, 12288,
                                   14336, 16384])
def test_istft_register_form_matches_plain(dev, n_fft):
    """K8's register form at every n_fft it takes, 2 rows of 40 frames and
    1 row of 3: within 1e-5 of the plain version, its radices the plan's,
    the same bits from run to run; its mixed-radix yardstick by name within
    the same bound."""
    from umx_tpu_torch.ops import istft_ct, istft_ct_cuda
    from umx_tpu_torch.ops.stft import hann_window

    hop, F = n_fft // 4, n_fft // 2 + 1
    w = hann_window(n_fft, dev)
    g = torch.Generator(device=dev).manual_seed(n_fft)
    for rows, T in ((2, 40), (1, 3)):
        re = torch.randn((rows, T, F), generator=g, device=dev)
        im = torch.randn((rows, T, F), generator=g, device=dev)
        before = istft_ct_cuda.istft_ct2.launches
        out = istft_ct_cuda.istft_ct2(re, im, n_fft, hop, w)
        torch.cuda.synchronize()
        assert istft_ct_cuda.istft_ct2.launches == before + 1
        assert istft_ct_cuda.istft_ct2.form[2] == istft_ct_cuda.istft_register_plan(n_fft)
        ref = istft_ct.istft_ct2_plain(re, im, n_fft, hop, w)
        assert (out - ref).abs().max().item() <= 1e-5
        assert torch.equal(out, istft_ct_cuda.istft_ct2(re, im, n_fft, hop, w))
        mixed = istft_ct_cuda.istft_ct2(re, im, n_fft, hop, w, _form="mixed_radix")
        assert (mixed - ref).abs().max().item() <= 1e-5


def _loss_and_grads(monkeypatch, d, branches=None):
    """mask_loss and its gradients at hidden 48 (G 24) on device ``d``, a
    batch of 3 x 12 frames → (loss, {field: gradient on the CPU}, [the
    pre-activations of umx_post's two ReLUs, fc2's and the mask's, on the
    CPU]); ``branches``: for each ReLU a 0/1 tensor, the branch it takes at
    each element (x * branch) in place of its own sign."""
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
    p = synthetic_params(cfg, seed=4, device=d)
    names = [f.name for f in dataclasses.fields(UMXParams) if f.name not in FROZEN]
    for n in names:
        getattr(p, n).requires_grad_(True)
    b = {k: torch.tensor(v, dtype=torch.float32, device=d) for k, v in batch.items()}
    pre, relu = [], torch.relu

    def recording_relu(x):
        pre.append(x.detach().cpu().clone())
        if branches is None:
            return relu(x)
        return x * branches[len(pre) - 1].to(x.device, x.dtype)

    before = lstm_cuda.lstm_merged_dw.launches
    with monkeypatch.context() as m:
        m.setattr(torch, "relu", recording_relu)
        loss = mask_loss(p, b, cfg)
        loss.backward()
    if d != "cpu":
        assert lstm_cuda.lstm_merged_dw.launches == before + cfg.n_lstm_layers
    assert len(pre) == 2
    return loss.item(), {n: getattr(p, n).grad.cpu() for n in names}, pre


def test_training_loss_and_grads_on_the_card_match_cpu(dev, monkeypatch):
    """mask_loss and its gradients at a small width: K4/K5/K6 on the card
    against every plain version on the CPU, same weights and batch, as one
    function.  The card gives the same bits twice.  Its pre-activations of
    the two ReLUs agree with the CPU's to 1e-3 of their peak (f32 sums in
    other orders, bf16 recurrence operands); where that difference straddles
    zero, a ReLU takes its other branch, which moves fc3's and the output
    scale's gradients by a whole element's share (up to 3e-2 of their max
    where 1e-3 is allowed), and the CPU's own result moves between processes
    by enough to flip elements there.  So the CPU side takes the card's
    branch at every element (its own but at those sign flips), and then the
    two sides compute one function: the loss within 1e-4, every gradient
    within 1e-3 of its max|g|."""
    l_gpu, g_gpu, p_gpu = _loss_and_grads(monkeypatch, dev)
    again = _loss_and_grads(monkeypatch, dev)
    assert again[0] == l_gpu
    assert all(torch.equal(again[1][n], g) for n, g in g_gpu.items())
    assert all(torch.equal(a, b) for a, b in zip(again[2], p_gpu))
    l_own, g_own, p_cpu = _loss_and_grads(monkeypatch, "cpu")
    flips, diffs = [], []
    for pg, pc in zip(p_gpu, p_cpu):
        diffs.append(float((pg - pc).abs().max()))
        assert diffs[-1] <= 1e-3 * float(pc.abs().max())
        flips.append(int(((pg > 0) != (pc > 0)).sum()))
    l_cpu, g_cpu, _ = _loss_and_grads(monkeypatch, "cpu", [(pg > 0).float() for pg in p_gpu])
    errs = {n: _rel(g_gpu[n], g) for n, g in g_cpu.items()}
    own = {n: _rel(g_gpu[n], g) for n, g in g_own.items()}
    worst, worst_own = max(errs, key=errs.get), max(own, key=own.get)
    print(f"grad test: card repeats bit-equal; ReLU sign flips {flips} (max|pre diff| {diffs}); "
          f"worst field on the card's branches {worst} {errs[worst]:.3g}, on the CPU's own "
          f"{worst_own} {own[worst_own]:.3g}")
    assert abs(l_gpu - l_cpu) <= 1e-4 * abs(l_cpu)
    # bf16 recurrence operands, cuBLAS summation order: 1e-3 of each max|g|
    for n, err in errs.items():
        assert err <= 1e-3, n


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
    the kernel route agrees with the CPU's plain versions (float32 planes
    on both sides)."""
    import dataclasses

    from umx_tpu_torch.ops.wiener import wiener_filter_masks

    cfg = dataclasses.replace(cfg, out_dtype="float32")
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

    cfg = _f32_seams(EngineConfig(model=ModelConfig(hidden_size=48),
                                  segment=SegmentConfig(segment_secs=1.0)))
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
    per_row, hops_per_run, plan = istft_ct_cuda.istft_ct2.form
    assert per_row * hops_per_run >= T + 3 > (per_row - 1) * hops_per_run
    assert plan == (16, 16, 8)
    plain = istft_ct.istft_ct2_plain(re, im, 4096, 1024, w)
    f64 = istft_ct.istft_ct2_plain(re.cpu().double(), im.cpu().double(), 4096, 1024,
                                   w.cpu().double() if windowed else None)
    # unit-normal planes: f32 sums over 2049 bins in other orders
    assert (out - plain).abs().max().item() <= 1e-5
    assert (out.cpu().double() - f64).abs().max().item() <= 1e-6
    assert torch.equal(out, istft_ct_cuda.istft_ct2(re, im, 4096, 1024, w))


@pytest.mark.parametrize("rows, T", [(3, 37), (48, 130), (1, 1), (500, 2)])
@pytest.mark.parametrize("n_fft", [1024, 2048, 3072, 5120, 6144, 7168, 8192, 12288, 15360,
                                   16384])
def test_istft_ct_kernel_at_every_n_fft(dev, n_fft, rows, T):
    """K8 in the form it takes at each n_fft (the register form, three
    passes in registers; at 15360 the mixed-radix form, a DFT of
    n_fft/1024 points, then three radix-8 passes) against its plain version
    and float64, windowed, at sizes that are and are not powers of two; one
    launch, its radices, bit-stable."""
    from umx_tpu_torch.ops import istft_ct, istft_ct_cuda
    from umx_tpu_torch.ops.stft import hann_window

    F, hop = n_fft // 2 + 1, n_fft // 4
    g = torch.Generator(device=dev).manual_seed(n_fft + rows * T)
    re = torch.randn((rows, T, F), generator=g, device=dev)
    im = torch.randn((rows, T, F), generator=g, device=dev)
    w = hann_window(n_fft, dev)
    before = istft_ct_cuda.istft_ct2.launches
    out = istft_ct_cuda.istft_ct2(re, im, n_fft, hop, w)
    torch.cuda.synchronize()
    assert istft_ct_cuda.istft_ct2.launches == before + 1
    assert istft_ct_cuda.istft_ct2.form[2] == istft_ct_cuda.istft_radices(n_fft)
    assert out.shape == (rows, (T - 1) * hop + n_fft)
    plain = istft_ct.istft_ct2_plain(re, im, n_fft, hop, w)
    n64 = min(rows, 8)
    f64 = istft_ct.istft_ct2_plain(re[:n64].cpu().double(), im[:n64].cpu().double(), n_fft, hop,
                                   w.cpu().double())
    assert (out - plain).abs().max().item() <= 1e-5
    assert (out[:n64].cpu().double() - f64).abs().max().item() <= 1e-6
    assert torch.equal(out, istft_ct_cuda.istft_ct2(re, im, n_fft, hop, w))


def test_istft_ct_kernel_block_fits_at_every_n_fft(dev):
    """What K8 reports of its blocks at every n_fft = 1024 k up to 16384:
    the frame and the ring fit a block's shared memory, at least one block
    an SM; above, the cluster form up to 232448: 8 n_fft / C bytes a block
    of its clusters of C, which the card holds at once at least a cluster
    per C SMs' GPC share; and the device-memory form (above, and by name):
    one block (and scratch slot) an SM, no dynamic shared memory."""
    from umx_tpu_torch.ops import istft_ct_cuda

    props = torch.cuda.get_device_properties(dev)
    assert props.shared_memory_per_block_optin == istft_ct_cuda.BLOCK_SMEM_MAX
    for k in range(1, 17):
        blocks, smem = istft_ct_cuda.istft_block_layout(dev.index, 1024 * k)
        assert 0 < smem <= props.shared_memory_per_block_optin
        assert blocks >= props.multi_processor_count
    for k in (17, 32, 57, 64, 113, 128, 227):
        n = 1024 * k
        C = istft_ct_cuda.istft_cluster_size(n)
        clusters, smem = istft_ct_cuda.istft_block_layout(dev.index, n)
        assert istft_ct_cuda.istft_form(n) == "cluster" and smem == 8 * n // C
        assert clusters * C >= props.multi_processor_count // 2, (k, C, clusters)
        assert istft_ct_cuda.istft_block_layout(dev.index, n, "device") == (
            props.multi_processor_count, 0)
    assert istft_ct_cuda.istft_form(1024 * 228) == "device"
    assert istft_ct_cuda.istft_block_layout(dev.index, 1024 * 228) == (
        props.multi_processor_count, 0)


@pytest.mark.parametrize("n_fft, rows, T", [
    (32768, 3, 41), (17408, 2, 9), (32768, 1, 2), (59392, 2, 5), (131072, 1, 6), (233472, 1, 3)])
def test_istft_ct_kernel_above_16384(dev, n_fft, rows, T):
    """K8 above 16384 (the cluster form: C 2 at 17408 and 32768, C 4 at
    59392 with an odd pass of 29, C 8 at 131072; the device-memory form at
    233472) against its plain version and float64 (1e-5, as the other
    sizes), bit-stable, one launch, and bit-equal to the device-memory form
    run by name (the same arithmetic); runs of a row shorter than the ring
    and rows beyond the grid's slots walk the grid."""
    from umx_tpu_torch.ops import istft_ct, istft_ct_cuda
    from umx_tpu_torch.ops.stft import hann_window

    hop, F = n_fft // 4, n_fft // 2 + 1
    g = torch.Generator(device=dev).manual_seed(n_fft + T)
    re = torch.randn((rows, T, F), generator=g, device=dev)
    im = torch.randn((rows, T, F), generator=g, device=dev)
    w = hann_window(n_fft, dev)
    before = istft_ct_cuda.istft_ct2.launches
    out = istft_ct_cuda.istft_ct2(re, im, n_fft, hop, w)
    torch.cuda.synchronize()
    assert istft_ct_cuda.istft_ct2.launches == before + 1
    assert istft_ct_cuda.istft_ct2.form[2] == istft_ct_cuda.istft_radices(n_fft)
    plain = istft_ct.istft_ct2_plain(re, im, n_fft, hop, w)
    f64 = istft_ct.istft_ct2_plain(re.cpu().double(), im.cpu().double(), n_fft, hop,
                                   w.cpu().double())
    assert (out - plain).abs().max().item() <= 1e-5
    assert (out.cpu().double() - f64).abs().max().item() <= 1e-5
    assert torch.equal(out, istft_ct_cuda.istft_ct2(re, im, n_fft, hop, w))
    device = istft_ct_cuda.istft_ct2(re, im, n_fft, hop, w, _form="device")
    assert istft_ct_cuda.istft_ct2.launches == before + 3
    assert torch.equal(out, device)


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

    cfg = _f32_seams(EngineConfig(
        dsp=DSPConfig(istft_algo="ct2"), model=ModelConfig(hidden_size=48),
        segment=SegmentConfig(segment_secs=1.0, streaming=False, chunk_batch=0),
        shifts=2, ola_impl="pallas",
    ))
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
    """Every width runs (G 20 padded to 24 on a cluster; G 1024, whose
    chain no cluster holds, through the wide K1), one counted launch each;
    a tensor on another device is still refused before any launch."""
    before = lstm_cuda.lstm_layer_pertarget.launches
    for G, wide in ((20, False), (1024, True)):
        args = _pertarget_inputs(dev, 3, G, seed=1, n_targets=1, D=2)
        out = lstm_cuda.lstm_layer_pertarget(*args)
        assert (lstm_cuda.lstm_layer_pertarget.form[0] == "wide") == wide
        for k, p in zip(out, lstm_cuda.lstm_pertarget_plain(*args)):
            assert k.shape == p.shape and (k - p).abs().max().item() <= 5e-3
    assert lstm_cuda.lstm_layer_pertarget.launches == before + 2
    x_proj, whh, h0, c0 = _pertarget_inputs(dev, 3, 512, seed=1, n_targets=1, D=1)
    with pytest.raises(ValueError, match="h0 is on"):
        lstm_cuda.lstm_layer_pertarget(x_proj, whh, h0.cpu(), c0)
    assert lstm_cuda.lstm_layer_pertarget.launches == before + 2


@pytest.mark.parametrize("G", [20, 1024])
def test_pertarget_lstm_kernel_at_every_width(dev, G):
    """K9 at G 20 (a cluster at 24, zero units) and G 1024 (the wide K1 at
    one row per chain) against its plain version at UMX's chains, bit-stable."""
    args = _pertarget_inputs(dev, 29, G, seed=G)
    out = lstm_cuda.lstm_layer_pertarget(*args)
    torch.cuda.synchronize()
    form = lstm_cuda.lstm_layer_pertarget.form
    assert (form[0] == "wide") == (G == 1024)
    for k, p in zip(out, lstm_cuda.lstm_pertarget_plain(*args)):
        assert k.shape == p.shape and (k - p).abs().max().item() <= 5e-3
    again = lstm_cuda.lstm_layer_pertarget(*args)
    assert all(torch.equal(a, b) for a, b in zip(again, out))
    if G == 1024:
        # its chains in the wide block form (two chain groups of four),
        # against the streaming yardstick by name
        assert form[3] == 2 and form[5] == 32
        streaming = lstm_cuda.lstm_layer_pertarget(*args, _form="wide_streaming")
        assert lstm_cuda.lstm_layer_pertarget.form[0] == "wide_streaming"
        for k, y in zip(out, streaming):
            assert (k - y).abs().max().item() <= 5e-3


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

    cfg = _f32_seams(EngineConfig(model=ModelConfig(hidden_size=128, lstm_impl="pallas"),
                                  segment=SegmentConfig(segment_secs=1.0, window_chunks=2),
                                  shifts=1))
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


def _device_kernels(fn, counted=None):
    """``fn()``'s result and the names of the kernels it launched on the
    card (``torch.profiler``'s device events).  A trace with no device
    event at all is the profiler's failure to attach, not a result: ``fn``
    is traced again after a pause, up to three times in all, as
    ``chip_smoke.py``'s ``device_kernels`` does (up to ten there).
    ``counted`` (a wrapper with a ``launches`` count) is set back before
    each retry, so that it counts the traced call alone."""
    import time

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    start = None if counted is None else counted.launches
    for attempt in range(3):
        if attempt:
            time.sleep(0.5)
            if counted is not None:
                counted.launches = start
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
        if names:
            break
    return out, names


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
        lambda: wiener_cuda.wiener_reduce(mode, xre, xim, first, second, inv),
        wiener_cuda.wiener_reduce)
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

    cfg = _f32_seams(EngineConfig(model=ModelConfig(hidden_size=64),
                                  segment=SegmentConfig(segment_secs=1.0)))
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


# the TPU's quantized-weights stems (PARITY_TPU_r5.json), bass/drums/other/vocals
_TPU_QHBM_STEMS = (31.0, 39.6, 39.2, 36.1)


def test_parity_at_umx_l_width_on_the_card(dev):
    """Every port variant of the parity harness at hidden 1024 on a 10 s
    segment: the whole waveform at least 32.7 dB below the oracle's signal
    (0.1 dB of SDR), every stem too but the quantized row's, whose stems
    may lie up to 3 dB below the TPU's."""
    from umx_tpu_torch.scripts import parity_fullscale as pf

    par = pf.Parity(hidden=1024, seg_secs=10.0, device="cuda")
    for v in pf.PORT_VARIANTS:
        row = par.row(v)
        assert row["backend"] == "cuda" and row["waveform_err_db"] >= 32.7, row
        if v == "qhbm":
            assert all(s >= t - 3.0 for s, t in zip(row["per_stem_err_db"], _TPU_QHBM_STEMS)), row
        else:
            assert min(row["per_stem_err_db"]) >= 32.7, row


def test_serve_bench_defaults_one_client_on_the_card(dev, capsys):
    import json

    from umx_tpu_torch.scripts import serve_bench

    before = lstm_cuda.lstm_merged.launches
    assert serve_bench.main(["--clients", "1"]) == 0
    d = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert lstm_cuda.lstm_merged.launches > before
    assert d["clients"] == d["requests"] == 1 and d["track_secs"] == 30.0
    assert d["batching"]["max_batch"] == 4 and d["device_xrt"] > 0
    assert d["device_name"] not in ("", "cuda")  # nvidia-smi's name and power limit


def _mesh_batch(cfg, n_rows, seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    n = cfg.segment.segment_samples(44100)
    t = np.arange(n) / 44100
    return torch.from_numpy(np.stack([
        np.stack([0.4 * np.sin(2 * np.pi * (220 + 40 * k) * t), 0.3 * np.sin(2 * np.pi * 330 * t)])
        + 0.05 * rng.standard_normal((2, n)) for k in range(n_rows)]).astype(np.float32))


def test_sharded_demix_on_one_card_repeated(dev):
    """dp 4 and dp 2 x tp 2 over [cuda:0] * 4, bit-equal to the unsharded
    batch."""
    from umx_tpu_torch.config import EngineConfig, ModelConfig, SegmentConfig
    from umx_tpu_torch.engine.separator import segment_forward_batched
    from umx_tpu_torch.models.umx import synthetic_params
    from umx_tpu_torch.parallel.mesh import make_mesh
    from umx_tpu_torch.parallel.sharding import batched_lstm_state, demix_segments_batch

    cfg = EngineConfig(model=ModelConfig(hidden_size=512), segment=SegmentConfig(segment_secs=4.0))
    params = synthetic_params(cfg.model, seed=3, device=dev)
    batch = _mesh_batch(cfg, 4, 5).to(dev)
    states = batched_lstm_state(cfg, 4, dev)
    n = batch.shape[-1]
    with torch.inference_mode():
        ref, ref_st = segment_forward_batched(params, batch, states, cfg, n)
    card = [torch.device("cuda", torch.cuda.current_device())] * 4
    before = lstm_cuda.lstm_merged.launches
    out, st = demix_segments_batch(params, batch, states, cfg, make_mesh(4, 1, card))
    assert lstm_cuda.lstm_merged.launches == before + 4 * cfg.model.n_lstm_layers
    assert torch.equal(out, ref) and torch.equal(st.h, ref_st.h) and torch.equal(st.c, ref_st.c)
    # a chain's and a target's arithmetic does not depend on what runs
    # beside it, so the target split is bit-equal too
    out, st = demix_segments_batch(params, batch, states, cfg, make_mesh(2, 2, card), tp=True)
    assert torch.equal(out, ref) and torch.equal(st.h, ref_st.h) and torch.equal(st.c, ref_st.c)


def test_sharded_train_step_on_one_card_repeated(dev):
    """dp 2 x tp 2 over [cuda:0] * 4 against the unsharded step: K4-K6 at
    R = 4 chains, B = batch / dp rows.  The first loss within 1e-5 and the
    first gradients within 1e-4 of each field's max|g| (f32 sums in another
    order); AdamW moves an element whose gradient is at the rounding level
    by up to the learning rate either way, so the losses of steps 2-3
    within 1e-4 and the loss after the third update within 1e-2 (3.3e-5
    measured on an H100)."""
    import dataclasses

    import numpy as np

    from umx_tpu_torch.config import DSPConfig, ModelConfig
    from umx_tpu_torch.models.umx import UMXParams, synthetic_params
    from umx_tpu_torch.parallel.mesh import make_mesh
    from umx_tpu_torch.train import (
        FROZEN, TrainConfig, init_train_state, make_batch_from_audio, make_eval_step,
        make_sharded_train_step, make_train_step,
    )

    mcfg, tcfg = ModelConfig(hidden_size=512), TrainConfig(seq_len=64)
    rng = np.random.default_rng(6)
    n = DSPConfig().hop * (tcfg.seq_len - 1)
    targets = (0.1 * rng.standard_normal((8, 4, 2, n))).astype(np.float32)
    batch = make_batch_from_audio(targets.sum(axis=1), targets, mcfg, DSPConfig(), tcfg.seq_len,
                                  dev)
    params = synthetic_params(mcfg, seed=2, device=dev)
    ref, ref_step = init_train_state(params, tcfg), make_train_step(mcfg)
    ref_losses = [float(ref_step(ref, batch)[1])]
    names = [f.name for f in dataclasses.fields(UMXParams) if f.name not in FROZEN]
    ref_grads = {n: getattr(ref.params, n).grad.clone() for n in names}
    ref_losses += [float(ref_step(ref, batch)[1]) for _ in range(2)]
    card = [torch.device("cuda", torch.cuda.current_device())] * 4
    step, shard_state, shard_batch = make_sharded_train_step(mcfg, tcfg, make_mesh(2, 2, card))
    state, sb = shard_state(init_train_state(params, tcfg)), shard_batch(batch)
    before = (lstm_cuda.lstm_merged_train_fwd.launches, lstm_cuda.lstm_merged_bwd_step.launches)
    losses = [float(step(state, sb)[1])]
    grads = {n: torch.cat([getattr(s, n).grad for s in state.slices]) for n in names}
    losses += [float(step(state, sb)[1]) for _ in range(2)]
    # 3 steps x 3 layers x 4 grid devices
    assert lstm_cuda.lstm_merged_train_fwd.launches == before[0] + 36
    assert lstm_cuda.lstm_merged_bwd_step.launches == before[1] + 36
    eval_step = make_eval_step(mcfg)
    trained = (float(eval_step(state.params, batch)), float(eval_step(ref.params, batch)))
    grad_err = max(_rel(grads[n], g) for n, g in ref_grads.items())
    print(f"sharded step against the unsharded one: losses {losses} / {ref_losses}, first "
          f"gradients {grad_err:.3g} of max|g|, trained loss {trained}")
    np.testing.assert_allclose(losses[0], ref_losses[0], rtol=1e-5)
    assert grad_err <= 1e-4
    np.testing.assert_allclose(losses[1:], ref_losses[1:], rtol=1e-4)
    np.testing.assert_allclose(trained[0], trained[1], rtol=1e-2)


def _peer_copies(fn) -> int:
    """Device-to-device copies between cards in ``fn()`` (``torch.profiler``)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()]
    assert any("lstm_resident_kernel" in n for n in names), "the profiler saw no kernel"
    return sum("PtoP" in n for n in names)


def test_mesh_over_two_cards(dev):
    """dp 2 over cuda:0 and cuda:1: the forward (inputs placed, result not
    yet gathered) makes no copy between cards, and equals one card's run;
    dp 1 x tp 2 makes at most 4."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    from umx_tpu_torch.config import EngineConfig, ModelConfig, SegmentConfig
    from umx_tpu_torch.models.umx import synthetic_params
    from umx_tpu_torch.parallel import sharding
    from umx_tpu_torch.parallel.mesh import make_mesh

    cfg = EngineConfig(model=ModelConfig(hidden_size=512), segment=SegmentConfig(segment_secs=4.0))
    params = synthetic_params(cfg.model, seed=3)
    batch = _mesh_batch(cfg, 2, 7)
    states = sharding.batched_lstm_state(cfg, 2)
    one, _ = sharding.demix_segments_batch(params, batch, states, cfg,
                                           make_mesh(2, 1, [torch.device("cuda", 0)] * 2))
    two = make_mesh(2, 1, [torch.device("cuda", 0), torch.device("cuda", 1)])
    out, _ = sharding.demix_segments_batch(params, batch, states, cfg, two)
    assert torch.equal(out, one)
    with torch.inference_mode():
        placed = sharding._place(params, batch, states, two, False)
        torch.cuda.synchronize()
        assert _peer_copies(lambda: sharding._forward(placed, cfg, two)) == 0
        tp = make_mesh(1, 2, [torch.device("cuda", 0), torch.device("cuda", 1)])
        placed = sharding._place(params, batch[:1], sharding.batched_lstm_state(cfg, 1), tp, True)
        torch.cuda.synchronize()
        n = _peer_copies(lambda: sharding._forward(placed, cfg, tp))
    print(f"dp 1 x tp 2 over two cards: {n} copies between cards in the forward")
    assert n <= 4


def test_fleet_and_train_step_over_two_cards(dev):
    """The fleet over dp 2 on cuda:0 and cuda:1 equals one card's; the
    sharded train step over dp 2 x tp 1 on two cards against the same grid
    on one card (the same arithmetic on each device; the leaves' gradient
    sums may take another order)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    import numpy as np

    from umx_tpu_torch.config import DSPConfig, EngineConfig, ModelConfig, SegmentConfig
    from umx_tpu_torch.engine.fleet import demix_tracks
    from umx_tpu_torch.models.umx import synthetic_params
    from umx_tpu_torch.parallel.mesh import make_mesh
    from umx_tpu_torch.train import (
        TrainConfig, init_train_state, make_batch_from_audio, make_sharded_train_step,
    )

    two = [torch.device("cuda", 0), torch.device("cuda", 1)]
    cfg = EngineConfig(model=ModelConfig(hidden_size=512), segment=SegmentConfig(segment_secs=4.0))
    params = synthetic_params(cfg.model, seed=3, device=two[0])
    tracks = [t.numpy() for t in _mesh_batch(cfg, 3, 8)]
    one = demix_tracks(params, tracks, cfg, mesh=make_mesh(2, 1, [two[0]] * 2))
    both = demix_tracks(params, tracks, cfg, mesh=make_mesh(2, 1, two))
    assert all(np.array_equal(a, b) for a, b in zip(one, both))

    mcfg, tcfg = cfg.model, TrainConfig(seq_len=64)
    rng = np.random.default_rng(9)
    n = DSPConfig().hop * (tcfg.seq_len - 1)
    targets = (0.1 * rng.standard_normal((4, 4, 2, n))).astype(np.float32)
    batch = make_batch_from_audio(targets.sum(axis=1), targets, mcfg, DSPConfig(), tcfg.seq_len,
                                  two[0])
    losses = {}
    for name, devices in (("one", [two[0]] * 2), ("two", two)):
        step, shard_state, shard_batch = make_sharded_train_step(
            mcfg, tcfg, make_mesh(2, 1, devices), tp=False)
        state, sb = shard_state(init_train_state(params, tcfg)), shard_batch(batch)
        losses[name] = [float(step(state, sb)[1]) for _ in range(3)]
    print(f"sharded train step over one card and over two: {losses}")
    assert losses["one"][0] == losses["two"][0]
    np.testing.assert_allclose(losses["two"], losses["one"], rtol=1e-3)


@pytest.mark.parametrize("G, groups", [(512, 3), (256, 2)])
def test_lstm_kernel_chain_groups_bit_equal_to_separate_launches(dev, G, groups):
    """K1 over R 24 chains (the pipelined schedule's three stacked layers):
    the card holds 8 chains at G = 512 (16 blocks each) and 16 at G = 256,
    so R 24 runs as serial cooperative launches of chain groups, whose
    exchange tags start at ``launched * T``.  Each chain is bit-equal to its
    launch among three R 8 calls on the same weights and inputs, and to
    the plain version within its tolerance."""
    T, B = 37, 1
    xp, whh, h0, c0 = _lstm_inputs(dev, T, 24, B, G, seed=24 + G)
    out = lstm_cuda.lstm_merged(xp, whh, h0, c0, B)
    per_chain, capacity, n_groups, _ = lstm_cuda.lstm_merged.form
    print(f"K1 at R 24, G {G}: form {lstm_cuda.lstm_merged.form}")
    # an H100 SXM holds 132 blocks at once: 3 groups at G = 512, 2 at 256
    assert n_groups == len(lstm_cuda.resident_chain_groups(24, G, capacity)) > 1
    if capacity == 132:
        assert n_groups == groups
    for r0 in range(0, 24, 8):
        part = lstm_cuda.lstm_merged(xp[:, r0 : r0 + 8].contiguous(), whh[r0 : r0 + 8].contiguous(),
                                     h0[r0 : r0 + 8].contiguous(), c0[r0 : r0 + 8].contiguous(), B)
        assert torch.equal(out[0][:, r0 : r0 + 8], part[0])
        assert torch.equal(out[1][r0 : r0 + 8], part[1]) and torch.equal(out[2][r0 : r0 + 8], part[2])
    for k, p in zip(out, lstm_cuda.lstm_merged_plain(xp, whh, h0, c0, B)):
        assert (k - p).abs().max().item() <= 5e-3


def test_stream_schedules_on_the_card_match_the_scan(dev):
    """Hidden 512, 2 s segments, a track of 4 chunks with a nonzero incoming
    state: the groups (width 3: a remainder group) and pipelined schedules
    against the scan, stems and final state within 1e-5 (K1 at R 8, 16 and
    24 in the pipelined one), and the CPU's pipelined run within 2e-3."""
    from umx_tpu_torch.config import EngineConfig, ModelConfig, SegmentConfig
    from umx_tpu_torch.engine import separator as S
    from umx_tpu_torch.models.umx import LSTMState, synthetic_params

    import numpy as np

    cfg = _f32_seams(EngineConfig(model=ModelConfig(hidden_size=512),
                                  segment=SegmentConfig(segment_secs=2.0)))
    params = synthetic_params(cfg.model, seed=3, device=dev)
    seg, stride = cfg.segment.segment_samples(44100), cfg.segment.stride_samples(44100)
    n_chunks = 4
    rng = np.random.default_rng(7)
    audio = torch.from_numpy(rng.uniform(-0.5, 0.5, (1, 2, (n_chunks - 1) * stride + seg))
                             .astype(np.float32)).to(dev)
    h0, c0 = (torch.from_numpy((0.1 * rng.standard_normal((1, 4, 3, 2, 256))).astype(np.float32))
              for _ in range(2))

    def state():
        return LSTMState(h=h0.to(dev), c=c0.to(dev))

    with torch.inference_mode():
        ref, ref_st = S.demix_fused(params, audio, state(), cfg, n_chunks, seg, stride)
        before = lstm_cuda.lstm_merged.launches
        pipe, pipe_st = S.demix_fused_stream_pipelined(params, audio, state(), cfg, n_chunks,
                                                       seg, stride)
        launches = lstm_cuda.lstm_merged.launches - before
        groups, groups_st = S.demix_fused_stream_groups(params, audio, state(), cfg, n_chunks,
                                                        seg, stride, 3)
    assert launches == n_chunks + 2  # the fill and the drain: R 8, 16, 24, 24, 16, 8
    peak = ref.abs().max().item()
    for out, st in ((pipe, pipe_st), (groups, groups_st)):
        print(f"arm vs scan: stems {(out - ref).abs().max().item() / peak:.3g} of the peak, "
              f"bit-equal {torch.equal(out, ref)}; h {(st.h - ref_st.h).abs().max().item():.3g}")
        assert (out - ref).abs().max().item() <= 1e-5 * peak
        assert (st.h - ref_st.h).abs().max().item() <= 1e-5
        assert (st.c - ref_st.c).abs().max().item() <= 1e-5
    cpu = synthetic_params(cfg.model, seed=3)
    with torch.inference_mode():
        out_cpu, _ = S.demix_fused_stream_pipelined(
            cpu, audio.cpu(), LSTMState(h=h0, c=c0), cfg, n_chunks, seg, stride)
    assert (out_cpu - pipe.cpu()).abs().max().item() <= 2e-3 * peak


# ---------------------------------------------------------------------------
# The Wiener kernels in the TPU kernels' storage dtypes: bfloat16 masks read
# by K2/K3, bfloat16 planes written by K3, and "auto" = bfloat16 on the card
# ---------------------------------------------------------------------------


def _wiener_case(dev, T, F, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    xre = 30 * torch.randn((2, T, F), generator=g, device=dev)
    xim = 30 * torch.randn((2, T, F), generator=g, device=dev)
    masks = torch.rand((4, T, 2 * F), generator=g, device=dev).to(torch.bfloat16)
    return xre, xim, masks, wiener_cuda.inv_max_abs(xre, xim, 10.0)


@pytest.mark.parametrize("T", [1, 37, 300, 2584])
def test_wiener_bf16_masks_bit_equal_to_the_upcast(dev, T):
    """K2 and K3 reading bfloat16 masks give the bits of the float32 forms
    on the masks upcast (exact), for both output dtypes, at F = 2049 (odd,
    so channel 1 of a bf16 mask row lies on a 2-byte boundary only)."""
    xre, xim, m16, inv = _wiener_case(dev, T, 2049, seed=T)
    m32 = m16.float()
    red, app = wiener_cuda.wiener_reduce, wiener_cuda.wiener_apply
    before = (red.form_launches["masks_bf16"], app.form_launches["masks_bf16"],
              app.form_launches["masks_bf16_out_bf16"])
    racc = red("masks", xre, xim, m16, None, inv)
    assert torch.equal(racc, red("masks", xre, xim, m32, None, inv))
    for out in (torch.float32, torch.bfloat16):
        a = app("masks", xre, xim, m16, None, racc, inv, 1e-10, out)
        b = app("masks", xre, xim, m32, None, racc, inv, 1e-10, out)
        assert a[0].dtype == out and torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert (red.form_launches["masks_bf16"], app.form_launches["masks_bf16"],
            app.form_launches["masks_bf16_out_bf16"]) == tuple(n + 1 for n in before)


@pytest.mark.parametrize("mode", ["masks", "mags", "y"])
@pytest.mark.parametrize("T", [37, 2584])
def test_wiener_bf16_output_is_the_rne_cast_of_the_f32_output(dev, mode, T):
    """K3 writing bfloat16 planes gives the round-to-nearest-even cast of
    its float32 planes (``Tensor.to(torch.bfloat16)``), bit for bit."""
    xre, xim, m16, inv = _wiener_case(dev, T, 2049, seed=T + 1)
    m32 = m16.float()
    racc = wiener_cuda.wiener_reduce("masks", xre, xim, m32, None, inv)
    if mode == "masks":
        first, second = m32, None
    elif mode == "mags":
        mags = m32.view(4, T, 2, 2049).transpose(1, 2) * torch.sqrt(xre * xre + xim * xim)[None]
        first, second = mags.contiguous(), None
    else:
        y = wiener_cuda.wiener_apply("masks", xre, xim, m32, None, racc, inv, 1e-10)
        first, second = (y[0] * inv).contiguous(), (y[1] * inv).contiguous()
    f32 = wiener_cuda.wiener_apply(mode, xre, xim, first, second, racc, inv, 1e-10)
    b16 = wiener_cuda.wiener_apply(mode, xre, xim, first, second, racc, inv, 1e-10,
                                   torch.bfloat16)
    for a, b in zip(f32, b16):
        assert b.dtype == torch.bfloat16 and torch.equal(b, a.to(torch.bfloat16))


def test_wiener_wrappers_take_bf16_without_an_f32_copy(dev):
    """Given bfloat16 masks, the wrappers launch the bf16 forms and
    allocate nothing but their outputs: no float32 copy of the masks (and
    with bf16 output no float32 planes); an unsupported dtype raises by
    name before any launch."""
    T, F = 2584, 2049
    xre, xim, m16, inv = _wiener_case(dev, T, F, seed=3)
    racc = wiener_cuda.wiener_reduce("masks", xre, xim, m16, None, inv)
    torch.cuda.synchronize()
    for call, outputs in (
        (lambda: wiener_cuda.wiener_reduce("masks", xre, xim, m16, None, inv), 4 * 4 * F * 4),
        (lambda: wiener_cuda.wiener_apply("masks", xre, xim, m16, None, racc, inv, 1e-10,
                                          torch.bfloat16), 2 * 4 * 2 * T * F * 2),
    ):
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = call()
        torch.cuda.synchronize()
        grown = torch.cuda.max_memory_allocated() - base
        # the caching allocator rounds each output up to 2 MB at most; a
        # float32 copy of the masks would add 169 MB
        assert grown <= outputs + 2 * 2**21, (grown, outputs)
        del out
    launches = (wiener_cuda.wiener_reduce.launches, wiener_cuda.wiener_apply.launches)
    with pytest.raises(TypeError, match=r"torch\.float16"):
        wiener_cuda.wiener_reduce("masks", xre, xim, m16.half(), None, inv)
    with pytest.raises(TypeError, match=r"torch\.float16"):
        wiener_cuda.wiener_apply("masks", xre, xim, m16, None, racc, inv, 1e-10, torch.float16)
    y16 = torch.zeros((4, 2, T, F), dtype=torch.bfloat16, device=dev)
    with pytest.raises(TypeError, match=r"torch\.bfloat16"):
        wiener_cuda.wiener_reduce("y", xre, xim, y16, y16, inv)
    assert (wiener_cuda.wiener_reduce.launches, wiener_cuda.wiener_apply.launches) == launches


def test_default_demix_on_the_card_is_the_explicit_bf16_demix(dev):
    """"auto" resolves to bfloat16 on the card for the three seams: a
    default Separator on cuda gives the bits of the same demix with the
    seams set to bfloat16 by name, and K2/K3 run their bf16 forms."""
    import dataclasses

    import numpy as np

    from umx_tpu_torch.config import EngineConfig, ModelConfig, SegmentConfig
    from umx_tpu_torch.engine.separator import Separator
    from umx_tpu_torch.models.umx import synthetic_params

    cfg = EngineConfig(model=ModelConfig(hidden_size=64), segment=SegmentConfig(segment_secs=1.0))
    bf16 = dataclasses.replace(cfg, mask_dtype="bfloat16", stems_stack_dtype="bfloat16",
                               wiener=dataclasses.replace(cfg.wiener, out_dtype="bfloat16"))
    params = synthetic_params(cfg.model, seed=0, device=dev)
    track = np.random.default_rng(5).uniform(-0.5, 0.5, (2, int(2.6 * 44100))).astype(np.float32)
    before = wiener_cuda.wiener_apply.form_launches["masks_bf16_out_bf16"]
    auto = Separator(params, cfg, dev).demix_track(track, seed=1)
    assert wiener_cuda.wiener_apply.form_launches["masks_bf16_out_bf16"] > before
    assert np.array_equal(auto, Separator(params, bf16, dev).demix_track(track, seed=1))
    f32 = Separator(params, _f32_seams(cfg), dev).demix_track(track, seed=1)
    assert not np.array_equal(auto, f32)


# ---- K10: the float32 recurrence (lstm_impl="scan") ------------------------


def _scan_inputs(dev, T, R, B, G, seed, dtype=torch.float32):
    g = torch.Generator(device=dev).manual_seed(seed)
    xp = torch.randn((T, R * B, 4 * G), generator=g, device=dev)
    whh = (torch.randn((R, G, 4 * G), generator=g, device=dev) / G**0.5).to(dtype)
    h0 = 0.5 * torch.randn((R * B, G), generator=g, device=dev)
    c0 = 0.5 * torch.randn((R * B, G), generator=g, device=dev)
    return xp, whh, h0, c0


# (T, R, B, G, W_hh dtype) of K10's tests, and the forms each shape takes:
# the resident and the streaming one at G <= 512 (the resident form by
# default), the wide and the streaming one up to G 640 (the wide form by
# default), the streaming one above
_SCAN_SHAPES = [
    (37, 3, 3, 40, torch.float32), (9, 8, 1, 512, torch.float32), (5, 2, 6, 18, torch.bfloat16),
    (7, 8, 20, 512, torch.float32), (11, 8, 1, 640, torch.float32), (1, 2, 1, 1, torch.float32),
    (3, 1, 9, 4096, torch.bfloat16), (9, 8, 16, 512, torch.bfloat16), (13, 8, 3, 256, torch.float32),
    (9, 8, 20, 640, torch.float32), (7, 5, 3, 520, torch.bfloat16), (5, 9, 17, 600, torch.float32),
    (3, 2, 2, 641, torch.float32),
]


def _forms_at(G):
    """The forms of K10 and K11 that take width G."""
    if G <= lstm_cuda.SCAN_RESIDENT_G_MAX:
        return ("resident", "streaming")
    return ("wide", "streaming") if G <= lstm_cuda.SCAN_WIDE_G_MAX else ("streaming",)


def _with_forms(shapes):
    return [(*shape, form) for shape in shapes for form in _forms_at(shape[3])]


@pytest.mark.parametrize("T, R, B, G, dtype, form", _with_forms(_SCAN_SHAPES))
def test_scan_kernel_matches_plain(dev, T, R, B, G, dtype, form):
    """K10 in each form at ragged widths (G 1, 18, 40: no multiple of 8
    needed; G 520-640 in the wide form, G 641 and 4096 streamed), W_hh in
    f32 and bf16, rows beyond one launch (B 20: groups of 16 and 4; G 4096,
    B 9: of 8 and 1, the rows that fit a block's shared memory), chains
    beyond one launch (R 9 at G 600: 30 blocks a chain, 4 chains a group)."""
    xp, whh, h0, c0 = _scan_inputs(dev, T, R, B, G, seed=T + G)
    before = lstm_cuda.lstm_scan.launches
    out_k = lstm_cuda.lstm_scan(xp, whh, h0, c0, B, _form=form)
    torch.cuda.synchronize()
    assert lstm_cuda.lstm_scan.launches == before + 1
    rows, _ = lstm_cuda._scan_capacity(dev.index, G, dtype == torch.bfloat16, "K10", form)
    assert rows == (8 if G == 4096 else 16)  # the H100's 227 KiB of shared memory a block
    assert lstm_cuda.lstm_scan.form[0] == form
    assert lstm_cuda.lstm_scan.form[4] == len(lstm_cuda.scan_row_groups(B, rows))
    lstm_cuda.lstm_scan(xp, whh, h0, c0, B)  # the default form: resident up to 512, wide to 640
    assert lstm_cuda.lstm_scan.form[0] == lstm_cuda.scan_form(G, dtype)
    out_p = lstm_cuda.lstm_scan_plain(xp, whh, h0, c0, B)
    # f32 products of the same operands, summed in another order
    for k, p in zip(out_k, out_p):
        assert (k - p).abs().max().item() <= 1e-4
    assert torch.equal(c0, _scan_inputs(dev, T, R, B, G, seed=T + G)[3])  # c0 untouched


@pytest.mark.parametrize("kernel", ["K10", "K10r", "K11"])
@pytest.mark.parametrize("G", [18, 256, 512, 640, 520])
def test_scan_block_layout_is_the_kernels_own(dev, kernel, G):
    """What K10, K10r and K11 report of their blocks at G 18, 256, 512, 520
    and 640: the resident form holds a block's whole share of W_hh (128
    columns x G, f32) between registers and its shared memory, all 16 rows
    at once under the card's shared memory a block, and UMX-L's 8 chains of
    16 blocks in one cooperative wave; the wide form a block's share of 80
    columns x G the same way, 4 chains a wave, its rows and shared memory
    those of its plan from the card's figures; the streaming form holds
    none of it; a form refuses the widths it does not take."""
    limit = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        for form in lstm_cuda.SCAN_FORMS:
            if form not in _forms_at(G):
                with pytest.raises(RuntimeError):
                    lstm_cuda.scan_block_layout(dev.index, G, bf16, kernel, form)
                continue
            rows, blocks, smem, w_regs = lstm_cuda.scan_block_layout(dev.index, G, bf16, kernel,
                                                                     form)
            assert rows == 16 and 0 < smem <= limit
            if form == "streaming":
                assert w_regs == 0
                continue
            if form == "wide":
                share = 4 * lstm_cuda.SCAN_WIDE_UNITS * G * 4
                plan = lstm_cuda.scan_wide_plan(G, 8, *lstm_cuda.device_limits(dev.index), kernel)
                assert (rows, smem) == (plan.rows, plan.smem)
                assert blocks >= 4 * plan.blocks_per_chain
            else:
                share = 128 * G * 4
                assert blocks >= 8 * lstm_cuda.scan_blocks_per_chain(G)
            assert 0 < w_regs <= share and share - w_regs <= smem
    assert lstm_cuda.scan_form(G, torch.float32) == _forms_at(G)[0]


_ROWS_ALONE = [(B, G, form) for B, G in ((3, 512), (17, 40), (16, 512), (6, 18), (3, 640),
                                          (17, 520), (16, 640), (6, 600))
               for form in _forms_at(G)]


@pytest.mark.parametrize("B, G, form", _ROWS_ALONE)
def test_scan_kernel_rows_are_bit_equal_alone(dev, B, G, form):
    """A row of K10 has the bits of the same row run alone, whatever rows
    (and row groups, and row tiles) run beside it, in each form."""
    T, R = 23, 4
    xp, whh, h0, c0 = _scan_inputs(dev, T, R, B, G, seed=B)
    hs, hT, cT = lstm_cuda.lstm_scan(xp, whh, h0, c0, B, _form=form)
    for b in (0, B - 1):
        rows = torch.arange(R, device=dev) * B + b
        one = lstm_cuda.lstm_scan(xp[:, rows].contiguous(), whh, h0[rows].contiguous(),
                                  c0[rows].contiguous(), 1, _form=form)
        assert torch.equal(one[0], hs[:, rows]) and torch.equal(one[1], hT[rows])
        assert torch.equal(one[2], cT[rows])


@pytest.mark.parametrize("B, G", [(6, 512), (1, 640), (16, 512), (1, 512), (16, 640), (3, 520)])
def test_scan_kernel_repeats_its_bits(dev, B, G):
    """Twenty launches of K10 on the same inputs give the same bits: the
    exchange of h between a chain's blocks never hands a block a word of
    another step (a race there would show as an output that moves)."""
    xp, whh, h0, c0 = _scan_inputs(dev, 257, 8, B, G, seed=G + B)
    ref = lstm_cuda.lstm_scan(xp, whh, h0, c0, B)
    assert lstm_cuda.lstm_scan.form[0] == lstm_cuda.scan_form(G, torch.float32)
    for _ in range(20):
        out = lstm_cuda.lstm_scan(xp, whh, h0, c0, B)
        assert all(torch.equal(a, b) for a, b in zip(out, ref))


@pytest.mark.parametrize("kernel", ["K10", "K10r", "K11"])
@pytest.mark.parametrize("G, R, B", [(520, 8, 1), (640, 8, 16), (640, 3, 2), (1024, 8, 1)])
def test_scan_wide_form_is_the_plans(dev, kernel, G, R, B):
    """The form K10, K10r and K11 choose by width on the card: the wide
    form at G 520 and 640, its fields the plan's from the card's figures
    (blocks a chain, chain groups, units a block), within 1e-4 of the
    plain version; the streaming form above SCAN_WIDE_G_MAX (G 1024)."""
    xp, whh, h0, c0, cts = _scan_train_case(dev, 3, R, B, G, torch.float32, seed=G + R + B)
    if kernel == "K11":
        _, _, _, gates, cs = lstm_cuda.lstm_scan_train_fwd_plain(xp, whh, h0, c0, B)
        args = (gates, cs, c0, whh, *cts, B)
        wrapper, plain = lstm_cuda.lstm_scan_bwd_step, lstm_cuda.lstm_scan_bwd_step_plain
    else:
        args = (xp, whh, h0, c0, B)
        wrapper, plain = ((lstm_cuda.lstm_scan, lstm_cuda.lstm_scan_plain) if kernel == "K10"
                          else (lstm_cuda.lstm_scan_train_fwd, lstm_cuda.lstm_scan_train_fwd_plain))
    out = wrapper(*args)
    torch.cuda.synchronize()
    form = wrapper.form
    assert form[0] == lstm_cuda.scan_form(G, torch.float32)
    if G <= lstm_cuda.SCAN_WIDE_G_MAX:
        plan = lstm_cuda.scan_wide_plan(G, R, *lstm_cuda.device_limits(dev.index), kernel)
        assert form[0] == "wide" and form[1] == plan.blocks_per_chain == -(-G // 20)
        assert form[3] == -(-R // plan.chains_per_group) and form[5] == plan.units == 20
        assert form[4] == len(lstm_cuda.scan_row_groups(B, plan.rows))
    else:
        assert form[0] == "streaming"
    for k, p in zip(out, plain(*args)):
        assert (k - p).abs().max().item() <= 1e-4 * max(p.abs().max().item(), 1.0)


def test_scan_demix_on_the_card_matches_the_cpu(dev):
    """lstm_impl="scan" at hidden 36 (G 18, which K1 pads to 24): the card's
    streaming demix through K10 against the CPU's plain versions, the
    seams pinned to float32 on both sides (both recurrences float32)."""
    import numpy as np

    from umx_tpu_torch.config import EngineConfig, ModelConfig, SegmentConfig
    from umx_tpu_torch.engine.separator import Separator
    from umx_tpu_torch.models.umx import synthetic_params

    cfg = _f32_seams(EngineConfig(model=ModelConfig(hidden_size=36, lstm_impl="scan"),
                                  segment=SegmentConfig(segment_secs=1.0)))
    track = np.random.default_rng(6).uniform(-0.5, 0.5, (2, int(2.6 * 44100))).astype(np.float32)
    before = (lstm_cuda.lstm_scan.launches, lstm_cuda.lstm_merged.launches)
    gpu = Separator(synthetic_params(cfg.model, seed=0, device=dev), cfg, dev).demix_track(
        track, seed=0)
    assert lstm_cuda.lstm_scan.launches > before[0]
    assert lstm_cuda.lstm_merged.launches == before[1]
    cpu = Separator(synthetic_params(cfg.model, seed=0), cfg, "cpu").demix_track(track, seed=0)
    assert float(np.abs(gpu - cpu).max() / np.abs(cpu).max()) <= 2e-4


# ---- K10 with residuals and K11: training through the float32 recurrence ----


_SCAN_TRAIN_SHAPES = [
    (37, 3, 3, 40, torch.float32), (9, 8, 16, 512, torch.float32),
    (5, 2, 6, 18, torch.bfloat16), (7, 8, 20, 512, torch.float32),
    (11, 8, 1, 640, torch.float32), (1, 2, 1, 1, torch.float32),
    (3, 1, 9, 4096, torch.bfloat16), (9, 8, 16, 512, torch.bfloat16),
    (13, 8, 3, 256, torch.float32), (6, 2, 4, 516, torch.float32), (5, 2, 2, 642, torch.float32),
    (7, 8, 16, 640, torch.float32), (5, 9, 3, 600, torch.bfloat16), (4, 3, 20, 520, torch.float32),
]


def _scan_train_case(dev, T, R, B, G, dtype, seed):
    """K10 inputs, the residual forward's outputs, and cotangents."""
    xp, whh, h0, c0 = _scan_inputs(dev, T, R, B, G, seed, dtype)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    cts = (torch.randn((T, R * B, G), generator=g, device=dev),
           torch.randn((R * B, G), generator=g, device=dev),
           torch.randn((R * B, G), generator=g, device=dev))
    return xp, whh, h0, c0, cts


@pytest.mark.parametrize("T, R, B, G, dtype, form", _with_forms(_SCAN_TRAIN_SHAPES))
def test_scan_train_fwd_is_k10_with_residuals(dev, T, R, B, G, dtype, form):
    """K10 with its residual flag: hs/hT/cT are K10's bits in the same
    form, the activated gates and c within 1e-4 of the plain version's
    (rows beyond one launch's 16 at B 20; G 4096 at 8 rows a launch)."""
    xp, whh, h0, c0, _ = _scan_train_case(dev, T, R, B, G, dtype, seed=T + G)
    before = lstm_cuda.lstm_scan_train_fwd.launches
    out = lstm_cuda.lstm_scan_train_fwd(xp, whh, h0, c0, B, _form=form)
    torch.cuda.synchronize()
    assert lstm_cuda.lstm_scan_train_fwd.launches == before + 1
    assert lstm_cuda.lstm_scan_train_fwd.form[0] == form
    for a, b in zip(out[:3], lstm_cuda.lstm_scan(xp, whh, h0, c0, B, _form=form)):
        assert torch.equal(a, b)
    ref = lstm_cuda.lstm_scan_train_fwd_plain(xp, whh, h0, c0, B)
    for a, b in zip(out, ref):
        assert (a - b).abs().max().item() <= 1e-4


@pytest.mark.parametrize("T, R, B, G, dtype, form", _with_forms(_SCAN_TRAIN_SHAPES))
def test_scan_bwd_kernel_matches_plain(dev, T, R, B, G, dtype, form):
    """K11 in each form against its plain version on the same residuals:
    dxp, dh0 and dc0 within 1e-4 of their largest entry (f32 products of
    the same operands, summed in another order); the resident and the
    streaming form sum in one order, so they give the same bits (the wide
    form sums over blocks of 20 units: its own order)."""
    xp, whh, h0, c0, cts = _scan_train_case(dev, T, R, B, G, dtype, seed=T + G)
    _, _, _, gates, cs = lstm_cuda.lstm_scan_train_fwd(xp, whh, h0, c0, B)
    before = lstm_cuda.lstm_scan_bwd_step.launches
    out = lstm_cuda.lstm_scan_bwd_step(gates, cs, c0, whh, *cts, B, _form=form)
    torch.cuda.synchronize()
    assert lstm_cuda.lstm_scan_bwd_step.launches == before + 1
    rows, _ = lstm_cuda._scan_capacity(dev.index, G, dtype == torch.bfloat16, "K11", form)
    assert lstm_cuda.lstm_scan_bwd_step.form[0] == form
    assert lstm_cuda.lstm_scan_bwd_step.form[4] == len(lstm_cuda.scan_row_groups(B, rows))
    if form == "resident":
        streamed = lstm_cuda.lstm_scan_bwd_step(gates, cs, c0, whh, *cts, B, _form="streaming")
        assert all(torch.equal(a, b) for a, b in zip(out, streamed))
    ref = lstm_cuda.lstm_scan_bwd_step_plain(gates, cs, c0, whh, *cts, B)
    for k, p in zip(out, ref):
        assert (k - p).abs().max().item() <= 1e-4 * max(p.abs().max().item(), 1e-30)
    assert torch.equal(cts[2], _scan_train_case(dev, T, R, B, G, dtype, seed=T + G)[4][2])


@pytest.mark.parametrize("B, G, form", _ROWS_ALONE)
def test_scan_bwd_rows_are_bit_equal_alone(dev, B, G, form):
    """A row of K11 has the bits of the same row run alone, whatever rows
    and row groups run beside it, in each form."""
    T, R = 23, 4
    xp, whh, h0, c0, (dhs, dhT, dcT) = _scan_train_case(dev, T, R, B, G, torch.float32, seed=B)
    _, _, _, gates, cs = lstm_cuda.lstm_scan_train_fwd(xp, whh, h0, c0, B)
    dxp, dh0, dc0 = lstm_cuda.lstm_scan_bwd_step(gates, cs, c0, whh, dhs, dhT, dcT, B,
                                                 _form=form)
    for b in (0, B - 1):
        rows = torch.arange(R, device=dev) * B + b
        one = lstm_cuda.lstm_scan_bwd_step(
            gates[:, rows].contiguous(), cs[:, rows].contiguous(), c0[rows].contiguous(), whh,
            dhs[:, rows].contiguous(), dhT[rows].contiguous(), dcT[rows].contiguous(), 1,
            _form=form)
        assert torch.equal(one[0], dxp[:, rows]) and torch.equal(one[1], dh0[rows])
        assert torch.equal(one[2], dc0[rows])


@pytest.mark.parametrize("B, G", [(6, 512), (1, 640), (16, 512), (1, 512), (16, 640), (3, 520)])
def test_scan_bwd_repeats_its_bits(dev, B, G):
    """Twenty launches of K11 on the same inputs give the same bits: the
    exchange never hands a block a word of another step."""
    xp, whh, h0, c0, cts = _scan_train_case(dev, 129, 8, B, G, torch.float32, seed=G + B)
    _, _, _, gates, cs = lstm_cuda.lstm_scan_train_fwd(xp, whh, h0, c0, B)
    ref = lstm_cuda.lstm_scan_bwd_step(gates, cs, c0, whh, *cts, B)
    for _ in range(20):
        out = lstm_cuda.lstm_scan_bwd_step(gates, cs, c0, whh, *cts, B)
        assert all(torch.equal(a, b) for a, b in zip(out, ref))


@pytest.mark.parametrize("impl", ["scan", "auto"])
def test_scan_training_on_the_card_matches_cpu(dev, impl):
    """mask_loss and every gradient at hidden 36 (G 18: "auto" is the scan
    too), K10 with residuals and K11 on the card against their plain
    versions on the CPU: both float32, so 1e-5 on the loss and 2e-4 of
    each field's largest gradient entry (cuBLAS's summation order)."""
    import dataclasses

    import numpy as np

    from umx_tpu_torch.config import ModelConfig
    from umx_tpu_torch.models.umx import UMXParams, synthetic_params
    from umx_tpu_torch.train import FROZEN, mask_loss

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ModelConfig(hidden_size=36, lstm_impl=impl)
    rng = np.random.default_rng(8)
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
        before = (lstm_cuda.lstm_scan_train_fwd.launches, lstm_cuda.lstm_scan_bwd_step.launches,
                  lstm_cuda.lstm_merged_bwd_step.launches)
        loss = mask_loss(p, b, cfg)
        loss.backward()
        if d != "cpu":
            L = cfg.n_lstm_layers
            assert (lstm_cuda.lstm_scan_train_fwd.launches, lstm_cuda.lstm_scan_bwd_step.launches,
                    lstm_cuda.lstm_merged_bwd_step.launches) == (
                        before[0] + L, before[1] + L, before[2])
        grads[str(d)] = (loss.item(), {n: getattr(p, n).grad.cpu() for n in names})
    (l_cpu, g_cpu), (l_gpu, g_gpu) = grads["cpu"], grads[str(dev)]
    assert abs(l_gpu - l_cpu) <= 1e-5 * abs(l_cpu)
    for n, g in g_cpu.items():
        assert _rel(g_gpu[n], g) <= 2e-4, n
