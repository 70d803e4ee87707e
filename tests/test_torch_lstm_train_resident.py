"""The host-side planning and the data layout of the resident training
kernels: K4 (``csrc/lstm_merged.cu``, the forward with residuals, K1's
kernel with a flag) and K5 (``csrc/lstm_train.cu``, the reverse sweep).

The kernels run only on a GPU (``tests/test_torch_cuda.py``).  Here a numpy
model of K5's index maps (the mma fragment a thread keeps of W_hh, the
contraction slice a warp owns, the cell a thread owns, the exchange slot it
writes, the flags a warp polls and the pieces it copies) must cover every
weight, cell, slot and column exactly once; the launch plans must cover
every row and chain at any B; a torch emulation of K5's order of summation
(eight warp slices, added in a fixed order) is held against the plain
sweep; and the plain versions run by row groups equal the whole."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from umx_tpu_torch.ops import lstm_cuda as L

WARPS, KT_MAX, ROWS = 8, 16, 16


def _slice(G, warp):
    """(first gate column, k-tiles) of a warp's slice of the contraction:
    the G/4 k-tiles of 16 gate columns dealt out in runs of ceil(G/32)."""
    ktw = -(-(G // 4) // WARPS)
    kt0 = warp * ktw
    return kt0 * 16, max(0, min(ktw, G // 4 - kt0))


def _fragment_index(G, block, warp, lane, mt, kt):
    """(unit, gate column) of the eight W_hh values a thread keeps for
    m-tile mt and k-tile kt: registers 0/1 hold columns 2tq, 2tq+1 of
    units g / g + 8, registers 2/3 the columns 8 higher."""
    g, tq = lane >> 2, lane & 3
    col0, ktn = _slice(G, warp)
    if kt >= ktn:
        return []
    ua = block * L.RESIDENT_UNITS + mt * 16 + g
    c = col0 + kt * 16 + 2 * tq
    out = [(u, c + dc + e) for dc in (0, 8) for u in (ua, ua + 8) for e in (0, 1)]
    return [(u, col) for u, col in out if u < G]


@pytest.mark.parametrize("G", [8, 40, 72, 512])
def test_bwd_fragments_cover_every_weight_once(G):
    """Every (unit, gate column) of a chain's W_hh (G x 4G) lands in exactly
    one register half of one thread, in at most 16 k-tiles a warp."""
    assert -(-(G // 4) // WARPS) <= KT_MAX
    seen = np.zeros((G, 4 * G), dtype=np.int64)
    lanes = np.arange(32)
    g, tq = lanes >> 2, lanes & 3
    for block in range(L.resident_blocks_per_chain(G)):
        for warp in range(WARPS):
            col0, ktn = _slice(G, warp)
            for mt in range(2):
                for kt in range(ktn):
                    ua = block * L.RESIDENT_UNITS + mt * 16 + g
                    c = col0 + kt * 16 + 2 * tq
                    for dc in (0, 8):
                        for du in (0, 8):
                            for e in (0, 1):
                                ok = ua + du < G
                                np.add.at(seen, ((ua + du)[ok], (c + dc + e)[ok]), 1)
    assert (seen == 1).all()
    # the scalar model agrees with the vectorised sweep on a few threads
    for block, warp, lane, mt, kt in ((0, 0, 0, 0, 0), (0, 1, 13, 1, 0), (0, 3, 31, 0, 0)):
        for u, col in _fragment_index(G, block, warp, lane, mt, kt):
            assert 0 <= u < G and 0 <= col < 4 * G


@pytest.mark.parametrize("G", [8, 40, 72, 512])
@pytest.mark.parametrize("B", [1, 3, 8, 9, 16])
def test_bwd_cells_slots_and_flags_cover_every_unit_gate_and_row_once(G, B):
    """In the cell a warp is a row of its n-tile and a lane a unit of the
    block: over a chain every (unit, row) has one owner, every exchange slot
    (row, gate column) one writer and every block one flag; a consumer
    warp's polled blocks produce all of its columns, and the warps' 16-byte
    copies cover each column of each row once."""
    nblk = L.resident_blocks_per_chain(G)
    assert nblk <= L.BWD_FLAG_WORDS
    (b0, nb), = L.resident_row_groups(B)
    nt = 2 if nb > 8 else 1
    cells = np.zeros((G, nb), dtype=np.int64)
    slots = np.zeros((nb, 4 * G), dtype=np.int64)
    producer = np.full(4 * G, -1)
    for block in range(nblk):
        for warp in range(WARPS):
            for lane in range(32):
                u = block * L.RESIDENT_UNITS + lane
                for j in range(nt):
                    row = j * 8 + warp
                    if u < G and row < nb:
                        cells[u, row] += 1
                        for q in range(4):
                            slots[row, q * G + u] += 1
                            producer[q * G + u] = block
    assert (cells == 1).all() and (slots == 1).all() and (producer >= 0).all()
    copied = np.zeros((nb, 4 * G), dtype=np.int64)
    for warp in range(WARPS):
        col0, ktn = _slice(G, warp)
        col1 = col0 + 16 * ktn
        polled = set()
        if ktn > 0:
            for lane in range(nblk):
                for q in range(4):
                    lo = q * G + lane * L.RESIDENT_UNITS
                    hi = q * G + min(lane * L.RESIDENT_UNITS + L.RESIDENT_UNITS, G)
                    if lo < col1 and hi > col0:
                        polled.add(lane)
        assert set(producer[col0:col1]) <= polled
        for lane in range(2 * ktn):  # 16-byte pieces of 8 bf16
            assert (col0 + lane * 8) % 8 == 0
            copied[:, col0 + lane * 8: col0 + lane * 8 + 8] += 1
    assert (copied == 1).all()


@pytest.mark.parametrize("G", [8, 40, 256, 512])
@pytest.mark.parametrize("R", [1, 8])
def test_bwd_exchange_and_flag_buffer_sizes(R, G):
    # per chain: two step parities x 16 rows x 4G bf16; one line of flags
    assert L.bwd_exchange_elems(R, G) == R * 2 * ROWS * 4 * G
    assert L.bwd_exchange_elems(R, G) == 8 * L.resident_exchange_words(R, G)  # 4x the bytes
    assert L.bwd_flag_words(R) == 32 * R
    assert L.bwd_exchange_elems(8, 512) * 2 == 1024 * 1024


@pytest.mark.parametrize("B", [1, 2, 7, 8, 9, 15, 16, 17, 20, 31, 32, 33, 48, 64, 81, 82, 96, 100])
def test_launch_plans_cover_every_row_and_chain_at_any_b(B):
    """Row groups of 16 for any B (no upper bound), each with every chain
    group: the launches of K4 and K5 cover (chain, row) exactly once."""
    R, G = 8, 512
    for capacity in (132, 100, 16):
        seen = np.zeros((R, B), dtype=np.int64)
        chains = L.resident_chain_groups(R, G, capacity)
        rows = L.resident_row_groups(B)
        assert len(rows) == -(-B // 16)
        for r0, nr in chains:
            assert nr * L.resident_blocks_per_chain(G) <= capacity
            for b0, nb in rows:
                assert 1 <= nb <= L.RESIDENT_ROWS
                seen[r0:r0 + nr, b0:b0 + nb] += 1
        assert (seen == 1).all()


def _case(T, R, B, G, seed):
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32))

    xp = t(T, R * B, 4 * G)
    whh = t(R, G, 4 * G, scale=G**-0.5).to(torch.bfloat16)
    h0, c0 = t(R * B, G, scale=0.5), t(R * B, G, scale=0.5)
    return (xp, whh, h0, c0), (t(T, R * B, G), t(R * B, G), t(R * B, G))


def _sweep_emulated(gates, cs, c0, whh, dhs, dhT, dcT, B):
    """K5's arithmetic in torch: coefficients formed before the carry, the
    product as eight warp slices of the gate columns added in warp order,
    one row at a time (a row never sees its neighbours)."""
    T, RB, G4 = gates.shape
    R, G = whh.shape[0], whh.shape[1]
    w = whh.float()
    dxp = torch.empty_like(gates)
    dh, dc = dhT.clone(), dcT.clone()
    slices = [(c, c + 16 * n) for c, n in (_slice(G, wp) for wp in range(WARPS)) if n > 0]
    for t in range(T - 1, -1, -1):
        i, f, g, o = (gates[t][:, q * G:(q + 1) * G] for q in range(4))
        cprev = cs[t - 1] if t > 0 else c0
        tc = torch.tanh(cs[t])
        ka, ki, kf = o * (1 - tc * tc), g * i * (1 - i), cprev * f * (1 - f)
        kg, ko = i * (1 - g * g), tc * o * (1 - o)
        dh = dh + dhs[t]
        dct = dc + dh * ka
        dg = torch.cat([dct * ki, dct * kf, dct * kg, dh * ko], dim=1)
        dxp[t] = dg
        dc = dct * f
        dgb = dg.to(torch.bfloat16).float()
        dh = torch.empty_like(dh)
        for row in range(RB):
            wr = w[row // B]
            acc = torch.mv(wr[:, slices[0][0]:slices[0][1]], dgb[row, slices[0][0]:slices[0][1]])
            for lo, hi in slices[1:]:
                acc = acc + torch.mv(wr[:, lo:hi], dgb[row, lo:hi])
            dh[row] = acc
    return dxp, dh, dc


@pytest.mark.parametrize("G, B", [(8, 3), (40, 5), (72, 2)])
def test_bwd_summation_order_agrees_with_plain_and_is_row_independent(G, B):
    T, R = 6, 2
    (xp, whh, h0, c0), (dhs, dhT, dcT) = _case(T, R, B, G, seed=G)
    _, _, _, gates, cs = L.lstm_merged_train_fwd_plain(xp, whh, h0, c0, B)
    ours = _sweep_emulated(gates, cs, c0, whh, dhs, dhT, dcT, B)
    ref = L.lstm_merged_bwd_step_plain(gates, cs, c0, whh, dhs, dhT, dcT, B)
    # another order of f32 sums, bf16 roundings of dg that may flip: the
    # kernels' own bound against plain
    for a, b in zip(ours, ref):
        assert ((a - b).abs().max() / b.abs().max()).item() <= 5e-3
    # one row of each chain alone: the same bits
    rows = torch.tensor([r * B + (B - 1) for r in range(R)])
    alone = _sweep_emulated(gates[:, rows].contiguous(), cs[:, rows].contiguous(), c0[rows], whh,
                            dhs[:, rows].contiguous(), dhT[rows], dcT[rows], 1)
    assert torch.equal(alone[0], ours[0][:, rows])
    assert torch.equal(alone[1], ours[1][rows]) and torch.equal(alone[2], ours[2][rows])


@pytest.mark.parametrize("G", [8, 40])
@pytest.mark.parametrize("B", [3, 17, 33])
def test_row_groups_give_the_training_layer(G, B):
    """The wrappers' CPU route (the plain versions) over all B rows equals
    the plain forward and backward run on each of the kernels' row groups
    alone (to f32 rounding: the CPU's matrix product sums in an order that
    depends on its width; 1e-5 absolute forward on |h| < 1 and c over five
    steps, 1e-5 of max|ref| backward)."""
    T, R = 5, 2
    (xp, whh, h0, c0), (dhs, dhT, dcT) = _case(T, R, B, G, seed=G + B)
    fwd = L.lstm_merged_train_fwd(xp, whh, h0, c0, B)
    _, _, _, gates, cs = fwd
    bwd = L.lstm_merged_bwd_step(gates, cs, c0, whh, dhs, dhT, dcT, B)
    for b0, nb in L.resident_row_groups(B):
        rows = torch.tensor([r * B + b for r in range(R) for b in range(b0, b0 + nb)])

        def sub(x):
            return (x[:, rows] if x.dim() == 3 else x[rows]).contiguous()

        gf = L.lstm_merged_train_fwd_plain(sub(xp), whh, sub(h0), sub(c0), nb)
        for ours, ref in zip(gf, fwd):
            assert (ours - sub(ref)).abs().max().item() <= 1e-5
        gb = L.lstm_merged_bwd_step_plain(sub(gates), sub(cs), sub(c0), whh, sub(dhs), sub(dhT),
                                          sub(dcT), nb)
        for ours, ref in zip(gb, bwd):
            assert (ours - sub(ref)).abs().max().item() <= 1e-5 * ref.abs().max().item()


@pytest.mark.parametrize("G", [520, 12])
def test_the_width_limit_is_the_kernels_not_the_plain_versions(G):
    """The width picks the kernels' form, not a refusal: G above 512 does
    not fit a warp's registers and takes the wide form, G % 8 != 0 the
    resident form at the next multiple of 8 (for CUDA tensors, before any
    launch); CPU tensors of any width run the plain versions, uncounted."""
    want = ("wide", G) if G > L.RESIDENT_G_MAX else ("resident", -(-G // 8) * 8)
    assert (L.merged_form(G), L.merged_width(G)) == want
    assert (L.merged_form(512), L.merged_width(512)) == ("resident", 512)
    (xp, whh, h0, c0), (dhs, dhT, dcT) = _case(2, 1, 1, G, seed=G)
    before = (L.lstm_merged_train_fwd.launches, L.lstm_merged_bwd_step.launches)
    hs, hT, cT, gates, cs = L.lstm_merged_train_fwd(xp, whh, h0, c0, 1)
    assert gates.shape == (2, 1, 4 * G) and torch.equal(hs[-1], hT) and torch.equal(cs[-1], cT)
    dxp, dh0, dc0 = L.lstm_merged_bwd_step(gates, cs, c0, whh, dhs, dhT, dcT, 1)
    assert dxp.shape == (2, 1, 4 * G) and torch.isfinite(dxp).all()
    assert dh0.shape == dc0.shape == (1, G)
    assert (L.lstm_merged_train_fwd.launches, L.lstm_merged_bwd_step.launches) == before
