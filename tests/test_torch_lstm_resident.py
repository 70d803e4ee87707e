"""The host-side planning of the resident recurrence kernel (K1,
``csrc/lstm_merged.cu``): how a layer's chains and rows are cut into
launches, the size of the exchange buffer, and a numpy model of the
kernel's data layout (the mma fragment a thread keeps of W_hh, the
(unit, row) a thread owns, the exchange word) that must cover every
weight, cell and word exactly once.  The kernel itself runs only on a
GPU (``tests/test_torch_cuda.py``); here the wrapper's CPU route is held
against the row-group split: rows are independent, so a layer run group
by group equals the layer run at once."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from umx_tpu_torch.ops import lstm_cuda as L

GS = (8, 40, 72, 256, 512)
BS = (1, 3, 16)


@pytest.mark.parametrize("B", [1, 3, 8, 9, 16, 17, 32, 33, 100])
def test_row_groups_cover_every_row_once(B):
    groups = L.resident_row_groups(B)
    rows = [b for b0, nb in groups for b in range(b0, b0 + nb)]
    assert rows == list(range(B))
    assert all(1 <= nb <= L.RESIDENT_ROWS for _, nb in groups)
    assert len(groups) == -(-B // 16)
    # only the last group is ragged
    assert all(nb == L.RESIDENT_ROWS for _, nb in groups[:-1])


@pytest.mark.parametrize("G", GS)
def test_blocks_per_chain(G):
    nbk = L.resident_blocks_per_chain(G)
    assert (nbk - 1) * L.RESIDENT_UNITS < G <= nbk * L.RESIDENT_UNITS
    assert L.resident_blocks_per_chain(512) == 16 and L.resident_blocks_per_chain(256) == 8


@pytest.mark.parametrize("R, G, capacity, want", [
    (8, 512, 132, [(0, 8)]),            # UMX-L on an H100: one wave of 128 blocks
    (8, 256, 132, [(0, 8)]),            # UMX-HQ: 64 blocks
    (8, 512, 100, [(0, 6), (6, 2)]),    # a smaller device: two chain groups
    (3, 40, 4, [(0, 2), (2, 1)]),
    (2, 512, 16, [(0, 1), (1, 1)]),
])
def test_chain_groups(R, G, capacity, want):
    groups = L.resident_chain_groups(R, G, capacity)
    assert groups == want
    assert all(nr * L.resident_blocks_per_chain(G) <= capacity for _, nr in groups)


def test_chain_groups_refuse_a_device_that_cannot_hold_one_chain():
    with pytest.raises(RuntimeError, match="16 co-resident blocks"):
        L.resident_chain_groups(8, 512, 15)


@pytest.mark.parametrize("G", GS)
@pytest.mark.parametrize("R", [1, 8])
def test_exchange_buffer_size(R, G):
    # per chain: two step parities x 16 rows x one 64-bit word per two units
    assert L.resident_exchange_words(R, G) == R * 2 * 16 * G // 2
    assert L.resident_exchange_words(8, 512) * 8 == 512 * 1024


def _fragment_index(G, block, warp, lane, kt):
    """(k, column) of the eight W_hh values a thread keeps for k-tile kt,
    as the kernel lays them out: tile row g is gate g // 4 of unit
    u0 + g % 4, row g + 8 gate g // 4 + 2; registers 0/1 hold k pairs
    2tq, 2tq+1 of rows g / g + 8, registers 2/3 the pairs 8 higher."""
    g, tq = lane >> 2, lane & 3
    u0 = block * L.RESIDENT_UNITS + warp * 4
    col_a = (g >> 2) * G + u0 + (g & 3)
    out = []
    for k0, col in ((0, col_a), (0, col_a + 2 * G), (8, col_a), (8, col_a + 2 * G)):
        for e in (0, 1):
            out.append((kt * 16 + 2 * tq + k0 + e, col))
    return u0, out


@pytest.mark.parametrize("G", [8, 40, 72])
def test_fragments_cover_every_weight_once(G):
    """Every (k, column) of a chain's W_hh (G x 4G) lands in exactly one
    register half of one thread; what falls beyond G is the zero padding."""
    seen = np.zeros((G, 4 * G), dtype=np.int64)
    KT = -(-G // 16)
    for block in range(L.resident_blocks_per_chain(G)):
        for warp in range(8):
            for lane in range(32):
                for kt in range(KT):
                    u0, idx = _fragment_index(G, block, warp, lane, kt)
                    if u0 >= G:
                        continue  # an idle warp: G % 4 == 0, all in or all out
                    for k, col in idx:
                        if k < G:
                            assert col // G == (col - u0) // G and u0 <= col % G < u0 + 4
                            seen[k, col] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("G", [8, 40, 72])
@pytest.mark.parametrize("B", BS)
def test_cells_and_exchange_words_cover_every_unit_and_row_once(G, B):
    """After the gate shuffle lane (g, tq) owns unit u0 + g % 4 and row
    2 tq + g // 4 of its n-tile; lanes with an even unit write the word of
    units (u, u + 1).  Over a chain every (unit, row) has one owner and
    every exchange word one writer."""
    for b0, nb in L.resident_row_groups(B):
        cells = np.zeros((G, nb), dtype=np.int64)
        words = np.zeros((nb, G // 2), dtype=np.int64)
        for block in range(L.resident_blocks_per_chain(G)):
            for warp in range(8):
                u0 = block * L.RESIDENT_UNITS + warp * 4
                if u0 >= G:
                    continue
                for lane in range(32):
                    g, tq = lane >> 2, lane & 3
                    u, n = u0 + (g & 3), 2 * tq + (g >> 2)
                    for j in range(2 if nb > 8 else 1):
                        if j * 8 + n < nb:
                            cells[u, j * 8 + n] += 1
                            if g & 1 == 0:
                                # its partner lane ^ 4 holds unit u + 1 of the same row
                                pg = (lane ^ 4) >> 2
                                assert u0 + (pg & 3) == u + 1 and 2 * tq + (pg >> 2) == n
                                words[j * 8 + n, u >> 1] += 1
        assert (cells == 1).all() and (words == 1).all()


def _inputs(T, R, B, G, seed):
    rng = np.random.default_rng(seed)
    xp = torch.from_numpy(rng.standard_normal((T, R * B, 4 * G)).astype(np.float32))
    whh = torch.from_numpy((rng.standard_normal((R, G, 4 * G)) / G**0.5).astype(np.float32)).to(
        torch.bfloat16)
    h0 = torch.from_numpy((0.5 * rng.standard_normal((R * B, G))).astype(np.float32))
    c0 = torch.from_numpy((0.5 * rng.standard_normal((R * B, G))).astype(np.float32))
    return xp, whh, h0, c0


@pytest.mark.parametrize("G", [8, 40, 72])
@pytest.mark.parametrize("B", [3, 17, 33])
def test_row_groups_give_the_layer(G, B):
    """The plain recurrence over all B rows equals the recurrence run on
    each of the kernel's row groups alone: the split changes no row (the
    CPU's matrix product sums in an order that depends on its width, so
    to f32 rounding: 1e-5 absolute on |h| < 1 and c over five steps)."""
    T, R = 5, 2
    xp, whh, h0, c0 = _inputs(T, R, B, G, seed=G + B)
    hs, hT, cT = L.lstm_merged(xp, whh, h0, c0, B)  # CPU tensors: the plain version
    for b0, nb in L.resident_row_groups(B):
        rows = torch.tensor([r * B + b for r in range(R) for b in range(b0, b0 + nb)])
        ghs, ghT, gcT = L.lstm_merged_plain(xp[:, rows].contiguous(), whh, h0[rows], c0[rows], nb)
        for ours, ref in ((ghs, hs[:, rows]), (ghT, hT[rows]), (gcT, cT[rows])):
            assert (ours - ref).abs().max().item() <= 1e-5


def test_the_width_limit_is_the_kernels_not_the_plain_versions():
    """G above 512 does not fit a warp's registers, so the wrapper refuses
    it for CUDA tensors before any launch; CPU tensors of any width (a
    multiple of 8 or not) still run the plain version."""
    assert (L.RESIDENT_G_MAX, L.RESIDENT_ROWS, L.RESIDENT_UNITS) == (512, 16, 32)
    for G in (520, 12):
        xp, whh, h0, c0 = _inputs(2, 1, 1, G, seed=G)
        before = L.lstm_merged.launches
        hs, hT, cT = L.lstm_merged(xp, whh, h0, c0, 1)
        assert hs.shape == (2, 1, G) and torch.isfinite(hs).all()
        assert torch.equal(hs[-1], hT)
        assert L.lstm_merged.launches == before  # the count is of kernel runs only
