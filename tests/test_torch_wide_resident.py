"""The wide block forms of the resident recurrence kernel (K1 and K4 above
G 512, ``csrc/lstm_merged.cu``): the planner that picks a block form from
the card's figures, and a numpy model of where a block form keeps each
weight (register tiles, then shared-memory tiles) and in which order a
warp sums its k-tiles.  The kernel runs only on a GPU
(``tests/test_torch_cuda.py``); its plain version at these widths is held
against the Pallas kernel in ``tests/test_torch_model.py``."""

from __future__ import annotations

import numpy as np
import pytest

from umx_tpu_torch.ops import lstm_cuda as L

# An H100 SXM: SMs, the shared memory a block may ask for, registers an SM
H100 = (132, 232448, 65536)


def _plan(G, R, card=H100):
    return L.merged_wide_plan(L.merged_width(G), R, *card)


@pytest.mark.parametrize("R", [1, 3, 8, 16, 24])
def test_plans_fit_the_card_and_cover_g_and_r(R):
    """At every G from 513 to 2048 (at the kernel's width, a multiple of
    8): a group's blocks never exceed the SMs, the register and shared
    k-tiles cover G exactly, a block's shared memory and registers fit, and
    the chain groups cover R; a plan exists exactly up to
    ``MERGED_WIDE_G_MAX``."""
    sms, smem_max, regs = H100
    for G in range(513, 2049):
        Gp = L.merged_width(G)
        plan = _plan(G, R)
        assert (plan is not None) == (Gp <= L.MERGED_WIDE_G_MAX), G
        if plan is None:
            continue
        kt = plan.kreg + plan.ksmem
        assert 16 * (kt - 1) < Gp <= 16 * kt, G
        assert plan.kreg == min(kt, dict(L.MERGED_BLOCK_FORMS)[plan.warps])
        assert plan.units == 4 * plan.warps
        assert plan.blocks_per_chain == -(-Gp // plan.units)
        assert (plan.blocks_per_chain - 1) * plan.units < Gp
        assert plan.blocks_per_chain * plan.chains_per_group <= sms
        assert 1 <= plan.chains_per_group <= R
        assert plan.smem == L.merged_block_smem(Gp, plan.warps, plan.rows) <= smem_max
        assert plan.rows in (8, 16)
        assert 4 * plan.kreg + L.MERGED_OTHER_REGS <= L.merged_thread_regs(plan.warps, regs)
        groups = L.chain_groups(R, plan.blocks_per_chain,
                                plan.blocks_per_chain * plan.chains_per_group, "wide")
        chains = [r for r0, nr in groups for r in range(r0, r0 + nr)]
        assert chains == list(range(R))


def test_the_widest_g_one_chain_fits_is_the_figure_written_down():
    """MERGED_WIDE_G_MAX: 4 warps of 16 units, 122 blocks a chain, 40
    register and 82 shared k-tiles a warp beside h of 8 rows; 8 more units
    need 227.5 KiB of shared memory a block.  Its chain is 8 G^2 bytes of
    bf16 W_hh, 30.5 MB."""
    plan = L.merged_wide_plan(L.MERGED_WIDE_G_MAX, 1, *H100)
    assert plan == L.MergedWidePlan(4, 16, 40, 82, 8, 122, 1, 230656)
    assert L.merged_wide_plan(L.MERGED_WIDE_G_MAX + 8, 1, *H100) is None
    assert L.merged_block_smem(L.MERGED_WIDE_G_MAX + 8, 4, 8) > H100[1]
    assert 8 * L.MERGED_WIDE_G_MAX ** 2 == 30482432


@pytest.mark.parametrize("G, R, want", [
    # UMX-style chains of hidden 1280: 8 x 16 blocks of 40 units, one wave,
    # 20 register and 20 shared k-tiles a warp, 140.5 KiB a block
    (640, 8, (10, 20, 20, 16, 16, 8, 143872)),
    (640, 16, (10, 20, 20, 16, 16, 8, 143872)),
    # hidden 2048: 32 blocks of 32 units, two chain groups of four chains
    # (33.5 MB of W_hh each), 32 + 32 k-tiles a warp
    (1024, 8, (8, 32, 32, 16, 32, 4, 197120)),
    (520, 8, (10, 20, 13, 16, 13, 8, 100864)),
    # just above: 6 warps of 24 units with 40 register tiles, two groups
    (648, 8, (6, 40, 1, 16, 27, 4, 45568)),
    (1952, 8, (4, 40, 82, 8, 122, 1, 230656)),
])
def test_plans_at_the_paths_widths(G, R, want):
    p = _plan(G, R)
    assert (p.warps, p.kreg, p.ksmem, p.rows, p.blocks_per_chain, p.chains_per_group,
            p.smem) == want


def test_plans_follow_the_cards_figures():
    """A smaller card (fewer SMs, less shared memory) gets more chain
    groups or no plan; K1's own form is the first of the table; a thread
    of a 10-warp block may have 168 registers (3 warps on a partition)."""
    assert L.MERGED_BLOCK_FORMS[0] == (L.RESIDENT_WARPS, L.RESIDENT_G_MAX // 16)
    assert [L.merged_thread_regs(w, 65536) for w in (4, 6, 8, 10)] == [255, 255, 255, 168]
    big = _plan(640, 8)
    small = _plan(640, 8, (66, 232448, 65536))
    assert -(-8 // small.chains_per_group) > -(-8 // big.chains_per_group)
    assert _plan(1024, 8, (132, 101376, 65536)).rows == 8 or _plan(
        1024, 8, (132, 101376, 65536)) is None
    assert _plan(1900, 1, (100, 232448, 65536)) is None
    with pytest.raises(ValueError, match="G % 8"):
        L.merged_wide_plan(644, 8, *H100)


def _weights_of_a_block_form(G, warps, kreg):
    """(k, column) of every bf16 weight each thread of a chain keeps, as the
    kernel lays them out: warp w of block b owns the 4 units from u0 =
    4 (warps b + w); k-tile kt < kreg in registers, the rest in shared memory at
    slot ((kt - kreg) warps + w) 32 + lane, 16 bytes each.  Returns the
    count of each weight and, per block, the shared slots its warps write
    (a block's shared memory is its own)."""
    units = 4 * warps
    KT = -(-G // 16)
    seen = np.zeros((G, 4 * G), dtype=np.int64)
    slots = []
    lane = np.arange(32)
    g, tq = lane >> 2, lane & 3
    for block in range(-(-G // units)):
        slots.append([])
        for warp in range(warps):
            u0 = block * units + warp * 4
            if u0 >= G:
                continue  # an idle warp: G % 4 == 0, all in or all out
            col_a = (g >> 2) * G + u0 + (g & 3)
            for kt in range(KT):
                if kt >= kreg:
                    slots[-1].append(((kt - kreg) * warps + warp) * 32 + lane)
                k = kt * 16 + 2 * tq
                for k0, col in ((k, col_a), (k, col_a + 2 * G), (k + 8, col_a),
                                (k + 8, col_a + 2 * G)):
                    for e in (0, 1):
                        ok = k0 + e < G
                        np.add.at(seen, (k0[ok] + e, col[ok]), 1)
    return seen, slots


@pytest.mark.parametrize("warps, kreg, G", [(10, 20, 520), (10, 20, 648), (8, 32, 528),
                                            (4, 40, 680), (6, 40, 664)])
def test_register_and_shared_tiles_cover_every_weight_once(warps, kreg, G):
    """Every (k, column) of a chain's W_hh (G x 4G) is in exactly one
    register half of one thread, in a register tile or a shared one; the
    shared slots are each written once, by their own thread, and a warp's
    slots of one tile are 32 neighbouring 16-byte words (512 contiguous
    bytes: four wavefronts, no bank conflict)."""
    seen, slots = _weights_of_a_block_form(G, warps, kreg)
    assert (seen == 1).all()
    KT = -(-G // 16)
    n_slots = (KT - kreg) * warps * 32
    for block in slots:
        flat = np.concatenate(block)
        # an idle warp of the last block leaves its slots unwritten
        assert len(set(flat.tolist())) == flat.size and flat.max() < n_slots
        for s in block:
            assert (np.diff(s) == 1).all() and s[0] % 32 == 0
    assert sorted(np.concatenate(slots[0]).tolist()) == list(range(n_slots))
    assert L.merged_block_smem(G, warps, 16) == 4 * 2 * 16 * (8 * KT + 4) + 16 * n_slots


@pytest.mark.parametrize("G", [520, 640, 1024, 1952])
def test_a_sum_has_one_order_whatever_the_block_form(G):
    """The kernel adds the even k-tiles into one accumulator and the odd
    into the other, in ascending k, from registers then from shared memory
    (two at a time, from an even tile): the sequence of (accumulator, tile)
    is the same for every block form, so a (unit, row) sum has one order,
    set by G alone."""
    KT = -(-G // 16)

    def order(kreg):
        seq = [(kt & 1, kt) for kt in range(min(kreg, KT))]
        for kt in range(kreg, KT, 2):
            seq.append((0, kt))
            if kt + 1 < KT:
                seq.append((1, kt + 1))
        return seq

    want = [(kt & 1, kt) for kt in range(KT)]
    for _, kreg in L.MERGED_BLOCK_FORMS:
        assert kreg % 2 == 0
        assert order(kreg) == want
