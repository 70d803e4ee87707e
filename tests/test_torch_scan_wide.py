"""The wide forms of the float32 recurrence K10 (with its residual flag,
K10r) and its reverse sweep K11 above G 512 (``csrc/lstm_scan.cu:
lstm_scan_wide_kernel``, ``csrc/lstm_scan_train.cu:
lstm_scan_bwd_wide_kernel``): the planner that picks the form's row tile
and chain groups from the card's figures, numpy models of where a block
keeps each weight of W_hh (registers, then shared memory), of the cells
and of the exchange words of a step, emulations of the two kernels'
orders of summation held against the plain versions and against
themselves row by row, the ``_form`` argument, and the layer and its VJP
at G 520 against the JAX package's ``_bilstm_layer``.  The kernels run
only on a GPU (``tests/test_torch_cuda.py``)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from umx_tpu.models import umx as jumx
from umx_tpu_torch.ops import lstm_cuda as L

# An H100 SXM: SMs, the shared memory a block may ask for, registers an SM
H100 = (132, 232448, 65536)
UNITS, COLS = L.SCAN_WIDE_UNITS, 4 * L.SCAN_WIDE_UNITS
THREADS = 32 * L.SCAN_WIDE_WARPS
KERNELS = ("K10", "K10r", "K11")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ---- the planner -----------------------------------------------------------------


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("R", [1, 3, 8, 16, 24])
def test_plans_fit_the_card_and_cover_g_and_r(kernel, R):
    """At every G from 513 to 2048: a plan exists exactly up to
    ``SCAN_WIDE_G_MAX``; a chain is ceil(G/20) blocks, a group's blocks
    never exceed the SMs, a block's shared memory fits, the row tile is the
    largest that fits (16 on an H100), the form is the one chosen at R 1
    (it depends on G alone) and the chain groups cover R once."""
    sms, smem_max, _ = H100
    for G in range(513, 2049):
        plan = L.scan_wide_plan(G, R, *H100, kernel)
        assert (plan is not None) == (G <= L.SCAN_WIDE_G_MAX), G
        if plan is None:
            continue
        assert (plan.units, plan.warps) == (UNITS, L.SCAN_WIDE_WARPS)
        assert plan.blocks_per_chain == -(-G // UNITS)
        assert (plan.blocks_per_chain - 1) * UNITS < G
        assert plan.blocks_per_chain * plan.chains_per_group <= sms
        assert 1 <= plan.chains_per_group <= R
        assert plan.rows == 16
        assert plan.smem == L.scan_wide_smem(kernel, G, plan.rows) <= smem_max
        assert plan[:4] == L.scan_wide_plan(G, 1, *H100, kernel)[:4]
        assert plan.smem == L.scan_wide_plan(G, 1, *H100, kernel).smem
        groups = L.chain_groups(R, plan.blocks_per_chain,
                                plan.blocks_per_chain * plan.chains_per_group, kernel)
        assert [r for r0, nr in groups for r in range(r0, r0 + nr)] == list(range(R))


def test_the_widest_g_one_chain_fits_is_the_figure_written_down():
    """SCAN_WIDE_G_MAX: K10's 320 threads poll h of two units each and
    K11's own two units each in the product, 640; a block's share there is
    80 columns x 640 rows of f32, 200 KiB, in both kernels split between
    registers (80 a thread in K10, 96 in K11) and shared memory; four
    chains of 32 blocks are one wave of an H100 (128 of 132 SMs)."""
    assert L.SCAN_WIDE_G_MAX == THREADS * 2 == 640
    k10 = L.scan_wide_plan(L.SCAN_WIDE_G_MAX, 1, *H100, "K10")
    k11 = L.scan_wide_plan(L.SCAN_WIDE_G_MAX, 1, *H100, "K11")
    assert k10 == L.ScanWidePlan(20, 10, 16, 32, 1, 153600)
    assert k11 == L.ScanWidePlan(20, 10, 16, 32, 1, 92160)
    for kernel in KERNELS:
        assert L.scan_wide_plan(L.SCAN_WIDE_G_MAX + 1, 1, *H100, kernel) is None
    share = COLS * L.SCAN_WIDE_G_MAX * 4
    assert share == 200 * 1024
    iters = L.SCAN_WIDE_G_MAX // 16  # K10: a lane's k iterations, a float4 each
    assert share == 16 * THREADS * (L.SCAN_WIDE_KREG + (iters - L.SCAN_WIDE_KREG))
    assert share == 4 * THREADS * 2 * (L.SCAN_BWD_WIDE_CREG + (COLS - L.SCAN_BWD_WIDE_CREG))
    assert 16 * THREADS * L.SCAN_WIDE_KREG == 100 * 1024
    assert 4 * THREADS * 2 * L.SCAN_BWD_WIDE_CREG == 120 * 1024
    assert 4 * k10.blocks_per_chain <= H100[0] < 5 * k10.blocks_per_chain
    # what the registers of a thread of 10 warps allow on an H100
    assert (max(4 * L.SCAN_WIDE_KREG, 2 * L.SCAN_BWD_WIDE_CREG) + L.SCAN_WIDE_OTHER_REGS
            <= L.merged_thread_regs(10, H100[2]) == 168)


@pytest.mark.parametrize("G, R, kernel, want", [
    # hidden 1280: 32 blocks of 20 units a chain, 4 chains a wave, R 8 in two
    (640, 8, "K10", (20, 10, 16, 32, 4, 153600)),
    (640, 8, "K10r", (20, 10, 16, 32, 4, 153600)),
    (640, 8, "K11", (20, 10, 16, 32, 4, 92160)),
    (640, 16, "K11", (20, 10, 16, 32, 4, 92160)),
    (520, 8, "K10", (20, 10, 16, 26, 5, 108800)),
    (520, 8, "K11", (20, 10, 16, 26, 5, 92160)),
    (513, 1, "K10", (20, 10, 16, 26, 1, 108800)),
])
def test_plans_at_the_paths_widths(G, R, kernel, want):
    assert tuple(L.scan_wide_plan(G, R, *H100, kernel)) == want


def test_plans_follow_the_cards_figures():
    """A card with fewer SMs gets more chain groups; with less shared
    memory a smaller row tile (or none); with fewer registers no plan; G up
    to 512 and an unknown kernel are refused."""
    big = L.scan_wide_plan(640, 8, *H100)
    small = L.scan_wide_plan(640, 8, 66, 232448, 65536)
    assert small[:4] == big[:4] and small.chains_per_group == 2 < big.chains_per_group
    assert L.scan_wide_plan(640, 8, 31, 232448, 65536) is None  # 32 blocks a chain
    assert L.scan_wide_plan(640, 8, 132, 110000, 65536).rows == 2  # K10's W alone is 100 KiB
    assert L.scan_wide_plan(640, 8, 132, 110000, 65536, "K11").rows == 16
    assert L.scan_wide_plan(640, 8, 132, 140000, 65536).rows == 8
    assert L.scan_wide_plan(640, 8, 132, 100000, 65536) is None
    assert L.scan_wide_plan(640, 8, 132, 232448, 32768) is None
    with pytest.raises(ValueError, match="G > 512"):
        L.scan_wide_plan(512, 8, *H100)
    with pytest.raises(ValueError, match="kernel must be"):
        L.scan_wide_plan(640, 8, *H100, "K5")


def test_form_by_width_and_exchange_sizes():
    for G, want in ((512, "resident"), (513, "wide"), (520, "wide"), (640, "wide"),
                    (641, "streaming"), (1024, "streaming")):
        assert L.scan_form(G, torch.float32) == L.scan_form(G, torch.bfloat16) == want
    assert L.scan_blocks_per_chain(640, UNITS) == 32 and L.scan_blocks_per_chain(520, UNITS) == 26
    # K11's partials: per chain and step parity, 16 rows of G from each of
    # the chain's ceil(G/20) blocks
    assert L.scan_bwd_exchange_words(8, 640, UNITS) == 8 * 2 * 16 * 32 * 640
    assert L.scan_bwd_exchange_words(8, 640) == 8 * 2 * 16 * 20 * 640  # 32-unit blocks
    # K10's exchange of h is the other forms'
    assert L.scan_exchange_words(8, 640) == 8 * 2 * 16 * 640


# ---- numpy models of the kernels' maps -------------------------------------------


def _k10_share(G):
    """K10's wide form: block b owns units [20 b, 20 b + 20); lane p of
    half-warp j (thread tid = 16 j + p) owns unit u0 + j, its four gate
    columns, and k = p + 16 i for i < ceil(G/16) (W zero at k >= G);
    i < SCAN_WIDE_KREG in registers, the rest in shared memory at slot
    (i - KREG) 320 + tid (a float4 of the four gates).  Returns the count of
    each (k, gate column) and per block the slots written."""
    iters = -(-G // 16)
    seen = np.zeros((G, 4 * G), dtype=np.int64)
    slots = []
    tid = np.arange(THREADS)
    p, j = tid % 16, tid // 16
    for block in range(-(-G // UNITS)):
        unit = block * UNITS + j
        slots.append([])
        for i in range(iters):
            k = p + 16 * i
            ok = (unit < G) & (k < G)
            for q in range(4):
                np.add.at(seen, (k[ok], q * G + unit[ok]), 1)
            if i >= L.SCAN_WIDE_KREG:
                slots[-1].append((i - L.SCAN_WIDE_KREG) * THREADS + tid)
    return seen, slots, iters


def _k11_share(G):
    """K11's wide form: block b owns units [20 b, 20 b + 20) and columns c
    = 20 q + j (gate q of unit u0 + j); thread tid owns units tid and tid +
    320 against every column, c < SCAN_BWD_WIDE_CREG in registers, the rest
    in shared memory at slot (c - CREG) 320 + tid (a float2 of both
    units).  Returns the count of each (unit, gate column) and the slots."""
    seen = np.zeros((G, 4 * G), dtype=np.int64)
    slots = []
    tid = np.arange(THREADS)
    for block in range(-(-G // UNITS)):
        u0 = block * UNITS
        slots.append([])
        for c in range(COLS):
            j = c % UNITS
            if u0 + j < G:
                for unit in (tid, tid + THREADS):
                    ok = unit < G
                    np.add.at(seen, (unit[ok], np.full(ok.sum(), (c // UNITS) * G + u0 + j)), 1)
            if c >= L.SCAN_BWD_WIDE_CREG:
                slots[-1].append((c - L.SCAN_BWD_WIDE_CREG) * THREADS + tid)
    return seen, slots


@pytest.mark.parametrize("G", [520, 536, 600, 640])
def test_k10_share_covers_every_weight_once(G):
    """Every (k, gate column) of a chain's W_hh is in exactly one register
    or shared slot of one thread of one block; a block's shared slots are
    each written once, by their own thread, 32 neighbouring words a warp
    (no bank conflict), and fill the shared memory the plan counts."""
    seen, slots, iters = _k10_share(G)
    assert (seen == 1).all()
    n_slots = (iters - L.SCAN_WIDE_KREG) * THREADS
    for block in slots:
        flat = np.concatenate(block)
        assert sorted(flat.tolist()) == list(range(n_slots))
        for s in block:
            assert (np.diff(s) == 1).all() and s[0] % 32 == 0
    assert 16 * n_slots + 4 * 16 * iters * (16 + 4) == L.scan_wide_smem("K10", G, 16)


@pytest.mark.parametrize("rt", [1, 2, 4, 8, 16])
def test_k10_h_reads_are_conflict_free(rt):
    """A quarter-warp's lanes read h at eight neighbouring k, the same rows
    (a float4 of four rows, or fewer): at the resident form's padded row
    stride the 16-byte reads of one quarter-warp fall on distinct banks
    (the other half-warp reads the same words: a broadcast)."""
    stride = rt if rt <= 4 else rt + 4
    width = min(rt, 4)
    for n0 in range(0, rt, width):
        for q0 in (0, 8):
            banks = [((q0 + lane) * stride + n0 + e) % 32 for lane in range(8)
                     for e in range(width)]
            if rt >= 4:
                assert len(set(banks)) == len(banks)
            else:  # one or two words a lane: 8 lanes cover 8 or 16 neighbouring words
                assert len(set(banks)) == 8 * width


@pytest.mark.parametrize("G", [520, 536, 600, 640])
def test_k11_share_covers_every_weight_once(G):
    seen, slots = _k11_share(G)
    assert (seen == 1).all()
    n_slots = (COLS - L.SCAN_BWD_WIDE_CREG) * THREADS
    for block in slots:
        assert sorted(np.concatenate(block).tolist()) == list(range(n_slots))
    assert 8 * n_slots + 4 * 2 * COLS * 16 == L.scan_wide_smem("K11", G, 16)


@pytest.mark.parametrize("G", [520, 600, 640])
@pytest.mark.parametrize("B", [1, 3, 16])
def test_cells_and_exchange_cover_every_unit_and_row_once(G, B):
    """One step of one chain, each row group of the plan: the cells (unit
    u0 + tid % 20, row tid // 20, one a thread) own every (unit, row) once
    and write each of its four gate columns once; K10's poll asks for every
    (row, unit) word of h once a block (units tid and tid + 320, every row);
    K11's blocks publish every (row, unit) partial once each, and a cell
    reads its (row, unit) from every block's slice, so the chain's reads
    cover every slice once; K10's leading lanes own every (unit, row) of
    a pass once after the tree."""
    plan = L.scan_wide_plan(G, 8, *H100)
    nblk = plan.blocks_per_chain
    tid = np.arange(THREADS)
    for b0, nb, rt in L.scan_row_groups(B, plan.rows):
        assert nb <= rt <= 16 and THREADS == UNITS * 16
        cells = np.zeros((G, nb), dtype=np.int64)
        cols = np.zeros((nb, 4 * G), dtype=np.int64)
        polled = np.zeros((nblk, nb, G), dtype=np.int64)
        published = np.zeros((nblk, nb, G), dtype=np.int64)
        read = np.zeros((nblk, nb, G), dtype=np.int64)
        for block in range(nblk):
            u0 = block * UNITS
            cj, cb = tid % UNITS, tid // UNITS
            ok = (cb < nb) & (u0 + cj < G)
            np.add.at(cells, (u0 + cj[ok], cb[ok]), 1)
            for q in range(4):
                np.add.at(cols, (cb[ok], q * G + u0 + cj[ok]), 1)
            # K10: units tid and tid + 320, every row of the group
            for unit in (tid, tid + THREADS):
                u = unit[unit < G]
                for n in range(nb):
                    np.add.at(polled[block], (n, u), 1)
            # K10's cells: lane p of half-warp j leads row n RP + rb(p) of
            # unit u0 + j where the in-place rounds' bits of p are 0
            rp = min(rt, 8)
            scat = {8: 3, 4: 2, 2: 1, 1: 0}[rp]
            p, j = tid % 16, tid // 16
            rb = np.zeros_like(p)
            for r in range(scat):
                rb = rb + np.where(p & (8 >> r), rp >> (r + 1), 0)
            leader = (p & ((1 << (4 - scat)) - 1)) == 0
            k10 = np.zeros((G, nb), dtype=np.int64)
            for n0 in range(0, rt, rp):
                ok10 = leader & (u0 + j < G) & (n0 + rb < nb)
                np.add.at(k10, (u0 + j[ok10], (n0 + rb)[ok10]), 1)
            assert (k10[u0:min(G, u0 + UNITS)] == 1).all()
            # K11: units tid and tid + 320 publish every row of the group
            for unit in (tid, tid + THREADS):
                u = unit[unit < G]
                for n in range(nb):
                    np.add.at(published[block], (n, u), 1)
            for p in range(nblk):
                np.add.at(read[p], (cb[ok], u0 + cj[ok]), 1)
        assert (cells == 1).all() and (cols == 1).all()
        assert (polled == 1).all() and (published == 1).all() and (read == 1).all()


# ---- the orders of summation -------------------------------------------------------


def _fma32(w, h, acc):
    """f32 fused multiply-add, elementwise: the product of two f32 values
    is exact in f64, the sum rounds once there and once to f32 (the
    kernels' __fmaf_rn but for a double rounding no test input meets)."""
    return (w.astype(np.float64) * h.astype(np.float64) + acc.astype(np.float64)).astype(
        np.float32)


def _k10_wide_emulated(xp, whh, h0, c0, B):
    """K10's wide form in numpy: per (row, gate column), sixteen parts of
    k (part p: k = p + 16 i), each summed in ascending k from 0 by FMA, then
    the tree over the parts, pairs {p, p ^ 8} first, then {p, p ^ 4}, ...,
    then xp; the cell in torch's operation order (the plain version's).
    One row at a time, so a row never sees its neighbours.  This is also
    the resident form's order at the same G."""
    T, RB, G4 = xp.shape
    G = G4 // 4
    w = whh.float().numpy()
    hs = np.empty((T, RB, G), np.float32)
    hT, cT = np.empty((RB, G), np.float32), np.empty((RB, G), np.float32)
    for row in range(RB):
        wr = w[row // B]
        h, c = h0[row].numpy(), c0[row].numpy()
        for t in range(T):
            parts = np.zeros((16, G4), np.float32)
            for k in range(G):
                parts[k % 16] = _fma32(wr[k], np.float32(h[k]), parts[k % 16])
            for m in (8, 4, 2, 1):
                parts = (parts[:m] + parts[m:2 * m]).astype(np.float32)
            pre = torch.from_numpy((xp[t, row].numpy() + parts[0]).astype(np.float32))[None]
            _, cn, hn = L._cell(pre, torch.from_numpy(c)[None], G)
            c, h = cn[0].numpy(), hn[0].numpy()
            hs[t, row] = h
        hT[row], cT[row] = h, c
    return torch.from_numpy(hs), torch.from_numpy(hT), torch.from_numpy(cT)


def _k11_wide_emulated(gates, cs, c0, whh, dhs, dhT, dcT, B):
    """K11's wide form in numpy: the plain version's cell, then per block
    of 20 units its partial over its 80 columns c = 20 q + j in ascending c
    from 0 by FMA, and the blocks' partials added in block order; one row
    at a time."""
    T, RB, G4 = gates.shape
    G = G4 // 4
    w = whh.float().numpy()
    blocks = []
    for u0 in range(0, G, UNITS):
        blocks.append([q * G + u for q in range(4) for u in range(u0, min(G, u0 + UNITS))])
    dxp = torch.empty_like(gates)
    dh, dc = dhT.clone(), dcT.clone()
    for t in range(T - 1, -1, -1):
        i, f, g, o = (gates[t][:, q * G:(q + 1) * G] for q in range(4))
        cprev = cs[t - 1] if t > 0 else c0
        tc = torch.tanh(cs[t])
        dh = dh + dhs[t]
        do = dh * tc
        dct = dc + dh * o * (1.0 - tc * tc)
        dg = torch.cat([dct * g * i * (1.0 - i), dct * cprev * f * (1.0 - f),
                        dct * i * (1.0 - g * g), do * o * (1.0 - o)], dim=1)
        dxp[t] = dg
        dc = dct * f
        dgn = dg.numpy()
        new = np.empty((RB, G), np.float32)
        for row in range(RB):
            wr = w[row // B]
            total = None
            for cols in blocks:
                acc = np.zeros(G, np.float32)
                for col in cols:
                    acc = _fma32(wr[:, col], np.float32(dgn[row, col]), acc)
                total = acc if total is None else (total + acc).astype(np.float32)
            new[row] = total
        dh = torch.from_numpy(new)
    return dxp, dh, dc


def _case(T, R, B, G, seed):
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32))

    xp = t(T, R * B, 4 * G)
    whh = t(R, G, 4 * G, scale=G**-0.5)
    h0, c0 = t(R * B, G, scale=0.5), t(R * B, G, scale=0.5)
    return (xp, whh, h0, c0), (t(T, R * B, G), t(R * B, G), t(R * B, G))


def _rows(x, rows):
    return (x[:, rows] if x.dim() == 3 else x[rows]).contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k10_wide_sum_order_agrees_with_plain_and_is_row_independent(dtype):
    """At G 520, T 4, R 2, B 2: the emulated order within 1e-4 of the plain
    version (the scan kernels' gate; f32 sums in another order), and each
    row run alone gives its bits in the batch."""
    T, R, B, G = 4, 2, 2, 520
    (xp, whh, h0, c0), _ = _case(T, R, B, G, seed=520)
    whh = whh.to(dtype)
    ours = _k10_wide_emulated(xp, whh, h0, c0, B)
    ref = L.lstm_scan_plain(xp, whh, h0, c0, B)
    for a, b in zip(ours, ref):
        assert float((a - b).abs().max()) <= 1e-4
    rows = torch.tensor([r * B + (B - 1) for r in range(R)])
    alone = _k10_wide_emulated(_rows(xp, rows), whh, h0[rows], c0[rows], 1)
    assert torch.equal(alone[0], ours[0][:, rows])
    assert torch.equal(alone[1], ours[1][rows]) and torch.equal(alone[2], ours[2][rows])


def test_k11_wide_sum_order_agrees_with_plain_and_is_row_independent():
    """K11's wide order at G 520, T 3, R 2, B 2: within 1e-4 of each
    output's largest entry of the plain sweep, and row-independent."""
    T, R, B, G = 3, 2, 2, 520
    (xp, whh, h0, c0), (dhs, dhT, dcT) = _case(T, R, B, G, seed=521)
    _, _, _, gates, cs = L.lstm_scan_train_fwd_plain(xp, whh, h0, c0, B)
    args = (gates, cs, c0, whh, dhs, dhT, dcT)
    ours = _k11_wide_emulated(*args, B)
    ref = L.lstm_scan_bwd_step_plain(*args, B)
    for a, b in zip(ours, ref):
        assert float((a - b).abs().max() / b.abs().max()) <= 1e-4
    rows = torch.tensor([r * B for r in range(R)])
    alone = _k11_wide_emulated(*(_rows(a, rows) if a is not whh else a for a in args), 1)
    assert all(torch.equal(a, _rows(b, rows)) for a, b in zip(alone, ours))


# ---- the wrappers and the layer against JAX -----------------------------------------


def test_form_is_validated_before_the_route():
    """``_form="wide"`` names the wide form for 512 < G <= 640 only, on
    either device; a named form on CPU tensors runs the plain version,
    uncounted."""
    (xp, whh, h0, c0), (dhs, dhT, dcT) = _case(2, 1, 1, 520, seed=5)
    before = (L.lstm_scan.launches, L.lstm_scan_train_fwd.launches,
              L.lstm_scan_bwd_step.launches)
    ref = L.lstm_scan_plain(xp, whh, h0, c0, 1)
    fwd = L.lstm_scan_train_fwd_plain(xp, whh, h0, c0, 1)
    bref = L.lstm_scan_bwd_step_plain(fwd[3], fwd[4], c0, whh, dhs, dhT, dcT, 1)
    for form in ("wide", "streaming"):
        assert all(torch.equal(a, b)
                   for a, b in zip(L.lstm_scan(xp, whh, h0, c0, 1, _form=form), ref))
        assert all(torch.equal(a, b) for a, b in zip(
            L.lstm_scan_train_fwd(xp, whh, h0, c0, 1, _form=form), fwd))
        assert all(torch.equal(a, b) for a, b in zip(
            L.lstm_scan_bwd_step(fwd[3], fwd[4], c0, whh, dhs, dhT, dcT, 1, _form=form), bref))
    with pytest.raises(ValueError, match="up to G = 512"):
        L.lstm_scan(xp, whh, h0, c0, 1, _form="resident")
    for G in (512, 648):
        (xp, whh, h0, c0), (dhs, dhT, dcT) = _case(2, 1, 1, G, seed=6)
        with pytest.raises(ValueError, match="the wide form takes"):
            L.lstm_scan(xp, whh, h0, c0, 1, _form="wide")
        with pytest.raises(ValueError, match="the wide form takes"):
            L.lstm_scan_bwd_step(xp, xp[:, :, :G].contiguous(), c0, whh, dhs, dhT, dcT, 1,
                                 _form="wide")
    assert (L.lstm_scan.launches, L.lstm_scan_train_fwd.launches,
            L.lstm_scan_bwd_step.launches) == before


def test_the_card_streams_where_its_figures_give_no_plan(monkeypatch):
    """On a card whose figures give the wide form no plan, the form the
    width chose streams, decided before any launch; named, it raises."""

    class Ref:
        device = torch.device("cuda", 0)

    monkeypatch.setattr(L, "device_limits", lambda index: (31, 232448, 65536))
    assert L._scan_device_form("K10", Ref, 8, 640, "wide", False) == "streaming"
    assert L._scan_device_form("K11", Ref, 8, 640, "streaming", True) == "streaming"
    with pytest.raises(RuntimeError, match="holds no chain at G = 640"):
        L._scan_device_form("K11", Ref, 8, 640, "wide", True)
    monkeypatch.setattr(L, "device_limits", lambda index: H100)
    assert L._scan_device_form("K10r", Ref, 8, 640, "wide", False) == "wide"


def _layer_inputs(G, T, seed, n_in=16):
    rng = np.random.default_rng(seed)
    f = lambda *shape, s=1.0: (s * rng.standard_normal(shape)).astype(np.float32)  # noqa: E731
    return {"x": f(T, n_in), "ih_w": f(2, n_in, 4 * G, s=n_in**-0.5),
            "ih_b": f(2, 4 * G, s=0.1), "hh_w": f(2, G, 4 * G, s=G**-0.5),
            "hh_b": f(2, 4 * G, s=0.1), "h0": f(2, G, s=0.5), "c0": f(2, G, s=0.5),
            "dout": f(T, 2 * G), "dhT": f(2, G), "dcT": f(2, G)}


def test_scan_layer_and_its_vjp_match_jax_at_g520():
    """The float32 layer at G 520 (on the card K10 with residuals and K11
    in their wide forms; their plain versions here), one row, 5 steps,
    against ``_bilstm_layer`` and ``jax.vjp`` of it: every output and
    every input's gradient within 1e-5 of its largest entry."""
    G, T = 520, 5
    c = _layer_inputs(G, T, seed=520)
    names = ("x", "ih_w", "ih_b", "hh_w", "hh_b", "h0", "c0")
    out, vjp = jax.vjp(lambda *a: jumx._bilstm_layer(*a, "default"),
                       *(jnp.asarray(c[n]) for n in names))
    grads = vjp((jnp.asarray(c["dout"]), (jnp.asarray(c["dhT"]), jnp.asarray(c["dcT"]))))
    ref_out = (np.asarray(out[0]), np.asarray(out[1][0]), np.asarray(out[1][1]))
    leaves = {n: torch.from_numpy(c[n]).requires_grad_() for n in names}
    x = leaves["x"]
    xs = torch.stack([x, x.flip(0)])  # (D, T, in)
    proj = torch.einsum("dti,dig->tdg", xs, leaves["ih_w"]) + leaves["ih_b"] + leaves["hh_b"]
    hs, hT, cT = L.lstm_layer_scan_batched(proj[None, None], leaves["hh_w"][None],
                                           leaves["h0"][None, None], leaves["c0"][None, None])
    ours = torch.cat([hs[0, 0, :, 0], hs[0, 0, :, 1].flip(0)], dim=-1)
    loss = ((ours * torch.from_numpy(c["dout"])).sum()
            + (hT[0, 0] * torch.from_numpy(c["dhT"])).sum()
            + (cT[0, 0] * torch.from_numpy(c["dcT"])).sum())
    loss.backward()
    for o, r in zip((ours, hT[0, 0], cT[0, 0]), ref_out):
        o = o.detach().numpy()
        assert o.shape == r.shape
        assert np.max(np.abs(o - r)) <= 1e-5
    for n, g in zip(names, grads):
        g = np.asarray(g)
        got = leaves[n].grad.numpy()
        assert got.shape == g.shape
        assert np.max(np.abs(got - g)) / np.max(np.abs(g)) <= 1e-5, n
