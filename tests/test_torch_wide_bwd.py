"""The block form of the reverse-sweep kernel K5 above G 512 (the wide K5,
``csrc/lstm_train.cu:lstm_bwd_block_kernel``): the planner that picks a
block form from the card's figures, a numpy model of where a block keeps
each weight of W_hh^T (register tiles, then shared tiles) and of the
cells, dg columns, exchange slots and flags of a step, a torch emulation
of its order of summation held against the plain sweep, the zero-unit
padding of wide widths, the ``_form`` argument, and the merged layer's VJP
at G 520 against the JAX package's Pallas kernels in interpret mode.  The
kernel runs only on a GPU (``tests/test_torch_cuda.py``)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from umx_tpu_torch.ops import lstm_cuda as L

# An H100 SXM: SMs, the shared memory a block may ask for, registers an SM
H100 = (132, 232448, 65536)
WARPS = L.BWD_BLOCK_WARPS


def _plan(G, R, card=H100):
    return L.merged_bwd_wide_plan(L.merged_width(G), R, *card)


@pytest.mark.parametrize("R", [1, 3, 8, 16, 24])
def test_plans_fit_the_card_and_cover_g_and_r(R):
    """At every G from 513 to 1100 (at the kernel's width, a multiple of 8):
    the warps' m-tiles cover the chain's units, the blocks its units, a
    group's blocks never exceed the SMs, a block's shared memory and
    registers fit, the chain groups cover R, and the form is the one chosen
    at R 1 (it depends on G alone); a plan exists exactly up to
    ``BWD_WIDE_G_MAX``."""
    sms, smem_max, regs = H100
    for G in range(513, 1101):
        Gp = L.merged_width(G)
        plan = _plan(G, R)
        assert (plan is not None) == (Gp <= L.BWD_WIDE_G_MAX), G
        if plan is None:
            continue
        assert (plan.mtw, plan.units, plan.kreg) in L.BWD_BLOCK_FORMS
        assert plan.kreg + plan.ksmem == plan.mtw * plan.units // 4
        assert 16 * WARPS * plan.mtw >= Gp
        assert plan.blocks_per_chain == -(-Gp // plan.units)
        assert (plan.blocks_per_chain - 1) * plan.units < Gp
        assert plan.blocks_per_chain <= L.BWD_BLOCK_FLAG_WORDS
        assert plan.blocks_per_chain * plan.chains_per_group <= sms
        assert 1 <= plan.chains_per_group <= R
        assert plan.rows in (8, 16)
        assert plan.smem == L.bwd_block_smem(plan.mtw, plan.units, plan.kreg,
                                             plan.rows) <= smem_max
        assert (4 * plan.kreg + L.BWD_BLOCK_OTHER_REGS[plan.mtw]
                <= L.merged_thread_regs(WARPS, regs))
        assert plan[:5] == _plan(G, 1)[:5]
        groups = L.chain_groups(R, plan.blocks_per_chain,
                                plan.blocks_per_chain * plan.chains_per_group, "wide K5")
        chains = [r for r0, nr in groups for r in range(r0, r0 + nr)]
        assert chains == list(range(R))


def test_the_widest_g_one_chain_fits_is_the_figure_written_down():
    """BWD_WIDE_G_MAX: 8 warps of 8 m-tiles cover 1024 units; the chain is
    32 blocks of 32 units, each with its 128 gate columns against all 1024
    units (256 KiB of bf16 W_hh^T: 20 tiles a warp in registers, 44 in
    shared memory beside 16 rows of dg), 8.4 MB a chain."""
    plan = L.merged_bwd_wide_plan(L.BWD_WIDE_G_MAX, 1, *H100)
    assert plan == L.BwdBlockPlan(8, 32, 20, 44, 16, 32, 1, 184576)
    assert L.merged_bwd_wide_plan(L.BWD_WIDE_G_MAX + 8, 1, *H100) is None
    assert 16 * WARPS * max(m for m, _, _ in L.BWD_BLOCK_FORMS) == L.BWD_WIDE_G_MAX
    assert 2 * L.BWD_WIDE_G_MAX * 4 * 32 == 256 * 1024
    assert 8 * L.BWD_WIDE_G_MAX ** 2 == 8388608


@pytest.mark.parametrize("G, R, want", [
    # UMX-style chains of hidden 1280: 16 blocks of 40 units, R 8 in one
    # wave of 128 blocks; 24 register and 26 shared tiles a warp
    (640, 8, (5, 40, 24, 26, 16, 16, 8, 111872)),
    (640, 16, (5, 40, 24, 26, 16, 16, 8, 111872)),
    (520, 8, (5, 40, 24, 26, 16, 13, 8, 111872)),
    # above 640 the second form: 32 units, two chain groups
    (648, 8, (8, 32, 20, 44, 16, 21, 6, 184576)),
    (1024, 8, (8, 32, 20, 44, 16, 32, 4, 184576)),
    (1024, 24, (8, 32, 20, 44, 16, 32, 4, 184576)),
])
def test_plans_at_the_paths_widths(G, R, want):
    assert tuple(_plan(G, R)) == want


def test_plans_follow_the_cards_figures():
    """A card with fewer SMs gets more chain groups; with less shared
    memory a row tile of 8 or no plan; with fewer registers no form whose
    register tiles do not fit; G % 8 != 0 is refused (the wrapper pads)."""
    big = _plan(640, 8)
    small = _plan(640, 8, (66, 232448, 65536))
    assert small[:6] == big[:6] and -(-8 // small.chains_per_group) > 1
    assert _plan(1024, 8, (132, 101376, 65536)) is None
    assert _plan(640, 8, (132, 101376, 65536)) is None
    assert _plan(640, 8, (132, 110000, 65536)).rows == 8
    assert _plan(640, 8, (132, 232448, 32768)) is None
    assert _plan(1024, 1, (31, 232448, 65536)) is None  # 32 blocks a chain, 31 SMs
    with pytest.raises(ValueError, match="G % 8"):
        L.merged_bwd_wide_plan(644, 8, *H100)


def _tiles_of_a_block_form(G, mtw, units, kreg):
    """(unit, gate column) of every bf16 weight each thread of a chain keeps,
    as the kernel lays them out: block b owns the units from u0 = b units
    and local columns l (gate l // units of unit u0 + l % units); warp w of
    it takes m-tiles w + 8 i of the chain; tile s = kt mtw + i is in
    registers for s < kreg, else in shared memory at slot ((s - kreg) 8 +
    w) 32 + lane, 16 bytes each.  Returns the count of each weight and, per
    block, the shared slots its threads write."""
    kl = units // 4
    MT = -(-G // 16)
    seen = np.zeros((G, 4 * G), dtype=np.int64)
    slots = []
    lane = np.arange(32)
    g, tq = lane >> 2, lane & 3
    for block in range(-(-G // units)):
        u0 = block * units
        slots.append([])
        for warp in range(WARPS):
            for s in range(mtw * kl):
                kt, i = divmod(s, mtw)
                m = warp + WARPS * i
                if s >= kreg:
                    slots[-1].append(((s - kreg) * WARPS + warp) * 32 + lane)
                if m >= MT:
                    continue
                for v, l in ((16 * m + g, 16 * kt + 2 * tq), (16 * m + g + 8, 16 * kt + 2 * tq),
                             (16 * m + g, 16 * kt + 2 * tq + 8),
                             (16 * m + g + 8, 16 * kt + 2 * tq + 8)):
                    for e in (0, 1):
                        unit = u0 + (l + e) % units
                        col = (l + e) // units * G + unit
                        ok = (v < G) & (unit < G)
                        np.add.at(seen, (v[ok], col[ok]), 1)
    return seen, slots


@pytest.mark.parametrize("mtw, units, kreg, G", [(5, 40, 24, 520), (5, 40, 24, 640),
                                                 (8, 32, 20, 648), (8, 32, 20, 1024),
                                                 (5, 40, 24, 536)])
def test_register_and_shared_tiles_cover_every_weight_once(mtw, units, kreg, G):
    """Every (unit, gate column) of a chain's W_hh (G x 4G) is in exactly
    one register half of one thread of one block, in a register tile or a
    shared one; a block's shared slots are each written once, by their own
    thread, 32 neighbouring 16-byte words a warp and tile (no bank
    conflict); a register's two halves are neighbouring units of one gate
    (one aligned 32-bit load)."""
    assert (mtw, units, kreg) in L.BWD_BLOCK_FORMS and units % 2 == 0 and G % 8 == 0
    seen, slots = _tiles_of_a_block_form(G, mtw, units, kreg)
    assert (seen == 1).all()
    n_slots = (mtw * units // 4 - kreg) * WARPS * 32
    for block in slots:
        flat = np.concatenate(block)
        assert sorted(flat.tolist()) == list(range(n_slots))
        for s in block:
            assert (np.diff(s) == 1).all() and s[0] % 32 == 0
    assert L.bwd_block_smem(mtw, units, kreg, 16) == 16 * n_slots + 4 * 16 * (2 * units + 4)


@pytest.mark.parametrize("G", [520, 640, 1024])
@pytest.mark.parametrize("B", [1, 3, 9, 16])
def test_cells_slots_and_flags_cover_every_unit_gate_and_row_once(G, B):
    """One step of one chain in the plan's form, each row group: the cells
    (c = tid + 256 e: unit u0 + c % units, row c // units) own every (unit,
    row) once; their bf16 dg cover every (row, gate column) once and a
    block's local column l = gate x units + unit - u0 once; a warp's B
    fragments read every local (row, column) of the row tile once; the
    warps' exchange stores write every (row, unit) of the block's slice
    once; a cell reads its (row, unit) from every block's slice, so the
    chain's reads cover every slice once; one flag a block, polled once by
    warp 0."""
    plan = _plan(G, 8)
    units, mtw = plan.units, plan.mtw
    nblk, MT = plan.blocks_per_chain, -(-G // 16)
    assert nblk <= L.BWD_BLOCK_FLAG_WORDS
    for b0, nb in L.resident_row_groups(B, plan.rows):
        nt = 2 if nb > 8 else 1
        rows8 = 8 * nt
        cells_per_thread = -(-units * rows8 // 256)
        cells = np.zeros((G, nb), dtype=np.int64)
        cols = np.zeros((nb, 4 * G), dtype=np.int64)
        stores = np.zeros((nblk, nb, G), dtype=np.int64)
        reads = np.zeros((nblk, nb, G), dtype=np.int64)
        for block in range(nblk):
            u0 = block * units
            local = np.zeros((rows8, 4 * units), dtype=np.int64)
            for tid in range(256):
                for e in range(cells_per_thread):
                    c = tid + 256 * e
                    n, unit = c // units, u0 + c % units
                    if c < units * rows8 and unit < G and n < nb:
                        cells[unit, n] += 1
                        reads[:, n, unit] += 1
                        for q in range(4):
                            cols[n, q * G + unit] += 1
                            local[n, q * units + unit - u0] += 1
            assert local.max() == 1
            lane = np.arange(32)
            g, tq = lane >> 2, lane & 3
            for warp in range(WARPS):
                frag = np.zeros((rows8, 4 * units), dtype=np.int64)
                for kt in range(units // 4):
                    for j in range(nt):
                        for dw in (0, 4):  # b0 and b1: words kt 8 + tq and 4 further
                            word = kt * 8 + tq + dw
                            for h in (0, 1):
                                np.add.at(frag, (j * 8 + g, 2 * word + h), 1)
                assert (frag == 1).all()
                for i in range(mtw):
                    m = warp + WARPS * i
                    if m >= MT:
                        continue
                    for j in range(nt):
                        for e in range(4):
                            v = 16 * m + g + (e >> 1) * 8
                            n = j * 8 + 2 * tq + (e & 1)
                            ok = (v < G) & (n < nb)
                            np.add.at(stores[block], (n[ok], v[ok]), 1)
        assert (cells == 1).all() and (cols == 1).all()
        assert (stores == 1).all() and (reads == 1).all()
        polled = [bb for lane in range(32) for bb in range(lane, nblk, 32)]
        assert sorted(polled) == list(range(nblk))


def _case(T, R, B, G, seed):
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32))

    xp = t(T, R * B, 4 * G)
    whh = t(R, G, 4 * G, scale=G**-0.5).to(torch.bfloat16)
    h0, c0 = t(R * B, G, scale=0.5), t(R * B, G, scale=0.5)
    return (xp, whh, h0, c0), (t(T, R * B, G), t(R * B, G), t(R * B, G))


def _sweep_emulated(gates, cs, c0, whh, dhs, dhT, dcT, B, units):
    """The block form's arithmetic in torch: the resident form's cell, then
    per block of ``units`` units its partial sums over its local columns
    (gate l // units of unit u0 + l % units), one k-tile of 16 after
    another into one accumulator, and the blocks' partials added in block
    order; one row at a time (a row never sees its neighbours)."""
    T, RB, G4 = gates.shape
    G = G4 // 4
    w = whh.float()
    blocks = []
    for u0 in range(0, G, units):
        cols = torch.tensor([q * G + u for q in range(4) for u in range(u0, u0 + units)])
        cols = cols.view(4, units).flatten()
        keep = torch.tensor([u < G for q in range(4) for u in range(u0, u0 + units)])
        blocks.append((cols.clamp(max=G4 - 1), keep))
    dxp = torch.empty_like(gates)
    dh, dc = dhT.clone(), dcT.clone()
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
            total = None
            for cols, keep in blocks:
                d = torch.where(keep, dgb[row, cols], torch.zeros(()))
                wl = torch.where(keep[None], wr[:, cols], torch.zeros(()))
                acc = None
                for k0 in range(0, len(cols), 16):
                    p = torch.mv(wl[:, k0:k0 + 16], d[k0:k0 + 16])
                    acc = p if acc is None else acc + p
                total = acc if total is None else total + acc
            dh[row] = total
    return dxp, dh, dc


@pytest.mark.parametrize("G, B, units", [(80, 3, 40), (96, 2, 32), (520, 2, 40)])
def test_block_sum_order_agrees_with_plain_and_is_row_independent(G, B, units):
    T, R = 3 if G > 100 else 5, 2
    (xp, whh, h0, c0), (dhs, dhT, dcT) = _case(T, R, B, G, seed=G + B)
    _, _, _, gates, cs = L.lstm_merged_train_fwd_plain(xp, whh, h0, c0, B)
    ours = _sweep_emulated(gates, cs, c0, whh, dhs, dhT, dcT, B, units)
    ref = L.lstm_merged_bwd_step_plain(gates, cs, c0, whh, dhs, dhT, dcT, B)
    # another order of f32 sums, bf16 roundings of dg that may flip: the
    # kernels' own bound against plain, of each output's largest entry
    for a, b in zip(ours, ref):
        assert ((a - b).abs().max() / b.abs().max()).item() <= 5e-3
    rows = torch.tensor([r * B + (B - 1) for r in range(R)])
    alone = _sweep_emulated(gates[:, rows].contiguous(), cs[:, rows].contiguous(), c0[rows], whh,
                            dhs[:, rows].contiguous(), dhT[rows], dcT[rows], 1, units)
    assert torch.equal(alone[0], ours[0][:, rows])
    assert torch.equal(alone[1], ours[1][rows]) and torch.equal(alone[2], ours[2][rows])


@pytest.mark.parametrize("G, B", [(644, 1), (644, 3), (530, 2)])
def test_padded_wide_widths_are_exact(G, B):
    """Wide widths that are no multiple of 8 run the block form at the next
    multiple with zero units (``at_width``): the plain sweep padded and cut
    is bit-equal to the plain sweep at G, as at the resident widths."""
    T, R = 3, 2
    Gp = L.merged_width(G)
    assert Gp % 8 == 0 and Gp - G < 8 and L.merged_form(G) == "wide"
    assert L.merged_bwd_wide_plan(Gp, R, *H100) is not None
    (xp, whh, h0, c0), (dhs, dhT, dcT) = _case(T, R, B, G, seed=G + B)
    _, _, _, gates, cs = L.lstm_merged_train_fwd_plain(xp, whh, h0, c0, B)
    args = (gates, cs, c0, whh, dhs, dhT, dcT, B)
    bwd = L.lstm_merged_bwd_step_plain(*args)
    padded = L.at_width(L.lstm_merged_bwd_step_plain, G, Gp, args, L._BWD_KINDS, L._BWD_OUT)
    assert all(torch.equal(a, b) for a, b in zip(padded, bwd))


def test_form_is_validated_before_the_route():
    """``_form`` names a wide form above G 512 only (as K1's does), on
    either device; a named form on CPU tensors runs the plain version,
    uncounted."""
    (xp, whh, h0, c0), (dhs, dhT, dcT) = _case(2, 1, 1, 520, seed=5)
    _, _, _, gates, cs = L.lstm_merged_train_fwd_plain(xp, whh, h0, c0, 1)
    args = (gates, cs, c0, whh, dhs, dhT, dcT, 1)
    before = L.lstm_merged_bwd_step.launches
    ref = L.lstm_merged_bwd_step_plain(*args)
    for form in ("wide", "wide_streaming"):
        out = L.lstm_merged_bwd_step(*args, _form=form)
        assert all(torch.equal(a, b) for a, b in zip(out, ref))
    with pytest.raises(ValueError, match="form must be"):
        L.lstm_merged_bwd_step(*args, _form="streaming")
    (xp, whh, h0, c0), (dhs, dhT, dcT) = _case(2, 1, 1, 512, seed=5)
    _, _, _, gates, cs = L.lstm_merged_train_fwd_plain(xp, whh, h0, c0, 1)
    with pytest.raises(ValueError, match="form must be"):
        L.lstm_merged_bwd_step(gates, cs, c0, whh, dhs, dhT, dcT, 1, _form="wide")
    assert L.lstm_merged_bwd_step.launches == before


def test_merged_training_vjp_matches_jax_at_g520():
    """The differentiable merged layer at G 520 (on the card K4 and K5 in
    their wide block forms and K6; their plain versions here) against
    ``jax.vjp`` of the JAX package's custom-VJP kernels in interpret mode,
    one target (R 2), one row, 4 steps."""
    import jax
    import jax.numpy as jnp

    from umx_tpu.ops.lstm_pallas import lstm_layer_pallas_merged_batched

    B, G, T, n_t = 1, 520, 4, 1
    rng = np.random.default_rng(520)
    x_proj = rng.standard_normal((B, n_t, T, 2, 4 * G)).astype(np.float32)
    hh_w = (rng.standard_normal((n_t, 2, G, 4 * G)) / np.sqrt(G)).astype(np.float32)
    h0, c0 = ((0.5 * rng.standard_normal((B, n_t, 2, G))).astype(np.float32) for _ in range(2))
    cts = tuple(rng.standard_normal(s).astype(np.float32)
                for s in ((B, n_t, T, 2, G), (B, n_t, 2, G), (B, n_t, 2, G)))
    out, vjp = jax.vjp(lambda *a: lstm_layer_pallas_merged_batched(*a, time_block=4,
                                                                    interpret=True),
                       *map(jnp.asarray, (x_proj, hh_w, h0, c0)))
    grads = vjp(tuple(map(jnp.asarray, cts)))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x_proj, hh_w, h0, c0)]
    ours = L.lstm_layer_merged_batched(*leaves)
    loss = sum((o * torch.from_numpy(c)).sum() for o, c in zip(ours, cts))
    ours_g = torch.autograd.grad(loss, leaves)
    # bf16 operands on both sides, f32 sums in other orders (the 1e-4 of
    # tests/test_torch_model.py's VJP at G 18)
    for o, r in zip((*ours, *ours_g), (*out, *grads)):
        o, r = o.detach().numpy().astype(np.float64), np.asarray(r, np.float64)
        assert o.shape == r.shape
        assert np.max(np.abs(o - r)) / np.max(np.abs(r)) <= 1e-4
