"""K6, the merged layer's weight gradient, in its Hopper form
(``umx_tpu_torch/csrc/lstm_dw.cu``), on the CPU: the form chosen from the
shape, the launch plan from the card's figures, the output tiles and the
contraction's stages the kernel addresses, and an emulation of its
accumulation order built from the tensor-map boxes it copies, against the
plain version; then the plain version against the JAX package's merged
backward (Pallas interpret mode).  No GPU is needed: the kernel's shapes,
boxes and order are pure functions of the plan."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from umx_tpu.ops.lstm_pallas import lstm_layer_pallas_merged_batched
from umx_tpu_torch.ops import lstm_cuda as L

# What an H100 reports for the form: clusters of two blocks it holds at
# once (one block an SM) at 256 and at 128 columns a block.
HELD = {256: 66, 128: 66}

# (T, R, B, G) of the shapes the paths give K6: UMX-L training, its batch-32
# rate, hidden 1280 under "auto", train_umx at UMX-HQ, the mesh's grid cell
PATH_SHAPES = {
    "umxl_train": (256, 8, 16, 512),
    "umxl_batch32": (256, 8, 32, 512),
    "hidden1280": (256, 8, 16, 640),
    "umxhq_train_umx": (256, 8, 4, 256),
    "mesh_cell": (256, 4, 8, 512),
}
# the plan each takes on those figures: (columns a block, rows a box, steps a
# stage, boxes a step, stages, unit-tile pairs, column tiles, clusters, waves)
PATH_PLANS = {
    "umxl_train": (256, 16, 2, 1, 128, 2, 8, 128, 2),
    "umxl_batch32": (256, 32, 1, 1, 256, 2, 8, 128, 2),
    "hidden1280": (256, 16, 2, 1, 128, 3, 10, 240, 4),
    "umxhq_train_umx": (128, 4, 8, 1, 32, 1, 8, 64, 1),
    "mesh_cell": (256, 8, 4, 1, 64, 2, 8, 64, 1),
}
# The same shapes narrowed (a few steps, G 40-136), shapes whose T*B is no
# multiple of a stage's 32 pairs, B above 32 (two boxes a step), R 1, and
# chains of more stages than DW_PROMOTE (sums added into dW twice, thrice)
NARROW_SHAPES = [
    (4, 8, 16, 40), (3, 8, 32, 72), (4, 8, 16, 136), (5, 8, 4, 48), (4, 4, 8, 96),
    (7, 2, 5, 40), (3, 2, 40, 64), (9, 1, 3, 72), (1, 1, 1, 8), (2, 1, 7, 64),
    (40, 2, 16, 40), (150, 1, 16, 8), (140, 1, 40, 8),
]


def _plan(T, R, B, G, held=None):
    return L.dw_plan(T, R, B, G, HELD if held is None else held)


@pytest.mark.parametrize("G, form", [(8, "wgmma"), (40, "wgmma"), (72, "wgmma"),
                                     (130, "wgmma"), (136, "wgmma"), (18, "wgmma"),
                                     (256, "wgmma"), (512, "wgmma"), (640, "wgmma"),
                                     (2, "wgmma")])
def test_form_comes_from_the_width(G, form):
    """The Hopper form at every width: where TMA cannot stride the rows (G %
    4 != 0) at K4's and K5's padded width, so no path runs the mma_sync form."""
    assert L.dw_form(G) == form
    assert L.dw_width(G) % 4 == 0 and L.dw_width(G) - G < 8
    assert L.dw_width(G) == (G if G % 4 == 0 else L.merged_width(G))


@pytest.mark.parametrize("name", list(PATH_SHAPES))
def test_plan_at_the_path_shapes(name):
    plan = _plan(*PATH_SHAPES[name])
    assert plan[:8] + (plan.waves,) == PATH_PLANS[name]
    assert plan.held == HELD[plan.bn]
    assert plan.bp * plan.tb == L.DW_BK


def test_plan_weighs_waves_against_the_narrower_tile():
    # UMX-HQ's 64 clusters of 256 columns fill half the card: 128 columns
    # take the same single wave at two thirds of the cost a column
    assert _plan(256, 8, 16, 256).bn == 128
    # a card that holds only 16 clusters: UMX-L needs 8 waves at 256 and 16
    # at 128, and 8 x 80 < 16 x 52 KiB
    assert _plan(256, 8, 16, 512, {256: 16, 128: 16}).bn == 256
    # a form the card cannot hold is not planned; none at all raises
    assert _plan(256, 8, 16, 512, {256: 0, 128: 66}).bn == 128
    with pytest.raises(RuntimeError, match="holds no cluster"):
        _plan(256, 8, 16, 512, {256: 0, 128: 0})
    with pytest.raises(ValueError, match="G % 4"):
        _plan(4, 1, 1, 130)


@pytest.mark.parametrize("B, bp, tb, nbc", [(1, 1, 32, 1), (3, 4, 8, 1), (5, 8, 4, 1),
                                            (16, 16, 2, 1), (17, 32, 1, 1), (32, 32, 1, 1),
                                            (33, 32, 1, 2), (100, 32, 1, 4)])
def test_rows_a_box_and_steps_a_stage(B, bp, tb, nbc):
    plan = _plan(7, 2, B, 40)
    assert (plan.bp, plan.tb, plan.nbc) == (bp, tb, nbc)
    assert plan.stages == -(-7 * nbc // tb)


def _shapes():
    return [*PATH_SHAPES.values(), *NARROW_SHAPES]


@pytest.mark.parametrize("shape", _shapes(), ids=str)
@pytest.mark.parametrize("held", [HELD, {256: 0, 128: 66}], ids=["auto", "bn128"])
def test_output_tiles_cover_dw_exactly_once(shape, held):
    T, R, B, G = shape
    plan = _plan(T, R, B, G, held)
    tiles = L.dw_tiles(plan)
    assert len(tiles) == L.DW_CLUSTER * plan.clusters
    cover = np.zeros((R, G, 4 * G), np.int32)
    for block, (r, m0, n0) in enumerate(tiles):
        assert 0 <= r < R and m0 % L.DW_BM == 0 and n0 % plan.bn == 0 and n0 < 4 * G
        cover[r, m0:m0 + L.DW_BM, n0:n0 + plan.bn] += 1
        if block % L.DW_CLUSTER:  # the pair of a cluster: same chain and columns
            r1, m1, n1 = tiles[block - 1]
            assert (r1, n1, m1 + L.DW_BM) == (r, n0, m0)
            # only the second tile of a pair may lie past G (odd tile counts)
            assert m1 < G
    assert (cover == 1).all()


@pytest.mark.parametrize("shape", _shapes(), ids=str)
def test_stages_cover_every_pair_of_a_chain_once(shape):
    """Each (t, b) pair of a chain is one row of exactly one stage; its h
    row is h0 at t = 0 and hs[t - 1] inside hs's map (steps 0 .. T-2)
    above; every other row of a stage (b past B, t past T-1) reads zeros
    from both boxes."""
    T, R, B, G = shape
    plan = _plan(T, R, B, G)
    seen = np.zeros((T, B), np.int32)
    steps_in_map = max(T - 1, 1)
    for s, (t0, b0) in enumerate(L.dw_stages(plan)):
        assert 0 <= b0 < max(B, 1) and b0 % L.DW_BK == 0
        # h0's own region is written once: only stage 0 reads it
        assert not (t0 == 0 and plan.tb > 1) or s == 0
        for k in range(L.DW_BK):
            j, b = divmod(k, plan.bp)
            t, row = t0 + j, b0 + b
            h_step = t0 - 1 + j  # hs's box coordinate for this row
            if t < T and row < B:
                seen[t, row] += 1
                if t == 0:
                    assert k < plan.bp and h_step == -1  # h0's box fills these rows
                else:
                    assert 0 <= h_step < steps_in_map and h_step == t - 1
            else:  # outside dxp's map: zeros, so the row adds 0 whatever h is
                assert t >= T or row >= B
    assert (seen == 1).all()


def _box(x, t0: int, steps: int, b0: int, rows: int, c0: int, width: int, r: int):
    """A TMA box of f32 ``x`` (steps, R, B, W): steps [t0, t0 + steps), rows
    [b0, b0 + rows), columns [c0, c0 + width) of chain r, zeros outside the
    tensor, as (steps * rows, width)."""
    nt, _, nb, nw = x.shape
    out = torch.zeros((steps, rows, width), dtype=torch.float32)
    for j in range(steps):
        t = t0 + j
        if 0 <= t < nt:
            b1, c1 = min(rows, nb - b0), min(width, nw - c0)
            if b1 > 0 and c1 > 0:
                out[j, :b1, :c1] = x[t, r, b0:b0 + b1, c0:c0 + c1]
    return out.reshape(steps * rows, width)


def _emulate(hs, h0, dxp, B: int, plan, ordered: bool = False):
    """K6's Hopper form on the CPU, block by block and stage by stage: each
    stage's f32 boxes as the kernel copies them (hs at step t0 - 1; at t0 =
    0 h0's box, the stage's h rows where a stage is one step, else rows [0,
    bp) from h0's own region; dxp in two halves of the block's columns), rounded to
    bf16, then the stage's two k16 slices of 16 pairs added into the
    tensor cores' f32 sums in order, and those of every DW_PROMOTE stages
    of a slice added into the slice's partial tile, in order; then the
    slices' partial tiles added in slice order (the second pass); past G
    or 4G cut.  ``ordered``: each k16 slice as 16 outer products added one
    after another, an order that is the same for every entry wherever its
    tile lies."""
    T, RB, G = hs.shape
    R = RB // B
    hs_map = hs.view(T, R, B, G)[:max(T - 1, 1)]
    h0_map = h0.view(1, R, B, G)
    dx_map = dxp.view(T, R, B, 4 * G)
    dw = torch.full((R, G, 4 * G), float("nan"))
    half = plan.bn // 2
    stages = L.dw_stages(plan)
    parts = {}
    for r, m0, n0, s_begin, s_end in L.dw_blocks(plan):
        tile = None
        for i, s in enumerate(range(s_begin, s_end)):
            t0, b0 = stages[s]
            if i % L.DW_PROMOTE == 0:
                acc = torch.zeros((L.DW_BM, plan.bn))
            if t0 == 0 and plan.tb == 1:  # h0's box fills the stage's h rows
                a = _box(h0_map, 0, 1, b0, plan.bp, m0, L.DW_BM, r)
            else:  # hs at steps t0 - 1 ..., and at t0 = 0 h0's rows from their region
                a = _box(hs_map, t0 - 1, plan.tb, b0, plan.bp, m0, L.DW_BM, r)
                if t0 == 0:
                    a[:plan.bp] = _box(h0_map, 0, 1, b0, plan.bp, m0, L.DW_BM, r)
            b = torch.cat([_box(dx_map, t0, plan.tb, b0, plan.bp, n0 + h * half, half, r)
                           for h in range(2)], dim=1)
            a, b = a.to(torch.bfloat16).float(), b.to(torch.bfloat16).float()
            for kk in range(0, L.DW_BK, 16):
                if ordered:
                    part = a[kk][:, None] * b[kk][None, :]
                    for k in range(kk + 1, kk + 16):
                        part = part + a[k][:, None] * b[k][None, :]
                    acc += part
                else:
                    acc += a[kk:kk + 16].T @ b[kk:kk + 16]
            if (i + 1) % L.DW_PROMOTE == 0 or s + 1 == s_end:
                tile = acc if tile is None else tile + acc
        key = (r, m0, n0)
        parts[key] = tile if key not in parts else parts[key] + tile
    for (r, m0, n0), tile in parts.items():
        m1, n1 = min(m0 + L.DW_BM, G), min(n0 + plan.bn, 4 * G)
        if m1 > m0:
            dw[r, m0:m1, n0:n1] = tile[:m1 - m0, :n1 - n0]
    return dw


def _dw_inputs(T, R, B, G, seed):
    rng = np.random.default_rng(seed)
    hs = np.tanh(rng.standard_normal((T, R * B, G))).astype(np.float32)
    h0 = np.tanh(rng.standard_normal((R * B, G))).astype(np.float32)
    dxp = (0.1 * rng.standard_normal((T, R * B, 4 * G))).astype(np.float32)
    return torch.from_numpy(hs), torch.from_numpy(h0), torch.from_numpy(dxp)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("shape", NARROW_SHAPES, ids=str)
@pytest.mark.parametrize("held", [HELD, {256: 0, 128: 66}], ids=["auto", "bn128"])
def test_emulated_order_matches_plain_and_repeats(shape, held):
    """bf16 products are exact in f32; the emulation sums them in the
    kernel's order (stages in order, 16 pairs at a time) and the plain
    version in one bmm's: within 1e-5 of max|dW|, and the same bits from
    run to run."""
    T, R, B, G = shape
    hs, h0, dxp = _dw_inputs(T, R, B, G, seed=T * G + B)
    plan = _plan(T, R, B, G, held)
    got = _emulate(hs, h0, dxp, B, plan)
    ref = L.lstm_merged_dw_plain(hs, h0, dxp, B)
    assert not got.isnan().any()
    assert _rel(got, ref) <= 1e-5
    assert torch.equal(got, _emulate(hs, h0, dxp, B, plan))


def test_wrapper_forms_on_the_cpu():
    """On CPU tensors either form is the plain version, at any G; a form
    that does not exist raises."""
    hs, h0, dxp = _dw_inputs(3, 2, 5, 40, seed=1)
    ref = L.lstm_merged_dw_plain(hs, h0, dxp, 5)
    before = L.lstm_merged_dw.launches
    for form in (None, "wgmma", "mma_sync"):
        assert torch.equal(L.lstm_merged_dw(hs, h0, dxp, 5, _form=form), ref)
    assert L.lstm_merged_dw.launches == before
    with pytest.raises(ValueError, match="form must be"):
        L.lstm_merged_dw(hs, h0, dxp, 5, _form="cutlass")
    hs, h0, dxp = _dw_inputs(2, 1, 2, 18, seed=2)
    for form in (None, "wgmma", "mma_sync"):
        assert torch.equal(L.lstm_merged_dw(hs, h0, dxp, 2, _form=form),
                           L.lstm_merged_dw_plain(hs, h0, dxp, 2))


def test_plain_dw_matches_the_jax_merged_backward():
    """lstm_merged_dw_plain on the residuals of the plain forward and the
    dxp of the plain sweep against dW of ``jax.vjp`` of the JAX package's
    merged layer (its Pallas kernels in interpret mode), at T 9 (no
    multiple of the time block), 2 targets x 2 directions, B 3, G 24:
    both round h and the gate cotangents to bf16 and sum in f32 in other
    orders, so within 1e-4 of max|dW| (the bound of
    tests/test_torch_lstm_train.py)."""
    Bn, Tn, T, D, G = 3, 2, 9, 2, 24
    rng = np.random.default_rng(22)

    def mk(*shape, a=1.0):
        return (a * rng.standard_normal(shape)).astype(np.float32)

    prim = (mk(Bn, Tn, T, D, 4 * G, a=0.5), mk(Tn, D, G, 4 * G, a=G**-0.5),
            mk(Bn, Tn, D, G, a=0.5), mk(Bn, Tn, D, G, a=0.5))
    cts = (mk(Bn, Tn, T, D, G), mk(Bn, Tn, D, G), mk(Bn, Tn, D, G))

    def f(*a):
        return lstm_layer_pallas_merged_batched(*a, time_block=4, interpret=True)

    _, vjp = jax.vjp(f, *map(jnp.asarray, prim))
    ref_dw = np.asarray(vjp(tuple(map(jnp.asarray, cts)))[1])

    def rows(x):  # (B, T#, [T,] D, W) -> chain-major rows
        x = torch.from_numpy(x)
        if x.dim() == 5:
            return x.permute(2, 1, 3, 0, 4).reshape(x.shape[2], -1, x.shape[4]).contiguous()
        return x.permute(1, 2, 0, 3).reshape(-1, x.shape[3]).contiguous()

    whh = torch.from_numpy(prim[1]).reshape(Tn * D, G, 4 * G).to(torch.bfloat16)
    h0, c0 = rows(prim[2]), rows(prim[3])
    hs, _, _, gates, cs = L.lstm_merged_train_fwd_plain(rows(prim[0]), whh, h0, c0, Bn)
    dxp, _, _ = L.lstm_merged_bwd_step_plain(gates, cs, c0, whh, *(rows(c) for c in cts), Bn)
    dw = L.lstm_merged_dw_plain(hs, h0, dxp, Bn).view(Tn, D, G, 4 * G).numpy()
    err = np.max(np.abs(dw - ref_dw)) / np.max(np.abs(ref_dw))
    assert err <= 1e-4, err
    # and the Hopper form's emulated order on the same operands
    got = _emulate(hs, h0, dxp, Bn, _plan(T, Tn * D, Bn, G)).view(Tn, D, G, 4 * G).numpy()
    assert np.max(np.abs(got - dw)) / np.max(np.abs(dw)) <= 1e-5


# --- the contraction split over slices, and the padded widths ---------------

# (T, R, B, G) where the tiles leave the card nearly empty: hidden 36 (G 18,
# padded to 24) and hidden 48 (G 24) at the training shape, and narrower
SPLIT_SHAPES = {
    "hidden36_train": (256, 8, 16, 24),
    "hidden48_train": (256, 8, 16, 24),
    "r1": (256, 1, 16, 24),
    "b4": (64, 8, 4, 40),
}


def test_split_plan_from_the_shape_and_the_cards_figures():
    # hidden 36 and 48 at T 256, R 8, B 16: one 128 x 128 tile a chain, 8
    # clusters where the card holds 66: 8 slices of 16 stages, one wave
    plan = _plan(256, 8, 16, L.dw_width(18))
    assert (plan.bn, plan.clusters, plan.slices, plan.per_slice, plan.waves) == (128, 8, 8, 16, 1)
    assert plan == _plan(256, 8, 16, 24)
    # one chain: 66 slices wanted of 128 stages, so 64 of two stages each
    one = _plan(256, 1, 16, 24)
    assert (one.held, one.waves, one.slices, one.per_slice) == (66, 1, 64, 2)
    # a card that holds fewer clusters takes fewer slices
    assert _plan(256, 8, 16, 24, {256: 16, 128: 16}).slices == 2
    assert _plan(256, 8, 16, 24, {256: 8, 128: 8}).slices == 1
    # never more slices than stages, and none empty
    for stages, clusters, held in ((1, 1, 66), (3, 1, 66), (128, 8, 66), (100, 7, 66),
                                   (256, 64, 66), (256, 128, 66), (5, 2, 9)):
        slices, per = L.dw_slices(stages, clusters, held)
        assert 1 <= slices <= stages and (slices - 1) * per < stages <= slices * per
        assert slices == 1 or slices * clusters <= held


@pytest.mark.parametrize("name", list(PATH_SHAPES))
def test_no_split_at_the_path_shapes(name):
    plan = _plan(*PATH_SHAPES[name])
    assert (plan.slices, plan.per_slice) == (1, plan.stages)
    assert len(L.dw_blocks(plan)) == len(L.dw_tiles(plan))


@pytest.mark.parametrize("shape", [*SPLIT_SHAPES.values(), *NARROW_SHAPES], ids=str)
def test_tiles_and_slices_cover_every_entry_and_pair_once(shape):
    """Every (chain, unit, column) of dW and every (t, b) pair of its chain
    meet in exactly one block: the tiles cover dW once a slice, the slices
    the stages once, the stages the pairs once."""
    T, R, B, G = shape
    plan = _plan(T, R, B, G)
    blocks = L.dw_blocks(plan)
    assert len(blocks) == L.DW_CLUSTER * plan.clusters * plan.slices
    m_tiles, n_tiles = -(-G // L.DW_BM), plan.n_tiles
    cover = np.zeros((R, m_tiles, n_tiles, plan.stages), np.int32)
    for r, m0, n0, s0, s1 in blocks:
        assert 0 <= s0 < s1 <= plan.stages and s1 - s0 <= plan.per_slice
        if m0 < G:
            cover[r, m0 // L.DW_BM, n0 // plan.bn, s0:s1] += 1
    assert (cover == 1).all()
    seen = np.zeros((T, B), np.int32)
    for t0, b0 in L.dw_stages(plan):
        for k in range(L.DW_BK):
            j, b = divmod(k, plan.bp)
            if t0 + j < T and b0 + b < B:
                seen[t0 + j, b0 + b] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("shape", [SPLIT_SHAPES["hidden48_train"], SPLIT_SHAPES["b4"],
                                   (40, 2, 16, 40), (9, 1, 3, 72)], ids=str)
def test_split_order_matches_plain_and_repeats(shape):
    """The slices' partial tiles, each summed in the unsplit form's order,
    then added in slice order: within 1e-5 of max|dW| of the plain version,
    the same bits from run to run, and within 1e-5 of the unsplit order."""
    T, R, B, G = shape
    hs, h0, dxp = _dw_inputs(T, R, B, G, seed=7 * T + G)
    plan = _plan(T, R, B, G)
    assert plan.slices > 1
    got = _emulate(hs, h0, dxp, B, plan)
    ref = L.lstm_merged_dw_plain(hs, h0, dxp, B)
    assert not got.isnan().any()
    assert _rel(got, ref) <= 1e-5
    assert torch.equal(got, _emulate(hs, h0, dxp, B, plan))
    one = _emulate(hs, h0, dxp, B, plan._replace(slices=1, per_slice=plan.stages))
    assert _rel(got, one) <= 1e-5


@pytest.mark.parametrize("G", [18, 22, 26])
def test_padded_width_is_bit_equal_to_the_same_order_at_the_real_width(G):
    """At G % 4 != 0 the kernel runs at dw_width(G) on operands padded with
    zero units (h's units, each gate block's columns): cut back, every real
    entry of dW has the bits of the same order of sums on the real-width
    operands, and the padded entries are 0."""
    T, R, B = 12, 3, 5
    Gp = L.dw_width(G)
    assert Gp == L.merged_width(G) and Gp % 8 == 0
    hs, h0, dxp = _dw_inputs(T, R, B, G, seed=G)
    plan = _plan(T, R, B, Gp)
    padded = _emulate(L.pad_width(hs, "units", G, Gp), L.pad_width(h0, "units", G, Gp),
                      L.pad_width(dxp, "gates", G, Gp), B, plan, ordered=True)
    real = _emulate(hs, h0, dxp, B, plan, ordered=True)
    assert torch.equal(L.cut_width(padded, "whh", G, Gp), real)
    keep = L.pad_width(torch.ones((R, G, 4 * G)), "whh", G, Gp).bool()
    assert (padded[~keep] == 0).all()
    assert _rel(real, L.lstm_merged_dw_plain(hs, h0, dxp, B)) <= 1e-5


def test_padded_dw_matches_the_jax_merged_backward_at_g18():
    """The merged layer at G 18 (hidden 36), as the card's trainer runs it:
    the plain forward and sweep at the padded width 24, K6's split order
    emulated there and cut, against dW of ``jax.vjp`` of the JAX package's
    merged layer (its Pallas kernels in interpret mode) at G 18; within
    1e-4 of max|dW| as ``test_plain_dw_matches_the_jax_merged_backward``."""
    Bn, Tn, T, D, G = 3, 2, 9, 2, 18
    Gp = L.dw_width(G)
    rng = np.random.default_rng(18)

    def mk(*shape, a=1.0):
        return (a * rng.standard_normal(shape)).astype(np.float32)

    prim = (mk(Bn, Tn, T, D, 4 * G, a=0.5), mk(Tn, D, G, 4 * G, a=G**-0.5),
            mk(Bn, Tn, D, G, a=0.5), mk(Bn, Tn, D, G, a=0.5))
    cts = (mk(Bn, Tn, T, D, G), mk(Bn, Tn, D, G), mk(Bn, Tn, D, G))

    def f(*a):
        return lstm_layer_pallas_merged_batched(*a, time_block=4, interpret=True)

    _, vjp = jax.vjp(f, *map(jnp.asarray, prim))
    ref_dw = np.asarray(vjp(tuple(map(jnp.asarray, cts)))[1])

    def rows(x):  # (B, T#, [T,] D, W) -> chain-major rows
        x = torch.from_numpy(x)
        if x.dim() == 5:
            return x.permute(2, 1, 3, 0, 4).reshape(x.shape[2], -1, x.shape[4]).contiguous()
        return x.permute(1, 2, 0, 3).reshape(-1, x.shape[3]).contiguous()

    def pad(t, kind):
        return L.pad_width(t, kind, G, Gp)

    whh = pad(torch.from_numpy(prim[1]).reshape(Tn * D, G, 4 * G), "whh").to(torch.bfloat16)
    h0, c0 = pad(rows(prim[2]), "units"), pad(rows(prim[3]), "units")
    hs, _, _, gates, cs = L.lstm_merged_train_fwd_plain(pad(rows(prim[0]), "gates"), whh, h0, c0,
                                                        Bn)
    dxp, _, _ = L.lstm_merged_bwd_step_plain(gates, cs, c0, whh,
                                             *(pad(rows(c), "units") for c in cts), Bn)
    plan = _plan(T, Tn * D, Bn, Gp)
    assert plan.slices > 1
    dw = L.cut_width(_emulate(hs, h0, dxp, Bn, plan), "whh", G, Gp)
    dw = dw.view(Tn, D, G, 4 * G).numpy()
    err = np.max(np.abs(dw - ref_dw)) / np.max(np.abs(ref_dw))
    assert err <= 1e-4, err
