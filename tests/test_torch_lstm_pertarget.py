"""The per-target BLSTM recurrence (plain version of the CUDA kernel)
against the JAX package's per-target Pallas kernel in interpret mode and
against the merged plain version, the model's dispatch on
``ModelConfig.lstm_impl``, the wrapper's argument checks, the choice of
the kernel's cluster size, and a numpy mirror of the kernel's index maps."""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from umx_tpu.config import ModelConfig as JModelConfig
from umx_tpu.models import umx as jumx
from umx_tpu.ops.lstm_pallas import lstm_layer_pallas
from umx_tpu_torch.config import ModelConfig
from umx_tpu_torch.models import umx as tumx
from umx_tpu_torch.ops import lstm_cuda

# Both sides round h and W_hh to bf16 and accumulate exact products in f32,
# so they differ only in f32 summation order (measured ~1e-7): 1e-5.  The
# bound holds where no bf16 rounding of an h element flips between the two
# orders; a flip (about 3e-5 likely per element and step) moves the next
# gates by ~4e-5, as seed 77 at G = 64 shows, so the seeds are fixed.
LSTM_ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(G, T, n_targets=4, D=2, seed=0):
    rng = np.random.default_rng(seed)
    x_proj = rng.standard_normal((n_targets, T, D, 4 * G)).astype(np.float32)
    hh_w = (rng.standard_normal((n_targets, D, G, 4 * G)) / np.sqrt(G)).astype(np.float32)
    h0 = (0.5 * rng.standard_normal((n_targets, D, G))).astype(np.float32)
    c0 = (0.5 * rng.standard_normal((n_targets, D, G))).astype(np.float32)
    return x_proj, hh_w, h0, c0


def _torch_args(x_proj, hh_w, h0, c0):
    return (torch.from_numpy(x_proj), torch.from_numpy(hh_w).to(torch.bfloat16),
            torch.from_numpy(h0), torch.from_numpy(c0))


@pytest.mark.parametrize("G, T", [(16, 21), (64, 13), (16, 1)])
def test_pertarget_plain_matches_pallas_interpret(G, T):
    # time_block 8: T = 21 and 13 leave a partial last block on the TPU side
    x_proj, hh_w, h0, c0 = _inputs(G, T, seed=G)
    ref = lstm_layer_pallas(jnp.asarray(x_proj), jnp.asarray(hh_w), jnp.asarray(h0),
                            jnp.asarray(c0), time_block=8, interpret=True)
    before = lstm_cuda.lstm_layer_pertarget.launches
    ours = lstm_cuda.lstm_layer_pertarget(*_torch_args(x_proj, hh_w, h0, c0))
    assert lstm_cuda.lstm_layer_pertarget.launches == before  # CPU: the plain version
    for o, r in zip(ours, ref):
        assert o.shape == r.shape
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0, atol=LSTM_ATOL)
    assert np.abs(ours[1].numpy()).max() > 0.01  # nonzero state came through


@pytest.mark.parametrize("G", [16, 64])
def test_pertarget_plain_matches_merged_plain_at_one_row(G):
    """The same function in the merged kernel's layout: rows chain-major,
    (T, R, 4G) with R = T# x D and B = 1."""
    T = 19
    x_proj, whh, h0, c0 = _torch_args(*_inputs(G, T, seed=3))
    hs, hT, cT = lstm_cuda.lstm_pertarget_plain(x_proj, whh, h0, c0)
    R = 8
    xp = x_proj.permute(1, 0, 2, 3).reshape(T, R, 4 * G).contiguous()
    mhs, mhT, mcT = lstm_cuda.lstm_merged_plain(
        xp, whh.reshape(R, G, 4 * G), h0.reshape(R, G), c0.reshape(R, G), 1)
    for o, r in ((hs, mhs.view(T, 4, 2, G).permute(1, 0, 2, 3)), (hT, mhT.view(4, 2, G)),
                 (cT, mcT.view(4, 2, G))):
        np.testing.assert_allclose(o.numpy(), r.numpy(), rtol=0, atol=LSTM_ATOL)


@pytest.mark.parametrize("batch", [1, 2])
def test_recurrence_dispatches_on_lstm_impl(batch, monkeypatch):
    """lstm_impl="pallas" runs the per-target layer once per batch row and
    gives what the merged layer gives; both match the JAX recurrence on
    its per-target kernel."""
    hidden = 32
    jcfg = JModelConfig(hidden_size=hidden, lstm_impl="pallas_interpret")
    jp = jumx.synthetic_params(jcfg, seed=1)
    tp = tumx.params_from_jax(jp)
    rng = np.random.default_rng(5)
    x1 = np.tanh(rng.standard_normal((batch, 4, 13, hidden))).astype(np.float32)
    calls = []
    real = lstm_cuda.lstm_layer_pertarget

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(lstm_cuda, "lstm_layer_pertarget", spy)
    outs = {}
    for impl in ("auto", "pallas_merged", "pallas"):
        cfg = ModelConfig(hidden_size=hidden, lstm_impl=impl)
        state = tumx.init_lstm_state(cfg, batch=batch)
        out, st = tumx.umx_recurrence_batched(tp, torch.from_numpy(x1), state, cfg)
        outs[impl] = (out, st.h, st.c)
        if impl != "pallas":
            assert not calls
    assert len(calls) == 3 * batch and calls[0] == (4, 13, 2, 64)
    for a, b in zip(outs["auto"], outs["pallas_merged"]):
        assert torch.equal(a, b)
    for a, b in zip(outs["auto"], outs["pallas"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-4)
    for b in range(batch):
        jout, jst = jumx.umx_recurrence(jp, jnp.asarray(x1[b]), jumx.init_lstm_state(jcfg), jcfg)
        # three layers: a flipped bf16 rounding of one h element moves the
        # next gates by ~1e-5 (the class of tests/test_torch_model.py): 1e-4
        np.testing.assert_allclose(outs["pallas"][0][b].numpy(), np.asarray(jout), rtol=0, atol=1e-4)
        np.testing.assert_allclose(outs["pallas"][1][b].numpy(), np.asarray(jst.h), rtol=0, atol=1e-4)


def test_training_ignores_the_pertarget_kernel(monkeypatch):
    """A gradient never runs the per-target kernel: the trainer's loss
    lowers "pallas" to the float32 recurrence, as the JAX trainer does."""
    from umx_tpu_torch.train import mask_loss

    cfg = ModelConfig(hidden_size=32, lstm_impl="pallas")
    params = tumx.synthetic_params(cfg, seed=0)
    for f in dataclasses.fields(params):
        getattr(params, f.name).requires_grad_(True)
    monkeypatch.setattr(lstm_cuda, "lstm_layer_pertarget",
                        lambda *a, **k: pytest.fail("the per-target kernel has no backward"))
    rng = np.random.default_rng(0)
    batch = {
        "x": torch.from_numpy(np.abs(rng.standard_normal((2, 9, cfg.n_features))).astype(np.float32)),
        "mix_mag": torch.from_numpy(np.abs(rng.standard_normal((2, 2, 9, cfg.n_bins))).astype(np.float32)),
        "target_mag": torch.from_numpy(
            np.abs(rng.standard_normal((2, 4, 2, 9, cfg.n_bins))).astype(np.float32)),
    }
    loss = mask_loss(params, batch, cfg)
    loss.backward()
    assert torch.isfinite(loss) and params.lstm_hh_w.grad is not None


def test_pertarget_layer_refuses_a_gradient():
    """Outside the trainer's loss nothing switches kernels behind the
    caller: lstm_impl="pallas" with a gradient wanted raises."""
    cfg = ModelConfig(hidden_size=32, lstm_impl="pallas")
    params = tumx.synthetic_params(cfg, seed=0)
    params.lstm_hh_w.requires_grad_(True)
    x1 = torch.zeros((1, 4, 5, 32))
    with pytest.raises(RuntimeError, match="no backward"):
        tumx.umx_recurrence_batched(params, x1, tumx.init_lstm_state(cfg, batch=1), cfg)
    with torch.no_grad():
        tumx.umx_recurrence_batched(params, x1, tumx.init_lstm_state(cfg, batch=1), cfg)


def test_lstm_impl_values():
    assert ModelConfig(lstm_impl="scan").lstm_impl == "scan"  # the float32 recurrence
    with pytest.raises(ValueError, match="no meaning"):
        ModelConfig(lstm_impl="pallas_interpret")
    with pytest.raises(ValueError, match="auto, pallas_merged, pallas or scan"):
        ModelConfig(lstm_impl="cudnn")


def test_pertarget_wrapper_checks():
    x_proj, whh, h0, c0 = _torch_args(*_inputs(16, 5))
    with pytest.raises(TypeError, match="bfloat16"):
        lstm_cuda.lstm_layer_pertarget(x_proj, whh.float(), h0, c0)
    with pytest.raises(ValueError, match="whh must be"):
        lstm_cuda.lstm_layer_pertarget(x_proj, whh[:, :1], h0, c0)
    with pytest.raises(ValueError, match="h0"):
        lstm_cuda.lstm_layer_pertarget(x_proj, whh, h0[..., :8], c0)
    with pytest.raises(ValueError, match="contiguous"):
        lstm_cuda.lstm_layer_pertarget(x_proj.transpose(1, 2).contiguous().transpose(1, 2), whh, h0, c0)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        lstm_cuda.lstm_layer_merged_batched(x_proj[None], whh.half(), h0[None], c0[None])
    # a bf16 W_hh goes to the merged layer as it is and gives what f32 -> bf16 gives
    a = lstm_cuda.lstm_layer_merged_batched(x_proj[None], whh, h0[None], c0[None])
    b = lstm_cuda.lstm_layer_merged_batched(x_proj[None], whh.float(), h0[None], c0[None])
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# --- the cluster chooser, and the kernel's index maps mirrored in numpy ------

# clusters an H100 SXM holds at once, by blocks per cluster: at one block an
# SM (K9 at G = 512), and where two or more blocks share an SM (small G)
H100_ONE_BLOCK_AN_SM = {16: 7, 15: 7, 14: 7, 13: 7, 12: 7, 11: 7, 10: 7, 9: 9, 8: 15, 7: 15,
                        6: 17, 5: 22, 4: 30, 3: 39, 2: 66, 1: 132}
H100_SMALL_BLOCKS = {16: 28, 15: 28, 14: 30, 13: 30, 12: 37, 11: 37, 10: 44, 9: 51, 8: 62,
                     7: 69, 6: 79, 5: 94, 4: 124, 3: 163, 2: 264, 1: 528}


def test_cluster_choice_with_powers_of_two_and_small_blocks_is_the_earlier_two_waves():
    """Sizes 16, 8, 4, 2, 1 only and a block that holds at most 32-55 units
    (its W_hh slice in shared memory): 16 blocks, 7 at once, two waves."""
    placeable = {16: 7, 8: 16, 4: 33, 2: 66, 1: 132}
    for max_units in (32, 48, 55):
        assert lstm_cuda.pertarget_cluster_choice(512, 8, placeable, max_units) == (16, 32, 2)


@pytest.mark.parametrize("size", [11, 12])
def test_cluster_choice_takes_a_size_that_is_no_power_of_two_for_one_wave(size):
    placeable = {16: 7, size: 8}
    cluster, units, waves = lstm_cuda.pertarget_cluster_choice(512, 8, placeable, max_units=48)
    assert (cluster, waves) == (size, 1) and units == (48 if size == 11 else 44)
    assert cluster * units >= 512


def test_cluster_choice_on_the_h100_is_one_wave_of_eight_or_nine_blocks():
    """What an H100 SXM places: 8 or 9 blocks run UMX-L's 8 chains in one
    wave (9 of 60 units win on units), 10 to 16 blocks would take two."""
    assert lstm_cuda.pertarget_cluster_choice(512, 8, H100_ONE_BLOCK_AN_SM) == (9, 60, 1)
    only_eight = {cl: n for cl, n in H100_ONE_BLOCK_AN_SM.items() if cl != 9}
    assert lstm_cuda.pertarget_cluster_choice(512, 8, only_eight) == (8, 64, 1)
    # ten chains no longer fit the 9 clusters of 9; sixteen take two waves either way
    assert lstm_cuda.pertarget_cluster_choice(512, 10, H100_ONE_BLOCK_AN_SM) == (8, 64, 1)
    assert lstm_cuda.pertarget_cluster_choice(512, 16, H100_ONE_BLOCK_AN_SM) == (9, 60, 2)


def test_cluster_choice_ties_go_to_the_fewest_units_then_the_fewest_blocks():
    # one wave each: 4 blocks of 64 units, 6 of 48, 8 of 32
    assert lstm_cuda.pertarget_cluster_choice(256, 8, {4: 30, 6: 17, 8: 15}) == (8, 32, 1)
    # 5 and 6 blocks both leave 40 units a block at G = 240 (the width's cap is 7 blocks)
    assert lstm_cuda.pertarget_cluster_choice(240, 4, {4: 30, 5: 22, 6: 17}) == (6, 40, 1)
    assert lstm_cuda.pertarget_cluster_choice(232, 4, {4: 30, 5: 22, 6: 17}) == (6, 40, 1)
    assert lstm_cuda.pertarget_cluster_choice(192, 4, {4: 30, 5: 22, 6: 17}) == (6, 32, 1)
    assert lstm_cuda.pertarget_cluster_choice(128, 4, {2: 66, 3: 39}) == (3, 44, 1)
    # fewer waves beat fewer units
    assert lstm_cuda.pertarget_cluster_choice(512, 8, {16: 7, 8: 15}) == (8, 64, 1)


def test_cluster_choice_raises_by_name_where_nothing_holds_a_chain():
    with pytest.raises(RuntimeError, match="no cluster of up to 16 blocks"):
        lstm_cuda.pertarget_cluster_choice(512, 8, {})
    with pytest.raises(RuntimeError, match="no cluster of up to 16 blocks"):
        lstm_cuda.pertarget_cluster_choice(1032, 1, {16: 7, 8: 15})  # 64 units x 16 < 1032
    with pytest.raises(RuntimeError, match="no cluster of up to 16 blocks"):
        lstm_cuda.pertarget_cluster_choice(512, 8, {4: 30, 2: 66, 1: 132})  # 128 units a block


@pytest.mark.parametrize("G, expect", [
    (16, (1, 16)), (40, (1, 40)), (72, (2, 36)), (128, (4, 32)), (200, (6, 36)), (256, (8, 32)),
    (512, (9, 60)), (640, (16, 40)),
])
def test_cluster_choice_at_every_width_the_kernel_takes(G, expect):
    placeable = H100_ONE_BLOCK_AN_SM if G >= 512 else H100_SMALL_BLOCKS
    cluster, units, waves = lstm_cuda.pertarget_cluster_choice(G, 8, placeable)
    assert (cluster, units) == expect
    assert units % 4 == 0 and units <= 64 and cluster * units >= G
    assert cluster == 1 or units >= 32  # no block is left fewer than 32 units
    assert waves == -(-8 // placeable[cluster]) == (2 if G == 640 else 1)
    assert units == lstm_cuda.pertarget_units_per_block(G, cluster)


def _h_pos(w):
    """csrc/lstm_pertarget.cu::h_pos."""
    return (w & ~15) | ((w & 3) << 2) | ((w >> 2) & 3)


def _pertarget_step_mirror(G, cluster, units, rank, whh, h_prev):
    """One step of one block of K9 as its lanes compute it: the A-fragments
    each lane holds, the B-fragments it reads from the permuted h buffer,
    mma.sync.m16n8k16's element-to-lane layout, the gates each cell lane
    ends up with, and the words each lane sends to which block.  Returns
    ({unit: (i, f, g, o) pre-activations without x_proj}, {(destination
    rank, buffer position): (unit, unit + 1)})."""
    kt_n = -(-G // 16)
    pairs = -(-kt_n // 2)
    buf = np.zeros(pairs * 16 * 2)  # bf16 values, two per word, permuted by word
    for w in range(G // 2):
        buf[2 * _h_pos(w)], buf[2 * _h_pos(w) + 1] = h_prev[2 * w], h_prev[2 * w + 1]
    nu = max(0, min(units, G - rank * units))
    gates, stores = {}, {}
    for warp in range(16):
        if warp * 4 >= nu:
            continue
        u0 = rank * units + warp * 4
        acc = np.zeros((32, 4))  # [lane][c0..c3], the four accumulators summed
        for kt in range(2 * pairs):
            q, half = kt // 2, kt % 2
            # B: lane (g = 0, tq) reads the 16-byte word 4 q + tq; x, y feed
            # k-tile 2 q, z, w k-tile 2 q + 1; lanes g != 0 read zeros
            b = np.zeros((16, 8))
            for tq in range(4):
                word4 = buf[2 * 4 * (4 * q + tq) : 2 * 4 * (4 * q + tq + 1)].reshape(4, 2)
                b[2 * tq : 2 * tq + 2, 0] = word4[2 * half]           # b0: k = 2 tq, 2 tq + 1
                b[2 * tq + 8 : 2 * tq + 10, 0] = word4[2 * half + 1]  # b1: k + 8
            a = np.zeros((16, 16))
            for lane in range(32):
                g, tq = lane >> 2, lane & 3
                col_a = (g >> 2) * G + u0 + (g & 3)
                col_b = col_a + 2 * G
                k = kt * 16 + 2 * tq
                for row, kk, col in ((g, k, col_a), (g + 8, k, col_b), (g, k + 8, col_a),
                                     (g + 8, k + 8, col_b)):
                    for e in range(2):  # a register holds k and k + 1
                        a[row, kk - kt * 16 + e] = whh[kk + e, col] if kk + e < G else 0.0
            d = a @ b
            for lane in range(32):
                g, tq = lane >> 2, lane & 3
                acc[lane] += (d[g, 2 * tq], d[g, 2 * tq + 1], d[g + 8, 2 * tq], d[g + 8, 2 * tq + 1])
        for lane in range(0, 16, 4):  # lane 4 g' has gates i, g; lane 4 (g' + 4) gates f, o
            unit = u0 + (lane >> 2)
            gates[unit] = (acc[lane, 0], acc[lane ^ 16, 0], acc[lane, 2], acc[lane ^ 16, 2])
        for lane in range(32):  # lane l sends word l / 16, packed by lane 8 (l / 16), to block l % 16
            src = (lane >> 4) * 8
            pair = (u0 + (src >> 2), u0 + ((src ^ 4) >> 2))  # its own unit, lane ^ 4's above
            dst = lane & 15
            if dst < cluster and dst * units < G:
                stores[dst, _h_pos((u0 >> 1) + (lane >> 4))] = pair
    return gates, stores


@pytest.mark.parametrize("G, cluster", [(512, 8), (40, 1), (72, 2), (200, 6), (520, 16)])
def test_kernel_index_maps_give_every_unit_its_four_gates(G, cluster):
    units = lstm_cuda.pertarget_units_per_block(G, cluster)
    rng = np.random.default_rng(G)
    whh = rng.standard_normal((G, 4 * G))
    h_prev = rng.standard_normal(G)
    ref = h_prev @ whh
    gates, stored = {}, {}
    for rank in range(cluster):
        gt, st = _pertarget_step_mirror(G, cluster, units, rank, whh, h_prev)
        assert not set(gt) & set(gates) and not set(st) & set(stored)
        gates.update(gt)
        stored.update(st)
    assert sorted(gates) == list(range(G))  # every unit has exactly one pair of cell lanes
    for u, pre in gates.items():
        np.testing.assert_allclose(pre, [ref[q * G + u] for q in range(4)], rtol=0, atol=1e-9)
    # the exchange fills every word of the next buffer of every block that owns
    # units with its own unit pair: G / 2 words of 4 bytes, the 2 G bytes a
    # block's barrier is armed with; a block without units is sent nothing
    busy = [rk for rk in range(cluster) if rk * units < G]
    assert stored == {(rk, _h_pos(w)): (2 * w, 2 * w + 1) for rk in busy for w in range(G // 2)}
    if G == 520:
        assert busy == list(range(15))  # 16 blocks of 36 units: the last owns none
