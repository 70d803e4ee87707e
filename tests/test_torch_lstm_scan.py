"""The float32 recurrence (``lstm_impl="scan"``, kernel K10's plain
version on the CPU) against the JAX package's ``lax.scan`` recurrence
(``umx_tpu.models.umx._bilstm_layer``) per layer, with float32 and bf16
stored W_hh; rows bit-equal to themselves alone; the model, the
streaming, windowed and fleet slice against the JAX ``Separator`` and
``demix_tracks`` under ``lstm_impl="scan"``; the train step and the layer
taking a gradient through the float32 kernels (against the JAX trainer:
``tests/test_torch_lstm_scan_train.py``), the eval step running the scan;
the pipelined arm keeping K1; and K10's launch plan."""

from __future__ import annotations

import dataclasses
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from umx_tpu.config import EngineConfig as JEngineConfig
from umx_tpu.config import ModelConfig as JModelConfig
from umx_tpu.config import SegmentConfig as JSegmentConfig
from umx_tpu.config import WienerConfig as JWienerConfig
from umx_tpu.engine.fleet import demix_tracks as jdemix_tracks
from umx_tpu.engine.separator import Separator as JSeparator
from umx_tpu.models import umx as jumx
from umx_tpu_torch.config import EngineConfig, ModelConfig, SegmentConfig
from umx_tpu_torch.engine import fleet, memory
from umx_tpu_torch.engine.separator import Separator
from umx_tpu_torch.models import umx as tumx
from umx_tpu_torch.ops import lstm_cuda as L
from umx_tpu_torch.train import make_eval_step, make_train_step, mask_loss

# Both sides take f32 products of unrounded h and exact weights and sum
# them in f32; they differ in summation order only (measured below 1e-6 of
# |h| < 1 at T 100), so 1e-5.
LAYER_ATOL = 1e-5
SLICE_RTOL = 2e-4  # port against JAX, dense (tests/test_torch_separator.py)
HIDDEN = 32
SR = 44100


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _layer_inputs(G, T, B, seed, n_in=24):
    """One layer of one target: per-row inputs x (B, T, in), the JAX
    layouts of the weights (D, in, 4G), (D, G, 4G), biases (D, 4G), and a
    non-zero state (B, D, G)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, n_in)).astype(np.float32)
    ih_w = (rng.standard_normal((2, n_in, 4 * G)) / np.sqrt(n_in)).astype(np.float32)
    hh_w = (rng.standard_normal((2, G, 4 * G)) / np.sqrt(G)).astype(np.float32)
    ih_b = (0.1 * rng.standard_normal((2, 4 * G))).astype(np.float32)
    hh_b = (0.1 * rng.standard_normal((2, 4 * G))).astype(np.float32)
    h0 = (0.5 * rng.standard_normal((B, 2, G))).astype(np.float32)
    c0 = (0.5 * rng.standard_normal((B, 2, G))).astype(np.float32)
    return x, ih_w, ih_b, hh_w, hh_b, h0, c0


def _jax_layer(x, ih_w, ih_b, hh_w, hh_b, h0, c0):
    """``_bilstm_layer`` row by row → out (B, T, 2G), hT, cT (B, D, G), and
    its input projection (B, T, D, 4G), computed as it computes it."""
    outs, hTs, cTs, projs = [], [], [], []
    for b in range(x.shape[0]):
        xb = jnp.asarray(x[b])
        out, (hT, cT) = jumx._bilstm_layer(xb, jnp.asarray(ih_w), jnp.asarray(ih_b),
                                           jnp.asarray(hh_w), jnp.asarray(hh_b),
                                           jnp.asarray(h0[b]), jnp.asarray(c0[b]), "default")
        xs = jnp.stack([xb, xb[::-1]])
        projs.append(np.asarray(jnp.einsum("dti,dig->tdg", xs, jnp.asarray(ih_w))
                                + jnp.asarray(ih_b) + jnp.asarray(hh_b)))
        outs.append(np.asarray(out))
        hTs.append(np.asarray(hT))
        cTs.append(np.asarray(cT))
    return np.stack(outs), np.stack(hTs), np.stack(cTs), np.stack(projs)


def _port_layer(proj, hh, h0, c0):
    """The port's layer on the JAX projection: (B, T, 2G), hT, cT."""
    hs, hT, cT = L.lstm_layer_scan_batched(
        torch.from_numpy(proj)[:, None], hh[None], torch.from_numpy(h0)[:, None],
        torch.from_numpy(c0)[:, None])
    out = torch.cat([hs[:, 0, :, 0], hs[:, 0, :, 1].flip(1)], dim=-1)
    return out.numpy(), hT[:, 0].numpy(), cT[:, 0].numpy()


@pytest.mark.parametrize("hidden, B", [(32, 1), (32, 3), (36, 1), (36, 3)])
def test_scan_layer_matches_jax_bilstm_layer(hidden, B):
    """hidden 36 is G 18, not a multiple of 8 (K1 refuses it; the scan
    takes any G)."""
    G = hidden // 2
    x, ih_w, ih_b, hh_w, hh_b, h0, c0 = _layer_inputs(G, 100, B, seed=hidden + B)
    ref_out, ref_hT, ref_cT, proj = _jax_layer(x, ih_w, ih_b, hh_w, hh_b, h0, c0)
    out, hT, cT = _port_layer(proj, torch.from_numpy(hh_w), h0, c0)
    errs = [float(np.abs(a - b).max()) for a, b in ((out, ref_out), (hT, ref_hT), (cT, ref_cT))]
    print(f"scan layer vs JAX (G {G}, B {B}): max|dh| {errs[0]:.3g}, hT {errs[1]:.3g}, "
          f"cT {errs[2]:.3g}")
    assert max(errs) <= LAYER_ATOL, errs


def test_scan_layer_with_bf16_weights_matches_jax():
    """The quantized parameters' W_hh is dense bf16: both sides upcast it
    exactly and run f32 h against it."""
    G = 16
    x, ih_w, ih_b, hh_w, hh_b, h0, c0 = _layer_inputs(G, 100, 2, seed=5)
    hh_bf16 = torch.from_numpy(hh_w).to(torch.bfloat16)
    ref_out, _, ref_cT, proj = _jax_layer(x, ih_w, ih_b, jnp.asarray(hh_w).astype(jnp.bfloat16),
                                          hh_b, h0, c0)
    out, _, cT = _port_layer(proj, hh_bf16, h0, c0)
    err = max(float(np.abs(out - ref_out).max()), float(np.abs(cT - ref_cT).max()))
    assert err <= LAYER_ATOL, err
    # and the weights' rounding is real: against the f32 weights it moves h
    out32, _, _ = _port_layer(proj, torch.from_numpy(hh_w), h0, c0)
    assert float(np.abs(out32 - out).max()) > 10 * LAYER_ATOL


def _scan_inputs(T, R, B, G, seed, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    xp = torch.randn((T, R * B, 4 * G), generator=g)
    whh = (torch.randn((R, G, 4 * G), generator=g) / G**0.5).to(dtype)
    h0 = 0.5 * torch.randn((R * B, G), generator=g)
    c0 = 0.5 * torch.randn((R * B, G), generator=g)
    return xp, whh, h0, c0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scan_rows_are_bit_equal_to_themselves_alone(dtype):
    """A row's sums have one order whatever B is: each of B = 3 rows gives
    the bits of the same row run alone (B = 1), as the fleet bucket and
    the serving batcher need."""
    T, R, B, G = 40, 4, 3, 20
    xp, whh, h0, c0 = _scan_inputs(T, R, B, G, seed=7, dtype=dtype)
    hs, hT, cT = L.lstm_scan(xp, whh, h0, c0, B)
    for b in range(B):
        rows = torch.arange(R) * B + b
        one = L.lstm_scan(xp[:, rows].contiguous(), whh, h0[rows].contiguous(),
                          c0[rows].contiguous(), 1)
        assert torch.equal(one[0], hs[:, rows]) and torch.equal(one[1], hT[rows])
        assert torch.equal(one[2], cT[rows])


def test_scan_wrapper_checks_and_counts():
    xp, whh, h0, c0 = _scan_inputs(5, 2, 1, 8, seed=1)
    before = L.lstm_scan.launches
    L.lstm_scan(xp, whh, h0, c0, 1)
    assert L.lstm_scan.launches == before  # the CPU runs the plain version: no launch
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        L.lstm_scan(xp, whh.half(), h0, c0, 1)
    with pytest.raises(TypeError, match="xp must be"):
        L.lstm_scan(xp.double(), whh, h0, c0, 1)
    with pytest.raises(ValueError, match="rows"):
        L.lstm_scan(xp, whh, h0, c0, 2)
    with pytest.raises(ValueError, match="h0 must be"):
        L.lstm_scan(xp, whh, h0[:1], c0, 1)


def test_scan_plain_is_the_f32_recurrence_and_not_k1():
    """The scan's plain version does not round h: it differs from K1's
    plain version (bf16 h operands) on the same bf16 weights."""
    xp, whh, h0, c0 = _scan_inputs(30, 2, 2, 16, seed=3, dtype=torch.bfloat16)
    ours = L.lstm_scan_plain(xp, whh, h0, c0, 2)[0]
    k1 = L.lstm_merged_plain(xp, whh, h0, c0, 2)[0]
    assert float((ours - k1).abs().max()) > 1e-4


def test_launch_plan():
    assert L.scan_blocks_per_chain(1) == 1 and L.scan_blocks_per_chain(18) == 1
    assert L.scan_blocks_per_chain(512) == 16 and L.scan_blocks_per_chain(640) == 20
    # rows per launch come from the device (16 on the H100 up to G 2048)
    assert L.scan_row_groups(3, 16) == [(0, 3, 4)]
    assert L.scan_row_groups(20, 16) == [(0, 16, 16), (16, 4, 4)]
    assert L.scan_row_groups(1, 16) == [(0, 1, 1)]
    assert L.scan_row_groups(9, 8) == [(0, 8, 8), (8, 1, 1)]
    assert L.scan_row_groups(5, 2) == [(0, 2, 2), (2, 2, 2), (4, 1, 1)]
    # chains: one launch while the device holds them all, else groups
    assert L.chain_groups(8, L.scan_blocks_per_chain(640), 264, "K10") == [(0, 8)]
    assert L.chain_groups(8, L.scan_blocks_per_chain(640), 100, "K10") == [(0, 5), (5, 3)]
    with pytest.raises(RuntimeError, match="K10 needs 20 co-resident blocks"):
        L.chain_groups(8, L.scan_blocks_per_chain(640), 19, "K10")
    assert L.scan_exchange_words(8, 512) == 8 * 2 * 16 * 512


# ---- the two forms of K10 and K11, and the resident form's maps ------------


@pytest.mark.parametrize("G, want", [(1, "resident"), (18, "resident"), (256, "resident"),
                                     (512, "resident"), (513, "streaming"), (640, "streaming"),
                                     (4096, "streaming")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_form_is_chosen_by_width_alone(G, want, dtype, monkeypatch):
    """The form comes from G (and W_hh's dtype, which changes nothing: bf16
    is upcast to f32 on the chip) before any launch: the card's plan for
    every B, R and kernel, with its capacity query stubbed, runs that form
    and reports it first in ``wrapper.form``."""
    assert L.scan_form(G, dtype) == want
    asked = []

    def capacity(index, G_, bf16, kernel, form):
        asked.append(form)
        return 16, 264

    monkeypatch.setattr(L, "_scan_capacity", capacity)

    class Ref:
        device = torch.device("cuda", 0)

    for kernel, wrapper in (("K10", L.lstm_scan), ("K10r", L.lstm_scan_train_fwd),
                            ("K11", L.lstm_scan_bwd_step)):
        for R, B in ((8, 1), (8, 16), (3, 40), (1, 5)):
            form = L._scan_form_for(G, dtype, None)
            L._scan_plan(wrapper, kernel, Ref, R, B, G, dtype == torch.bfloat16, form)
            assert wrapper.form[0] == want
    assert set(asked) == {want}


@pytest.mark.parametrize("name", ["lstm_scan", "lstm_scan_train_fwd", "lstm_scan_bwd_step"])
def test_the_form_is_no_public_argument(name):
    """The wrappers choose the form from the width alone; only the private
    keyword ``_form`` names one, for the checks that compare the forms."""
    params = inspect.signature(getattr(L, name)).parameters
    assert "form" not in params
    assert params["_form"].kind is inspect.Parameter.KEYWORD_ONLY
    assert params["_form"].default is None


def test_a_form_named_is_checked_on_either_route():
    xp, whh, h0, c0 = _scan_inputs(4, 2, 1, 8, seed=2)
    ref = L.lstm_scan(xp, whh, h0, c0, 1)
    for form in L.SCAN_FORMS:  # the CPU runs the plain version whatever the form
        assert all(torch.equal(a, b)
                   for a, b in zip(L.lstm_scan(xp, whh, h0, c0, 1, _form=form), ref))
    with pytest.raises(ValueError, match="form must be one of"):
        L.lstm_scan(xp, whh, h0, c0, 1, _form="stream")
    xp, whh, h0, c0 = _scan_inputs(2, 1, 1, 640, seed=2)
    with pytest.raises(ValueError, match="up to G = 512"):
        L.lstm_scan_train_fwd(xp, whh, h0, c0, 1, _form="resident")


def _k10_lane_roles(G):
    """The resident K10's roles: lane l of warp w owns units 4 w + 2 (l //
    16) and the next of the block, and k part p = l % 16, the k = p + 16 i
    of the product."""
    roles = {}
    for tid in range(256):
        lane, warp = tid % 32, tid // 32
        roles[tid] = (4 * warp + 2 * (lane // 16), lane % 16)
    ks = {p: list(range(p, G, 16)) for p in range(16)}
    return roles, ks


@pytest.mark.parametrize("G", [18, 256, 512])
def test_k10_resident_lanes_cover_every_product_term_once(G):
    roles, ks = _k10_lane_roles(G)
    seen = np.zeros((32, G), int)
    for unit, p in roles.values():
        for k in ks[p]:
            seen[unit, k] += 1
            seen[unit + 1, k] += 1
    assert (seen == 1).all()
    # a quarter-warp reads h at eight neighbouring k = 16 i + p (p = 0..7 or
    # 8..15), a float4 of rows each (a float2, a float at 2 and 1 rows) at
    # the padded row stride: distinct banks, one wavefront
    for rows in (1, 2, 4, 8, 16):
        hs = rows if rows <= 4 else rows + 4
        width = min(rows, 4)
        lanes = 8 if width == 4 else 16  # the parts one wavefront serves at that width
        for first in range(0, 16, lanes):
            banks = [((16 * 3 + p) * hs + e) % 32 for p in range(first, first + lanes)
                     for e in range(width)]
            assert len(set(banks)) == len(banks)


def _rs_reduce(parts, rp):
    """The shuffle tree of rs_reduce on float32 sums parts (16 lanes, 2
    units, 4 gates, rp rows): returns {lane: (unit, first row, rows held,
    leader, values (4, rows))}."""
    scat = {1: 0, 2: 1, 4: 2, 8: 3}[rp]
    acc = np.empty((16, 4, rp), np.float32)
    for p in range(16):  # mask 8: the lane keeps the unit of its mask bit
        e = p >> 3
        acc[p] = (parts[p, e] + parts[p ^ 8, e]).astype(np.float32)
    held = {p: rp for p in range(16)}
    base = {p: 0 for p in range(16)}
    for rnd in range(3):
        mask = 4 >> rnd
        new = acc.copy()
        for p in range(16):
            q = p ^ mask
            if rnd < scat:
                half = (rp >> rnd) // 2
                hi = bool(p & mask)
                # keep the upper half on the side with the mask bit; the
                # partner sends its copy of the half this lane keeps
                keep = acc[p, :, half:2 * half] if hi else acc[p, :, :half]
                recv = acc[q, :, half:2 * half] if hi else acc[q, :, :half]
                new[p, :, :half] = (keep + recv).astype(np.float32)
            else:
                new[p, :, :1] = (acc[p, :, :1] + acc[q, :, :1]).astype(np.float32)
        for p in range(16):
            if rnd < scat:
                if p & mask:
                    base[p] += (rp >> rnd) // 2
                held[p] = (rp >> rnd) // 2
        acc = new
    out = {}
    for p in range(16):
        leader = (p & ((1 << (3 - scat)) - 1)) == 0
        rows = held[p] if scat else 1
        out[p] = (p >> 3, base[p], rows, leader, acc[p, :, :rows])
    return out


@pytest.mark.parametrize("rp", [1, 2, 4, 8])
def test_k10_resident_reduce_is_one_tree_at_every_row_tile(rp):
    """Every (unit, gate, row) sum of the sixteen parts is led by exactly
    one lane and has the bits of the tree over the masks 8, 4, 2, 1,
    whatever the rows of the pass: a row's bits do not depend on B."""
    rng = np.random.default_rng(rp)
    parts = (rng.standard_normal((16, 2, 4, 8))
             * 10.0 ** rng.integers(-3, 4, (16, 2, 4, 8))).astype(np.float32)
    level = list(parts)  # the tree: pairs {p, p ^ 8}, then {p, p ^ 4}, ...
    for mask in (8, 4, 2, 1):
        level = [(level[p] + level[p ^ mask]).astype(np.float32) for p in range(16)]
    tree = level[0]
    out = _rs_reduce(parts[..., :rp], rp)
    led = np.zeros((2, rp), int)
    for p, (unit, first, rows, leader, vals) in out.items():
        for m in range(rows):
            np.testing.assert_array_equal(vals[:, m], tree[unit, :, first + m])
            led[unit, first + m] += leader
    assert (led == 1).all()


# ---- the model and the slice ----------------------------------------------


@pytest.fixture(scope="module")
def jax_params():
    return jumx.synthetic_params(JModelConfig(hidden_size=HIDDEN), seed=0)


@pytest.fixture(scope="module")
def params(jax_params):
    return tumx.params_from_jax(jax_params)


def test_recurrence_dispatches_scan_and_matches_jax(jax_params, params, monkeypatch):
    """umx_recurrence_batched under "scan" runs the scan layer three times
    (never K1) and gives the JAX scan's outputs and states."""
    rng = np.random.default_rng(4)
    B, T = 2, 30
    x1 = rng.standard_normal((B, 4, T, HIDDEN)).astype(np.float32)
    h = (0.3 * rng.standard_normal((B, 4, 3, 2, HIDDEN // 2))).astype(np.float32)
    c = (0.3 * rng.standard_normal((B, 4, 3, 2, HIDDEN // 2))).astype(np.float32)
    jcfg = JModelConfig(hidden_size=HIDDEN, lstm_impl="scan")
    jout, jst = jumx.umx_recurrence_batched(jax_params, jnp.asarray(x1),
                                            jumx.LSTMState(h=jnp.asarray(h), c=jnp.asarray(c)),
                                            jcfg)
    calls = []
    scan_layer = L.lstm_layer_scan_batched
    monkeypatch.setattr(tumx, "lstm_layer_scan_batched",
                        lambda *a: calls.append(1) or scan_layer(*a))
    monkeypatch.setattr(tumx, "lstm_layer_merged_batched",
                        lambda *a: pytest.fail("K1 ran under lstm_impl='scan'"))
    cfg = ModelConfig(hidden_size=HIDDEN, lstm_impl="scan")
    with torch.no_grad():
        out, st = tumx.umx_recurrence_batched(
            params, torch.from_numpy(x1),
            tumx.LSTMState(h=torch.from_numpy(h), c=torch.from_numpy(c)), cfg)
    assert len(calls) == cfg.n_lstm_layers
    for a, b in ((out, jout), (st.h, jst.h), (st.c, jst.c)):
        assert float(np.abs(a.numpy() - np.asarray(b)).max()) <= LAYER_ATOL


@pytest.fixture(scope="module")
def track():
    # 2.6 s of stereo tones + noise: five 1 s chunks with the shift pad
    t = np.arange(int(2.6 * SR)) / SR
    rng = np.random.default_rng(0)
    return np.stack([
        0.4 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.standard_normal(t.size),
        0.3 * np.sin(2 * np.pi * 330 * t) + 0.05 * rng.standard_normal(t.size),
    ]).astype(np.float32)


def _rel(ours, ref, what):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape and np.isfinite(ours).all()
    err = float(np.max(np.abs(ours - ref)) / np.max(np.abs(ref)))
    print(f"scan {what} vs JAX: max|d|/max|stem| {err:.3g}")
    return err


def _cfgs(secs, shifts, window_chunks=-1, chunk_batch=0):
    seg = dict(segment_secs=secs, window_chunks=window_chunks, chunk_batch=chunk_batch)
    jcfg = JEngineConfig(model=JModelConfig(hidden_size=HIDDEN, lstm_impl="scan"),
                         segment=JSegmentConfig(**seg),
                         wiener=JWienerConfig(impl="pallas_interpret"), shifts=shifts)
    tcfg = EngineConfig(model=ModelConfig(hidden_size=HIDDEN, lstm_impl="scan"),
                        segment=SegmentConfig(**seg), shifts=shifts)
    return jcfg, tcfg


def test_streaming_demix_track_matches_jax_scan(jax_params, params, track):
    jcfg, tcfg = _cfgs(1.0, shifts=1)
    ref = JSeparator(jax_params, jcfg).demix_track(track, seed=0)
    ours = Separator(params, tcfg, "cpu").demix_track(track, seed=0)
    assert _rel(ours, ref, "streaming demix_track") <= SLICE_RTOL


def test_windowed_demix_matches_jax_scan(jax_params, params, track):
    jcfg, tcfg = _cfgs(0.5, shifts=0, window_chunks=4, chunk_batch=2)
    ref = JSeparator(jax_params, jcfg).demix(track)
    sep = Separator(params, tcfg, "cpu")
    assert sep._geometry(track.shape[1])[2] > 4  # more chunks than a window
    ours = sep.demix(track).numpy()
    assert _rel(ours, ref, "windowed demix") <= SLICE_RTOL


def test_fleet_bucket_matches_jax_scan(jax_params, params, track):
    """A bucket of three tracks of one length: the scan over three rows a
    chain, each track against the JAX fleet and against itself alone."""
    jcfg, tcfg = _cfgs(0.5, shifts=1)
    sub = [track[:, :30_000], track[:, 30_000:60_000] * 0.5, track[:, 60_000:90_000]]
    seeds = [7, 8, 9]
    ref = jdemix_tracks(jax_params, sub, jcfg, mesh=None, seeds=seeds)
    stats: dict = {}
    ours = fleet.demix_tracks(params, sub, tcfg, seeds=seeds, stats=stats)
    assert stats["rows"] == 3
    for k, (o, r) in enumerate(zip(ours, ref)):
        assert _rel(o, r, f"fleet bucket track {k}") <= SLICE_RTOL
        alone = fleet.demix_tracks(params, [sub[k]], tcfg, seeds=[seeds[k]])[0]
        assert np.array_equal(alone, o)


def _run_path(path, params, track):
    """One inference entry point under lstm_impl="scan", small and on the CPU."""
    from umx_tpu_torch.engine.batcher import SegmentBatcher
    from umx_tpu_torch.engine.streaming import StreamingDemixer
    from umx_tpu_torch.parallel.mesh import make_mesh
    from umx_tpu_torch.parallel.sharding import batched_lstm_state, demix_segments_batch

    _, cfg = _cfgs(0.5, shifts=0)
    audio = track[:, :40_000]
    if path in ("streaming", "groups", "batched", "windowed"):
        seg = {"batched": dict(streaming=False), "windowed": dict(window_chunks=2)}.get(path, {})
        cfg = cfg.replace(segment=dataclasses.replace(cfg.segment, **seg),
                          stream_impl="groups" if path == "groups" else "scan")
        Separator(params, cfg, "cpu").demix(audio)
    elif path == "fleet":
        fleet.demix_tracks(params, [audio, audio[:, ::-1].copy()], cfg)
    elif path == "served row":
        n = cfg.segment.segment_samples(SR)
        batcher = SegmentBatcher(max_batch=2)
        try:
            batcher.run(params, torch.from_numpy(audio[:, :n]), tumx.init_lstm_state(cfg.model),
                        cfg, n)
        finally:
            batcher.close()
    elif path == "stream session":
        sd = StreamingDemixer(params, cfg, "cpu")
        sd.push(audio)
        sd.flush()
    else:  # the sharded demix on a grid of one repeated CPU device
        n = cfg.segment.segment_samples(SR)
        batch = torch.from_numpy(np.stack([track[:, :n], track[:, n: 2 * n]]))
        demix_segments_batch(params, batch, batched_lstm_state(cfg, 2), cfg,
                             make_mesh(2, 1, [torch.device("cpu")] * 2))


@pytest.mark.parametrize("path", ["streaming", "groups", "batched", "windowed", "fleet",
                                  "served row", "stream session", "sharded demix"])
def test_every_inference_path_runs_the_scan(params, track, path, monkeypatch):
    """Every inference entry point reaches the float32 layer under "scan"
    (the pipelined arm excepted, below), never the merged kernel."""
    calls = {"scan": 0, "merged": 0}
    real = {"scan": L.lstm_layer_scan_batched, "merged": L.lstm_layer_merged_batched}

    def counted(name):
        def fn(*a):
            calls[name] += 1
            return real[name](*a)
        return fn

    monkeypatch.setattr(tumx, "lstm_layer_scan_batched", counted("scan"))
    monkeypatch.setattr(tumx, "lstm_layer_merged_batched", counted("merged"))
    _run_path(path, params, track)
    assert calls["scan"] > 0 and calls["merged"] == 0, calls


def test_pipelined_arm_keeps_k1_under_scan(params, monkeypatch):
    """The pipelined step calls the merged kernel whatever lstm_impl says,
    as the JAX arm always calls its merged kernel."""
    monkeypatch.setattr(tumx, "lstm_layer_scan_batched",
                        lambda *a: pytest.fail("the pipelined arm ran the scan"))
    cfg = ModelConfig(hidden_size=HIDDEN, lstm_impl="scan")
    x = torch.zeros((1, 4, 5, HIDDEN))
    st = (torch.zeros((1, 4, 2, HIDDEN // 2)),) * 2
    with torch.no_grad():
        outs, states = tumx.umx_recurrence_pipelined_step(params, [x, x], [st, st], [0, 1], cfg)
    assert len(outs) == len(states) == 2 and outs[0].shape == (1, 4, 5, HIDDEN)


# ---- gradients through the scan ---------------------------------------------


def _loss_batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "x": torch.from_numpy(np.abs(rng.standard_normal((1, 5, cfg.n_features))).astype(np.float32)),
        "mix_mag": torch.from_numpy(np.abs(rng.standard_normal((1, 2, 5, cfg.n_bins))).astype(np.float32)),
        "target_mag": torch.from_numpy(
            np.abs(rng.standard_normal((1, 4, 2, 5, cfg.n_bins))).astype(np.float32)),
    }


def test_trainer_trains_through_the_scan(params, monkeypatch):
    """The train step under "scan" runs K10 with residuals and K11 once per
    layer (their plain versions here), never the merged kernels, and
    updates every trainable field."""
    from umx_tpu_torch.train import TrainConfig, init_train_state

    cfg = ModelConfig(hidden_size=HIDDEN, lstm_impl="scan")
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = L.lstm_scan_train_fwd, L.lstm_scan_bwd_step
    monkeypatch.setattr(L, "lstm_scan_train_fwd",
                        lambda *a: calls.__setitem__("fwd", calls["fwd"] + 1) or fwd(*a))
    monkeypatch.setattr(L, "lstm_scan_bwd_step",
                        lambda *a: calls.__setitem__("bwd", calls["bwd"] + 1) or bwd(*a))
    for name in ("lstm_merged", "lstm_merged_train_fwd", "lstm_merged_bwd_step"):
        monkeypatch.setattr(L, name, lambda *a, n=name: pytest.fail(f"{n} ran under scan"))
    state = init_train_state(params, TrainConfig())
    state, loss = make_train_step(cfg)(state, _loss_batch(cfg))
    assert calls == {"fwd": cfg.n_lstm_layers, "bwd": cfg.n_lstm_layers}
    assert torch.isfinite(loss) and state.step == 1
    assert not torch.equal(state.params.lstm_hh_w, params.lstm_hh_w)


def test_eval_step_runs_the_scan(params, monkeypatch):
    """The eval step takes no gradient, so it runs the float32 recurrence
    (three layers, never K1) and gives the loss of the scan's forward."""
    cfg = ModelConfig(hidden_size=HIDDEN, lstm_impl="scan")
    batch = _loss_batch(cfg, seed=1)
    calls = []
    monkeypatch.setattr(L, "lstm_scan", lambda *a: calls.append(1) or L.lstm_scan_plain(*a))
    monkeypatch.setattr(L, "lstm_merged", lambda *a: pytest.fail("K1 ran under scan"))
    loss = make_eval_step(cfg)(params, batch)
    assert len(calls) == cfg.n_lstm_layers
    with torch.no_grad():
        assert torch.equal(loss, mask_loss(params, batch, cfg))
    assert torch.isfinite(loss) and float(loss) > 0


def test_scan_layer_takes_a_gradient(params):
    """The recurrence under "scan" with a gradient wanted gives autograd's
    gradients through the plain float32 forward (the same function run
    step by step): W_hh, x1 and the initial state, within 1e-5 of each
    gradient's largest entry (f32 both sides, summation order only)."""
    cfg = ModelConfig(hidden_size=HIDDEN, lstm_impl="scan")
    rng = np.random.default_rng(11)
    x1 = torch.from_numpy(np.tanh(rng.standard_normal((2, 4, 7, HIDDEN))).astype(np.float32))
    st = tumx.init_lstm_state(cfg, batch=2)
    h0 = torch.from_numpy(0.3 * rng.standard_normal(st.h.shape).astype(np.float32))
    c0 = torch.from_numpy(0.3 * rng.standard_normal(st.c.shape).astype(np.float32))
    cot = torch.from_numpy(rng.standard_normal((2, 4, 7, HIDDEN)).astype(np.float32))

    def grads(layer):
        leaves = [params.lstm_hh_w.detach().clone().requires_grad_(), x1.clone().requires_grad_(),
                  h0.clone().requires_grad_(), c0.clone().requires_grad_()]
        p = dataclasses.replace(params, lstm_hh_w=leaves[0])
        real = tumx.lstm_layer_scan_batched
        tumx.lstm_layer_scan_batched = layer
        try:
            out, new = tumx.umx_recurrence_batched(p, leaves[1], tumx.LSTMState(*leaves[2:]), cfg)
        finally:
            tumx.lstm_layer_scan_batched = real
        ((out * cot).sum() + new.h.sum() + 0.5 * new.c.sum()).backward()
        return [t.grad for t in leaves]

    def plain_layer(x_proj, hh_w, h0, c0):  # autograd through the plain forward
        Bsz, n_t, _, D, G4 = x_proj.shape
        xp, h0r, c0r = L._chain_rows(x_proj, h0, c0)
        out = L.lstm_scan_plain(xp, hh_w.reshape(n_t * D, G4 // 4, G4), h0r, c0r, Bsz)
        return L._batched_outputs(*out, x_proj.shape)

    ours, ref = grads(tumx.lstm_layer_scan_batched), grads(plain_layer)
    for name, a, b in zip(("hh_w", "x1", "h0", "c0"), ours, ref):
        err = float((a - b).abs().max()) / float(b.abs().max())
        print(f"scan layer gradient {name}: {err:.3g} of max|g|")
        assert err <= 1e-5, (name, err)


def test_planner_counts_the_scan_exchange_buffer():
    """K10's exchange holds one f32 value of h a word (K1's two bf16): the
    planner's fixed part grows by the difference, nothing else."""
    auto = EngineConfig()
    scan = auto.replace(model=dataclasses.replace(auto.model, lstm_impl="scan"))
    a, s = memory.segment_batch_hbm_bytes(auto, 1), memory.segment_batch_hbm_bytes(scan, 1)
    words = L.scan_exchange_words(8, 512) - L.resident_exchange_words(8, 512)
    assert s["fixed"] - a["fixed"] == 8 * words and s["total"] - a["total"] == 8 * words
