"""The port's mask network against the JAX package: umx_pre / umx_post,
the merged BLSTM recurrence (plain version of the CUDA kernel) against
the Pallas kernel in interpret mode, and the 3-layer streaming
umx_recurrence.  The kernel wrapper's argument checks run here too."""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from umx_tpu.config import ModelConfig as JModelConfig
from umx_tpu.models import umx as jumx
from umx_tpu.ops.lstm_pallas import (
    lstm_layer_pallas_merged,
    lstm_layer_pallas_merged_batched,
)
from umx_tpu_torch.config import ModelConfig
from umx_tpu_torch.models import umx as tumx
from umx_tpu_torch.ops import lstm_cuda

HIDDEN = 32
N_FRAMES = 23


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def cfgs():
    return JModelConfig(hidden_size=HIDDEN), ModelConfig(hidden_size=HIDDEN)


@pytest.fixture(scope="module")
def params(cfgs):
    jp = jumx.synthetic_params(cfgs[0], seed=1)
    return jp, tumx.params_from_jax(jp)


@pytest.fixture(scope="module")
def x_in(cfgs):
    rng = np.random.default_rng(7)
    return np.abs(rng.standard_normal((N_FRAMES, cfgs[1].n_features))).astype(np.float32)


def _assert_normwise(ours, ref, rtol):
    """max |ours - ref| <= rtol * max |ref| (error relative to the tensor's
    scale, so entries near zero are not held to a pointwise relative bound)."""
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert ours.shape == ref.shape
    err = np.max(np.abs(ours - ref)) / np.max(np.abs(ref))
    assert err <= rtol, f"normwise error {err:.3g} > {rtol}"


@pytest.mark.parametrize("scaling", ["openunmix", "umxcpp"])
def test_umx_pre_post_match_jax(cfgs, params, x_in, scaling):
    jcfg = dataclasses.replace(cfgs[0], input_scaling=scaling)
    tcfg = dataclasses.replace(cfgs[1], input_scaling=scaling)
    jp, tp = params
    j1 = np.array(jumx.umx_pre(jp, jnp.asarray(x_in), jcfg))
    t1 = tumx.umx_pre(tp, torch.from_numpy(x_in), tcfg)
    # f32 on both sides; only the summation order of the 2974-long fc1
    # products differs → 1e-5 of the output scale
    _assert_normwise(t1.numpy(), j1, 1e-5)

    rng = np.random.default_rng(2)
    lstm_out = rng.standard_normal((4, N_FRAMES, HIDDEN)).astype(np.float32)
    jm = np.asarray(jumx.umx_post(jp, jnp.asarray(j1), jnp.asarray(lstm_out), jcfg))
    tm = tumx.umx_post(tp, torch.from_numpy(j1), torch.from_numpy(lstm_out), tcfg)
    assert tm.shape == (4, N_FRAMES, tcfg.n_outputs)
    _assert_normwise(tm.numpy(), jm, 1e-5)


def _layer_inputs(B, n_targets=4, D=2, G=16, T=21, seed=0):
    rng = np.random.default_rng(seed)
    lead = (B,) if B else ()
    x_proj = rng.standard_normal((*lead, n_targets, T, D, 4 * G)).astype(np.float32)
    hh_w = (rng.standard_normal((n_targets, D, G, 4 * G)) / np.sqrt(G)).astype(np.float32)
    h0 = (0.5 * rng.standard_normal((*lead, n_targets, D, G))).astype(np.float32)
    c0 = (0.5 * rng.standard_normal((*lead, n_targets, D, G))).astype(np.float32)
    return x_proj, hh_w, h0, c0


# Both sides round h and W_hh to bf16 and accumulate exact products in
# f32, so they differ only in f32 summation order; this comparison
# measures max |Δ| ≈ 1.2e-7, so the bound is 1e-5.
LSTM_ATOL = 1e-5


def test_merged_layer_matches_pallas_interpret():
    x_proj, hh_w, h0, c0 = _layer_inputs(B=0)
    # time_block 8 over T=21 leaves a partial last block on the TPU side
    ref = lstm_layer_pallas_merged(
        jnp.asarray(x_proj), jnp.asarray(hh_w), jnp.asarray(h0), jnp.asarray(c0),
        time_block=8, interpret=True,
    )
    # the port has one layer entry, batched: a batch of one row
    ours = [o[0] for o in lstm_cuda.lstm_layer_merged_batched(
        *(torch.from_numpy(a)[None] if a is not hh_w else torch.from_numpy(a)
          for a in (x_proj, hh_w, h0, c0)))]
    for o, r in zip(ours, ref):
        assert o.shape == r.shape
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0, atol=LSTM_ATOL)


@pytest.mark.parametrize("B", [1, 3])
def test_batched_merged_layer_matches_pallas_interpret(B):
    x_proj, hh_w, h0, c0 = _layer_inputs(B=B, seed=B)
    ref = lstm_layer_pallas_merged_batched(
        jnp.asarray(x_proj), jnp.asarray(hh_w), jnp.asarray(h0), jnp.asarray(c0),
        time_block=8, interpret=True,
    )
    ours = lstm_cuda.lstm_layer_merged_batched(*map(torch.from_numpy, (x_proj, hh_w, h0, c0)))
    for o, r in zip(ours, ref):
        assert o.shape == r.shape
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0, atol=LSTM_ATOL)


def test_umx_recurrence_streams_state_like_jax(cfgs, params):
    jcfg = dataclasses.replace(cfgs[0], lstm_impl="pallas_interpret")
    tcfg = cfgs[1]
    jp, tp = params
    rng = np.random.default_rng(11)
    xs = [np.tanh(rng.standard_normal((4, 13, HIDDEN))).astype(np.float32) for _ in range(2)]
    jstate = jumx.init_lstm_state(jcfg)
    tstate = tumx.init_lstm_state(tcfg)
    for x1 in xs:  # two calls: the second starts from the first's state
        jout, jstate = jumx.umx_recurrence(jp, jnp.asarray(x1), jstate, jcfg)
        tout, tstate = tumx.umx_recurrence(tp, torch.from_numpy(x1), tstate, tcfg)
        assert tout.shape == (4, 13, HIDDEN)
        # Across three layers the f32 input projections differ in their last
        # bits, which now and then flips the bf16 rounding of one h element
        # (one bf16 step, 2^-8 relative); its effect on the next gates stays
        # ~1e-5 (measured max 2.5e-5 here), so the bound is 1e-4.
        for o, r in ((tout, jout), (tstate.h, jstate.h), (tstate.c, jstate.c)):
            np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0, atol=1e-4)
    assert np.abs(tstate.h.numpy()).max() > 0.01  # the carry is not trivially zero


def test_lstm_merged_wrapper_checks_and_cpu_route():
    T, R, B, G = 5, 2, 2, 8
    xp = torch.zeros((T, R * B, 4 * G))
    whh = torch.zeros((R, G, 4 * G), dtype=torch.bfloat16)
    h0 = torch.zeros((R * B, G))
    before = lstm_cuda.lstm_merged.launches
    hs, hT, cT = lstm_cuda.lstm_merged(xp, whh, h0, h0.clone(), B)
    assert hs.shape == (T, R * B, G) and hT.shape == cT.shape == (R * B, G)
    # the CPU route runs the plain version and launches nothing
    assert lstm_cuda.lstm_merged.launches == before
    with pytest.raises(TypeError, match="bfloat16"):
        lstm_cuda.lstm_merged(xp, whh.float(), h0, h0, B)
    with pytest.raises(ValueError, match="R\\*B"):
        lstm_cuda.lstm_merged(xp, whh, h0, h0, 3)
    with pytest.raises(ValueError, match="contiguous"):
        lstm_cuda.lstm_merged(xp.transpose(0, 1).contiguous().transpose(0, 1), whh, h0, h0, B)
    with pytest.raises(ValueError, match="h0"):
        lstm_cuda.lstm_merged(xp, whh, h0[:, :4], h0, B)


# Widths the resident kernels do not hold as they are: G % 8 != 0 (the card
# pads them with zero units) and G > 512 (the card runs the wide form); the
# JAX kernel has no condition on G.  T <= 16 keeps the interpreter quick.
@pytest.mark.parametrize("G, T", [(18, 13), (20, 16), (520, 5)])
def test_merged_layer_matches_pallas_interpret_at_width(G, T):
    n_targets = 4 if G < 512 else 1
    x_proj, hh_w, h0, c0 = _layer_inputs(B=0, n_targets=n_targets, G=G, T=T, seed=G)
    ref = lstm_layer_pallas_merged(
        jnp.asarray(x_proj), jnp.asarray(hh_w), jnp.asarray(h0), jnp.asarray(c0),
        time_block=8, interpret=True,
    )
    ours = [o[0] for o in lstm_cuda.lstm_layer_merged_batched(
        *(torch.from_numpy(a)[None] if a is not hh_w else torch.from_numpy(a)
          for a in (x_proj, hh_w, h0, c0)))]
    for o, r in zip(ours, ref):
        assert o.shape == r.shape
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0, atol=LSTM_ATOL)


@pytest.mark.parametrize("G", [18, 20])
@pytest.mark.parametrize("B", [1, 3])
def test_padding_to_the_kernels_width_is_exact(G, B):
    """The card runs the resident kernels at G rounded up to a multiple of
    8, zero units appended to each gate block (``lstm_cuda.at_width``): the
    plain versions at the padded width, cut, are bit-equal to the plain
    versions at G (K1 and K4 forward, K5 sweep, K9)."""
    T, R = 7, 8
    Gp = lstm_cuda.merged_width(G)
    assert Gp == 24 and lstm_cuda.merged_form(G) == "resident"
    rng = np.random.default_rng(G + B)
    xp = torch.from_numpy(rng.standard_normal((T, R * B, 4 * G)).astype(np.float32))
    whh = torch.from_numpy((rng.standard_normal((R, G, 4 * G)) / np.sqrt(G)).astype(
        np.float32)).to(torch.bfloat16)
    h0, c0, dhT, dcT = (torch.from_numpy((0.5 * rng.standard_normal((R * B, G))).astype(
        np.float32)) for _ in range(4))
    dhs = torch.from_numpy(rng.standard_normal((T, R * B, G)).astype(np.float32))

    fwd = lstm_cuda.lstm_merged_train_fwd_plain(xp, whh, h0, c0, B)
    padded = lstm_cuda.at_width(lstm_cuda.lstm_merged_train_fwd_plain, G, Gp,
                                (xp, whh, h0, c0, B), lstm_cuda._FWD_KINDS, lstm_cuda._FWD_OUT)
    assert all(torch.equal(a, b) for a, b in zip(padded, fwd))
    gates, cs = fwd[3], fwd[4]
    args = (gates, cs, c0, whh, dhs, dhT, dcT, B)
    bwd = lstm_cuda.lstm_merged_bwd_step_plain(*args)
    padded = lstm_cuda.at_width(lstm_cuda.lstm_merged_bwd_step_plain, G, Gp, args,
                                lstm_cuda._BWD_KINDS, lstm_cuda._BWD_OUT)
    assert all(torch.equal(a, b) for a, b in zip(padded, bwd))

    x4 = xp[:, :R].reshape(T, 4, 2, 4 * G).transpose(0, 1).contiguous()  # (T#, T, D, 4G)
    w4, h4, c4 = whh.view(4, 2, G, 4 * G), h0[:R].view(4, 2, G), c0[:R].view(4, 2, G)
    k9 = lstm_cuda.lstm_pertarget_plain(x4, w4, h4, c4)
    padded = lstm_cuda.at_width(lstm_cuda.lstm_pertarget_plain, G, Gp, (x4, w4, h4, c4),
                                ("gates", "whh", "units", "units"), ("units",) * 3)
    assert all(torch.equal(a, b) for a, b in zip(padded, k9))
    # a padded unit's gate columns sit at the end of each gate block
    p = lstm_cuda.pad_width(xp, "gates", G, Gp).view(T, R * B, 4, Gp)
    assert torch.equal(p[..., :G], xp.view(T, R * B, 4, G)) and not p[..., G:].any()
    assert torch.equal(lstm_cuda.cut_width(lstm_cuda.pad_width(whh, "whh", G, Gp), "whh",
                                           G, Gp), whh)


def test_merged_training_vjp_matches_jax_at_g18():
    """The differentiable merged layer (K4, K5 + K6 on the card, padded to
    G 24 there; their plain versions here) at G 18 against ``jax.vjp`` of
    the JAX package's custom-VJP kernels in interpret mode."""
    import jax

    B, G, T = 2, 18, 9
    x_proj, hh_w, h0, c0 = _layer_inputs(B=B, n_targets=2, G=G, T=T, seed=18)
    rng = np.random.default_rng(19)
    cts = tuple(rng.standard_normal(s).astype(np.float32)
                for s in ((B, 2, T, 2, G), (B, 2, 2, G), (B, 2, 2, G)))
    out, vjp = jax.vjp(lambda *a: lstm_layer_pallas_merged_batched(*a, time_block=4,
                                                                    interpret=True),
                       *map(jnp.asarray, (x_proj, hh_w, h0, c0)))
    grads = vjp(tuple(map(jnp.asarray, cts)))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x_proj, hh_w, h0, c0)]
    ours = lstm_cuda.lstm_layer_merged_batched(*leaves)
    loss = sum((o * torch.from_numpy(c)).sum() for o, c in zip(ours, cts))
    ours_g = torch.autograd.grad(loss, leaves)
    # bf16 operands on both sides, f32 sums in other orders (the 1e-4 of
    # tests/test_torch_lstm_train.py)
    for o, r in zip((*ours, *ours_g), (*out, *grads)):
        o, r = o.detach().numpy(), np.asarray(r)
        assert o.shape == r.shape
        _assert_normwise(o, r, 1e-4)


def test_pipelined_step_matches_the_jax_step_at_hidden_36():
    """The pipelined arm's stacked recurrence at hidden 36 (G 18: the card
    pads it to 24) against the JAX arm's step with its merged kernel in
    interpret mode, three stages."""
    H = 36
    jcfg, tcfg = JModelConfig(hidden_size=H), ModelConfig(hidden_size=H)
    jp = jumx.synthetic_params(jcfg, seed=3)
    tp = tumx.params_from_jax(jp)
    rng = np.random.default_rng(36)
    n_t, T, G, layers = 4, 11, H // 2, [0, 1, 2]
    xs = [rng.uniform(-1, 1, (n_t, T, H)).astype(np.float32) for _ in layers]
    hc = [tuple((0.2 * rng.standard_normal((n_t, 2, G))).astype(np.float32) for _ in range(2))
          for _ in layers]
    j_outs, j_states = jumx.umx_recurrence_pipelined_step(
        jp, [jnp.asarray(x) for x in xs], [(jnp.asarray(h), jnp.asarray(c)) for h, c in hc],
        layers, jcfg, interpret=True)
    with torch.inference_mode():
        outs, states = tumx.umx_recurrence_pipelined_step(
            tp, [torch.from_numpy(x)[None] for x in xs],
            [(torch.from_numpy(h)[None], torch.from_numpy(c)[None]) for h, c in hc],
            layers, tcfg)
    for s in range(len(layers)):
        assert outs[s].shape == (1, n_t, T, 2 * G)
        # one bf16 rounding of h may flip between the two f32 projections
        # (test_umx_recurrence_streams_state_like_jax's 1e-4)
        np.testing.assert_allclose(outs[s][0].numpy(), np.asarray(j_outs[s]), atol=1e-4)
        for ours, theirs in zip(states[s], j_states[s]):
            np.testing.assert_allclose(ours[0].numpy(), np.asarray(theirs), atol=1e-4)
