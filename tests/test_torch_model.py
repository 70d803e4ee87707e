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
    ours = lstm_cuda.lstm_layer_merged(*map(torch.from_numpy, (x_proj, hh_w, h0, c0)))
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
