"""The per-target BLSTM recurrence (plain version of the CUDA kernel)
against the JAX package's per-target Pallas kernel in interpret mode and
against the merged plain version, the model's dispatch on
``ModelConfig.lstm_impl``, and the wrapper's argument checks."""

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
    """A gradient runs the merged training kernels whatever lstm_impl says."""
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
    for impl in ("scan", "pallas_interpret"):
        with pytest.raises(ValueError, match="no meaning"):
            ModelConfig(lstm_impl=impl)
    with pytest.raises(ValueError, match="auto, pallas_merged or pallas"):
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
