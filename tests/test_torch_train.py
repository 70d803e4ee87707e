"""The port's trainer (``umx_tpu_torch.train``) against ``umx_tpu.train``:
the loss and its gradients through the kernel recurrence, the AdamW step
with its frozen BatchNorm-statistics group, the plateau/early-stop
recipe, checkpoints, ggml export and batch construction."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from umx_tpu.config import DSPConfig as JDSPConfig
from umx_tpu.config import ModelConfig as JModelConfig
from umx_tpu.models import umx as jumx
from umx_tpu_torch import train as ttrain
from umx_tpu_torch.config import DSPConfig, ModelConfig
from umx_tpu_torch.models import umx as tumx

HIDDEN, B, T = 32, 2, 12


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
def jparams(cfgs):
    return jumx.synthetic_params(cfgs[0], seed=0)


@pytest.fixture(scope="module")
def batch_np(cfgs):
    rng = np.random.default_rng(5)
    cfg = cfgs[1]
    return {
        "x": rng.uniform(0, 1, (B, T, cfg.n_features)).astype(np.float32),
        "mix_mag": rng.uniform(0, 1, (B, 2, T, cfg.n_bins)).astype(np.float32),
        "target_mag": rng.uniform(0, 1, (B, 4, 2, T, cfg.n_bins)).astype(np.float32),
    }


def _torch_batch(batch_np):
    return {k: torch.from_numpy(v) for k, v in batch_np.items()}


def _fields():
    return [f.name for f in dataclasses.fields(tumx.UMXParams)]


def _jax_kernel_loss(cfg):
    """The JAX trainer's loss with the TPU kernel semantics on the CPU:
    the merged recurrence's custom VJP in Pallas interpret mode."""
    from umx_tpu.engine.separator import apply_masks

    spec = jumx.resolve_compute("default")

    def loss(p, batch):
        x = batch["x"]
        state_b = jax.tree.map(
            lambda a: jnp.broadcast_to(a, (x.shape[0], *a.shape)), jumx.init_lstm_state(cfg)
        )
        x1 = jax.vmap(lambda xi: jumx.umx_pre(p, xi, cfg, spec))(x)
        out, _ = jumx._recurrence_pallas_batched(p, x1, state_b, cfg, spec, interpret=True)
        masks = jax.vmap(lambda a, b_: jumx.umx_post(p, a, b_, cfg, spec))(x1, out)
        pred = jax.vmap(lambda m, mg: apply_masks(m, mg, cfg.n_bins))(masks, batch["mix_mag"])
        return jnp.mean(jnp.square(pred - batch["target_mag"]))

    return loss


def test_mask_loss_and_gradients_match_jax_kernel_path(cfgs, jparams, batch_np):
    jcfg, tcfg = cfgs
    jb = {k: jnp.asarray(v) for k, v in batch_np.items()}
    jl, jg = jax.value_and_grad(_jax_kernel_loss(jcfg))(jparams, jb)

    params = tumx.params_from_jax(jparams)
    for n in _fields():  # every field, the frozen statistics included
        getattr(params, n).requires_grad_(True)
    loss = ttrain.mask_loss(params, _torch_batch(batch_np), tcfg)
    loss.backward()
    # f32 on both sides; summation order only
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    # Each field's gradient against its own scale.  Where f32 sums differ
    # in order, the bf16 rounding of an h or a gate cotangent flips now and
    # then; in a weight gradient of the recurrence that is one term of only
    # T·B = 24 moved by 2^-8: measured 9.7e-5 of max|g| (lstm_hh_w), bound
    # 2e-4.  Every other field sees it only through the f32 dx chain:
    # measured ≤ 6.8e-6, bound 2e-5.
    for n in _fields():
        ours = getattr(params, n).grad.numpy().astype(np.float64)
        ref = np.asarray(getattr(jg, n), np.float64)
        assert ours.shape == ref.shape, n
        err = np.max(np.abs(ours - ref)) / np.max(np.abs(ref))
        assert err <= (2e-4 if n.startswith("lstm_") else 2e-5), f"{n}: {err:.3g}"


def test_adamw_step_matches_optax_from_the_same_grads(cfgs, jparams):
    """Steps from identical gradients (Adam's first step is ~lr·sign(g), so
    comparing each side's own gradients would amplify tiny differences)."""
    from umx_tpu.train import TrainConfig as JTrainConfig
    from umx_tpu.train import make_optimizer as jmake_optimizer

    import optax

    tc = ttrain.TrainConfig(learning_rate=1e-3)
    jopt = jmake_optimizer(JTrainConfig(learning_rate=1e-3))
    jp, jst = jparams, jopt.init(jparams)
    state = ttrain.init_train_state(tumx.params_from_jax(jparams), tc)
    rng = np.random.default_rng(9)
    for _ in range(3):
        grads = {n: rng.standard_normal(np.shape(getattr(jp, n))).astype(np.float32)
                 for n in _fields()}
        upd, jst = jopt.update(jumx.UMXParams(**{n: jnp.asarray(g) for n, g in grads.items()}),
                               jst, jp)
        jp = optax.apply_updates(jp, upd)
        for n in _fields():
            p = getattr(state.params, n)
            if p.requires_grad:
                p.grad = torch.from_numpy(grads[n])
        state.optimizer.step()
    for n in _fields():
        ours, ref = getattr(state.params, n).detach().numpy(), np.asarray(getattr(jp, n))
        if n in ttrain.FROZEN:
            np.testing.assert_array_equal(ours, ref, err_msg=n)
        else:
            # the same AdamW arithmetic in another operation order
            np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6, err_msg=n)


def _train(cfg, params, batch, steps, lr=1e-3):
    state = ttrain.init_train_state(params, ttrain.TrainConfig(learning_rate=lr))
    step = ttrain.make_train_step(cfg)
    losses = []
    for _ in range(steps):
        state, loss = step(state, batch)
        losses.append(loss.item())
    return state, losses


def test_training_freezes_bn_statistics_and_lowers_the_loss(cfgs, batch_np):
    cfg = cfgs[1]
    params = tumx.synthetic_params(cfg, seed=5)
    state, losses = _train(cfg, params, _torch_batch(batch_np), steps=4)
    assert state.step == 4
    assert losses[-1] < losses[0], losses
    for n in _fields():
        moved = not torch.equal(getattr(state.params, n), getattr(params, n))
        assert moved == (n not in ttrain.FROZEN), n
        assert not getattr(params, n).requires_grad  # the caller's tensors are untouched


def test_lr_zero_leaves_params_bit_equal(cfgs, batch_np):
    cfg = cfgs[1]
    params = tumx.synthetic_params(cfg, seed=3)
    state = ttrain.init_train_state(params, ttrain.TrainConfig())
    assert ttrain.get_lr(state.optimizer) == pytest.approx(1e-3)
    ttrain.set_lr(state.optimizer, 0.0)
    state, _ = ttrain.make_train_step(cfg)(state, _torch_batch(batch_np))
    for n in _fields():
        assert torch.equal(getattr(state.params, n), getattr(params, n)), n
    assert ttrain.get_lr(state.optimizer) == 0.0


def test_eval_step_takes_no_gradient(cfgs, batch_np):
    cfg = cfgs[1]
    state = ttrain.init_train_state(tumx.synthetic_params(cfg, seed=1), ttrain.TrainConfig())
    batch = _torch_batch(batch_np)
    loss = ttrain.make_eval_step(cfg)(state.params, batch)
    assert loss.grad_fn is None
    assert loss.item() == pytest.approx(ttrain.mask_loss(state.params, batch, cfg).item(), rel=1e-6)


def test_plateau_scheduler_semantics():
    s = ttrain.PlateauScheduler(lr=1.0, gamma=0.5, patience=2, cooldown=1)
    assert s.update(1.0) == 1.0  # new best
    assert s.update(1.0) == 1.0  # bad 1
    assert s.update(1.0) == 1.0  # bad 2 (== patience, not yet >)
    assert s.update(1.0) == 0.5  # bad 3 > patience -> decay
    assert s.update(1.0) == 0.5  # cooldown round: no counting
    assert s.update(0.5) == 0.5  # improvement resets
    assert s.best == 0.5


def test_early_stopper_semantics():
    e = ttrain.EarlyStopper(patience=1)
    assert not e.update(1.0)  # best
    assert not e.update(1.0)  # bad 1
    assert e.update(1.0)  # bad 2 > patience
    e2 = ttrain.EarlyStopper(patience=1)
    assert not e2.update(1.0)
    assert not e2.update(0.9)  # keeps improving
    assert not e2.update(0.8)


def test_checkpoint_round_trip(tmp_path, cfgs, batch_np):
    cfg = cfgs[1]
    batch = _torch_batch(batch_np)
    state, _ = _train(cfg, tumx.synthetic_params(cfg, seed=1), batch, steps=2)
    path = str(tmp_path / "ckpt.pt")
    ttrain.save_checkpoint(path, state)
    fresh = ttrain.init_train_state(tumx.synthetic_params(cfg, seed=2), ttrain.TrainConfig())
    restored = ttrain.restore_checkpoint(path, fresh)
    assert restored.step == 2
    for n in _fields():
        assert torch.equal(getattr(restored.params, n), getattr(state.params, n)), n
    # the optimizer's moments came back too: one more step agrees exactly
    step = ttrain.make_train_step(cfg)
    step(state, batch)
    step(restored, batch)
    for n in _fields():
        assert torch.equal(getattr(restored.params, n), getattr(state.params, n)), n


def test_export_ggml_reads_back_as_jax_export(tmp_path, cfgs, jparams):
    from umx_tpu.io.ggml import read_ggml as jread_ggml
    from umx_tpu.train import export_ggml as jexport_ggml
    from umx_tpu_torch.io.ggml import read_ggml

    jcfg, tcfg = cfgs
    jexport_ggml(jparams, str(tmp_path / "jax.bin"), jcfg)
    ttrain.export_ggml(tumx.params_from_jax(jparams), str(tmp_path / "port.bin"), tcfg)
    ours, ref = read_ggml(str(tmp_path / "port.bin")), jread_ggml(str(tmp_path / "jax.bin"))
    assert ours.hidden_size == ref.hidden_size == HIDDEN
    for t in ref.targets:
        assert set(ours.targets[t]) == set(ref.targets[t])
        for name, arr in ref.targets[t].items():
            np.testing.assert_array_equal(ours.targets[t][name], arr, err_msg=f"{t}/{name}")


def test_make_batch_from_audio_matches_jax(cfgs):
    from umx_tpu.train import make_batch_from_audio as jmake_batch

    jcfg, tcfg = cfgs
    rng = np.random.default_rng(91)
    seq_len = 12
    n = 1024 * (seq_len - 1)
    mix = rng.standard_normal((2, 2, n)).astype(np.float32) * 0.1
    targets = rng.standard_normal((2, 4, 2, n)).astype(np.float32) * 0.05
    ref = jmake_batch(mix, targets, jcfg, JDSPConfig(), seq_len)
    ours = ttrain.make_batch_from_audio(mix, targets, tcfg, DSPConfig(), seq_len)
    for k, r in ref.items():
        r = np.asarray(r)
        assert ours[k].shape == r.shape, k
        # f32 FFTs with different summation orders (as test_torch_stft.py)
        assert np.max(np.abs(ours[k].numpy() - r)) <= 1e-4 * np.max(np.abs(r)), k
