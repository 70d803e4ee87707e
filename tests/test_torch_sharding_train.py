"""The port's sharded train step (``umx_tpu_torch.train.make_sharded_train_step``)
and ``train_loop``'s mesh on the CPU grid ``[torch.device("cpu")] * 8``,
against the port's unsharded step and the JAX package's sharded step
(``tests/test_parallel.py::test_training_step_dp_tp_loss_decreases``).

The JAX step runs its f32 scan recurrence; the port's keeps the training
kernels' bf16 operands (their plain versions here), so the first loss is
held at 1e-5 relative (1.3e-6 measured).  Against the unsharded port step
the losses are held at 1e-5 relative.  The parameters cannot all be held
so tightly once the batch is split over dp: the weight gradients sum the
rows in another order (2e-5 of max|g| at most, 8.8e-6 measured), and
AdamW divides each element's update by that element's own gradient, so an
element whose gradient is at the rounding level moves by up to the
learning rate either way.  So over dp the parameters are held at 1e-5
relative plus that bound, and the loss they give on the batch at 1e-5;
over tp alone (the targets' sums are untouched) every element at 1e-5."""

from dataclasses import fields

import jax
import numpy as np
import pytest
import torch

from umx_tpu.config import DSPConfig as JDSPConfig
from umx_tpu.config import ModelConfig as JModelConfig
from umx_tpu.models.umx import synthetic_params as jsynthetic_params
from umx_tpu.parallel import mesh as jmesh
from umx_tpu.train import TrainConfig as JTrainConfig
from umx_tpu.train import init_train_state as jinit_train_state
from umx_tpu.train import make_batch_from_audio as jmake_batch_from_audio
from umx_tpu.train import make_sharded_train_step as jmake_sharded_train_step
from umx_tpu_torch.config import DSPConfig, ModelConfig
from umx_tpu_torch.models.umx import UMXParams, params_from_jax
from umx_tpu_torch.parallel.mesh import make_mesh
from umx_tpu_torch.train import (
    FROZEN,
    TrainConfig,
    init_train_state,
    make_batch_from_audio,
    make_eval_step,
    make_sharded_train_step,
    make_train_step,
    restore_checkpoint,
    save_checkpoint,
    unshard_state,
)

CPU8 = [torch.device("cpu")] * 8
LR = 1e-3
B = 8
STEPS = 3


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def mcfg():
    return ModelConfig(hidden_size=64)


@pytest.fixture(scope="module")
def tcfg():
    return TrainConfig(seq_len=16, learning_rate=LR)


@pytest.fixture(scope="module")
def jax_params():
    return jsynthetic_params(JModelConfig(hidden_size=64), seed=0)


@pytest.fixture(scope="module")
def params(jax_params):
    return params_from_jax(jax_params)


@pytest.fixture(scope="module")
def audio(tcfg):
    rng = np.random.default_rng(53)
    n = DSPConfig().hop * (tcfg.seq_len - 1)
    mix = rng.standard_normal((B, 2, n)).astype(np.float32) * 0.1
    targets = rng.standard_normal((B, 4, 2, n)).astype(np.float32) * 0.05
    return mix, targets


@pytest.fixture(scope="module")
def batch(mcfg, tcfg, audio):
    return make_batch_from_audio(*audio, mcfg, DSPConfig(), tcfg.seq_len, "cpu")


@pytest.fixture(scope="module")
def unsharded(mcfg, tcfg, params, batch):
    """The unsharded port step: losses, first-step gradients, final state."""
    state = init_train_state(params, tcfg)
    step = make_train_step(mcfg)
    losses, grads = [], None
    for k in range(STEPS):
        state, loss = step(state, batch)
        losses.append(float(loss))
        if k == 0:
            grads = {f.name: getattr(state.params, f.name).grad.clone()
                     for f in fields(UMXParams) if f.name not in FROZEN}
    return losses, grads, state


def _sharded(mcfg, tcfg, params, batch, dp, tp, steps=STEPS):
    step, shard_state, shard_batch = make_sharded_train_step(
        mcfg, tcfg, make_mesh(dp, tp, CPU8), tp=tp > 1)
    state, sb = shard_state(init_train_state(params, tcfg)), shard_batch(batch)
    losses, grads = [], None
    for k in range(steps):
        state, loss = step(state, sb)
        losses.append(float(loss))
        if k == 0:
            grads = {n: torch.cat([getattr(s, n).grad for s in state.slices]) for n in
                     (f.name for f in fields(UMXParams) if f.name not in FROZEN)}
    return losses, grads, state


def test_loss_decreases_over_5_steps(mcfg, tcfg, params, batch):
    # the JAX case, on a dp 4 x tp 2 mesh
    losses, _, _ = _sharded(mcfg, tcfg, params, batch, 4, 2, steps=5)
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0], losses


@pytest.mark.parametrize("dp,tp", [(4, 2), (2, 1), (1, 2)])
def test_sharded_step_equals_the_unsharded_step(mcfg, tcfg, params, batch, unsharded, dp, tp):
    ref_losses, ref_grads, ref = unsharded
    losses, grads, state = _sharded(mcfg, tcfg, params, batch, dp, tp)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    for name, g in ref_grads.items():
        assert float((grads[name] - g).abs().max()) <= 2e-5 * float(g.abs().max()), name
    whole = state.params
    atol = 0.0 if dp == 1 else 2 * STEPS * LR
    for f in fields(UMXParams):
        np.testing.assert_allclose(getattr(whole, f.name).numpy(),
                                   getattr(ref.params, f.name).detach().numpy(),
                                   rtol=1e-5, atol=atol + 1e-7, err_msg=f.name)
    eval_step = make_eval_step(mcfg)
    np.testing.assert_allclose(float(eval_step(whole, batch)),
                               float(eval_step(ref.params, batch)), rtol=1e-5)


def test_first_loss_equals_the_jax_sharded_step(mcfg, tcfg, params, jax_params, audio):
    losses, _, _ = _sharded(mcfg, tcfg, params,
                            make_batch_from_audio(*audio, mcfg, DSPConfig(), tcfg.seq_len, "cpu"),
                            4, 2, steps=1)
    mesh = jmesh.make_mesh(dp=4, tp=2)
    jcfg, jtcfg = JModelConfig(hidden_size=64), JTrainConfig(seq_len=16, learning_rate=LR)
    with mesh:
        step, shard_state, shard_batch = jmake_sharded_train_step(jcfg, jtcfg, mesh, tp=True)
        jbatch = shard_batch(jmake_batch_from_audio(*audio, jcfg, JDSPConfig(), jtcfg.seq_len))
        _, jloss = step(shard_state(jinit_train_state(jax_params, jtcfg)), jbatch)
    assert len(jax.devices()) == 8
    np.testing.assert_allclose(losses[0], float(jloss), rtol=1e-5)


@pytest.mark.parametrize("flavour", ["for-loop", "foreach", "fused"])
def test_adamw_on_split_leaves_equals_the_whole(mcfg, tcfg, params, flavour):
    # the same gradients into the whole leaves and into their target
    # slices: AdamW is elementwise, so the updates agree to 1e-6
    whole = init_train_state(params, tcfg)
    _, shard_state, _ = make_sharded_train_step(mcfg, tcfg, make_mesh(2, 4, CPU8))
    split = shard_state(init_train_state(params, tcfg))
    for opt in (whole.optimizer, split.optimizer):
        opt.param_groups[0].update(foreach=flavour == "foreach", fused=flavour == "fused" or None)
    rng = np.random.default_rng(9)
    for _ in range(3):
        for f in fields(UMXParams):
            if f.name in FROZEN:
                continue
            g = torch.from_numpy(rng.standard_normal(getattr(params, f.name).shape)
                                 .astype(np.float32))
            getattr(whole.params, f.name).grad = g
            for j, s in enumerate(split.slices):
                getattr(s, f.name).grad = g[j : j + 1].clone()
        whole.optimizer.step()
        split.optimizer.step()
    gathered = split.params
    for f in fields(UMXParams):
        a, b = getattr(gathered, f.name), getattr(whole.params, f.name).detach()
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max()), f.name


def test_shard_and_unshard_state_round_trip(mcfg, tcfg, params, batch, tmp_path):
    step, shard_state, shard_batch = make_sharded_train_step(mcfg, tcfg, make_mesh(2, 2, CPU8))
    state = shard_state(init_train_state(params, tcfg))
    state, _ = step(state, shard_batch(batch))
    back = unshard_state(state)
    assert back.step == 1
    assert len(back.optimizer.state) == len(back.optimizer.param_groups[0]["params"])
    for f in fields(UMXParams):
        assert torch.equal(getattr(back.params, f.name), getattr(state.params, f.name))
    # re-sharded, the optimizer state is the one that was gathered
    again = shard_state(back)
    for s0, s1 in zip(state.slices, again.slices):
        for f in fields(UMXParams):
            if f.name not in FROZEN:
                st0 = state.optimizer.state[getattr(s0, f.name)]
                st1 = again.optimizer.state[getattr(s1, f.name)]
                assert all(torch.equal(st0[k], st1[k]) for k in st0), f.name
    # a checkpoint of the gathered state restores into an unsharded one
    path = str(tmp_path / "ckpt.pt")
    save_checkpoint(path, back)
    fresh = restore_checkpoint(path, init_train_state(params, tcfg))
    assert fresh.step == 1
    for f in fields(UMXParams):
        assert torch.equal(getattr(fresh.params, f.name), getattr(back.params, f.name))


def test_uneven_batch_and_targets_raise_by_name(mcfg, tcfg, batch):
    _, _, shard_batch = make_sharded_train_step(mcfg, tcfg, make_mesh(3, 2, CPU8))
    with pytest.raises(ValueError, match="dp=3"):
        shard_batch(batch)
    with pytest.raises(ValueError, match="tp=8 does not divide the 4 targets"):
        make_sharded_train_step(mcfg, tcfg, make_mesh(1, 8, CPU8))


def test_train_loop_over_a_mesh_keeps_a_gathered_checkpoint(mcfg, tmp_path):
    from scipy.io import wavfile

    from umx_tpu_torch.config import TARGETS
    from umx_tpu_torch.data import StemDataset, train_loop

    rng = np.random.default_rng(0)
    for k in range(3):
        (tmp_path / f"t{k}").mkdir()
        for t in TARGETS:
            wavfile.write(str(tmp_path / f"t{k}" / f"{t}.wav"), 44100,
                          rng.uniform(-0.3, 0.3, (44100, 2)).astype(np.float32))
    tcfg = TrainConfig(seq_len=16)
    excerpt = DSPConfig().hop * (tcfg.seq_len - 1)
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    state, hist = train_loop(
        StemDataset(str(tmp_path), excerpt_samples=excerpt, split="train"), mcfg, tcfg, steps=2,
        batch_size=4, valid_dataset=StemDataset(str(tmp_path), excerpt_samples=excerpt,
                                                split="valid"),
        valid_every=1, valid_batches=1, checkpoint_dir=str(ckpt),
        mesh=make_mesh(2, 2, CPU8), params=None)
    assert len(hist) == 2 and all(np.isfinite(hist)) and len(hist.valid) == 2
    assert state.step == 2 and len(state.slices) == 2
    restored = restore_checkpoint(str(ckpt / "step_2.pt"),
                                  init_train_state(state.params, tcfg))
    assert restored.step == 2
    for f in fields(UMXParams):
        assert torch.equal(getattr(restored.params, f.name), getattr(state.params, f.name))


def test_train_umx_mesh_flag(tmp_path, capsys):
    from scipy.io import wavfile

    from umx_tpu_torch.config import TARGETS
    from umx_tpu_torch.scripts import train_umx

    rng = np.random.default_rng(1)
    for k in range(2):
        (tmp_path / f"t{k}").mkdir()
        for t in TARGETS:
            wavfile.write(str(tmp_path / f"t{k}" / f"{t}.wav"), 44100,
                          rng.uniform(-0.3, 0.3, (44100, 2)).astype(np.float32))
    out = str(tmp_path / "m.bin")
    argv = [str(tmp_path), out, "--hidden-size", "32", "--steps", "2", "--batch-size", "2",
            "--seq-len", "16", "--mesh", "--device", "cpu"]
    assert train_umx.main(argv) == 0
    text = capsys.readouterr().out
    assert "mesh: {'dp': 1, 'tp': 1}" in text and f"wrote {out}" in text
