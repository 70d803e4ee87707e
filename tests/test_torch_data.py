"""The port's data pipeline and training loop (``umx_tpu_torch.data``)
against ``umx_tpu.data``: the same seed gives bit-equal batches, the loop
runs with a validation split, and the trainer imports without jax."""

from __future__ import annotations

import os
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from umx_tpu.data import AugmentConfig as JAugmentConfig
from umx_tpu.data import StemDataset as JStemDataset
from umx_tpu_torch.config import TARGETS, ModelConfig
from umx_tpu_torch.data import AugmentConfig, StemDataset, train_loop
from umx_tpu_torch.train import TrainConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def stem_root(tmp_path_factory):
    from scipy.io import wavfile

    root = tmp_path_factory.mktemp("stems")
    rng = np.random.default_rng(0)
    for name, n in (("track_a", 30_000), ("track_b", 25_000), ("track_c", 12_000)):
        d = root / name
        d.mkdir()
        for t in TARGETS:
            wavfile.write(str(d / f"{t}.wav"), 44100, rng.uniform(-0.4, 0.4, (n, 2)).astype(np.float32))
    (root / "not_a_track").mkdir()  # a folder missing stems is ignored
    return str(root)


@pytest.mark.parametrize("source_mixing", [True, False])
@pytest.mark.parametrize("excerpt", [8000, 20_000])
def test_sample_is_bit_equal_to_jax(stem_root, source_mixing, excerpt):
    kw = dict(gain_min=0.5, gain_max=1.5, channel_swap_prob=0.5, source_mixing=source_mixing)
    ours = StemDataset(stem_root, excerpt_samples=excerpt, augment=AugmentConfig(**kw), seed=7)
    ref = JStemDataset(stem_root, excerpt_samples=excerpt, augment=JAugmentConfig(**kw), seed=7)
    assert ours.tracks == ref.tracks == ["track_a", "track_b", "track_c"]
    for _ in range(2):  # the second batch continues the same generator
        (m, t), (jm, jt) = ours.sample(3), ref.sample(3)
        assert m.shape == (3, 2, excerpt) and t.shape == (3, 4, 2, excerpt)
        np.testing.assert_array_equal(m, jm)
        np.testing.assert_array_equal(t, jt)


def test_fixed_batches_and_splits_are_bit_equal_to_jax(stem_root):
    for split in ("train", "valid"):
        ours = StemDataset(stem_root, excerpt_samples=9000, split=split, n_valid_tracks=1)
        ref = JStemDataset(stem_root, excerpt_samples=9000, split=split, n_valid_tracks=1)
        assert ours.tracks == ref.tracks
        got, want = list(ours.fixed_batches(2, 3)), list(ref.fixed_batches(2, 3))
        assert len(got) == len(want) == 3
        for (m, t), (jm, jt) in zip(got, want):
            np.testing.assert_array_equal(m, jm)
            np.testing.assert_array_equal(t, jt)
    with pytest.raises(ValueError, match="split"):
        StemDataset(stem_root, excerpt_samples=100, split="bogus")


def test_train_loop_runs_with_validation_split(stem_root, tmp_path):
    mcfg = ModelConfig(hidden_size=32)
    tcfg = TrainConfig(seq_len=8, learning_rate=2e-3)
    train = StemDataset(stem_root, excerpt_samples=1024 * 7, split="train", seed=4)
    valid = StemDataset(stem_root, excerpt_samples=1024 * 7, split="valid", seed=4)
    state, hist = train_loop(
        train, mcfg, tcfg, steps=3, batch_size=2, log_every=0, device="cpu",
        checkpoint_dir=str(tmp_path), valid_dataset=valid, valid_every=1, valid_batches=1,
    )
    assert state.step == 3 and len(hist) == 3 and np.isfinite(hist).all()
    assert [s for s, _ in hist.valid] == [1, 2, 3]
    assert all(np.isfinite(v) for _, v in hist.valid)
    assert hist.best_valid == min(v for _, v in hist.valid)
    assert [lr for _, lr in hist.lrs] == [2e-3] * 3
    assert (tmp_path / "best.pt").is_file() and (tmp_path / "step_3.pt").is_file()


def test_train_loop_early_stops_on_a_flat_validation_loss(stem_root):
    """With lr = 0 the validation loss is constant: the first round sets the
    best and early stopping fires at the third (bad 2 > patience 1)."""
    mcfg = ModelConfig(hidden_size=32)
    tcfg = TrainConfig(seq_len=8, learning_rate=0.0, early_stop_patience=1,
                       lr_decay_patience=1000)
    train = StemDataset(stem_root, excerpt_samples=1024 * 7, split="train", seed=4)
    valid = StemDataset(stem_root, excerpt_samples=1024 * 7, split="valid", seed=4)
    _, hist = train_loop(train, mcfg, tcfg, steps=20, batch_size=2, log_every=0,
                         valid_dataset=valid, valid_every=2, valid_batches=1, device="cpu")
    assert hist.stopped_early and len(hist) == 6 and len(hist.valid) == 3
    assert hist.best_step == 2


def test_trainer_imports_without_jax():
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None  # any import of jax now fails
        sys.modules["umx_tpu"] = None
        import umx_tpu_torch.data, umx_tpu_torch.train
        from umx_tpu_torch.config import ModelConfig
        from umx_tpu_torch.models.umx import synthetic_params
        state = umx_tpu_torch.train.init_train_state(
            synthetic_params(ModelConfig(hidden_size=16)), umx_tpu_torch.train.TrainConfig())
        loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "umx_tpu")
                  and sys.modules[m] is not None]
        assert not loaded, loaded
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]


NUMBER = re.compile(r"\d+\.\d+(?:e[-+]\d+)?")


@pytest.mark.parametrize("valid", [False, True])
def test_train_loop_prints_the_jax_progress_lines(stem_root, capsys, monkeypatch, valid):
    """With ``UMX_TPU_LOG`` unset both loops print ``step N/M loss ...`` at
    info level on stderr (and, with a flat validation loss, the early-stop
    line): after the timestamp the same words, and the same losses within
    ``rtol``.  The JAX trainer runs its float32 scan on the CPU, the port
    the plain version of its kernels (bf16 recurrence operands): a step's
    loss agrees to 5e-6 (measured).  The learning rate is 0 so that the
    lines compare the same weights: with lr > 0 AdamW's first steps (about
    lr * sign(g)) carry each side's gradient differences into the next
    losses (1.5e-4 apart after 6 steps at lr 1e-4, measured), which
    ``tests/test_torch_train.py`` covers from identical gradients."""
    rtol = 2e-5
    from umx_tpu.config import ModelConfig as JModelConfig
    from umx_tpu.data import train_loop as jtrain_loop
    from umx_tpu.train import TrainConfig as JTrainConfig

    monkeypatch.delenv("UMX_TPU_LOG", raising=False)
    kw = dict(seq_len=8, learning_rate=0.0, early_stop_patience=1, lr_decay_patience=1000)
    runs = {}
    for name, loop, mcfg, tcfg, ds, extra in (
        ("ours", train_loop, ModelConfig(hidden_size=32), TrainConfig(**kw), StemDataset,
         {"device": "cpu"}),
        ("jax", jtrain_loop, JModelConfig(hidden_size=32), JTrainConfig(**kw), JStemDataset, {}),
    ):
        train = ds(stem_root, excerpt_samples=1024 * 7, split="train" if valid else "all", seed=4)
        vkw = {}
        if valid:
            vkw = dict(valid_dataset=ds(stem_root, excerpt_samples=1024 * 7, split="valid",
                                        seed=4), valid_every=2, valid_batches=1)
        capsys.readouterr()
        loop(train, mcfg, tcfg, steps=8, batch_size=2, log_every=2, **vkw, **extra)
        err = capsys.readouterr().err.splitlines()
        runs[name] = [re.sub(r"^\[ *\d+\.\d\ds\] ", "", ln) for ln in err
                      if re.match(r"^\[ *\d+\.\d\ds\] info: step", ln)]
    # 4 step lines; with a flat validation loss, early stop at step 6
    want_text = (["info: step 2/8 loss #", "info: step 4/8 loss #",
                  "info: step 6/8 loss #", "info: step 6: early stop (best #)"] if valid
                 else [f"info: step {i}/8 loss #" for i in (2, 4, 6, 8)])
    for name in ("jax", "ours"):
        assert [NUMBER.sub("#", ln) for ln in runs[name]] == want_text, (name, runs[name])
    for ours, theirs in zip(runs["ours"], runs["jax"]):
        a, b = float(NUMBER.findall(ours)[-1]), float(NUMBER.findall(theirs)[-1])
        assert abs(a - b) <= rtol * abs(b), (ours, theirs)
