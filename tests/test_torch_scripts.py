"""The port's script modules (``umx_tpu_torch.scripts``) against the
repository's scripts that drive the JAX package (``scripts/*.py``, loaded
with importlib): the same flags (but ``--mesh``, not ported, and
``--device``), the same evaluation results on the same directories, a
trained model both packages read, and no GPU taken for granted."""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from umx_tpu_torch.config import TARGETS, ModelConfig
from umx_tpu_torch.io.ggml import write_ggml
from umx_tpu_torch.models.umx import synthetic_state_dicts
from umx_tpu_torch.scripts import (
    evaluate_demixed_output,
    evaluate_musdb,
    profile_train_stream,
    train_umx,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 44100
PORTED = {
    "train-umx.py": train_umx,
    "evaluate-musdb.py": evaluate_musdb,
    "evaluate-demixed-output.py": evaluate_demixed_output,
    "profile-train-stream.py": profile_train_stream,
}


def _jax_script(name: str):
    path = os.path.join(REPO, "scripts", name)
    spec = importlib.util.spec_from_file_location("jax_" + name[:-3].replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _band_noise(rng, n, lo, hi):
    x = rng.standard_normal((2, n))
    spec = np.fft.rfft(x, axis=-1)
    f = np.fft.rfftfreq(n, 1 / SR)
    spec[:, (f < lo) | (f >= hi)] = 0
    y = np.fft.irfft(spec, n, axis=-1)
    return (y / (np.abs(y).max() + 1e-9) * 0.5).astype(np.float32)


@pytest.fixture(scope="module")
def musdb(tmp_path_factory):
    """Two MUSDB-style track folders of 3 s (band-limited stems, their sum
    as mixture.wav), a hidden-64 ggml model, and an estimates directory
    for the first track (its stems plus noise and a leak of the next)."""
    d = tmp_path_factory.mktemp("musdb")
    rng = np.random.default_rng(31)
    n = 3 * SR
    bands = [(40, 300), (300, 1200), (1200, 4000), (4000, 12000)]
    root = d / "test"
    for k in range(2):
        t = root / f"track_{k}"
        t.mkdir(parents=True)
        stems = [_band_noise(rng, n, lo, hi) for lo, hi in bands]
        for name, s in zip(TARGETS, stems):
            wavfile.write(str(t / f"{name}.wav"), SR, np.ascontiguousarray(s.T))
        wavfile.write(str(t / "mixture.wav"), SR, np.ascontiguousarray(np.sum(stems, 0).T))
        if k == 0:
            est = d / "est"
            est.mkdir()
            for i, s in enumerate(stems):
                e = s + 0.2 * stems[(i + 1) % 4] + 0.02 * rng.standard_normal(s.shape)
                wavfile.write(str(est / f"target_{i}.wav"), SR,
                              np.ascontiguousarray(e.astype(np.float32).T))
    model = str(d / "model.bin.gz")
    write_ggml(model, 64, synthetic_state_dicts(ModelConfig(hidden_size=64), seed=0))
    return d, root, model


def _flags(parser: argparse.ArgumentParser) -> set[str]:
    return {s for a in parser._actions for s in a.option_strings} | {
        a.dest for a in parser._actions if not a.option_strings}


class _Parsed(Exception):
    pass


def _jax_parser(mod, monkeypatch) -> argparse.ArgumentParser:
    """The parser a JAX script's ``main`` builds (caught at ``parse_args``)."""
    seen = []

    def capture(self, *a, **k):
        seen.append(self)
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(_Parsed):
        mod.main([]) if mod.main.__code__.co_argcount else mod.main()
    monkeypatch.undo()
    return seen[0]


@pytest.mark.parametrize("script", sorted(PORTED))
def test_flags_equal_the_jax_scripts(script, monkeypatch):
    ours = _flags(PORTED[script].build_parser())
    theirs = _flags(_jax_parser(_jax_script(script), monkeypatch))
    assert ours - {"--device"} == theirs - {"--mesh"}
    assert "--device" in ours


@pytest.mark.parametrize("script", sorted(PORTED))
def test_scripts_take_the_gpu_unless_told_otherwise(script, musdb, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU error path cannot be reached")
    d, root, model = musdb
    argv = {
        "train-umx.py": [str(root), str(tmp_path / "m.bin"), "--steps", "1"],
        "evaluate-musdb.py": [model, str(root)],
        "evaluate-demixed-output.py": [str(d / "est"), str(root / "track_0")],
        "profile-train-stream.py": ["--steps", "1"],
    }[script]
    with pytest.raises(RuntimeError, match="cuda"):
        PORTED[script].main(argv)


def test_train_umx_exports_a_model_both_packages_read(musdb, tmp_path, capsys):
    from umx_tpu.io.ggml import read_ggml as jread_ggml
    from umx_tpu_torch.config import EngineConfig, SegmentConfig
    from umx_tpu_torch.engine.separator import Separator
    from umx_tpu_torch.io.ggml import read_ggml

    _, root, _ = musdb
    out = str(tmp_path / "trained.bin.gz")
    assert train_umx.main([str(root), out, "--hidden-size", "32", "--steps", "4",
                           "--batch-size", "2", "--seq-len", "8", "--valid-tracks", "1",
                           "--valid-every", "2", "--device", "cpu"]) == 0
    printed = capsys.readouterr().out
    assert "1 training / 1 validation tracks" in printed and "best valid" in printed
    ours, theirs = read_ggml(out), jread_ggml(out)
    assert ours.hidden_size == theirs.hidden_size == 32
    assert sorted(ours.targets) == sorted(theirs.targets)
    for target, tensors in ours.targets.items():
        assert sorted(tensors) == sorted(theirs.targets[target])
        for k, v in tensors.items():
            np.testing.assert_array_equal(v, theirs.targets[target][k], err_msg=k)
    sep = Separator.from_ggml(out, EngineConfig(segment=SegmentConfig(segment_secs=1.0)), "cpu")
    mix = wavfile.read(str(root / "track_0" / "mixture.wav"))[1].T
    stems = sep.demix_track(mix)
    assert stems.shape == (4, *mix.shape) and np.isfinite(stems).all()


def _run_json(main, argv, path):
    assert main([*argv, "--json", str(path)]) == 0
    return json.loads(path.read_text())


def test_evaluate_demixed_output_equals_the_jax_script(musdb, tmp_path, capsys):
    d, root, _ = musdb
    jax_script = _jax_script("evaluate-demixed-output.py")
    args = [str(d / "est"), str(root / "track_0"), "--flen", "64"]
    # v4: the same float64 host code, so the same JSON within 1e-9 dB and
    # the same printed table
    ours = _run_json(evaluate_demixed_output.main, [*args, "--device", "cpu"], tmp_path / "a")
    table = capsys.readouterr().out.splitlines()[:5]
    theirs = _run_json(jax_script.main, args, tmp_path / "b")
    assert table == capsys.readouterr().out.splitlines()[:5]
    assert sorted(ours) == sorted(theirs) == sorted(TARGETS)
    for t in TARGETS:
        assert sorted(ours[t]) == ["ISR", "SAR", "SDR", "SIR"]
        for m, v in ours[t].items():
            assert abs(v - theirs[t][m]) <= 1e-9, (t, m, v, theirs[t][m])
    # v3: the port's float32 torch solves (on the CPU here) against the JAX
    # script's float64 host solves (its "auto" on a CPU backend): the
    # bounds of the batched solve in tests/test_bss.py.  The Grams of
    # band-limited stems are near-singular, so the float32 factorization
    # may fail on a window, which is then re-solved in float64 and counted
    ours = _run_json(evaluate_demixed_output.main,
                     [*args, "--mode", "v3", "--device", "cpu"], tmp_path / "c")
    counted = re.findall(r"^# (\d+) windows re-solved in float64$",
                         capsys.readouterr().out, re.M)
    assert len(counted) == 1 and 0 <= int(counted[0]) <= 3, counted
    theirs = _run_json(jax_script.main, [*args, "--mode", "v3"], tmp_path / "d")
    for t in TARGETS:
        assert abs(ours[t]["SDR"] - theirs[t]["SDR"]) <= 0.1, t
        assert abs(ours[t]["SIR"] - theirs[t]["SIR"]) <= 0.3, t


# the port's plain recurrence (bf16 operands) against the JAX script's
# float32 scan on the CPU: the medians measured at most 0.0020 dB apart
MUSDB_TOL = 0.02


def test_evaluate_musdb_matches_the_jax_script(musdb, tmp_path, capsys):
    _, root, model = musdb
    args = [model, str(root), "--segment-secs", "1.0", "--flen", "64"]
    assert evaluate_musdb.main([*args, "--out", str(tmp_path / "a.json"),
                                "--device", "cpu"]) == 0
    printed = capsys.readouterr().out
    rows = [json.loads(ln) for ln in printed.splitlines() if ln.startswith("{")]
    assert [r["track"] for r in rows] == ["track_0", "track_1"]
    assert all(set(r) == {"track", "demix_s", "bss_s", "sdr", "isr", "sir", "sar"} for r in rows)
    assert "| metric | bass | drums | other | vocals |" in printed
    assert _jax_script("evaluate-musdb.py").main([*args, "--out", str(tmp_path / "b.json")]) == 0
    ours = json.loads((tmp_path / "a.json").read_text())
    theirs = json.loads((tmp_path / "b.json").read_text())
    assert [r["track"] for r in ours["tracks"]] == [r["track"] for r in theirs["tracks"]]
    worst = 0.0
    for m in ("sdr", "isr", "sir", "sar"):
        for t in TARGETS:
            a, b = ours["median"][m][t], theirs["median"][m][t]
            assert np.isfinite(a), (m, t)
            worst = max(worst, abs(a - b))
    print(f"evaluate_musdb port vs JAX: worst median difference {worst:.4f} dB")
    assert worst <= MUSDB_TOL, worst


def test_profile_train_stream_runs_on_the_cpu(capsys):
    res = profile_train_stream.main(["--device", "cpu", "--hidden", "32", "--steps", "2",
                                     "--batch", "1", "--seq-len", "8", "--stream-secs", "3",
                                     "--segment-secs", "1.0"])
    out = capsys.readouterr().out
    assert "train[h=32 B=1 T=8 impl=auto]" in out and "MFU not measured (cpu)" in out
    assert "stream[seg=1s, 1s pushes]" in out
    assert res["device"] == "cpu" and res["train_steps_per_s"] > 0
    assert np.isfinite(res["train_losses"]).all()
    assert np.isfinite(res["boundary_push_p50_ms"])
