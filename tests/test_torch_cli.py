"""The port's CLI: the 3-argument contract writes four stems, the error
codes hold, a CUDA device without a GPU raises, and the port imports no
jax (checked in a subprocess where importing jax fails)."""

from __future__ import annotations

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from umx_tpu_torch import cli
from umx_tpu_torch.config import ModelConfig
from umx_tpu_torch.io.ggml import write_ggml
from umx_tpu_torch.models.umx import synthetic_state_dicts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 44100
FAST = ["--segment-secs", "1.0", "--device", "cpu", "--quiet"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    model = str(d / "model.bin.gz")
    write_ggml(model, 32, synthetic_state_dicts(ModelConfig(hidden_size=32), seed=0))
    t = np.arange(int(1.7 * SR)) / SR
    mix = np.stack([0.4 * np.sin(2 * np.pi * 220 * t), 0.4 * np.sin(2 * np.pi * 330 * t)])
    wav = str(d / "mix.wav")
    wavfile.write(wav, SR, np.ascontiguousarray(mix.T.astype(np.float32)))
    wav48 = str(d / "mix48.wav")
    wavfile.write(wav48, 48000, np.ascontiguousarray(mix.T.astype(np.float32)))
    return d, model, wav, wav48, mix.astype(np.float32)


def test_cli_writes_four_stems_that_sum_to_the_mix(fixtures):
    d, model, wav, _, mix = fixtures
    out = str(d / "out")
    assert cli.main([model, wav, out, *FAST]) == 0
    stems = []
    for i in range(4):
        rate, data = wavfile.read(os.path.join(out, f"target_{i}.wav"))
        assert rate == SR and data.dtype == np.float32 and data.shape == (mix.shape[1], 2)
        assert np.isfinite(data).all()
        stems.append(data.T)
    total = np.sum(stems, axis=0)
    # Wiener-EM partitions the mix: the stems sum back to it
    corr = np.corrcoef(total.ravel(), mix.ravel())[0, 1]
    assert corr >= 0.99


def test_cli_flags_no_wiener_umxcpp_psd(fixtures):
    d, model, wav, _, _ = fixtures
    for extra in (["--no-wiener", "--no-streaming", "--shifts", "0"],
                  ["--wiener-psd", "umxcpp", "--wiener-iters", "2", "--input-scaling", "umxcpp"]):
        out = str(d / ("out_" + extra[0].strip("-")))
        assert cli.main([model, wav, out, *FAST, *extra]) == 0
        assert sorted(os.listdir(out)) == [f"target_{i}.wav" for i in range(4)]


def test_cli_error_codes(fixtures, capsys):
    d, model, wav, wav48, _ = fixtures
    assert cli.main([model, wav48, str(d / "o48"), *FAST]) == 1
    assert "48000" in capsys.readouterr().err
    notggml = d / "not.bin"
    notggml.write_bytes(b"\x00" * 64)
    assert cli.main([str(notggml), wav, str(d / "ob"), *FAST]) == 1
    assert "bad ggml magic" in capsys.readouterr().err
    assert cli.main([str(d / "missing.bin"), wav, str(d / "om"), *FAST]) == 1
    with pytest.raises(SystemExit) as e:
        cli.main([])
    assert e.value.code == 2


def test_cli_cuda_without_gpu_raises(fixtures):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU error path cannot be reached")
    d, model, wav, _, _ = fixtures
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main([model, wav, str(d / "oc"), "--quiet"])


def test_port_imports_no_jax(fixtures):
    d, model, wav, _, _ = fixtures
    code = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None  # any import of jax now fails
        sys.modules["umx_tpu"] = None
        import torch
        torch.set_num_threads(1)
        from umx_tpu_torch import cli
        rc = cli.main([{model!r}, {wav!r}, {str(d / "nojax")!r}, "--segment-secs", "1.0",
                       "--device", "cpu", "--quiet"])
        loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "umx_tpu")
                  and sys.modules[m] is not None]
        assert not loaded, loaded
        sys.exit(rc)
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert len(os.listdir(d / "nojax")) == 4


BATCHED = ["--no-streaming", "--chunk-batch", "2", "--istft-algo", "ct2", "--shifts", "2"]


def test_cli_batched_whole_track_flags(fixtures):
    # chunk groups of 2, both shift passes as batch rows, the CT iSTFT
    d, model, wav, _, mix = fixtures
    out = str(d / "out_batched")
    assert cli.main([model, wav, out, *FAST, *BATCHED]) == 0
    stems = []
    for i in range(4):
        rate, data = wavfile.read(os.path.join(out, f"target_{i}.wav"))
        assert rate == SR and data.shape == (mix.shape[1], 2) and np.isfinite(data).all()
        stems.append(data.T)
    corr = np.corrcoef(np.sum(stems, axis=0).ravel(), mix.ravel())[0, 1]
    assert corr >= 0.99


def test_cli_rejects_an_unknown_istft_algo(fixtures):
    d, model, wav, _, _ = fixtures
    with pytest.raises(SystemExit) as e:
        cli.main([model, wav, str(d / "obad"), *FAST, "--istft-algo", "ct2_xla"])
    assert e.value.code == 2


def test_batched_path_imports_no_jax(fixtures):
    d, model, wav, _, _ = fixtures
    code = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None
        sys.modules["umx_tpu"] = None
        import torch
        torch.set_num_threads(1)
        from umx_tpu_torch import cli
        rc = cli.main([{model!r}, {wav!r}, {str(d / "nojax_b")!r}, "--segment-secs", "1.0",
                       "--device", "cpu", "--quiet", *{BATCHED!r}])
        loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "umx_tpu")
                  and sys.modules[m] is not None]
        assert not loaded, loaded
        sys.exit(rc)
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert len(os.listdir(d / "nojax_b")) == 4
