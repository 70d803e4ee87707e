"""The port's CLIs: the 3-argument contract writes four stems, the error
codes hold, a CUDA device without a GPU raises, the catalogue flags
(quantized weights, windows, the per-target recurrence) give the
``Separator``'s stems, ``cli_batch`` demixes a directory, and the port
imports no jax (checked in a subprocess where importing jax fails)."""

from __future__ import annotations

import dataclasses
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
        import importlib, pkgutil
        import torch
        torch.set_num_threads(1)
        import umx_tpu_torch
        # every module of the port, the evaluation, utilities, parallel
        # and script modules included
        names = [m.name for m in pkgutil.walk_packages(umx_tpu_torch.__path__, "umx_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        for name in ("eval.bss", "models.registry", "utils.logging", "utils.profiling",
                     "parallel.multihost", "scripts.train_umx", "scripts.evaluate_musdb",
                     "scripts.evaluate_demixed_output", "scripts.profile_train_stream"):
            assert "umx_tpu_torch." + name in names, name
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


def _read_stems(out_dir, n):
    stems = []
    for i in range(4):
        rate, data = wavfile.read(os.path.join(out_dir, f"target_{i}.wav"))
        assert rate == SR and data.dtype == np.float32 and data.shape == (n, 2)
        assert np.isfinite(data).all()
        stems.append(data.T)
    return np.stack(stems)


def test_cli_catalogue_flags_equal_the_separator_api(fixtures):
    """--quantized-hbm --window-chunks 2 --lstm-impl pallas: the stems the
    CLI writes are the ones the Separator gives with that config."""
    from umx_tpu_torch.config import EngineConfig, SegmentConfig
    from umx_tpu_torch.engine.separator import Separator

    d, model, wav, _, mix = fixtures
    out = str(d / "out_catalogue")
    assert cli.main([model, wav, out, *FAST, "--quantized-hbm", "--window-chunks", "2",
                     "--lstm-impl", "pallas"]) == 0
    stems = _read_stems(out, mix.shape[1])
    cfg = EngineConfig(model=ModelConfig(hidden_size=32, lstm_impl="pallas"),
                       segment=SegmentConfig(segment_secs=1.0, window_chunks=2))
    assert cli.engine_config_from_args(cli.build_parser().parse_args(
        [model, wav, out, *FAST, "--window-chunks", "2", "--lstm-impl", "pallas"])) == \
        dataclasses.replace(cfg, model=ModelConfig(lstm_impl="pallas"))
    sep = Separator.from_ggml(model, cfg, "cpu", quantized_hbm=True)
    assert sep._geometry(mix.shape[1] + 22050)[2] == 3  # 3 chunks: two windows of 2
    assert np.array_equal(stems, sep.demix_track(mix, seed=0))
    corr = np.corrcoef(stems.sum(axis=0).ravel(), mix.ravel())[0, 1]
    assert corr >= 0.99


def test_cli_rejects_an_unknown_lstm_impl(fixtures):
    d, model, wav, _, _ = fixtures
    with pytest.raises(SystemExit) as e:
        cli.main([model, wav, str(d / "obad2"), *FAST, "--lstm-impl", "cudnn"])
    assert e.value.code == 2


def test_cli_lstm_impl_scan_writes_four_stems(fixtures):
    """--lstm-impl scan (the float32 recurrence) runs on the CPU and
    writes four stems that sum to the mix, the Separator's with that
    config."""
    from umx_tpu_torch.config import EngineConfig, SegmentConfig
    from umx_tpu_torch.engine.separator import Separator

    d, model, wav, _, mix = fixtures
    out = str(d / "out_scan")
    assert cli.main([model, wav, out, *FAST, "--lstm-impl", "scan"]) == 0
    stems = _read_stems(out, mix.shape[1])
    corr = np.corrcoef(stems.sum(axis=0).ravel(), mix.ravel())[0, 1]
    assert corr >= 0.99
    cfg = EngineConfig(model=ModelConfig(hidden_size=32, lstm_impl="scan"),
                       segment=SegmentConfig(segment_secs=1.0))
    assert np.array_equal(stems, Separator.from_ggml(model, cfg, "cpu").demix_track(mix, seed=0))


@pytest.fixture(scope="module")
def catalogue(fixtures):
    """Two flat WAVs of different lengths and one MUSDB-style folder."""
    d, _, _, _, mix = fixtures
    root = d / "catalogue"
    (root / "song_c").mkdir(parents=True)
    tracks = {"song_a": mix, "song_b": mix[:, : int(0.8 * SR)], "song_c": 0.5 * mix[:, ::-1]}
    for name, audio in tracks.items():
        path = root / "song_c" / "mixture.wav" if name == "song_c" else root / f"{name}.wav"
        wavfile.write(str(path), SR, np.ascontiguousarray(audio.T))
    (root / "notes.txt").write_text("not a track")
    return str(root), tracks


@pytest.mark.parametrize("extra", [[], ["--quantized-hbm", "--shifts", "2"], ["--no-wiener"]])
def test_cli_batch_writes_every_tracks_stems(fixtures, catalogue, extra):
    from umx_tpu_torch import cli_batch
    from umx_tpu_torch.engine.separator import Separator

    d, model, _, _, _ = fixtures
    root, tracks = catalogue
    out_root = str(d / ("batch_" + "_".join(x.strip("-") for x in extra)))
    assert cli_batch.main([model, root, out_root, *FAST, *extra]) == 0
    assert sorted(os.listdir(out_root)) == sorted(tracks)
    args = cli_batch.build_parser().parse_args([model, root, out_root, *FAST, *extra])
    sep = Separator.from_ggml(model, cli.engine_config_from_args(args), "cpu",
                              quantized_hbm=args.quantized_hbm)
    for name, audio in tracks.items():
        stems = _read_stems(os.path.join(out_root, name), audio.shape[1])
        ref = sep.demix_track(audio, seed=0)
        # batched rows meet other matmul widths than a track alone; with
        # quantized weights such a last-bit difference flips bf16 roundings
        # of activations (2.5e-5 of max|stem| measured), hence 1e-3 there
        tol = 1e-3 if args.quantized_hbm else 1e-5
        np.testing.assert_allclose(stems, ref, rtol=0, atol=tol * np.abs(ref).max())
        if "--no-wiener" not in extra:
            assert np.corrcoef(stems.sum(axis=0).ravel(), audio.ravel())[0, 1] >= 0.99


def test_cli_batch_logs_its_mesh(fixtures, catalogue, capsys):
    # the JAX batch CLI's line, over the one device --device names
    from umx_tpu_torch import cli_batch

    d, model, _, _, _ = fixtures
    root, tracks = catalogue
    argv = [model, root, str(d / "batch_mesh"), "--segment-secs", "1.0", "--device", "cpu"]
    assert cli_batch.main(argv) == 0
    lines = [x for x in capsys.readouterr().out.splitlines() if x.startswith("mesh:")]
    assert lines == ["mesh: {'dp': 1, 'tp': 1} over 1 device(s)"]
    assert sorted(os.listdir(d / "batch_mesh")) == sorted(tracks)


def test_cli_batch_errors(fixtures, tmp_path):
    from umx_tpu_torch import cli_batch

    d, model, _, _, _ = fixtures
    assert cli_batch.main([model, str(tmp_path), str(tmp_path / "o"), *FAST]) == 1  # no WAVs
    with pytest.raises(SystemExit) as e:
        cli_batch.main([model])
    assert e.value.code == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            cli_batch.main([model, str(tmp_path), str(tmp_path / "o"), "--quiet"])


def test_cli_batch_imports_no_jax(fixtures, catalogue):
    d, model, _, _, _ = fixtures
    root, tracks = catalogue
    code = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None
        sys.modules["umx_tpu"] = None
        import torch
        torch.set_num_threads(1)
        from umx_tpu_torch import cli_batch
        rc = cli_batch.main([{model!r}, {root!r}, {str(d / "nojax_batch")!r}, "--segment-secs",
                             "1.0", "--device", "cpu", "--quiet", "--quantized-hbm"])
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
    assert sorted(os.listdir(d / "nojax_batch")) == sorted(tracks)


def test_cli_host_loop_prints_progress_and_equals_the_fused_run(fixtures, capsys):
    d, model, wav, _, mix = fixtures
    fused_out, loop_out = str(d / "out_fused"), str(d / "out_host_loop")
    assert cli.main([model, wav, fused_out, *FAST]) == 0
    capsys.readouterr()
    assert cli.main([model, wav, loop_out, "--segment-secs", "1.0", "--device", "cpu",
                     "--host-loop"]) == 0
    lines = [ln.strip() for ln in capsys.readouterr().out.splitlines() if "demix" in ln
             and "%" in ln]
    # 1.7 s + the 0.5 s shift pad at a 0.75 s stride: 3 chunks
    assert lines == ["demix 33%", "demix 67%", "demix 100%"]
    fused = _read_stems(fused_out, mix.shape[1])
    loop = _read_stems(loop_out, mix.shape[1])
    err = float(np.max(np.abs(loop - fused)) / np.max(np.abs(fused)))
    assert err <= 2e-4, f"max|Δ|/max|stem| = {err:.3g}"
    # --quiet silences the progress too
    assert cli.main([model, wav, loop_out, *FAST, "--host-loop"]) == 0
    assert "demix" not in capsys.readouterr().out


def test_cli_resample_demixes_a_48k_wav(fixtures):
    d, model, _, wav48, mix = fixtures
    out = str(d / "out_48k")
    assert cli.main([model, wav48, out, *FAST, "--resample"]) == 0
    n = -(-mix.shape[1] * 44100 // 48000)
    stems = _read_stems(out, n)
    assert stems.shape == (4, 2, n)


def _timings_table(out: str) -> tuple[str, list[str]]:
    """The header and the stage names of a ``--timings`` table."""
    lines = out.strip().splitlines()
    i = next(k for k, ln in enumerate(lines) if ln.split()[:1] == ["stage"])
    return lines[i], [ln.split()[0] for ln in lines[i + 1 :]]


def test_cli_timings_print_the_jax_stage_table(fixtures, capsys, monkeypatch):
    """``--timings`` prints ``StageTimer.report()``: the JAX CLI's header and
    stage names.  The JAX CLI runs with a stand-in separator (its table,
    not its demix, is what is compared)."""
    import umx_tpu.engine.separator as jsep
    from umx_tpu import cli as jcli

    d, model, wav, _, mix = fixtures
    assert cli.main([model, wav, str(d / "out_timings"), *FAST, "--timings"]) == 0
    header, names = _timings_table(capsys.readouterr().out)

    class StandIn:
        def __init__(self, cfg):
            self.cfg = cfg

        @classmethod
        def from_ggml(cls, path, cfg, quantized_hbm=False):
            return cls(cfg)

        def demix_track(self, audio, seed=0, progress=None, fused=True):
            return np.zeros((4, *audio.shape), np.float32)

    monkeypatch.setattr(jsep, "Separator", StandIn)
    assert jcli.main([model, wav, str(d / "out_timings_jax"), "--quiet", "--timings"]) == 0
    jheader, jnames = _timings_table(capsys.readouterr().out)
    assert header == jheader
    assert sorted(names) == sorted(jnames) == ["demix", "load_audio", "load_model",
                                              "write_stems"]
