"""The port's parity and certification tools (``umx_tpu_torch.eval.oracle``
and ``umx_tpu_torch.scripts.{parity_fullscale, umx_golden_inference,
convert_umx_pth_to_ggml, compare_torch_stft, e2e_test, fleet_certify,
serve_bench, longtrack_probe}``) against the test helpers and the
repository's scripts that drive the JAX package (loaded with importlib):
the oracle copy bit-equal to ``tests/torch_oracle.py`` and
``tests/test_wiener.py``, the same flags, the same converted bytes and
golden stems, the parity harness's gates at a small width, and every tool
run on the CPU when asked and raising without a GPU otherwise."""

from __future__ import annotations

import argparse
import gzip
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from torch_script_helpers import REPO, flags, jax_parser, jax_script
from umx_tpu_torch.config import EngineConfig, ModelConfig, SegmentConfig
from umx_tpu_torch.eval import oracle
from umx_tpu_torch.io.ggml import write_ggml
from umx_tpu_torch.models.umx import synthetic_state_dicts
from umx_tpu_torch.scripts import (
    compare_torch_stft,
    convert_umx_pth_to_ggml,
    e2e_test,
    fleet_certify,
    longtrack_probe,
    parity_fullscale,
    serve_bench,
    umx_golden_inference,
)

SR = 44100
PORTED = {
    "parity-fullscale.py": parity_fullscale,
    "umx-golden-inference.py": umx_golden_inference,
    "convert-umx-pth-to-ggml.py": convert_umx_pth_to_ggml,
    "compare-torch-stft.py": compare_torch_stft,
    "e2e_test.py": e2e_test,
    "fleet-certify.py": fleet_certify,
    "serve-bench.py": serve_bench,
    "longtrack-probe.py": longtrack_probe,
}
# the JAX scripts that take no flags at all
NO_FLAGS = {"compare-torch-stft.py", "longtrack-probe.py"}
BOUND_DB = 32.7  # 0.1 dB of SDR by PARITY.md's formula
H = 32


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU error path cannot be reached")


# ---- the oracle copy --------------------------------------------------------


@pytest.fixture(scope="module")
def sds():
    return synthetic_state_dicts(ModelConfig(hidden_size=H), seed=3)


def _x(seed: int, T: int = 23):
    return np.abs(np.random.default_rng(seed).standard_normal((T, 2 * 1487))).astype(np.float32)


@pytest.mark.parametrize("scaling", ["openunmix", "umxcpp"])
def test_oracle_masks_bit_equal_to_the_test_helper(sds, scaling):
    import torch_oracle

    x = _x(1)
    np.testing.assert_array_equal(oracle.oracle_masks(sds, x, H, scaling),
                                  torch_oracle.oracle_masks(sds, x, H, scaling))


def test_oracle_stream_form_bit_equal_with_its_carried_state(sds):
    import torch_oracle

    xs = [_x(2), _x(3, T=17)]
    ours, theirs = oracle.oracle_masks_stream(sds, xs, H), torch_oracle.oracle_masks_stream(sds, xs, H)
    assert len(ours) == len(theirs) == 2
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    # the state each form carries out of a segment
    m_ours, m_theirs = oracle.TorchUMX(H), torch_oracle.TorchUMX(H)
    m_ours.load_target_state_dict(sds["drums"])
    m_theirs.load_target_state_dict(sds["drums"])
    _, (h1, c1) = m_ours.forward(torch.from_numpy(xs[0]), state=None, return_state=True)
    _, (h2, c2) = m_theirs.forward(torch.from_numpy(xs[0]), state=None, return_state=True)
    assert torch.equal(h1, h2) and torch.equal(c1, c2) and h1.shape == (6, 1, H // 2)
    mask1 = m_ours.forward(torch.from_numpy(xs[1]), state=(h1, c1))
    mask2 = m_theirs.forward(torch.from_numpy(xs[1]), state=(h2, c2))
    assert torch.equal(mask1, mask2)


@pytest.mark.parametrize("psd", ["correct", "umxcpp"])
@pytest.mark.parametrize("iterations", [1, 2])
def test_numpy_wiener_oracle_bit_equal_to_the_test_helper(iterations, psd):
    from test_wiener import numpy_wiener_oracle

    rng = np.random.default_rng(21 + iterations)
    T, F = 9, 33
    mix = (rng.standard_normal((2, T, F)) + 1j * rng.standard_normal((2, T, F))).astype(np.complex64)
    mags = np.abs(rng.standard_normal((4, 2, T, F))).astype(np.float32)
    ours = oracle.numpy_wiener_oracle(mix, mags, iterations, psd=psd)
    theirs = numpy_wiener_oracle(mix, mags, iterations, psd=psd)
    assert ours.dtype == np.complex64
    np.testing.assert_array_equal(ours, theirs)


def test_oracle_shares_no_compute_code_with_the_port():
    src = open(oracle.__file__).read()
    imports = re.findall(r"^\s*(?:from|import) (\S+)", src, re.M)
    assert sorted(set(imports)) == ["__future__", "numpy", "torch", "torch.nn",
                                    "umx_tpu_torch.config"]


# ---- flags, and the GPU by default -----------------------------------------


@pytest.mark.parametrize("script", sorted(PORTED))
def test_flags_equal_the_jax_scripts(script, monkeypatch):
    ours = flags(PORTED[script].build_parser())
    theirs = ({"-h", "--help"} if script in NO_FLAGS
              else flags(jax_parser(jax_script(script), monkeypatch)))
    if script in ("umx-golden-inference.py", "convert-umx-pth-to-ggml.py"):
        # host code (the golden reference runs on the host CPU, as the JAX
        # script's): no device to pick
        assert ours == theirs
    else:
        assert ours - {"--device"} == theirs and "--device" in ours


@pytest.mark.parametrize("script", ["parity-fullscale.py", "compare-torch-stft.py",
                                    "e2e_test.py", "fleet-certify.py", "serve-bench.py",
                                    "longtrack-probe.py"])
def test_tools_take_the_gpu_unless_told_otherwise(script):
    _no_gpu()
    argv = {"parity-fullscale.py": ["--hidden", str(H), "--seg-secs", "1.0"],
            "fleet-certify.py": ["--quick"],
            "serve-bench.py": ["--hidden-size", str(H), "--track-secs", "1"]}.get(script, [])
    with pytest.raises(RuntimeError, match="cuda"):
        PORTED[script].main(argv)


# ---- the parity harness ----------------------------------------------------


@pytest.fixture(scope="module")
def parity_rows(tmp_path_factory):
    out = tmp_path_factory.mktemp("parity") / "rows.json"
    assert parity_fullscale.main(["--hidden", str(H), "--seg-secs", "1.0", "--device", "cpu",
                                  "--out", str(out)]) == 0
    return {r["variant"]: r for r in json.loads(out.read_text())}


@pytest.fixture(scope="module")
def jax_qhbm_row():
    """The JAX harness's qhbm row at the same width and segment (its own
    compile-cache settings restored afterwards)."""
    import contextlib
    import io

    import jax

    mod = jax_script("parity-fullscale.py")
    keep = {k: getattr(jax.config, k) for k in ("jax_compilation_cache_dir",
                                                 "jax_persistent_cache_min_compile_time_secs")}
    argv, buf = sys.argv, io.StringIO()
    sys.argv = ["parity-fullscale.py", "--hidden", str(H), "--seg-secs", "1.0",
                "--variants", "qhbm"]
    try:
        with contextlib.redirect_stdout(buf):
            assert mod.main() == 0
    finally:
        sys.argv = argv
        for k, v in keep.items():
            jax.config.update(k, v)
    return json.loads(buf.getvalue().splitlines()[0])


def test_parity_runs_every_port_variant_by_default(parity_rows):
    assert parity_fullscale.build_parser().parse_args([]).variants.split(",") == list(
        parity_fullscale.PORT_VARIANTS)
    assert list(parity_rows) == list(parity_fullscale.PORT_VARIANTS)
    for r in parity_rows.values():
        assert r["backend"] == "cpu" and r["device_name"] == "cpu" and r["hidden"] == H


@pytest.mark.parametrize("variant", [v for v in parity_fullscale.PORT_VARIANTS if v != "qhbm"])
def test_parity_dense_rows_inside_the_envelope(parity_rows, variant):
    r = parity_rows[variant]
    assert r["waveform_err_db"] >= BOUND_DB, r
    assert min(r["per_stem_err_db"]) >= BOUND_DB, r


def test_parity_pallas_is_the_fp32_program(parity_rows):
    a, b = parity_rows["fp32"], parity_rows["pallas"]
    assert a["waveform_max_abs_err"] == b["waveform_max_abs_err"]


def test_parity_wiener_out_dtype_rows(parity_rows):
    """wiener_f32 is the fp32 program; wiener_bf16 rounds the Wiener
    output planes, so its error moves, inside the envelope."""
    fp32 = parity_rows["fp32"]
    assert parity_rows["wiener_f32"]["waveform_max_abs_err"] == fp32["waveform_max_abs_err"]
    assert parity_rows["wiener_bf16"]["waveform_max_abs_err"] != fp32["waveform_max_abs_err"]


def test_parity_auto_row_is_the_fp32_program_on_the_cpu(parity_rows):
    """fp32 pins the three storage seams to float32; auto runs the
    defaults, which resolve to float32 on the CPU (bfloat16 on the card),
    so on the CPU the two rows are one program."""
    a, b = parity_rows["auto"], parity_rows["fp32"]
    assert a["waveform_max_abs_err"] == b["waveform_max_abs_err"]
    assert a["per_stem_err_db"] == b["per_stem_err_db"]


def test_parity_quantized_row_beside_the_jax_harness(parity_rows, jax_qhbm_row):
    """The quantized path rounds activations to bf16 before every product,
    so its error against the float32 oracle is the quantization's, not the
    implementation's: held to the JAX harness's row at the same shape,
    within 3 dB whole and per stem (the card's rule against the TPU row)."""
    ours, theirs = parity_rows["qhbm"], jax_qhbm_row
    assert theirs["variant"] == "qhbm" and theirs["hidden"] == H
    assert ours["waveform_err_db"] >= theirs["waveform_err_db"] - 3.0, (ours, theirs)
    for a, b in zip(ours["per_stem_err_db"], theirs["per_stem_err_db"]):
        assert a >= b - 3.0, (ours, theirs)


def test_parity_rows_have_the_jax_keys_and_numbers():
    import jax

    mod = jax_script("parity-fullscale.py")
    rng = np.random.default_rng(5)
    ref = rng.standard_normal((4, 2, 300)).astype(np.float32)
    waves = ref + 1e-3 * rng.standard_normal(ref.shape).astype(np.float32)
    args = argparse.Namespace(seg_secs=1.0, hidden=H)
    theirs = mod._err_row("fp32", waves, ref, args, jax, np)
    ours = parity_fullscale.err_row("fp32", waves, ref, 1.0, H, torch.device("cpu"), "cpu")
    assert set(ours) - set(theirs) == {"device_name"} and set(theirs) <= set(ours)
    assert {k: ours[k] for k in theirs} == theirs


@pytest.mark.parametrize("variant", sorted(parity_fullscale.JAX_ONLY_VARIANTS))
def test_parity_jax_only_variants_raise_by_name(variant):
    with pytest.raises(ValueError, match=variant):
        parity_fullscale.main(["--variants", f"fp32,{variant}", "--device", "cpu"])


def test_parity_unknown_variant_exits():
    with pytest.raises(SystemExit, match="unknown variant"):
        parity_fullscale.check_variants(["fp32", "bogus"])


# ---- the converter and the golden inference --------------------------------


@pytest.fixture(scope="module")
def hub_dir(tmp_path_factory, sds):
    """UMX-L torchhub checkpoints of the hidden-32 weights, with the keys
    the converter skips."""
    d = tmp_path_factory.mktemp("hub")
    for target, fname in convert_umx_pth_to_ggml.HUB_FILES["umxl"].items():
        sd = {k: torch.from_numpy(v) for k, v in sds[target].items()}
        sd.update({"stft.window": torch.ones(4096), "sample_rate": torch.tensor(44100.0),
                   "transform.0.window": torch.ones(4096)})
        sd.update({f"bn{i}.num_batches_tracked": torch.tensor(7) for i in (1, 2, 3)})
        torch.save(sd, str(d / fname))
    return d


@pytest.mark.parametrize("gz", [True, False])
def test_converter_writes_the_jax_scripts_bytes(hub_dir, tmp_path, sds, capsys, gz):
    from umx_tpu_torch.io.ggml import write_ggml_bytes

    mod = jax_script("convert-umx-pth-to-ggml.py")
    assert mod.HUB_FILES == convert_umx_pth_to_ggml.HUB_FILES
    assert mod.SKIP_KEYS == convert_umx_pth_to_ggml.SKIP_KEYS
    flag = ["--gzip"] if gz else []
    assert convert_umx_pth_to_ggml.main(["--ckpt-dir", str(hub_dir), *flag, str(tmp_path / "a")]) == 0
    ours_out = capsys.readouterr().out
    assert mod.main(["--ckpt-dir", str(hub_dir), *flag, str(tmp_path / "b")]) == 0
    assert capsys.readouterr().out.splitlines()[0] == ours_out.splitlines()[0] == "hidden_size = 32"
    name = "ggml-model-umxl-u8.bin" + (".gz" if gz else "")
    ours, theirs = ((tmp_path / d / name).read_bytes() for d in ("a", "b"))
    if gz:
        ours, theirs = gzip.decompress(ours), gzip.decompress(theirs)
    assert ours == theirs == write_ggml_bytes(H, sds)


def test_converter_names_a_missing_checkpoint(tmp_path):
    with pytest.raises(FileNotFoundError, match="vocals"):
        convert_umx_pth_to_ggml.main(["--ckpt-dir", str(tmp_path), str(tmp_path / "out")])


@pytest.fixture(scope="module")
def model_and_wav(tmp_path_factory, sds):
    d = tmp_path_factory.mktemp("golden")
    model = str(d / "model.bin.gz")
    write_ggml(model, H, sds)
    rng = np.random.default_rng(8)
    t = np.arange(int(2.5 * SR)) / SR
    mix = np.stack([0.3 * np.sin(2 * np.pi * 220 * t), 0.3 * np.sin(2 * np.pi * 330 * t)])
    mix = (mix + 0.05 * rng.standard_normal(mix.shape)).astype(np.float32)
    wav = str(d / "mix.wav")
    wavfile.write(wav, SR, np.ascontiguousarray(mix.T))
    return model, wav, mix


@pytest.mark.parametrize("wiener", [True, False])
def test_golden_inference_equals_the_jax_script(model_and_wav, tmp_path, capsys, wiener):
    model, wav, mix = model_and_wav
    flag = [] if wiener else ["--no-wiener"]
    assert umx_golden_inference.main([model, wav, str(tmp_path / "a"), *flag]) == 0
    assert jax_script("umx-golden-inference.py").main([model, wav, str(tmp_path / "b"), *flag]) == 0
    assert capsys.readouterr().out.count("wrote target_") == 8
    for i in range(4):
        ra, a = wavfile.read(str(tmp_path / "a" / f"target_{i}.wav"))
        rb, b = wavfile.read(str(tmp_path / "b" / f"target_{i}.wav"))
        assert ra == rb == SR and a.shape == b.shape == (mix.shape[1], 2)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
        assert np.isfinite(a).all()


def test_compare_torch_stft_passes_on_the_cpu(capsys):
    assert compare_torch_stft.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "parity OK" in out and "port on cpu" in out


# ---- the certification tools on the CPU ------------------------------------


def _json_keys(script: str) -> list[set[str]]:
    """The keys of each JSON object the JAX script prints (read from its
    source: the quoted keys of each ``json.dumps({...})`` block)."""
    src = open(os.path.join(REPO, "scripts", script)).read()
    blocks = re.findall(r"print\(json\.dumps\(\{(.*?)\n\s*\}\)\)", src, re.S)
    return [set(re.findall(r'^\s*"(\w+)":', b, re.M)) for b in blocks]


def test_e2e_test_runs_the_cli_on_the_cpu():
    r = subprocess.run([sys.executable, "-m", "umx_tpu_torch.scripts.e2e_test", "--device", "cpu"],
                       capture_output=True, text=True, timeout=300, cwd=REPO)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "umx_tpu_torch.cli" in r.stdout and "--device cpu" in r.stdout
    assert r.stdout.strip().splitlines()[-1] == "e2e OK"
    table = [ln.split() for ln in r.stdout.splitlines()
             if ln.split()[:1] and ln.split()[0] in ("bass", "drums", "other", "vocals")]
    assert len(table) == 4 and all(np.isfinite([float(v) for v in row[1:]]).all() for row in table)


def test_fleet_certify_quick_on_the_cpu(capsys):
    assert fleet_certify.main(["--quick", "--device", "cpu"]) == 0
    d = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    (keys,) = _json_keys("fleet-certify.py")
    assert set(d) == keys | {"device_name"}
    assert d["metric"] == "xRT_umxhq_fleet_musdb6" and d["value"] > 0 and d["tracks"] == 6
    assert d["rows"] == 6 and sum(d["buckets"].values()) == 6 and d["device_name"] == "cpu"


def test_fleet_certify_durations_are_the_jax_scripts():
    mod = jax_script("fleet-certify.py")
    assert fleet_certify.musdb_durations(50, np.random.default_rng(0)) == mod.musdb_durations(
        50, np.random.default_rng(0))


def test_serve_bench_on_the_cpu():
    r = subprocess.run(
        [sys.executable, "-m", "umx_tpu_torch.scripts.serve_bench", "--cpu", "--hidden-size",
         str(H), "--track-secs", "2", "--segment-secs", "1.0", "--clients", "2", "--ttl-probe"],
        capture_output=True, text=True, timeout=300, cwd=REPO)
    assert r.returncode == 0, r.stderr[-2000:]
    lines = [json.loads(ln) for ln in r.stdout.strip().splitlines()]
    main_keys, ttl_keys = _json_keys("serve-bench.py")
    assert len(lines) == 2
    assert set(lines[0]) == main_keys | {"device_name"}
    assert set(lines[1]) | set(lines[1]["ttl_probe"]) == ttl_keys
    d = lines[0]
    assert d["clients"] == d["requests"] == 2 and d["track_secs"] == 2.0
    assert d["latency_p50_s"] <= d["latency_p95_s"] <= d["latency_p99_s"]
    assert d["batching"]["max_batch"] == 4 and d["batching"]["jobs"] >= 2
    assert d["autoscaling"]["avg_batch_fill"] >= 1.0 and d["device_name"] == "cpu"
    assert lines[1]["ttl_probe"] == {"ttl_s": 2.0, "abandoned_sessions": 3,
                                     "sessions_after_ttl_plus_start": 1, "stale_push": "HTTP 404"}


@pytest.mark.parametrize("window_chunks", [0, 2])
def test_longtrack_probe_small_on_the_cpu(monkeypatch, capsys, window_chunks):
    monkeypatch.setenv("UMX_PROBE_TRACK_SECS", "6")
    cfg = EngineConfig(model=ModelConfig(hidden_size=H),
                       segment=SegmentConfig(segment_secs=2.0, window_chunks=window_chunks))
    assert longtrack_probe.main(["--device", "cpu"], cfg) == 0
    out = capsys.readouterr().out
    m = re.search(r"longtrack 6s: 4 chunks, xRT=\d+, corr\(sum stems, mix\)=([\d.]+), "
                  r"finite=True, route=([^,]+),", out)
    assert m, out
    assert m.group(2) == ("one program" if window_chunks == 0 else "2 windows")
    assert float(m.group(1)) >= 0.99


def test_longtrack_probe_windows_equal_the_one_program():
    dev = torch.device("cpu")
    one, win = (longtrack_probe.probe(dev, EngineConfig(
        model=ModelConfig(hidden_size=H),
        segment=SegmentConfig(segment_secs=2.0, window_chunks=w)), 6.0) for w in (-1, 2))
    assert one["route"] == "one program" and win["route"] == "2 windows"
    for k in ("corr", "corr_first_tenth", "corr_last_tenth", "planner_gib", "chunks"):
        assert one[k] == win[k], k


def test_longtrack_partition_of_its_signal_equals_the_jax_separator():
    """At UMX-L width the synthetic weights zero every target's mask in some
    bins of the probe's two-tone signal, so the stems do not sum to all of
    the mix (corr about 0.976): the JAX package's separator gives the same
    partition on the same signal (4 s at 2 s segments)."""
    from umx_tpu.config import EngineConfig as JEngineConfig
    from umx_tpu.config import SegmentConfig as JSegmentConfig
    from umx_tpu.engine.separator import Separator as JSeparator
    from umx_tpu.models.umx import synthetic_params as jsynthetic_params

    cfg = EngineConfig(segment=SegmentConfig(segment_secs=2.0))
    ours = longtrack_probe.probe(torch.device("cpu"), cfg, 4.0)["corr"]
    jcfg = JEngineConfig(segment=JSegmentConfig(segment_secs=2.0))
    audio = longtrack_probe.signal(4.0)
    stems = np.asarray(JSeparator(jsynthetic_params(jcfg.model, seed=0), jcfg).demix(audio))
    theirs = float(np.corrcoef(stems.sum(axis=0).ravel(), audio.ravel())[0, 1])
    assert abs(ours - theirs) <= 1e-4, (ours, theirs)
