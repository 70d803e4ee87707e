"""The port's public API against the JAX package's: the top-level exports,
the presets, ``umx_forward`` with its compute specs, ``param_count``, and
the complex STFT wrappers (``stft``, ``istft``, ``magnitude``,
``frame_signal``), on the same inputs made with numpy.  The cases mirror
``tests/test_model.py`` and ``tests/test_stft.py`` at a small width
(hidden 36: G 18, where both packages' "auto" is the float32 scan)."""

from __future__ import annotations

import ast
import dataclasses
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import umx_tpu_torch
from umx_tpu import config as jconfig
from umx_tpu.models import umx as jumx
from umx_tpu.ops import stft as jstft
from umx_tpu_torch import config as tconfig
from umx_tpu_torch.models import umx as tumx
from umx_tpu_torch.ops import stft as tstft

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HIDDEN = 36
N_FRAMES = 21
# the f32 products of both packages differ in summation order only
MASK_RTOL = 1e-5
# the state after three f32 layers (tests/test_torch_model.py's LSTM_ATOL)
STATE_ATOL = 1e-5
# "bfloat16": bf16 operands on both sides, f32 sums in other orders, so one
# rounding of an operand may flip by one bf16 step (2^-8 relative) and move
# a mask by about that much: max 2e-2 of the peak, RMS 2e-3 of it
BF16_MAX, BF16_RMS = 2e-2, 2e-3


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def cfgs():
    return jconfig.ModelConfig(hidden_size=HIDDEN), tconfig.ModelConfig(hidden_size=HIDDEN)


@pytest.fixture(scope="module")
def params(cfgs):
    jp = jumx.synthetic_params(cfgs[0], seed=11)
    return jp, tumx.params_from_jax(jp)


@pytest.fixture(scope="module")
def x(cfgs):
    rng = np.random.default_rng(12)
    # magnitude-like input, as tests/test_model.py
    return (np.abs(rng.standard_normal((N_FRAMES, cfgs[1].n_features))) * 0.3).astype(np.float32)


def _normwise(ours, ref) -> float:
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert ours.shape == ref.shape
    return float(np.max(np.abs(ours - ref)) / np.max(np.abs(ref)))


def _forward_both(params, cfgs, x, compute, state=None, cfg_kw=None):
    jcfg, tcfg = cfgs
    if cfg_kw:
        jcfg, tcfg = dataclasses.replace(jcfg, **cfg_kw), dataclasses.replace(tcfg, **cfg_kw)
    jst, tst = state if state is not None else (jumx.init_lstm_state(jcfg),
                                                tumx.init_lstm_state(tcfg))
    jm, jst = jumx.umx_forward(params[0], jnp.asarray(x), jst, jcfg, compute)
    tm, tst = tumx.umx_forward(params[1], torch.from_numpy(x), tst, tcfg, compute)
    return (np.asarray(jm), jst), (tm.numpy(), tst)


# ---- the top-level exports and the presets -------------------------------


def _jax_exports() -> set[str]:
    """The names ``umx_tpu/__init__.py`` imports from its modules."""
    tree = ast.parse(open(os.path.join(REPO, "umx_tpu", "__init__.py")).read())
    return {a.asname or a.name for node in ast.walk(tree) if isinstance(node, ast.ImportFrom)
            and (node.module or "").startswith("umx_tpu") for a in node.names}


def test_exports_cover_the_jax_package():
    names = _jax_exports()
    assert {"umx_forward", "Separator", "segment_forward", "TARGETS"} <= names
    assert names <= set(umx_tpu_torch.__all__)
    for name in umx_tpu_torch.__all__:
        assert getattr(umx_tpu_torch, name) is not None, name


@pytest.mark.parametrize("name, module", [
    ("umx_forward", "models.umx"), ("umx_pre", "models.umx"), ("umx_post", "models.umx"),
    ("umx_recurrence", "models.umx"), ("LSTMState", "models.umx"), ("UMXParams", "models.umx"),
    ("init_lstm_state", "models.umx"), ("params_from_ggml", "models.umx"),
    ("synthetic_params", "models.umx"), ("Separator", "engine.separator"),
    ("segment_forward", "engine.separator"), ("EngineConfig", "config"), ("TARGETS", "config"),
])
def test_each_export_is_the_module_object(name, module):
    import importlib

    assert getattr(umx_tpu_torch, name) is getattr(
        importlib.import_module(f"umx_tpu_torch.{module}"), name)


def test_importing_the_package_builds_nothing_and_leaves_cuda_alone():
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["umx_tpu"] = None
        import torch
        import umx_tpu_torch
        from umx_tpu_torch import _build
        assert not torch.cuda.is_initialized()
        assert _build._load_library.cache_info().currsize == 0
        loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "umx_tpu")
                  and sys.modules[m] is not None]
        assert not loaded, loaded
        print(len(umx_tpu_torch.__all__))
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


def _fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _assert_same_fields(ours, theirs, path):
    """Every field of the port's config equals the JAX field of that name
    (nested configs field by field); the port keeps no field JAX lacks."""
    o, t = _fields(ours), _fields(theirs)
    assert set(o) <= set(t), (path, set(o) - set(t))
    for name, v in o.items():
        if dataclasses.is_dataclass(v):
            _assert_same_fields(v, t[name], f"{path}.{name}")
        else:
            assert v == t[name], (f"{path}.{name}", v, t[name])


@pytest.mark.parametrize("name", ["UMXL", "UMXHQ"])
def test_presets_equal_the_jax_presets(name):
    _assert_same_fields(getattr(tconfig, name), getattr(jconfig, name), name)


def test_targets_and_file_index_equal():
    assert tconfig.TARGETS == jconfig.TARGETS
    assert tconfig.TARGET_FILE_INDEX == jconfig.TARGET_FILE_INDEX
    assert umx_tpu_torch.TARGETS == jconfig.TARGETS


def test_param_count_equals_jax(params, cfgs):
    assert tumx.param_count(params[1]) == jumx.param_count(params[0])
    H, F, O, G = HIDDEN, cfgs[1].n_features, cfgs[1].n_outputs, HIDDEN // 2
    per_target = (2 * F + F * H + 4 * H + 3 * 2 * (H * 4 * G + G * 4 * G + 2 * 4 * G)
                  + 2 * H * H + 4 * H + H * O + 4 * O + 2 * O)
    assert tumx.param_count(params[1]) == 4 * per_target


# ---- compute specs -------------------------------------------------------


@pytest.mark.parametrize("name", ["default", "float32", "bfloat16", "high", "highest"])
def test_resolve_compute_names(name):
    jdtype, jprec = jumx.resolve_compute(name)
    dtype, prec = tumx.resolve_compute(name)
    assert str(dtype).split(".")[-1] == jnp.dtype(jdtype).name
    assert prec == jprec.name.lower()


def test_resolve_compute_dtypes_tuples_and_unknown_names():
    assert tumx.resolve_compute("float16") == (torch.float16, "default")
    assert tumx.resolve_compute(torch.bfloat16) == (torch.bfloat16, "default")
    assert tumx.resolve_compute(np.float16) == (torch.float16, "default")
    spec = (torch.bfloat16, "high")
    assert tumx.resolve_compute(spec) is spec
    for bad in ("bf16x", "nonsense"):
        with pytest.raises(ValueError, match="unknown compute spec"):
            tumx.resolve_compute(bad)
        with pytest.raises(ValueError, match="unknown compute spec"):
            jumx.resolve_compute(bad)


# ---- umx_forward against the JAX package ---------------------------------


@pytest.mark.parametrize("compute", ["float32", "default"])
@pytest.mark.parametrize("scaling", ["openunmix", "umxcpp"])
def test_forward_matches_jax(params, cfgs, x, compute, scaling):
    (jm, jst), (tm, tst) = _forward_both(params, cfgs, x, compute,
                                         cfg_kw={"input_scaling": scaling})
    assert tm.shape == (4, N_FRAMES, cfgs[1].n_outputs) and tm.dtype == np.float32
    assert _normwise(tm, jm) <= MASK_RTOL
    np.testing.assert_allclose(tst.h.numpy(), np.asarray(jst.h), rtol=0, atol=STATE_ATOL)
    np.testing.assert_allclose(tst.c.numpy(), np.asarray(jst.c), rtol=0, atol=STATE_ATOL)


def test_bfloat16_forward_matches_jax_within_one_bf16_step(params, cfgs, x):
    """Under "scan" (hidden 36's "auto" in both packages) "bfloat16" rounds
    the fc and projection operands and h and W_hh in the recurrence: the
    merged recurrence's function (K1 on the card)."""
    (jm, jst), (tm, tst) = _forward_both(params, cfgs, x, "bfloat16")
    err = np.abs(tm.astype(np.float64) - jm)
    peak = np.abs(jm).max()
    assert err.max() <= BF16_MAX * peak and np.sqrt((err ** 2).mean()) <= BF16_RMS * peak
    assert np.abs(tst.h.numpy() - np.asarray(jst.h)).max() <= BF16_MAX


def test_bfloat16_scan_runs_the_merged_recurrence(params, cfgs, x, monkeypatch):
    """"bfloat16" under "scan" is K1's function, so the port runs the
    merged layer (never the float32 one); "float32" runs the float32 one."""
    from umx_tpu_torch.ops import lstm_cuda

    seen = []
    for name in ("lstm_layer_merged_batched", "lstm_layer_scan_batched"):
        real = getattr(tumx, name)
        monkeypatch.setattr(tumx, name, lambda *a, _r=real, _n=name: seen.append(_n) or _r(*a))
    tcfg = dataclasses.replace(cfgs[1], lstm_impl="scan")
    st = tumx.init_lstm_state(tcfg)
    tumx.umx_forward(params[1], torch.from_numpy(x), st, tcfg, "bfloat16")
    assert seen == ["lstm_layer_merged_batched"] * 3
    seen.clear()
    tumx.umx_forward(params[1], torch.from_numpy(x), st, tcfg, "float32")
    assert seen == ["lstm_layer_scan_batched"] * 3
    assert lstm_cuda.merged_form(HIDDEN // 2) == "resident"  # padded to 24 on the card


def test_float32_specs_are_one_program(params, cfgs, x):
    """Off a TPU every spec but a narrower dtype is one float32 product."""
    st = tumx.init_lstm_state(cfgs[1])
    ref, _ = tumx.umx_forward(params[1], torch.from_numpy(x), st, cfgs[1])
    for compute in ("float32", "high", "highest", (torch.float32, "high")):
        m, _ = tumx.umx_forward(params[1], torch.from_numpy(x), st, cfgs[1], compute)
        assert torch.equal(m, ref), compute


def test_bfloat16_close_to_float32(params, cfgs, x):
    """tests/test_model.py's bound: the mean mask error under 1 %."""
    st = tumx.init_lstm_state(cfgs[1])
    m32, _ = tumx.umx_forward(params[1], torch.from_numpy(x), st, cfgs[1], "float32")
    m16, _ = tumx.umx_forward(params[1], torch.from_numpy(x), st, cfgs[1], "bfloat16")
    assert m16.dtype == torch.float32
    rel = (m16 - m32).abs().mean() / (m32.abs().mean() + 1e-6)
    assert rel < 0.01, rel


@pytest.mark.parametrize("impl", ["pallas_merged", "pallas"])
def test_kernel_recurrences_ignore_the_spec_as_in_jax(params, cfgs, x, impl):
    """Under the kernel values the recurrence runs bf16 h and W_hh whatever
    the spec (the JAX package's Pallas kernels, here in interpret mode);
    the projections follow it."""
    jcfg = dataclasses.replace(cfgs[0], lstm_impl="pallas_interpret")
    tcfg = dataclasses.replace(cfgs[1], lstm_impl=impl)
    for compute in ("float32", "bfloat16"):
        jm, jst = jumx.umx_forward(params[0], jnp.asarray(x), jumx.init_lstm_state(jcfg), jcfg,
                                   compute)
        tm, tst = tumx.umx_forward(params[1], torch.from_numpy(x), tumx.init_lstm_state(tcfg),
                                   tcfg, compute)
        jm = np.asarray(jm)
        err = np.abs(tm.numpy().astype(np.float64) - jm)
        assert err.max() <= BF16_MAX * np.abs(jm).max(), compute
        assert np.sqrt((err ** 2).mean()) <= BF16_RMS * np.abs(jm).max(), compute


def test_quantized_weights_ignore_the_spec(tmp_path):
    """A quantized product dequantizes inside the matmul, and the
    recurrence reads the bf16 W_hh as stored, whatever the spec."""
    from umx_tpu_torch.io.ggml import read_ggml, write_ggml

    cfg = tconfig.ModelConfig(hidden_size=HIDDEN)
    path = str(tmp_path / "q.bin")
    write_ggml(path, HIDDEN, tumx.synthetic_state_dicts(cfg, seed=2))
    qp = tumx.quantized_params_from_ggml(read_ggml(path, keep_quantized=True), cfg)
    x = np.abs(np.random.default_rng(3).standard_normal((9, cfg.n_features))).astype(np.float32)
    st = tumx.init_lstm_state(cfg)
    a, sa = tumx.umx_forward(qp, torch.from_numpy(x), st, cfg, "float32")
    b, sb = tumx.umx_forward(qp, torch.from_numpy(x), st, cfg, "bfloat16")
    assert torch.equal(a, b) and torch.equal(sa.h, sb.h)
    assert tumx.param_count(qp) == tumx.param_count(tumx.params_from_ggml(read_ggml(path), cfg))


def test_masks_nonnegative(params, cfgs, x):
    m, _ = tumx.umx_forward(params[1], torch.from_numpy(x), tumx.init_lstm_state(cfgs[1]),
                            cfgs[1])
    assert float(m.min()) >= 0.0


def test_streaming_state_propagates_like_jax(params, cfgs, x):
    """Two chunks with the state carried (tests/test_model.py's
    two-chunk case): each chunk's masks and state against JAX's, and the
    carried state changes the second chunk's masks."""
    half = N_FRAMES // 2
    state = None
    outs = []
    for chunk in (x[:half], x[half:]):
        (jm, jst), (tm, tst) = _forward_both(params, cfgs, chunk, "default", state)
        assert _normwise(tm, jm) <= MASK_RTOL
        np.testing.assert_allclose(tst.h.numpy(), np.asarray(jst.h), rtol=0, atol=STATE_ATOL)
        state = (jst, tst)
        outs.append(tm)
    fresh, _ = tumx.umx_forward(params[1], torch.from_numpy(x[half:]),
                                tumx.init_lstm_state(cfgs[1]), cfgs[1])
    assert not np.allclose(outs[1], fresh.numpy())
    assert np.abs(state[1].h.numpy()).max() > 0.01


# ---- the complex STFT wrappers -------------------------------------------


@pytest.fixture(scope="module")
def dsp():
    return jconfig.DSPConfig(), tconfig.DSPConfig()


def test_frame_signal_equals_jax(dsp):
    cfg = dsp[1]
    x = np.random.default_rng(6).standard_normal((3, cfg.n_fft + cfg.hop * 7)).astype(np.float32)
    ours = tstft.frame_signal(torch.from_numpy(x), cfg.n_fft, cfg.hop)
    assert ours.shape == (3, 8, cfg.n_fft)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(jstft.frame_signal(x, cfg.n_fft,
                                                                              cfg.hop)))
    with pytest.raises(ValueError, match="hop"):
        tstft.frame_signal(torch.from_numpy(x), cfg.n_fft, 1000)


def test_stft_frame_count_and_layout(dsp):
    cfg = dsp[1]
    n = 44100
    x = np.random.default_rng(0).standard_normal((2, n)).astype(np.float32)
    spec = tstft.stft(torch.from_numpy(x), cfg)
    assert spec.shape == (2, n // cfg.hop + 1, cfg.n_bins) and spec.dtype == torch.complex64


@pytest.mark.parametrize("signal", ["noise", "square"])
def test_stft_matches_jax(dsp, signal):
    jcfg, cfg = dsp
    if signal == "noise":
        x = np.random.default_rng(1).standard_normal((2, 3 * cfg.hop * 16)).astype(np.float32)
    else:  # the compare-torch-stft probe signal
        t = np.arange(4096 * 8) / cfg.sample_rate
        x = np.sign(np.sin(2 * np.pi * 441.0 * t)).astype(np.float32)[None]
    ours = tstft.stft(torch.from_numpy(x), cfg).numpy()
    theirs = np.asarray(jstft.stft(x, jcfg))
    assert ours.shape == theirs.shape
    # both are f32 FFTs of the same windowed frames
    np.testing.assert_allclose(ours, theirs, atol=1e-5 * np.abs(theirs).max(), rtol=0)


def test_istft_matches_jax_and_round_trips(dsp):
    jcfg, cfg = dsp
    n = cfg.hop * 64 + 123
    x = np.random.default_rng(4).uniform(-1, 1, (2, n)).astype(np.float32)
    spec = np.array(jstft.stft(x, jcfg))
    ours = tstft.istft(torch.from_numpy(spec), n, cfg).numpy()
    np.testing.assert_allclose(ours, np.asarray(jstft.istft(jnp.asarray(spec), n, jcfg)),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(ours, x, atol=1e-4)  # tests/test_stft.py's round trip


def test_istft_ct2_matches_jax_dense(dsp):
    """The port's ct2 iSTFT (K8's plain version here) through the complex
    wrapper against the JAX package's default inverse."""
    jcfg, cfg = dsp
    n = cfg.hop * 40
    x = np.random.default_rng(5).uniform(-1, 1, (2, n)).astype(np.float32)
    spec = np.array(jstft.stft(x, jcfg))
    ours = tstft.istft(torch.from_numpy(spec), n, dataclasses.replace(cfg, istft_algo="ct2"))
    np.testing.assert_allclose(ours.numpy(), np.asarray(jstft.istft(jnp.asarray(spec), n, jcfg)),
                               atol=1e-5, rtol=0)


def test_magnitude_and_phase_reconstruction(dsp):
    jcfg, cfg = dsp
    n = cfg.hop * 40
    x = np.random.default_rng(5).uniform(-1, 1, (2, n)).astype(np.float32)
    spec = tstft.stft(torch.from_numpy(x), cfg)
    mag = tstft.magnitude(spec)
    assert mag.dtype == torch.float32
    np.testing.assert_allclose(mag.numpy(), np.asarray(jstft.magnitude(jnp.asarray(spec.numpy()))),
                               rtol=1e-6, atol=0)
    recon = tstft.polar_to_complex(mag, spec)
    np.testing.assert_allclose(recon.numpy(), spec.numpy(), atol=1e-5)
    np.testing.assert_allclose(tstft.istft(recon, n, cfg).numpy(), x, atol=1e-4)
