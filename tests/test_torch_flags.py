"""The storage and precision knobs and the CLI's flag set, against the
JAX package on the same weights and audio: the bfloat16 seams
(``mask_dtype``, ``WienerConfig.out_dtype``, ``stems_stack_dtype``; the
JAX cases are ``tests/test_engine.py``'s slow seam tests, run here at
small widths), ``WienerConfig.impl``, the planner's stems-stack term, the
precision flags (the default's bits for every value), and a parser that
accepts every option and choice of ``umx_tpu.cli.build_parser()`` but the
named TPU-only values."""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from umx_tpu import cli as jcli
from umx_tpu.config import EngineConfig as JEngineConfig
from umx_tpu.config import ModelConfig as JModelConfig
from umx_tpu.config import SegmentConfig as JSegmentConfig
from umx_tpu.config import WienerConfig as JWienerConfig
from umx_tpu.engine import memory as jmemory
from umx_tpu.engine.separator import Separator as JSeparator
from umx_tpu.models.umx import synthetic_params
from umx_tpu.ops import wiener as jwiener
from umx_tpu_torch import cli
from umx_tpu_torch.config import EngineConfig, ModelConfig, SegmentConfig, WienerConfig
from umx_tpu_torch.engine import memory
from umx_tpu_torch.engine.separator import Separator
from umx_tpu_torch.io.ggml import write_ggml
from umx_tpu_torch.models.umx import params_from_jax, synthetic_state_dicts
from umx_tpu_torch.ops import wiener
from umx_tpu_torch.ops.stft import masks_to_planes

HIDDEN = 32
SR = 44100
# a bf16 seam against float32: the JAX seam tests' gates (of the f32 peak)
SEAM_GATE = 2e-2
STACK_GATE = 1.5e-2  # the stems stack alone: at most two rounded addends a sample
SLICE_RTOL = 2e-4  # port against JAX, dense (tests/test_torch_separator.py)
# Port against JAX with the same bf16 knobs, measured here (hidden 32): the
# mask and Wiener-output seams 2.5e-5 and 4.8e-5 of the peak apart, inside
# the dense tolerance and well below their own effect (8.2e-4, 1.7e-3).
# The stems stack stores what it rounds, so a last-bit float32 difference
# that flips one rounding moves a sample by a bf16 step (max 4.6e-3 to
# 5.4e-3 of the peak, as large as the seam's own 3.3e-3).  Flips are rare,
# so the stack is held by the RMS of the difference: 1.9e-5 to 4.4e-5 of
# the peak against the seam's own 3.8e-4 to 4.7e-4; and each sample within
# one bf16 step (2^-7 of the peak) beyond the dense tolerance.
STACK_FLIP_RMS = 1e-4
BF16_STEP = 2.0**-7
# bf16 Wiener planes against the JAX package's: equal but for rare flips
# (measured 0 to 2 of 3168 elements), each one bf16 step
PLANE_FLIPS = 1e-2
# the JAX CLI's values that select what only XLA has; the port's parser
# refuses them, naming the value (``--lstm-impl scan``, the JAX package's
# float32 recurrence, is the port's kernel K10: nothing refused there)
JAX_ONLY = {"--lstm-impl": set(), "--istft-algo": {"ct2_xla"}}
PRECISION_FLAGS = {"--matmul-precision": ("default", "high", "highest"),
                   "--dft-precision": ("auto", "default", "high", "highest"),
                   "--idft-precision": ("auto", "default", "high", "highest"),
                   "--iframes-dtype": ("auto", "float32", "bfloat16")}
POS = ["model.bin", "mix.wav", "out"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def setup():
    jparams = synthetic_params(JModelConfig(hidden_size=HIDDEN), seed=0)
    rng = np.random.default_rng(31)
    t = np.arange(int(2.5 * SR)) / SR
    audio = np.stack([0.4 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.standard_normal(t.shape),
                      0.4 * np.sin(2 * np.pi * 330 * t) + 0.05 * rng.standard_normal(t.shape)])
    return jparams, params_from_jax(jparams), audio.astype(np.float32)


def _cfgs(streaming=True, **knobs):
    """The JAX config (merged kernel and Wiener passes in interpret mode)
    and the port's, both with ``knobs``: mask, wiener_out, stems_stack."""
    dt = {k: "bfloat16" if knobs.get(k) else "float32"
          for k in ("mask", "wiener_out", "stems_stack")}
    seg = dict(segment_secs=1.0, streaming=streaming)
    jcfg = JEngineConfig(
        model=JModelConfig(hidden_size=HIDDEN, lstm_impl="pallas_interpret"),
        segment=JSegmentConfig(window_chunks=-1, **seg),
        wiener=JWienerConfig(impl="pallas_interpret", out_dtype=dt["wiener_out"]),
        mask_dtype=dt["mask"], stems_stack_dtype=dt["stems_stack"], shifts=0)
    tcfg = EngineConfig(
        model=ModelConfig(hidden_size=HIDDEN), segment=SegmentConfig(**seg),
        wiener=WienerConfig(out_dtype=dt["wiener_out"]),
        mask_dtype=dt["mask"], stems_stack_dtype=dt["stems_stack"], shifts=0)
    return jcfg, tcfg


@pytest.mark.parametrize("knobs, gate", [
    (dict(mask=True), SEAM_GATE),
    (dict(wiener_out=True), SEAM_GATE),
    (dict(stems_stack=True), STACK_GATE),
    (dict(stems_stack=True, streaming=False), STACK_GATE),
    (dict(mask=True, wiener_out=True, stems_stack=True), SEAM_GATE),
])
def test_bf16_seam_within_its_gate(setup, knobs, gate):
    """Each bfloat16 seam, and all three together, stays within the JAX
    tests' gate of the float32 result's peak, rounds something, keeps the
    waves float32, and rounds where the JAX package does: with the same
    knobs it is within the dense tolerance of it (the stems stack: within
    the RMS of rare rounding flips, each at most one bf16 step)."""
    jparams, params, audio = setup
    knobs = dict(knobs)
    streaming = knobs.pop("streaming", True)
    _, ref_cfg = _cfgs(streaming)
    jcfg, tcfg = _cfgs(streaming, **knobs)
    ref = Separator(params, ref_cfg, "cpu").demix_track(audio, seed=3)
    out = Separator(params, tcfg, "cpu").demix_track(audio, seed=3)
    assert out.dtype == np.float32
    peak = float(np.abs(ref).max())
    err = float(np.abs(out - ref).max())
    assert 0.0 < err <= gate * peak
    diff = out - np.asarray(JSeparator(jparams, jcfg).demix_track(audio, seed=3))
    if knobs.get("stems_stack"):
        assert np.sqrt(np.mean(np.square(diff, dtype=np.float64))) <= STACK_FLIP_RMS * peak
        assert float(np.abs(diff).max()) <= (SLICE_RTOL + BF16_STEP) * peak
    else:
        assert float(np.abs(diff).max()) <= SLICE_RTOL * peak


def test_auto_storage_is_float32(setup):
    """On the CPU "auto" is float32, as the JAX package resolves it on a
    CPU backend: every default CPU result keeps its bits when the three
    seams are set to float32 by name."""
    _, params, audio = setup
    _, f32 = _cfgs()
    auto = dataclasses.replace(f32, mask_dtype="auto", stems_stack_dtype="auto",
                               wiener=WienerConfig())
    assert auto == EngineConfig(model=f32.model, segment=f32.segment, shifts=0)
    a = Separator(params, auto, "cpu").demix_track(audio, seed=3)
    assert np.array_equal(a, Separator(params, f32, "cpu").demix_track(audio, seed=3))


@pytest.mark.parametrize("rows", [1, 2])
def test_bf16_seams_reach_the_passes_and_the_istft_as_stored(setup, monkeypatch, rows):
    """With bfloat16 masks and Wiener output, a segment hands the masks to
    the fused passes as they are stored (no float32 copy; the passes read
    them) and the last pass's bfloat16 planes to the iSTFT (no float32
    copy; the iSTFT upcasts once), for one row or several; the output is
    float32 waves."""
    from umx_tpu_torch.engine import separator as S
    from umx_tpu_torch.models.umx import init_lstm_state
    from umx_tpu_torch.ops import wiener_cuda

    _, params, audio = setup
    _, cfg = _cfgs(mask=True, wiener_out=True)
    seen = {"masks": [], "out": [], "planes": []}
    reduce, apply, istft = wiener_cuda.wiener_reduce, wiener_cuda.wiener_apply, S.istft_planes

    def spy_reduce(mode, xre, xim, m, y_im, inv):
        if mode == "masks":
            seen["masks"].append(m.dtype)
        return reduce(mode, xre, xim, m, y_im, inv)

    def spy_apply(*args):
        seen["out"].append(args[-1])
        return apply(*args)

    def spy_istft(tre, tim, n, dsp):
        seen["planes"].append((tre.dtype, tim.dtype))
        return istft(tre, tim, n, dsp)

    monkeypatch.setattr(wiener_cuda, "wiener_reduce", spy_reduce)
    monkeypatch.setattr(wiener_cuda, "wiener_apply", spy_apply)
    monkeypatch.setattr(S, "istft_planes", spy_istft)
    n = cfg.segment.segment_samples(SR)
    batch = torch.from_numpy(np.stack([audio[:, :n]] * rows))
    with torch.inference_mode():
        waves, _ = S.segment_forward_batched(
            params, batch, init_lstm_state(cfg.model, batch=rows), cfg, n)
    assert seen["masks"] == [torch.bfloat16] * rows
    assert seen["out"] == [torch.bfloat16] * rows
    assert seen["planes"] == [(torch.bfloat16, torch.bfloat16)]
    assert waves.dtype == torch.float32 and waves.shape == (rows, 4, 2, n)


@pytest.mark.parametrize("backend, device, dtype", [
    ("cpu", "cpu", torch.float32), ("gpu", "cuda", torch.bfloat16),
    ("gpu", "cuda:1", torch.bfloat16), ("gpu", None, torch.bfloat16)])
def test_auto_resolves_as_the_jax_package(monkeypatch, backend, device, dtype):
    """"auto" at the three seams, the port's by the device against the JAX
    package's by the backend (``umx_tpu/engine/separator.py``'s
    ``_resolve_mask_dtype`` and ``_resolve_stems_stack_dtype``,
    ``umx_tpu/ops/wiener.py``'s ``_resolve_out_dtype``, the planner's
    ``_stems_itemsize``): bfloat16 on any backend but the CPU.  The
    explicit values hold on every device."""
    import jax
    import jax.numpy as jnp

    from umx_tpu.engine import separator as jsep
    from umx_tpu_torch.config import storage_dtype
    from umx_tpu_torch.ops.wiener import wiener_out_dtype

    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    jcfg = JEngineConfig()
    jdt = {"mask": jsep._resolve_mask_dtype(jcfg),
           "stems_stack": jsep._resolve_stems_stack_dtype(jcfg),
           "wiener_out": jwiener._resolve_out_dtype(jcfg.wiener)}
    want = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    assert all(jnp.dtype(v) == want for v in jdt.values()), jdt
    cfg = EngineConfig()
    assert storage_dtype(cfg.mask_dtype, device) == dtype
    assert storage_dtype(cfg.stems_stack_dtype, device) == dtype
    assert storage_dtype(cfg.wiener.out_dtype, device) == dtype
    assert wiener_out_dtype(cfg.wiener, device) == dtype
    # the planner's stack term: 2 bytes a sample on the card, as the JAX
    # planner's on an accelerator
    assert memory._stems_itemsize(cfg, device) == jmemory._stems_itemsize(jcfg) == dtype.itemsize
    for choice, explicit in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        assert storage_dtype(choice, device) == explicit
    # the einsum path gives float32 whatever out_dtype resolves to
    assert wiener_out_dtype(WienerConfig(impl="einsum"), device) == torch.float32


@pytest.fixture(scope="module")
def spec_data():
    rng = np.random.default_rng(21)
    T, F, S = 12, 33, 4
    mix = (rng.standard_normal((2, T, F)) + 1j * rng.standard_normal((2, T, F))).astype(
        np.complex64)
    masks = rng.uniform(0, 1, (S, 1, T, F)).astype(np.float32)
    masks = masks / masks.sum(0, keepdims=True)
    mags = (masks * np.abs(mix)[None]).astype(np.float32)
    net = np.concatenate([masks[:, 0], 0.7 * masks[:, 0]], axis=-1)  # (S, T, 2F)
    return mix, mags, net


@pytest.mark.parametrize("iterations", [1, 2])
@pytest.mark.parametrize("entry", ["planes", "masks"])
def test_wiener_out_dtype_bfloat16(spec_data, iterations, entry):
    """``out_dtype="bfloat16"`` gives bf16 y planes from the fused path
    (``tests/test_wiener.py``'s case), within 1e-2 of the scale of the
    float32 planes, and equal to the JAX package's bf16 planes but for
    rare rounding flips of one bf16 step."""
    mix, mags, net = spec_data
    xre, xim = mix.real.copy(), mix.imag.copy()
    t = [torch.from_numpy(a) for a in (xre, xim, mags if entry == "planes" else net)]
    cfg = WienerConfig(iterations=iterations, out_dtype="bfloat16")
    jcfg = dataclasses.replace(JWienerConfig(iterations=iterations), impl="pallas_interpret",
                               time_block=8, out_dtype="bfloat16")
    if entry == "planes":
        ours = wiener.wiener_filter_planes(*t, cfg)
        f32 = wiener.wiener_filter_planes(*t, dataclasses.replace(cfg, out_dtype="float32"))
        theirs = jwiener.wiener_filter_planes(xre, xim, mags, jcfg)
    else:
        ours = wiener.wiener_filter_masks(*t, 33, cfg)
        f32 = wiener.wiener_filter_masks(*t, 33, dataclasses.replace(cfg, out_dtype="float32"))
        theirs = jwiener.wiener_filter_masks(xre, xim, net, 33, jcfg)
    scale = float(np.abs(mix).max())
    for o, f, j in zip(ours, f32, theirs):
        assert o.dtype == torch.bfloat16 and f.dtype == torch.float32
        assert 0.0 < (o.float() - f).abs().max().item() <= 1e-2 * scale
        o32, j32 = o.float().numpy(), np.asarray(j, np.float32)
        flips = o32 != j32
        assert flips.mean() <= PLANE_FLIPS
        step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(o32), np.abs(j32))[flips])) - 7)
        assert np.all(np.abs(o32 - j32)[flips] <= step)


def test_wiener_impl_einsum_is_the_einsum_path(spec_data, setup):
    """``impl="einsum"`` runs the einsum chain (float32 whatever
    ``out_dtype`` says, as the JAX einsum path), bit-equal to calling it
    directly; "pallas" is the fused passes, as "auto"; and a demix with
    the einsum path is within the port's tolerance of the JAX package's."""
    mix, _, net = spec_data
    xre, xim, m = (torch.from_numpy(a) for a in (mix.real.copy(), mix.imag.copy(), net))
    cfg = WienerConfig(impl="einsum", out_dtype="bfloat16")
    yre, yim = wiener.wiener_filter_masks(xre, xim, m, 33, cfg)
    mag = torch.sqrt(xre * xre + xim * xim)
    y = wiener.wiener_filter(torch.complex(xre, xim), masks_to_planes(m, 33) * mag[None], cfg)
    assert yre.dtype == torch.float32 and torch.equal(yre, y.real) and torch.equal(yim, y.imag)
    fused = wiener.wiener_filter_masks(xre, xim, m, 33, WienerConfig())
    for a, b in zip(fused, wiener.wiener_filter_masks(xre, xim, m, 33, WienerConfig(impl="pallas"))):
        assert torch.equal(a, b)
    jparams, params, audio = setup
    jcfg, tcfg = _cfgs()
    jcfg = dataclasses.replace(jcfg, wiener=JWienerConfig(impl="einsum"))
    tcfg = dataclasses.replace(tcfg, wiener=WienerConfig(impl="einsum"))
    out = Separator(params, tcfg, "cpu").demix_track(audio, seed=3)
    jout = JSeparator(jparams, jcfg).demix_track(audio, seed=3)
    assert float(np.abs(out - jout).max()) <= SLICE_RTOL * float(np.abs(jout).max())


def test_config_values_raise_by_name():
    with pytest.raises(ValueError, match="stream_impl"):
        EngineConfig(stream_impl="scan2")
    for field in ("mask_dtype", "stems_stack_dtype"):
        with pytest.raises(ValueError, match=field):
            EngineConfig(**{field: "float16"})
    with pytest.raises(ValueError, match="out_dtype"):
        WienerConfig(out_dtype="float16")
    with pytest.raises(ValueError, match="pallas_interpret"):
        WienerConfig(impl="pallas_interpret")


@pytest.mark.parametrize("track_secs", [60.0, 420.0])
def test_planner_counts_the_stems_stack_dtype(track_secs):
    """``tests/test_memory.py``'s stack-dtype case: the bf16 stack term is
    half the float32 one, as the JAX planner's, and the bf16 estimate is
    strictly smaller, so the planner fits at least as many tracks."""
    def both(dtype):
        t = memory.fused_track_hbm_bytes(EngineConfig(stems_stack_dtype=dtype), 4, track_secs)
        j = jmemory.fused_track_hbm_bytes(JEngineConfig(stems_stack_dtype=dtype), 4, track_secs)
        return t, j

    (t32, j32), (t16, j16) = both("float32"), both("bfloat16")
    assert t32["ys"] == j32["ys"] and t16["ys"] == j16["ys"] == t32["ys"] // 2
    # "auto" counts the dtype of the device the run uses: float32 on the
    # CPU, bfloat16 on the card (the default device)
    auto = EngineConfig()
    assert memory.fused_track_hbm_bytes(auto, 4, track_secs, device="cpu") == t32
    for dev in (None, "cuda", "cuda:0"):
        assert memory.fused_track_hbm_bytes(auto, 4, track_secs, device=dev) == t16
    assert t16["total"] < t32["total"]
    cap = 80 * 2**30
    assert (memory.suggest_max_batch(EngineConfig(stems_stack_dtype="bfloat16"), track_secs,
                                     hbm_bytes=cap)
            >= memory.suggest_max_batch(auto, track_secs, hbm_bytes=cap, device="cpu"))


def _jax_options():
    return [a for a in jcli.build_parser()._actions if a.option_strings and a.dest != "help"]


@pytest.mark.parametrize("flag", [a.option_strings[0] for a in _jax_options()])
def test_port_parser_accepts_every_jax_option(flag, capsys):
    """Every option of the JAX CLI parses in the port's parser with every
    JAX choice (or a value of its type), to the same value under the same
    name and with the same default; the named TPU-only values are refused
    by argparse, naming the value."""
    action = next(a for a in _jax_options() if a.option_strings[0] == flag)
    port = cli.build_parser()
    assert getattr(port.parse_args(POS), action.dest) == action.default
    if action.nargs == 0:  # a store_true flag
        assert getattr(port.parse_args([*POS, flag]), action.dest) is True
        return
    values = action.choices or [str(action.default)]
    for v in values:
        if v in JAX_ONLY.get(flag, ()):
            with pytest.raises(SystemExit) as e:
                port.parse_args([*POS, flag, v])
            assert e.value.code == 2 and repr(v) in capsys.readouterr().err
            continue
        parsed = getattr(port.parse_args([*POS, flag, v]), action.dest)
        assert parsed == (action.type(v) if action.type else v)


def test_the_refused_values_are_the_named_ones():
    port = {a.option_strings[0]: a for a in cli.build_parser()._actions if a.option_strings}
    for a in _jax_options():
        missing = set(a.choices or ()) - set(port[a.option_strings[0]].choices or ())
        assert missing == JAX_ONLY.get(a.option_strings[0], set()), a.option_strings[0]


@pytest.mark.parametrize("flag, value", [(f, v) for f, vs in PRECISION_FLAGS.items() for v in vs])
def test_precision_flags_build_the_default_config(flag, value):
    """The precision flags select nothing the port computes otherwise: the
    config (and so the program) is the default's for every value."""
    base = cli.engine_config_from_args(cli.build_parser().parse_args(POS))
    args = cli.build_parser().parse_args([*POS, flag, value])
    assert cli.engine_config_from_args(args) == base


@pytest.fixture(scope="module")
def files(tmp_path_factory, setup):
    _, _, audio = setup
    d = tmp_path_factory.mktemp("flags")
    model = str(d / "model.bin.gz")
    write_ggml(model, HIDDEN, synthetic_state_dicts(ModelConfig(hidden_size=HIDDEN), seed=0))
    wav = str(d / "mix.wav")
    wavfile.write(wav, SR, np.ascontiguousarray(audio[:, : int(1.7 * SR)].T))
    return d, model, wav


def _stems(out_dir):
    return np.stack([wavfile.read(os.path.join(out_dir, f"target_{i}.wav"))[1].T
                     for i in range(4)])


FAST = ["--segment-secs", "1.0", "--device", "cpu", "--quiet"]


def test_precision_flags_give_the_default_bits(files):
    d, model, wav = files
    assert cli.main([model, wav, str(d / "default"), *FAST]) == 0
    flags = [x for f, vs in PRECISION_FLAGS.items() for x in (f, vs[-1])]
    assert cli.main([model, wav, str(d / "prec"), *FAST, *flags]) == 0
    assert np.array_equal(_stems(d / "prec"), _stems(d / "default"))


def test_cli_refuses_the_umxcpp_psd_on_the_fused_kernels(files, capsys):
    """rc 2 before any file or device is touched (the JAX CLI's guard)."""
    rc = cli.main(["m.bin", "x.wav", "o", "--wiener-psd", "umxcpp", "--wiener-impl", "pallas"])
    assert rc == 2 and "--wiener-impl einsum" in capsys.readouterr().err
    d, model, wav = files
    assert cli.main([model, wav, str(d / "quirk"), *FAST, "--wiener-psd", "umxcpp",
                     "--wiener-impl", "einsum"]) == 0


@pytest.mark.parametrize("flags", [
    ["--stream-impl", "groups", "--wiener-out-dtype", "float32", "--wiener-impl", "einsum",
     "--chunk-batch", "2"],
    ["--stream-impl", "pipelined", "--mask-dtype", "bfloat16", "--stems-stack-dtype",
     "bfloat16", "--wiener-out-dtype", "bfloat16"],
])
def test_cli_knob_flags_equal_the_separator_api(files, flags):
    """``tests/test_engine.py``'s CLI run of the knob flags: four finite
    stems, the ``Separator``'s with the config the flags build, and within
    the seam gate of the default run."""
    d, model, wav = files
    out = str(d / "knobs")
    assert cli.main([model, wav, out, *FAST, *flags]) == 0
    stems = _stems(out)
    assert np.isfinite(stems).all()
    cfg = cli.engine_config_from_args(cli.build_parser().parse_args([*POS, *FAST, *flags]))
    v = dict(zip(flags[::2], flags[1::2]))
    assert cfg.stream_impl == v["--stream-impl"]
    assert cfg.wiener.out_dtype == v["--wiener-out-dtype"]
    assert cfg.wiener.impl == v.get("--wiener-impl", "auto")
    assert cfg.mask_dtype == v.get("--mask-dtype", "auto")
    mix = wavfile.read(wav)[1].T
    sep = Separator.from_ggml(model, cfg, "cpu")
    assert np.array_equal(stems, sep.demix_track(mix, seed=0))
    if not os.path.isdir(d / "default"):
        assert cli.main([model, wav, str(d / "default"), *FAST]) == 0
    ref = _stems(d / "default")
    assert np.abs(stems - ref).max() <= SEAM_GATE * np.abs(ref).max()
    corr = np.corrcoef(stems.sum(axis=0).ravel(), mix.ravel())[0, 1]
    assert corr >= 0.99
