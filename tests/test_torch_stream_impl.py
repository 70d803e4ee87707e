"""The streaming schedules (``EngineConfig.stream_impl`` "groups" and
"pipelined") against the port's scan program and against the JAX arms
(``umx_tpu.engine.separator.demix_fused_stream_groups`` /
``demix_fused_stream_pipelined``, ``umx_tpu.models.umx.
umx_recurrence_pipelined_step``) on the same weights and audio: stems and
final state, a nonzero incoming state, the routing of ``Separator.demix``
(quantized weights keep the scan, the arms never window) and the fleet."""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from umx_tpu.config import EngineConfig as JEngineConfig
from umx_tpu.config import ModelConfig as JModelConfig
from umx_tpu.config import SegmentConfig as JSegmentConfig
from umx_tpu.config import WienerConfig as JWienerConfig
from umx_tpu.engine import separator as jsep
from umx_tpu.models import umx as jumx
from umx_tpu_torch.config import EngineConfig, ModelConfig, SegmentConfig
from umx_tpu_torch.engine import fleet as tfleet
from umx_tpu_torch.engine import separator as tsep
from umx_tpu_torch.models import umx as tumx

HIDDEN = 32
SR = 44100
SEG_SECS = 0.5
N_CHUNKS = 4
# the port's arms against its scan: the JAX tests' tolerance (the schedules
# compute the same arithmetic; on the CPU the port's are bit-equal)
ARM_ATOL = 1e-5
# port against JAX: bf16 recurrence operands, FFT and matmul summation
# order (the port's dense tolerance, tests/test_torch_separator.py)
SLICE_RTOL = 2e-4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfgs(**seg):
    jcfg = JEngineConfig(
        model=JModelConfig(hidden_size=HIDDEN, lstm_impl="pallas_interpret"),
        segment=JSegmentConfig(segment_secs=SEG_SECS, window_chunks=-1, **seg),
        wiener=JWienerConfig(impl="pallas_interpret"),
        shifts=0,
    )
    tcfg = EngineConfig(model=ModelConfig(hidden_size=HIDDEN),
                        segment=SegmentConfig(segment_secs=SEG_SECS, **seg), shifts=0)
    return jcfg, tcfg


def _geometry(tcfg):
    seg = tcfg.segment.segment_samples(SR)
    stride = tcfg.segment.stride_samples(SR)
    return seg, stride, (N_CHUNKS - 1) * stride + seg


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = _cfgs()
    jparams = jumx.synthetic_params(jcfg.model, seed=0)
    seg, stride, padded = _geometry(tcfg)
    rng = np.random.default_rng(3)
    t = np.arange(padded) / SR
    audio = np.stack([0.4 * np.sin(2 * np.pi * 220 * t), 0.3 * np.sin(2 * np.pi * 330 * t)])
    audio = (audio + 0.05 * rng.standard_normal(audio.shape)).astype(np.float32)
    sh = (4, 3, 2, HIDDEN // 2)  # (T#, L, D, G)
    states = {
        "zero": (np.zeros(sh, np.float32), np.zeros(sh, np.float32)),
        "nonzero": tuple((0.1 * rng.standard_normal(sh)).astype(np.float32) for _ in range(2)),
    }
    return jcfg, tcfg, jparams, tumx.params_from_jax(jparams), audio, states


def _tstate(h, c):
    return tumx.LSTMState(h=torch.from_numpy(h)[None].clone(), c=torch.from_numpy(c)[None].clone())


def _jstate(h, c):
    return jumx.LSTMState(h=jnp.asarray(h), c=jnp.asarray(c))


def _port_scan(tcfg, params, audio, state):
    seg, stride, _ = _geometry(tcfg)
    with torch.inference_mode():
        return tsep.demix_fused(params, torch.from_numpy(audio)[None], _tstate(*state), tcfg,
                                N_CHUNKS, seg, stride)


def _close(out, st, ref, ref_st, atol):
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=atol)
    np.testing.assert_allclose(np.asarray(st.h), np.asarray(ref_st.h), atol=atol)
    np.testing.assert_allclose(np.asarray(st.c), np.asarray(ref_st.c), atol=atol)


@pytest.mark.parametrize("chunk_batch", [1, 2, 3, 4, 7])  # 3: a remainder group; 7 > n_chunks
@pytest.mark.parametrize("state", ["zero", "nonzero"])
def test_groups_matches_scan(setup, chunk_batch, state):
    _, tcfg, _, params, audio, states = setup
    seg, stride, _ = _geometry(tcfg)
    ref, ref_st = _port_scan(tcfg, params, audio, states[state])
    with torch.inference_mode():
        out, st = tsep.demix_fused_stream_groups(
            params, torch.from_numpy(audio)[None], _tstate(*states[state]), tcfg, N_CHUNKS, seg,
            stride, chunk_batch)
    _close(out, st, ref, ref_st, ARM_ATOL)


@pytest.mark.parametrize("state", ["zero", "nonzero"])
def test_pipelined_matches_scan(setup, state):
    _, tcfg, _, params, audio, states = setup
    seg, stride, _ = _geometry(tcfg)
    ref, ref_st = _port_scan(tcfg, params, audio, states[state])
    with torch.inference_mode():
        out, st = tsep.demix_fused_stream_pipelined(
            params, torch.from_numpy(audio)[None], _tstate(*states[state]), tcfg, N_CHUNKS, seg,
            stride)
    _close(out, st, ref, ref_st, ARM_ATOL)


def _jax_arm(arm, jcfg, jparams, audio, state, chunk_batch):
    seg, stride, _ = _geometry(jcfg)
    args = (jparams, jnp.asarray(audio), _jstate(*state), jcfg, N_CHUNKS, seg, stride)
    if arm == "groups":
        return jsep.demix_fused_stream_groups(*args, chunk_batch=chunk_batch)
    return jsep.demix_fused_stream_pipelined(*args)


@pytest.mark.parametrize("arm, chunk_batch, state", [
    ("groups", 3, "zero"), ("groups", 3, "nonzero"), ("groups", 7, "zero"),
    ("pipelined", 0, "zero"), ("pipelined", 0, "nonzero"),
])
def test_arm_matches_jax_arm(setup, arm, chunk_batch, state):
    jcfg, tcfg, jparams, params, audio, states = setup
    seg, stride, _ = _geometry(tcfg)
    ref, ref_st = _jax_arm(arm, jcfg, jparams, audio, states[state], chunk_batch)
    with torch.inference_mode():
        a, st = torch.from_numpy(audio)[None], _tstate(*states[state])
        if arm == "groups":
            out, st = tsep.demix_fused_stream_groups(params, a, st, tcfg, N_CHUNKS, seg, stride,
                                                     chunk_batch)
        else:
            out, st = tsep.demix_fused_stream_pipelined(params, a, st, tcfg, N_CHUNKS, seg,
                                                        stride)
    ref = np.asarray(ref)
    peak = float(np.abs(ref).max())
    assert np.abs(out[0].numpy() - ref).max() <= SLICE_RTOL * peak
    for ours, theirs in ((st.h[0], ref_st.h), (st.c[0], ref_st.c)):
        assert np.abs(ours.numpy() - np.asarray(theirs)).max() <= SLICE_RTOL


@pytest.mark.parametrize("layers", [[0], [1], [0, 1], [1, 2], [0, 1, 2]])
def test_pipelined_step_matches_jax_step(setup, layers):
    """S = 1, 2, 3 stacked stages (the fill, steady and drain iterations),
    each stage on its own layer input and state, against the JAX step
    with the merged kernel in interpret mode."""
    jcfg, _, jparams, params, _, _ = setup
    rng = np.random.default_rng(len(layers) + 10 * layers[0])
    n_t, T, H, G = 4, 22, HIDDEN, HIDDEN // 2
    xs = [rng.uniform(-1, 1, (n_t, T, H)).astype(np.float32) for _ in layers]
    hc = [tuple((0.2 * rng.standard_normal((n_t, 2, G))).astype(np.float32) for _ in range(2))
          for _ in layers]
    j_outs, j_states = jumx.umx_recurrence_pipelined_step(
        jparams, [jnp.asarray(x) for x in xs], [(jnp.asarray(h), jnp.asarray(c)) for h, c in hc],
        layers, jcfg.model, interpret=True)
    with torch.inference_mode():
        outs, states = tumx.umx_recurrence_pipelined_step(
            params, [torch.from_numpy(x)[None] for x in xs],
            [(torch.from_numpy(h)[None], torch.from_numpy(c)[None]) for h, c in hc],
            layers, ModelConfig(hidden_size=HIDDEN))
    assert len(outs) == len(states) == len(layers)
    for s in range(len(layers)):
        assert outs[s].shape == (1, n_t, T, 2 * G)
        np.testing.assert_allclose(outs[s][0].numpy(), np.asarray(j_outs[s]), atol=SLICE_RTOL)
        for ours, theirs in zip(states[s], j_states[s]):
            np.testing.assert_allclose(ours[0].numpy(), np.asarray(theirs), atol=SLICE_RTOL)


def test_pipelined_step_equals_the_layers_one_by_one(setup):
    """Stacking stages changes nothing a stage computes: the step over
    layers 0-2 gives each layer's own call of the scan's recurrence layer
    (``umx_recurrence_batched`` over one layer), bit for bit on the CPU."""
    _, _, _, params, _, _ = setup
    rng = np.random.default_rng(5)
    B, n_t, T, G = 2, 4, 22, HIDDEN // 2
    xs = [torch.from_numpy(rng.uniform(-1, 1, (B, n_t, T, HIDDEN)).astype(np.float32))
          for _ in range(3)]
    hc = [tuple(torch.from_numpy((0.2 * rng.standard_normal((B, n_t, 2, G))).astype(np.float32))
                for _ in range(2)) for _ in range(3)]
    mcfg = ModelConfig(hidden_size=HIDDEN, n_lstm_layers=1)
    with torch.inference_mode():
        outs, states = tumx.umx_recurrence_pipelined_step(params, xs, hc, [0, 1, 2],
                                                          ModelConfig(hidden_size=HIDDEN))
        for l in range(3):
            one = dataclasses.replace(
                params, lstm_ih_w=params.lstm_ih_w[:, l : l + 1],
                lstm_hh_w=params.lstm_hh_w[:, l : l + 1], lstm_ih_b=params.lstm_ih_b[:, l : l + 1],
                lstm_hh_b=params.lstm_hh_b[:, l : l + 1])
            ref, st = tumx.umx_recurrence_batched(
                one, xs[l], tumx.LSTMState(h=hc[l][0][:, :, None], c=hc[l][1][:, :, None]), mcfg)
            assert torch.equal(outs[l], ref)
            assert torch.equal(states[l][0], st.h[:, :, 0])
            assert torch.equal(states[l][1], st.c[:, :, 0])


def test_pipelined_step_refuses_what_it_cannot_stack(setup):
    _, _, _, params, _, _ = setup
    x = torch.zeros((1, 4, 3, HIDDEN))
    hc = (torch.zeros((1, 4, 2, HIDDEN // 2)),) * 2
    # a gap, a descending range, an input short of the layers
    for layers, inputs in (([0, 2], [x, x]), ([1, 0], [x, x]), ([0, 1], [x])):
        with pytest.raises(ValueError, match="contiguous"):
            tumx.umx_recurrence_pipelined_step(params, inputs, [hc] * 2, layers,
                                               ModelConfig(hidden_size=HIDDEN))


class _Spy:
    """Counts calls of a module function and passes them on."""

    def __init__(self, monkeypatch, module, name):
        self.calls = 0
        fn = getattr(module, name)

        def wrapped(*a, **kw):
            self.calls += 1
            return fn(*a, **kw)

        monkeypatch.setattr(module, name, wrapped)


@pytest.mark.parametrize("arm, fn", [("groups", "demix_fused_stream_groups"),
                                     ("pipelined", "demix_fused_stream_pipelined")])
def test_knob_routes_separator_demix(setup, monkeypatch, arm, fn):
    jcfg, tcfg, jparams, params, audio, _ = setup
    track = audio[:, : audio.shape[1] - 100]  # 5 chunks as Separator.demix splits it
    ref = tsep.Separator(params, tcfg, "cpu").demix(track)
    spy = _Spy(monkeypatch, tsep, fn)
    scan = _Spy(monkeypatch, tsep, "demix_fused")
    out = tsep.Separator(params, tcfg.replace(stream_impl=arm), "cpu").demix(track)
    assert (spy.calls, scan.calls) == (1, 0)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=ARM_ATOL)
    # and against the JAX Separator routed the same way
    jout = np.asarray(jsep.Separator(jparams, jcfg.replace(stream_impl=arm)).demix(track))
    assert np.abs(out.numpy() - jout).max() <= SLICE_RTOL * float(np.abs(jout).max())
    # one chunk: no schedule to change, the scan runs
    short = track[:, : tcfg.segment.stride_samples(SR) // 2]
    tsep.Separator(params, tcfg.replace(stream_impl=arm), "cpu").demix(short)
    assert (spy.calls, scan.calls) == (1, 1)


def test_quantized_weights_keep_the_scan_under_pipelined(monkeypatch, tmp_path):
    """The pipelined stage stacking needs dense W_ih: quantized weights run
    the scan program and give its bits."""
    from umx_tpu_torch.io.ggml import write_ggml

    _, tcfg = _cfgs()
    path = str(tmp_path / "m.bin")
    write_ggml(path, HIDDEN, tumx.synthetic_state_dicts(tcfg.model, seed=0))
    rng = np.random.default_rng(1)
    track = rng.uniform(-0.5, 0.5, (2, _geometry(tcfg)[2] - 100)).astype(np.float32)
    ref = tsep.Separator.from_ggml(path, tcfg, "cpu", quantized_hbm=True).demix(track)
    spy = _Spy(monkeypatch, tsep, "demix_fused_stream_pipelined")
    sep = tsep.Separator.from_ggml(path, tcfg.replace(stream_impl="pipelined"), "cpu",
                                   quantized_hbm=True)
    assert tumx.is_quantized(sep.params)
    out = sep.demix(track)
    assert spy.calls == 0 and torch.equal(out, ref)
    # the scan that runs in the arm's place windows as the scan does
    windowed = _Spy(monkeypatch, tsep.Separator, "_demix_windowed")
    wcfg = tcfg.replace(segment=dataclasses.replace(tcfg.segment, window_chunks=2))
    ref = tsep.Separator.from_ggml(path, wcfg, "cpu", quantized_hbm=True).demix(track)
    out = tsep.Separator.from_ggml(path, wcfg.replace(stream_impl="pipelined"), "cpu",
                                   quantized_hbm=True).demix(track)
    assert windowed.calls == 2 and spy.calls == 0 and torch.equal(out, ref)
    with pytest.raises(ValueError, match="dense"):
        x = torch.zeros((1, 4, 3, HIDDEN))
        hc = (torch.zeros((1, 4, 2, HIDDEN // 2)),) * 2
        tumx.umx_recurrence_pipelined_step(sep.params, [x], [hc], [0], tcfg.model)


@pytest.mark.parametrize("arm", ["groups", "pipelined"])
def test_arms_never_window(setup, monkeypatch, arm):
    """A track of more chunks than ``window_chunks`` runs as one program
    under the arms (the scan windows it), as in the JAX package.  The
    fleet runs the scan whatever ``stream_impl`` says, so it windows such
    a track under every setting and calls no arm."""
    _, tcfg, _, params, audio, _ = setup
    cfg = tcfg.replace(segment=dataclasses.replace(tcfg.segment, window_chunks=2))
    windowed = _Spy(monkeypatch, tsep.Separator, "_demix_windowed")
    scan_out = tsep.Separator(params, cfg, "cpu").demix(audio)
    assert windowed.calls == 1
    out = tsep.Separator(params, cfg.replace(stream_impl=arm), "cpu").demix(audio)
    assert windowed.calls == 1
    ref = tsep.Separator(params, tcfg.replace(stream_impl=arm), "cpu").demix(audio)
    assert torch.equal(out, ref)
    np.testing.assert_allclose(out.numpy(), scan_out.numpy(), atol=ARM_ATOL)
    arm_fn = _Spy(monkeypatch, tsep, f"demix_fused_stream_{arm}")
    stats = {}
    fleet_out = tfleet.demix_tracks(tsep.Separator(params, cfg.replace(stream_impl=arm), "cpu"),
                                    [audio], stats=stats)
    assert stats["windowed_tracks"] == 1 and windowed.calls == 2 and arm_fn.calls == 0
    stats = {}
    scan_fleet = tfleet.demix_tracks(tsep.Separator(params, cfg, "cpu"), [audio], stats=stats)
    assert stats["windowed_tracks"] == 1
    assert np.array_equal(fleet_out[0], scan_fleet[0])


def test_groups_honours_the_per_target_recurrence(setup):
    """Under ``lstm_impl="pallas"`` the groups arm chains the per-target
    recurrence (K9's plain version on the CPU), as the scan does."""
    _, tcfg, _, params, audio, states = setup
    cfg = tcfg.replace(model=dataclasses.replace(tcfg.model, lstm_impl="pallas"))
    seg, stride, _ = _geometry(cfg)
    ref, ref_st = _port_scan(cfg, params, audio, states["nonzero"])
    with torch.inference_mode():
        out, st = tsep.demix_fused_stream_groups(
            params, torch.from_numpy(audio)[None], _tstate(*states["nonzero"]), cfg, N_CHUNKS,
            seg, stride, 3)
    _close(out, st, ref, ref_st, ARM_ATOL)


def test_groups_over_stacked_tracks(setup):
    """B = 2 stacked tracks, each with its own state row: the groups arm
    gives each track's single-track result."""
    _, tcfg, _, params, audio, states = setup
    seg, stride, _ = _geometry(tcfg)
    two = np.stack([audio, 0.5 * audio[:, ::-1]]).copy()
    h = np.stack([states["zero"][0], states["nonzero"][0]])
    c = np.stack([states["zero"][1], states["nonzero"][1]])
    with torch.inference_mode():
        st = tumx.LSTMState(h=torch.from_numpy(h), c=torch.from_numpy(c))
        for fn, extra in ((tsep.demix_fused_stream_groups, (2,)),
                          (tsep.demix_fused_stream_pipelined, ())):
            out, new = fn(params, torch.from_numpy(two), st, tcfg, N_CHUNKS, seg, stride, *extra)
            for b in range(2):
                one, one_st = tsep.demix_fused(
                    params, torch.from_numpy(two[b : b + 1]),
                    tumx.LSTMState(h=st.h[b : b + 1], c=st.c[b : b + 1]), tcfg, N_CHUNKS, seg,
                    stride)
                np.testing.assert_allclose(out[b : b + 1].numpy(), one.numpy(), atol=ARM_ATOL)
                np.testing.assert_allclose(new.h[b : b + 1].numpy(), one_st.h.numpy(),
                                           atol=ARM_ATOL)
