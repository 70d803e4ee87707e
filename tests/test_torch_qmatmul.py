"""Quantized weights: ``q_mm`` / ``q_einsum_ih`` against the JAX
functions for u8 and u16 payloads, ``quantized_params_from_ggml`` against
the JAX one field by field (planes and the bf16 ``hh`` bit-equal), the
weights carried across with ``quantized_params_from_jax``, and the
quantized mask network of both packages."""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from umx_tpu.config import ModelConfig as JModelConfig
from umx_tpu.io import ggml as jggml
from umx_tpu.models import umx as jumx
from umx_tpu.ops import qmatmul as jq
from umx_tpu_torch.config import ModelConfig
from umx_tpu_torch.engine.memory import params_hbm_bytes
from umx_tpu_torch.config import EngineConfig
from umx_tpu_torch.io import ggml as tggml
from umx_tpu_torch.models import umx as tumx
from umx_tpu_torch.ops import qmatmul as tq
from umx_tpu_torch.ops.quant import quantize

HIDDEN = 32


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rel(ours, ref):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert ours.shape == ref.shape
    return float(np.max(np.abs(ours - ref)) / np.max(np.abs(ref)))


@pytest.mark.parametrize("qtype", [np.uint8, np.uint16])
def test_q_mm_matches_jax(qtype):
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((48, 40)) / 7).astype(np.float32)
    x = rng.standard_normal((3, 11, 48)).astype(np.float32)
    q, scale, offset = quantize(w, qtype)
    ref = jq.q_mm(jnp.asarray(x), jq.qtensor_from_raw(q, scale, offset))
    qt = tq.qtensor_from_raw(q, scale, offset)
    assert len(qt.planes) == (1 if qtype == np.uint8 else 2)
    assert all(p.dtype == torch.bfloat16 for p in qt.planes)
    ours = tq.q_mm(torch.from_numpy(x), qt)
    assert ours.dtype == torch.float32
    # exact products on both sides, f32 sums in another order → 1e-5
    assert _rel(ours.numpy(), ref) <= 1e-5
    # and it is the matmul with the dequantized weight, up to bf16(x)
    dense = x.astype(np.float64) @ (q.astype(np.float64) * np.float32(scale) + np.float32(offset))
    assert _rel(ours.numpy(), dense) <= 1e-2


@pytest.mark.parametrize("qtype", [np.uint8, np.uint16])
def test_q_einsum_ih_matches_jax(qtype):
    rng = np.random.default_rng(1)
    D, T, n_in, G4 = 2, 9, 32, 64
    xs = rng.standard_normal((D, T, n_in)).astype(np.float32)
    raws = [quantize((rng.standard_normal((n_in, G4)) / 5).astype(np.float32), qtype)
            for _ in range(D)]
    ref = jq.q_einsum_ih(jnp.asarray(xs),
                         jq.stack_qtensors([jq.qtensor_from_raw(*r) for r in raws]))
    qt = tq.stack_qtensors([tq.qtensor_from_raw(*r) for r in raws])
    assert qt.shape == (D, n_in, G4) and qt.scale.shape == (D,)
    ours = tq.q_einsum_ih(torch.from_numpy(xs), qt)
    assert ours.shape == (T, D, G4)
    assert _rel(ours.numpy(), ref) <= 1e-5
    # indexing the stacked axis keeps scale and offset with their planes
    one = tq.q_mm(torch.from_numpy(xs[1]), qt[1])
    assert _rel(one.numpy(), np.asarray(ref)[:, 1]) <= 1e-5


@pytest.fixture(scope="module")
def model_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("q") / "model.bin")
    tggml.write_ggml(path, HIDDEN,
                     tumx.synthetic_state_dicts(ModelConfig(hidden_size=HIDDEN), seed=2))
    return path


@pytest.fixture(scope="module")
def both_params(model_file):
    jp = jumx.quantized_params_from_ggml(jggml.read_ggml(model_file, keep_quantized=True))
    tp = tumx.quantized_params_from_ggml(tggml.read_ggml(model_file, keep_quantized=True))
    return jp, tp


def test_read_ggml_keeps_the_payloads(model_file):
    assert tggml.read_ggml(model_file).raw is None
    ours = tggml.read_ggml(model_file, keep_quantized=True)
    ref = jggml.read_ggml(model_file, keep_quantized=True)
    for t in ref.raw:
        assert list(ours.raw[t]) == list(ref.raw[t])
        for name, (q, scale, offset) in ref.raw[t].items():
            oq, oscale, ooffset = ours.raw[t][name]
            assert oq.dtype == q.dtype and np.array_equal(oq, q)
            assert (oscale, ooffset) == (scale, offset)
    with pytest.raises(ValueError, match="keep_quantized"):
        tumx.quantized_params_from_ggml(tggml.read_ggml(model_file))


def _assert_fields_bit_equal(jp, tp):
    for f in dataclasses.fields(tp):
        j, t = getattr(jp, f.name), getattr(tp, f.name)
        if isinstance(t, tq.QTensor):
            assert isinstance(j, jq.QTensor) and len(j.planes) == len(t.planes), f.name
            for pj, pt in zip(j.planes, t.planes):
                assert pt.dtype == torch.bfloat16 and pt.shape == pj.shape, f.name
                assert np.array_equal(pt.float().numpy(), np.asarray(pj.astype(jnp.float32))), f.name
            assert np.array_equal(t.scale.numpy(), np.asarray(j.scale)), f.name
            assert np.array_equal(t.offset.numpy(), np.asarray(j.offset)), f.name
        else:
            assert str(j.dtype) == str(t.dtype).replace("torch.", ""), f.name
            assert np.array_equal(t.float().numpy(), np.asarray(j.astype(jnp.float32))), f.name


def test_quantized_params_from_ggml_bit_equal_to_jax(both_params):
    jp, tp = both_params
    assert tumx.is_quantized(tp) and tp.lstm_hh_w.dtype == torch.bfloat16
    assert len(tp.fc1_w.planes) == 1 and len(tp.fc3_w.planes) == 2
    assert tp.lstm_ih_w.shape == (4, 3, 2, HIDDEN, 2 * HIDDEN)
    _assert_fields_bit_equal(jp, tp)


def test_quantized_params_from_jax_bit_equal(both_params):
    jp, tp = both_params
    carried = tumx.quantized_params_from_jax(jp)
    _assert_fields_bit_equal(jp, carried)
    # resident bytes: counted at the stored size of every tensor
    cfg = EngineConfig(model=ModelConfig(hidden_size=HIDDEN))
    dense = params_hbm_bytes(cfg, tumx.synthetic_params(cfg.model, seed=2))
    assert params_hbm_bytes(cfg, carried) == params_hbm_bytes(cfg, tp) < dense
    with pytest.raises(ValueError, match="quantized"):
        tumx.params_to_state_dicts(tp, cfg.model)


def _x(tcfg):
    rng = np.random.default_rng(7)
    return np.abs(rng.standard_normal((23, tcfg.n_features))).astype(np.float32)


def test_quantized_fc1_against_float64(both_params):
    """The all-positive network input makes x @ q a sum of ~3e5 whose
    scale * acc + offset * rowsum cancels to O(1), so the order of the f32
    sums shows: against the exact float64 value of the same product the
    port is within 2e-4 of max|out| (measured 2e-5), the JAX package on
    the CPU within 1e-3 (measured 1e-4).  That, not a difference between
    the two, bounds every comparison of quantized activations below."""
    jp, tp = both_params
    tcfg = ModelConfig(hidden_size=HIDDEN)
    xin = (torch.from_numpy(_x(tcfg))[None] + tp.input_mean[:, None]) * tp.input_scale[:, None]
    w = tp.fc1_w
    exact = (w.scale.double()[:, None, None] * (xin.to(torch.bfloat16).double() @ w.integers().double())
             + w.offset.double()[:, None, None] * xin.double().sum(-1, keepdim=True)).numpy()
    ours = tq.q_mm(xin, w).numpy()
    import jax

    theirs = jax.vmap(jq.q_mm)(jnp.asarray(xin.numpy()), jp.fc1_w)
    assert _rel(ours, exact) <= 2e-4
    assert _rel(theirs, exact) <= 1e-3


def test_quantized_phases_match_jax_on_the_same_inputs(both_params):
    jp, tp = both_params
    jcfg = JModelConfig(hidden_size=HIDDEN, lstm_impl="pallas_interpret")
    tcfg = ModelConfig(hidden_size=HIDDEN)
    x = _x(tcfg)
    j1 = jumx.umx_pre(jp, jnp.asarray(x), jcfg)
    t1 = tumx.umx_pre(tp, torch.from_numpy(x), tcfg)
    # fc1's f32 sums under cancellation (see above): 1e-3 of max|x1|
    assert _rel(t1.numpy(), j1) <= 1e-3
    x1 = np.array(j1)
    jout, jst = jumx.umx_recurrence(jp, j1, jumx.init_lstm_state(jcfg), jcfg)
    tout, tst = tumx.umx_recurrence(tp, torch.from_numpy(x1), tumx.init_lstm_state(tcfg), tcfg)
    # the input projections round their activations to bf16: a last-bit
    # difference in a layer's output flips some of the next layer's
    # roundings, one part in 256 of one operand each: 2e-3 of max|h|
    assert _rel(tout.numpy(), jout) <= 2e-3
    assert _rel(tst.c.numpy(), jst.c) <= 2e-3
    jm = jumx.umx_post(jp, j1, jout, jcfg)
    tm = tumx.umx_post(tp, torch.from_numpy(x1), torch.from_numpy(np.array(jout)), tcfg)
    # identical inputs round to identical bf16 operands; u16 payloads,
    # f32 sums in another order: 1e-4 of max|mask|
    assert _rel(tm.numpy(), jm) <= 1e-4


@pytest.mark.parametrize("lstm_impl", ["auto", "pallas"])
def test_quantized_forward_matches_jax(both_params, lstm_impl):
    jp, tp = both_params
    jcfg = JModelConfig(hidden_size=HIDDEN, lstm_impl="pallas_interpret")
    tcfg = ModelConfig(hidden_size=HIDDEN, lstm_impl=lstm_impl)
    x = _x(tcfg)
    jm, jst = jumx.umx_forward(jp, jnp.asarray(x), jumx.init_lstm_state(jcfg), jcfg)
    tm, tst = tumx.umx_forward_batched(tp, torch.from_numpy(x)[None],
                                       tumx.init_lstm_state(tcfg, batch=1), tcfg)
    assert tm.shape == (1, 4, 23, tcfg.n_outputs) and tm.dtype == torch.float32
    # End to end the quantized network rounds five stages of activations
    # to bf16, and fc1's 3e-4 difference (the JAX side's f32 sums, see the
    # float64 test) flips about one rounding in fourteen, each one part in
    # 256 of its operand: the two differ by bf16 rounding noise, 7e-3 of
    # max|mask| measured, bound 2e-2.  The phases on the same inputs
    # (above) hold the arithmetic to 1e-3 and tighter.
    assert _rel(tm[0].numpy(), jm) <= 2e-2
    assert _rel(tst.h[0].numpy(), jst.h) <= 2e-2


def _planted(qt, idx, scale=1.0, offset=1.0, swap=False):
    """A copy of a QTensor with a fault in the slice ``idx`` of its stack
    axes: a wrong scale, a wrong (or dropped) offset, hi and lo swapped."""
    sc, of = qt.scale.clone(), qt.offset.clone()
    sc[idx] *= scale
    of[idx] *= offset
    planes = [p.clone() for p in qt.planes]
    if swap:
        planes[0][idx], planes[1][idx] = qt.planes[1][idx], qt.planes[0][idx]
    return tq.QTensor(tuple(planes), sc, of)


@pytest.mark.parametrize("field, idx, fault", [
    ("fc1_w", 0, {"offset": 0.0}),  # offset * rowsum dropped in one target
    ("lstm_ih_w", (0, 1, 0), {"offset": 0.0}),
    ("lstm_ih_w", (2, 0, 1), {"scale": 1.02}),  # one layer, one direction, 2 % off
    ("fc2_w", 1, {"swap": True}),
    ("fc3_w", 3, {"scale": 1.001}),
])
def test_quantized_phase_gates_catch_planted_faults(both_params, field, idx, fault):
    """The gates of the phase test above are tight enough to see a fault in
    one stacked slice of one quantized tensor."""
    jp, tp = both_params
    jcfg = JModelConfig(hidden_size=HIDDEN, lstm_impl="pallas_interpret")
    tcfg = ModelConfig(hidden_size=HIDDEN)
    bad = dataclasses.replace(tp, **{field: _planted(getattr(tp, field), idx, **fault)})
    x = _x(tcfg)
    j1 = jumx.umx_pre(jp, jnp.asarray(x), jcfg)
    jout, _ = jumx.umx_recurrence(jp, j1, jumx.init_lstm_state(jcfg), jcfg)
    x1 = torch.from_numpy(np.array(j1))
    if field == "fc1_w":
        err, gate = _rel(tumx.umx_pre(bad, torch.from_numpy(x), tcfg).numpy(), j1), 1e-3
    elif field == "lstm_ih_w":
        tout, _ = tumx.umx_recurrence(bad, x1, tumx.init_lstm_state(tcfg), tcfg)
        err, gate = _rel(tout.numpy(), jout), 2e-3
    else:
        tm = tumx.umx_post(bad, x1, torch.from_numpy(np.array(jout)), tcfg)
        err, gate = _rel(tm.numpy(), jumx.umx_post(jp, j1, jout, jcfg)), 1e-4
    assert err > gate, f"{field}{idx} {fault}: {err:.3g} passes the gate {gate:.3g}"
