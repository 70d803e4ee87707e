"""Training through the float32 recurrence (``lstm_impl="scan"``: kernel
K10 with residuals forward, K11 and an f32 ``torch.bmm`` backward; their
plain versions on the CPU) against the JAX package, whose trainer
differentiates through its ``lax.scan``: the layer's VJP against
``jax.vjp`` of ``umx_tpu.models.umx._bilstm_layer``; the plain backward
against autograd through the plain forward; the trainer's loss and every
field's gradient under "scan", "pallas" and "auto" at hidden 36 (G 18,
no multiple of 8, where "auto" is the scan) against
``jax.value_and_grad(umx_tpu.train.mask_loss)`` with the same
``lstm_impl``; one AdamW step against the JAX train step; the sharded
step against the JAX sharded step (which pins the scan).  Also the
resolution of "auto" by width, the planner's buffer under it, K11's
exchange sizes, and the kernels' C entry points against their ctypes
signatures."""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from umx_tpu.config import DSPConfig as JDSPConfig
from umx_tpu.config import ModelConfig as JModelConfig
from umx_tpu.models import umx as jumx
from umx_tpu.parallel import mesh as jmesh
from umx_tpu.train import TrainConfig as JTrainConfig
from umx_tpu.train import init_train_state as jinit_train_state
from umx_tpu.train import make_batch_from_audio as jmake_batch_from_audio
from umx_tpu.train import make_sharded_train_step as jmake_sharded_train_step
from umx_tpu.train import make_train_step as jmake_train_step
from umx_tpu.train import mask_loss as jmask_loss
from umx_tpu_torch import _build
from umx_tpu_torch import train as ttrain
from umx_tpu_torch.config import DSPConfig, EngineConfig, ModelConfig
from umx_tpu_torch.engine import memory
from umx_tpu_torch.models import umx as tumx
from umx_tpu_torch.ops import lstm_cuda as L
from umx_tpu_torch.parallel.mesh import make_mesh

# f32 products of the same operands on both sides, summed in another order
# (measured ≤ 3.3e-7 of each gradient's largest entry at T 40)
LAYER_GTOL = 1e-5
# the loss through three layers and the mask network, f32 on both sides
LOSS_RTOL = 1e-5
GRAD_TOL = 2e-5  # of each field's largest gradient entry
HIDDEN = 36  # G 18: no multiple of 8, so "auto" is the scan on both sides
B, T = 2, 12
LR = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _fields():
    return [f.name for f in dataclasses.fields(tumx.UMXParams)]


# ---- one layer ----------------------------------------------------------------


def _layer_case(G, T_, Bsz, seed, n_in=20):
    rng = np.random.default_rng(seed)
    f = lambda *shape, s=1.0: (s * rng.standard_normal(shape)).astype(np.float32)  # noqa: E731
    return {
        "x": f(Bsz, T_, n_in), "ih_w": f(2, n_in, 4 * G, s=n_in**-0.5),
        "ih_b": f(2, 4 * G, s=0.1), "hh_w": f(2, G, 4 * G, s=G**-0.5),
        "hh_b": f(2, 4 * G, s=0.1), "h0": f(Bsz, 2, G, s=0.5), "c0": f(Bsz, 2, G, s=0.5),
        # cotangents of out (B, T, 2G), hT and cT (B, 2, G)
        "dout": f(Bsz, T_, 2 * G), "dhT": f(Bsz, 2, G), "dcT": f(Bsz, 2, G),
    }


def _jax_layer_vjp(c):
    """``jax.vjp`` of ``_bilstm_layer`` row by row; the weight gradients
    summed over the rows."""
    names = ("x", "ih_w", "ih_b", "hh_w", "hh_b", "h0", "c0")
    total = {n: 0.0 for n in names[1:5]}
    per_row = {n: [] for n in ("x", "h0", "c0")}
    for b in range(c["x"].shape[0]):
        args = [jnp.asarray(c["x"][b]), *(jnp.asarray(c[n]) for n in names[1:5]),
                jnp.asarray(c["h0"][b]), jnp.asarray(c["c0"][b])]
        _, vjp = jax.vjp(lambda *a: jumx._bilstm_layer(*a, "default"), *args)
        g = vjp((jnp.asarray(c["dout"][b]), (jnp.asarray(c["dhT"][b]), jnp.asarray(c["dcT"][b]))))
        for n, gn in zip(names, g):
            if n in total:
                total[n] = total[n] + np.asarray(gn)
            else:
                per_row[n].append(np.asarray(gn))
    return {**total, **{n: np.stack(v) for n, v in per_row.items()}}


def _port_layer_grads(c, layer=None):
    """The port's layer (the projection as the model computes it, then
    :func:`lstm_layer_scan_batched` or ``layer``) under autograd."""
    leaves = {n: torch.from_numpy(c[n]).requires_grad_() for n in
              ("x", "ih_w", "ih_b", "hh_w", "hh_b", "h0", "c0")}
    x = leaves["x"]
    xs = torch.stack([x, x.flip(1)], dim=1)  # (B, D, T, in)
    proj = torch.einsum("bdti,dig->btdg", xs, leaves["ih_w"]) + leaves["ih_b"] + leaves["hh_b"]
    hs, hT, cT = (layer or L.lstm_layer_scan_batched)(
        proj[:, None], leaves["hh_w"][None], leaves["h0"][:, None], leaves["c0"][:, None])
    out = torch.cat([hs[:, 0, :, 0], hs[:, 0, :, 1].flip(1)], dim=-1)
    loss = ((out * torch.from_numpy(c["dout"])).sum() + (hT[:, 0] * torch.from_numpy(c["dhT"])).sum()
            + (cT[:, 0] * torch.from_numpy(c["dcT"])).sum())
    loss.backward()
    return {n: t.grad.numpy() for n, t in leaves.items()}


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@pytest.mark.parametrize("hidden, Bsz", [(32, 1), (32, 3), (36, 2)])
def test_scan_layer_vjp_matches_jax(hidden, Bsz):
    """LSTMScanTrain's gradients (through the model's projection) against
    ``jax.vjp`` of ``_bilstm_layer``: every input's, within 1e-5 of its
    largest entry."""
    c = _layer_case(hidden // 2, 40, Bsz, seed=hidden + Bsz)
    ref, ours = _jax_layer_vjp(c), _port_layer_grads(c)
    errs = {n: _rel(ours[n], ref[n]) for n in ref}
    print(f"scan layer VJP vs jax.vjp (G {hidden // 2}, B {Bsz}):",
          {n: f"{e:.3g}" for n, e in errs.items()})
    assert max(errs.values()) <= LAYER_GTOL, errs


def test_scan_layer_with_bf16_weights_returns_a_bf16_gradient():
    """The quantized parameters' W_hh is bf16: the layer runs it as stored
    and hands back its gradient in bf16 (the f32 product, rounded once)."""
    c = _layer_case(8, 10, 2, seed=3)
    hh = torch.from_numpy(c["hh_w"]).to(torch.bfloat16).requires_grad_()
    xp = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 1, 10, 2, 32)).astype(
        np.float32))
    hs, _, _ = L.lstm_layer_scan_batched(xp, hh[None], torch.zeros(2, 1, 2, 8),
                                         torch.zeros(2, 1, 2, 8))
    hs.sum().backward()
    assert hh.grad.dtype == torch.bfloat16 and bool(torch.isfinite(hh.grad.float()).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_backward_matches_autograd_through_the_plain_forward(dtype):
    """``lstm_scan_bwd_step_plain`` + ``lstm_scan_dw`` against autograd
    through ``lstm_scan_plain`` on the same cotangents, and K10's residuals
    are what the forward computed (hs/hT/cT its bits)."""
    g = torch.Generator().manual_seed(5)
    T_, R, Bsz, G = 9, 3, 2, 6
    xp = torch.randn((T_, R * Bsz, 4 * G), generator=g)
    whh = (torch.randn((R, G, 4 * G), generator=g) / G**0.5).to(dtype)
    h0, c0 = 0.5 * torch.randn((2, R * Bsz, G), generator=g)
    dhs, dhT, dcT = torch.randn((T_, R * Bsz, G), generator=g), *torch.randn(
        (2, R * Bsz, G), generator=g)
    hs, hT, cT, gates, cs = L.lstm_scan_train_fwd(xp, whh, h0, c0, Bsz)
    for a, b in zip((hs, hT, cT), L.lstm_scan(xp, whh, h0, c0, Bsz)):
        assert torch.equal(a, b)
    dxp, dh0, dc0 = L.lstm_scan_bwd_step(gates, cs, c0, whh, dhs, dhT, dcT, Bsz)
    dw = L.lstm_scan_dw(hs, h0, dxp, Bsz)

    leaves = [t.clone().requires_grad_() for t in (xp, whh.float(), h0, c0)]
    out = L.lstm_scan_plain(*leaves, Bsz)
    ((out[0] * dhs).sum() + (out[1] * dhT).sum() + (out[2] * dcT).sum()).backward()
    for name, ours, t in zip(("dxp", "dW", "dh0", "dc0"), (dxp, dw, dh0, dc0), leaves):
        err = float((ours - t.grad).abs().max()) / float(t.grad.abs().max())
        assert err <= 1e-5, (name, err)


def test_bwd_wrapper_checks_and_counts():
    g = torch.Generator().manual_seed(2)
    T_, R, Bsz, G = 4, 2, 1, 8
    gates, cs = torch.rand((T_, R, 4 * G), generator=g), torch.rand((T_, R, G), generator=g)
    c0, dhT, dcT = torch.zeros((3, R, G))
    whh, dhs = torch.rand((R, G, 4 * G), generator=g), torch.rand((T_, R, G), generator=g)
    before = (L.lstm_scan_bwd_step.launches, L.lstm_scan_train_fwd.launches)
    L.lstm_scan_bwd_step(gates, cs, c0, whh, dhs, dhT, dcT, Bsz)
    assert (L.lstm_scan_bwd_step.launches, L.lstm_scan_train_fwd.launches) == before  # CPU: plain
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        L.lstm_scan_bwd_step(gates, cs, c0, whh.half(), dhs, dhT, dcT, Bsz)
    with pytest.raises(ValueError, match="dhs must be"):
        L.lstm_scan_bwd_step(gates, cs, c0, whh, dhs[:1], dhT, dcT, Bsz)


# ---- the trainer against the JAX trainer ----------------------------------------


@pytest.fixture(scope="module")
def jparams():
    return jumx.synthetic_params(JModelConfig(hidden_size=HIDDEN), seed=0)


@pytest.fixture(scope="module")
def batch_np():
    rng = np.random.default_rng(17)
    cfg = ModelConfig(hidden_size=HIDDEN)
    return {
        "x": rng.uniform(0, 1, (B, T, cfg.n_features)).astype(np.float32),
        "mix_mag": rng.uniform(0, 1, (B, 2, T, cfg.n_bins)).astype(np.float32),
        "target_mag": rng.uniform(0, 1, (B, 4, 2, T, cfg.n_bins)).astype(np.float32),
    }


def _torch_batch(batch_np):
    return {k: torch.from_numpy(v) for k, v in batch_np.items()}


@pytest.mark.parametrize("impl", ["scan", "pallas", "auto"])
def test_mask_loss_and_gradients_match_the_jax_trainer(jparams, batch_np, impl, monkeypatch):
    """The port's ``mask_loss`` and every field's gradient under ``impl``
    against ``jax.value_and_grad(umx_tpu.train.mask_loss)`` with the same
    value (the JAX trainer runs its scan for all three on the CPU; the
    port lowers "pallas" to "scan" and resolves "auto" to it at G 18).
    Measured: the same loss (0 relative), gradients ≤ 3.9e-7 of max|g|."""
    jcfg = JModelConfig(hidden_size=HIDDEN, lstm_impl=impl)
    jl, jg = jax.value_and_grad(jmask_loss)(
        jparams, {k: jnp.asarray(v) for k, v in batch_np.items()}, jcfg)

    cfg = ModelConfig(hidden_size=HIDDEN, lstm_impl=impl)
    calls = []
    bwd = L.lstm_scan_bwd_step
    monkeypatch.setattr(L, "lstm_scan_bwd_step", lambda *a: calls.append(1) or bwd(*a))
    params = tumx.params_from_jax(jparams)
    for n in _fields():
        getattr(params, n).requires_grad_(True)
    loss = ttrain.mask_loss(params, _torch_batch(batch_np), cfg)
    loss.backward()
    assert len(calls) == cfg.n_lstm_layers  # the float32 sweep, never K5
    rel = abs(loss.item() - float(jl)) / abs(float(jl))
    errs = {}
    for n in _fields():
        ours = getattr(params, n).grad.numpy().astype(np.float64)
        ref = np.asarray(getattr(jg, n), np.float64)
        assert ours.shape == ref.shape, n
        errs[n] = float(np.max(np.abs(ours - ref)) / np.max(np.abs(ref)))
    print(f"lstm_impl {impl}: loss {rel:.3g} relative; worst gradient "
          f"{max(errs, key=errs.get)} {max(errs.values()):.3g} of max|g|")
    assert rel <= LOSS_RTOL
    assert max(errs.values()) <= GRAD_TOL, errs


def test_one_adamw_step_matches_the_jax_train_step(jparams, batch_np):
    """One train step under "scan" on both sides.  Adam's first update is
    about lr·sign(g), so an element whose gradient is at the rounding level
    may move either way: such elements are held to 2·lr, every element with
    a gradient above 1e-4 of its field's largest to 1e-6 (f32 updates of
    the same size).  The loss of the updated parameters on the batch:
    1e-5 relative."""
    jcfg = JModelConfig(hidden_size=HIDDEN, lstm_impl="scan")
    jb = {k: jnp.asarray(v) for k, v in batch_np.items()}
    _, jg = jax.value_and_grad(jmask_loss)(jparams, jb, jcfg)
    jstate, _ = jmake_train_step(jcfg, JTrainConfig(learning_rate=LR))(
        jinit_train_state(jparams, JTrainConfig(learning_rate=LR)), jb)

    cfg = ModelConfig(hidden_size=HIDDEN, lstm_impl="scan")
    state = ttrain.init_train_state(tumx.params_from_jax(jparams),
                                    ttrain.TrainConfig(learning_rate=LR))
    state, _ = ttrain.make_train_step(cfg)(state, _torch_batch(batch_np))
    for n in _fields():
        ours = getattr(state.params, n).detach().numpy()
        ref = np.asarray(getattr(jstate.params, n))
        g = np.abs(np.asarray(getattr(jg, n)))
        clear = g > 1e-4 * max(float(g.max()), 1e-30)
        assert np.max(np.abs(ours - ref), initial=0.0) <= 2 * LR + 1e-7, n
        assert np.max(np.abs(ours - ref)[clear], initial=0.0) <= 1e-6, n
    ev = ttrain.make_eval_step(cfg)(state.params, _torch_batch(batch_np))
    np.testing.assert_allclose(float(ev), float(jmask_loss(jstate.params, jb, jcfg)), rtol=1e-5)


def test_sharded_step_under_scan_matches_the_jax_sharded_step(monkeypatch):
    """The sharded step under "scan" on the CPU grid (dp 4 x tp 2) runs the
    float32 recurrence, as the JAX sharded step does (it pins the scan):
    the first loss within 1e-6 relative (0 measured: the same loss; the bf16 path is
    held at 1e-5 in tests/test_torch_sharding_train.py)."""
    hidden, seq = 64, 16
    jp = jumx.synthetic_params(JModelConfig(hidden_size=hidden), seed=0)
    rng = np.random.default_rng(53)
    n = DSPConfig().hop * (seq - 1)
    mix = rng.standard_normal((8, 2, n)).astype(np.float32) * 0.1
    targets = rng.standard_normal((8, 4, 2, n)).astype(np.float32) * 0.05

    cfg = ModelConfig(hidden_size=hidden, lstm_impl="scan")
    tcfg = ttrain.TrainConfig(seq_len=seq, learning_rate=LR)
    step, shard_state, shard_batch = ttrain.make_sharded_train_step(
        cfg, tcfg, make_mesh(4, 2, [torch.device("cpu")] * 8), tp=True)
    calls = []
    fwd = L.lstm_scan_train_fwd
    monkeypatch.setattr(L, "lstm_scan_train_fwd", lambda *a: calls.append(1) or fwd(*a))
    state = shard_state(ttrain.init_train_state(tumx.params_from_jax(jp), tcfg))
    _, loss = step(state, shard_batch(ttrain.make_batch_from_audio(
        mix, targets, cfg, DSPConfig(), seq, "cpu")))
    assert len(calls) == 3 * 8  # three layers on each of the 8 grid cells

    mesh = jmesh.make_mesh(dp=4, tp=2)
    jcfg, jtcfg = JModelConfig(hidden_size=hidden), JTrainConfig(seq_len=seq, learning_rate=LR)
    with mesh:
        jstep, jshard_state, jshard_batch = jmake_sharded_train_step(jcfg, jtcfg, mesh, tp=True)
        _, jloss = jstep(jshard_state(jinit_train_state(jp, jtcfg)),
                         jshard_batch(jmake_batch_from_audio(mix, targets, jcfg, JDSPConfig(), seq)))
    rel = abs(float(loss) - float(jloss)) / abs(float(jloss))
    print(f"sharded step under scan: first loss {rel:.3g} relative to the JAX sharded step")
    assert rel <= 1e-6


# ---- "auto" by width, the planner, the kernels' plans and entry points ---------


# "auto" is the merged kernel at every G % 8 == 0 (resident, wide or
# streaming), as the JAX package's "auto" on its accelerator; the scan only
# where G % 8 != 0 (a departure kept on purpose)
@pytest.mark.parametrize("impl, G, want", [
    ("auto", 512, "auto"), ("auto", 256, "auto"), ("auto", 8, "auto"), ("auto", 640, "auto"),
    ("auto", 18, "scan"), ("auto", 516, "scan"), ("pallas_merged", 640, "pallas_merged"),
    ("scan", 256, "scan"), ("pallas", 18, "pallas"), ("auto", 520, "auto"),
    ("auto", 1024, "auto"), ("auto", 2048, "auto"), ("auto", 644, "scan"),
    ("scan", 640, "scan"),
])
def test_auto_resolves_to_the_scan_where_k1_cannot_hold_the_width(impl, G, want):
    assert tumx.resolve_lstm_impl(impl, G) == want


def test_auto_at_hidden_1280_trains_through_the_scan(monkeypatch):
    """A model wider than UMX-L (G 640) under "auto": the recurrence and
    its gradient go through the merged training kernels (on the card K4
    and K5 in their wide block forms, and K6; plain versions here, hidden
    1280 at 3 frames), never the float32 ones, as JAX's "auto" runs its
    merged kernel at every width on its accelerator."""
    cfg = ModelConfig(hidden_size=1280)
    for name in ("lstm_scan", "lstm_scan_train_fwd", "lstm_scan_bwd_step"):
        monkeypatch.setattr(L, name, lambda *a, n=name: pytest.fail(f"{n} ran at G 640"))
    calls = []
    bwd = L.lstm_merged_bwd_step
    monkeypatch.setattr(L, "lstm_merged_bwd_step", lambda *a: calls.append(a[3].shape) or bwd(*a))
    params = tumx.synthetic_params(cfg, seed=0)
    params.lstm_hh_w.requires_grad_(True)
    x1 = torch.zeros((1, 4, 3, 1280))
    out, _ = tumx.umx_recurrence_batched(params, x1, tumx.init_lstm_state(cfg, batch=1), cfg)
    out.sum().backward()
    assert calls == [(8, 640, 2560)] * 3
    assert torch.isfinite(params.lstm_hh_w.grad).all()


def test_planner_counts_the_scan_buffer_under_auto_at_hidden_1280():
    """Under "auto" at hidden 1280 the planner counts K1's exchange (two
    bf16 values of h a word), under "scan" K10's (one f32 value a word)."""
    auto = EngineConfig(model=ModelConfig(hidden_size=1280))
    scan = auto.replace(model=dataclasses.replace(auto.model, lstm_impl="scan"))
    merged = auto.replace(model=dataclasses.replace(auto.model, lstm_impl="pallas_merged"))
    assert (memory.segment_batch_hbm_bytes(auto, 1)["fixed"]
            == memory.segment_batch_hbm_bytes(merged, 1)["fixed"])
    assert memory._lstm_exchange_bytes(auto) == 8 * L.resident_exchange_words(8, 640)
    assert memory._lstm_exchange_bytes(scan) == 8 * L.scan_exchange_words(8, 640)
    assert (memory.segment_batch_hbm_bytes(scan, 1)["fixed"]
            - memory.segment_batch_hbm_bytes(auto, 1)["fixed"]
            == 8 * (L.scan_exchange_words(8, 640) - L.resident_exchange_words(8, 640)))


def test_bwd_exchange_sizes():
    # per chain and step parity, 16 rows of G partial sums from each of the
    # chain's ceil(G/32) blocks
    assert L.scan_bwd_exchange_words(8, 512) == 8 * 2 * 16 * 16 * 512
    assert L.scan_bwd_exchange_words(8, 640) == 8 * 2 * 16 * 20 * 640
    assert L.scan_bwd_exchange_words(1, 18) == 2 * 16 * 18


@pytest.mark.parametrize("G", [18, 256, 512])
def test_k11_resident_roles_cover_every_unit_and_pair_once(G):
    """K11's resident roles: thread tid owns units tid and tid + 256 of the
    chain in the product (every unit of G once) and the (unit, row) pairs
    e = tid + 256 m, unit e % 32 and row e // 32 of the block, in the cell
    (every one of the block's 32 units x 16 rows once)."""
    units = [tid + 256 * m for tid in range(256) for m in range(2) if tid + 256 * m < G]
    assert sorted(units) == list(range(G))
    pairs = [(e % 32, e // 32) for tid in range(256) for m in range(2) for e in [tid + 256 * m]]
    assert sorted(pairs) == sorted((j, b) for j in range(32) for b in range(16))


_C_TYPES = {"int": "I", "unsigned": "U", "float": "F"}


def _c_entry_points():
    """{name: argument kinds} of every ``extern "C"`` function in csrc/:
    "P" for a pointer, else the C type's letter."""
    out = {}
    for src in sorted(_build.CSRC.glob("*.cu")):
        text = Path(src).read_text()
        for name, args in re.findall(r'extern "C" \w+\*? (\w+)\(([^)]*)\)', text):
            kinds = []
            for a in (x.strip() for x in args.split(",") if x.strip()):
                kinds.append("P" if "*" in a else _C_TYPES[a.split()[-2]])
            out[name] = kinds
    return out


def test_every_entry_point_has_its_ctypes_signature():
    """The signatures ``_build`` binds with ctypes against the C sources
    (the build runs only on the card: a wrong count or type would pass a
    pointer as an int there)."""
    letters = {_build._P: "P", _build._I: "I", _build._U: "U", _build._F: "F"}
    entries = _c_entry_points()
    for name, argtypes in _build._SIGNATURES.items():
        assert entries[name] == [letters[a] for a in argtypes], name
    assert {"umx_lstm_scan_train", "umx_lstm_scan_bwd", "umx_lstm_scan_bwd_capacity"} <= set(
        _build._SIGNATURES)
