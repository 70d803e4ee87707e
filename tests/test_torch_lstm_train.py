"""The training path of the merged BLSTM layer: the plain residual forward
and plain backward (the CPU versions of kernels K4, K5 and K6) and the
``LSTMMergedTrain`` autograd Function, against ``jax.vjp`` of the JAX
package's custom-VJP kernels (Pallas interpret mode)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from umx_tpu.ops.lstm_pallas import lstm_layer_pallas_merged_batched
from umx_tpu_torch.ops import lstm_cuda

# (B, T#, T, D, G, time_block): T not a multiple of the TPU time block, so
# the reference runs a partial last block
SHAPES = [(2, 2, 11, 2, 8, 4), (3, 4, 37, 2, 32, 8)]

# Both sides round h, W_hh and the gate cotangents to bf16 before each
# product and accumulate in f32; they differ in f32 summation order, which
# now and then flips one bf16 rounding.  Measured max|Δ|/max|ref| ≤ 4.4e-5
# (dW at the larger shape), so the bound is 1e-4.
RTOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(B, Tn, T, D, G, seed):
    rng = np.random.default_rng(seed)

    def mk(*shape, a=1.0):
        return (a * rng.standard_normal(shape)).astype(np.float32)

    prim = (mk(B, Tn, T, D, 4 * G, a=0.5), mk(Tn, D, G, 4 * G, a=G**-0.5),
            mk(B, Tn, D, G, a=0.5), mk(B, Tn, D, G, a=0.5))
    cts = (mk(B, Tn, T, D, G), mk(B, Tn, D, G), mk(B, Tn, D, G))
    return prim, cts


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: "B%d_T%d_G%d" % (s[0], s[2], s[4]))
def case(request):
    """Inputs, cotangents and the JAX reference (primal outputs and vjp)."""
    B, Tn, T, D, G, tb = request.param
    prim, cts = _inputs(B, Tn, T, D, G, seed=T)

    def f(*a):
        return lstm_layer_pallas_merged_batched(*a, time_block=tb, interpret=True)

    out, vjp = jax.vjp(f, *map(jnp.asarray, prim))
    grads = vjp(tuple(map(jnp.asarray, cts)))
    return dict(
        B=B, prim=prim, cts=cts,
        ref_out=[np.asarray(o) for o in out], ref_grads=[np.asarray(g) for g in grads],
    )


def _assert_normwise(ours, ref, rtol, what):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert ours.shape == ref.shape, what
    err = np.max(np.abs(ours - ref)) / np.max(np.abs(ref))
    assert err <= rtol, f"{what}: normwise error {err:.3g} > {rtol}"


def _to_rows(x, B):
    """(B, T#, [T,] D, W) batched layout → (…, R*B, W) chain-major rows."""
    x = torch.from_numpy(x)
    if x.dim() == 5:  # (B, T#, T, D, W) → (T, R*B, W)
        return x.permute(2, 1, 3, 0, 4).reshape(x.shape[2], -1, x.shape[4]).contiguous()
    return x.permute(1, 2, 0, 3).reshape(-1, x.shape[3]).contiguous()  # (B, T#, D, W)


def _from_rows(x, B, Tn, D):
    if x.dim() == 3:  # (T, R*B, W) → (B, T#, T, D, W)
        return x.view(x.shape[0], Tn, D, B, x.shape[2]).permute(3, 1, 0, 2, 4)
    return x.view(Tn, D, B, x.shape[1]).permute(2, 0, 1, 3)


def test_plain_forward_and_backward_match_jax_vjp(case):
    B = case["B"]
    x_proj, hh_w, h0, c0 = case["prim"]
    Tn, D, G = hh_w.shape[0], hh_w.shape[1], hh_w.shape[2]
    whh = torch.from_numpy(hh_w).reshape(Tn * D, G, 4 * G).to(torch.bfloat16)
    h0r, c0r = _to_rows(h0, B), _to_rows(c0, B)
    hs, hT, cT, gates, cs = lstm_cuda.lstm_merged_train_fwd_plain(
        _to_rows(x_proj, B), whh, h0r, c0r, B
    )
    for name, o, r in zip(("hs", "hT", "cT"), (hs, hT, cT), case["ref_out"]):
        _assert_normwise(_from_rows(o, B, Tn, D).numpy(), r, RTOL, name)
    # the residuals are the activated gates and c of every step
    assert gates.shape == (hs.shape[0], hs.shape[1], 4 * G) and cs.shape == hs.shape
    np.testing.assert_array_equal(cs[-1].numpy(), cT.numpy())
    assert float(gates[..., : 2 * G].min()) >= 0.0 and float(gates[..., : 2 * G].max()) <= 1.0

    dhs, dhT, dcT = (_to_rows(c, B) for c in case["cts"])
    dxp, dw, dh0, dc0 = lstm_cuda.lstm_merged_bwd_plain(
        gates, cs, hs, h0r, c0r, whh, dhs, dhT, dcT, B
    )
    ours = (_from_rows(dxp, B, Tn, D), dw.view(Tn, D, G, 4 * G),
            _from_rows(dh0, B, Tn, D), _from_rows(dc0, B, Tn, D))
    for name, o, r in zip(("dxp", "dW", "dh0", "dc0"), ours, case["ref_grads"]):
        assert o.dtype == torch.float32
        _assert_normwise(o.numpy(), r, RTOL, name)


def _graph_nodes(fn):
    """Names of the autograd nodes reachable from ``fn``."""
    names, todo = set(), [fn]
    while todo:
        node = todo.pop()
        if node is not None and type(node).__name__ not in names:
            names.add(type(node).__name__)
            todo.extend(n for n, _ in node.next_functions)
    return names


def _autograd_through_layer(prim, cts):
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in prim]
    hs, hT, cT = lstm_cuda.lstm_layer_merged_batched(*leaves)
    assert "LSTMMergedTrainBackward" in _graph_nodes(hs.grad_fn)
    loss = sum((o * torch.from_numpy(c)).sum() for o, c in zip((hs, hT, cT), cts))
    return (hs, hT, cT), torch.autograd.grad(loss, leaves)


def test_autograd_function_matches_jax_vjp(case):
    outs, grads = _autograd_through_layer(case["prim"], case["cts"])
    for name, o, r in zip(("hs", "hT", "cT"), outs, case["ref_out"]):
        _assert_normwise(o.detach().numpy(), r, RTOL, name)
    for name, g, r in zip(("dxp", "dhh", "dh0", "dc0"), grads, case["ref_grads"]):
        assert g.dtype == torch.float32  # the f32 hh_w gets an f32 gradient
        _assert_normwise(g.numpy(), r, RTOL, name)


def test_autograd_function_matches_autograd_of_the_plain_recurrence(case):
    """An independent check: autograd through the plain inference
    recurrence.  Its backward rounds the dh carry to bf16 at every step
    (the backward of ``.to(bfloat16)``) where the kernels keep it f32, so
    the two differ by bf16 rounding: within 2 % of max|ref|, the class of
    tests/test_lstm_vjp.py."""
    B = case["B"]
    x_proj, hh_w, h0, c0 = case["prim"]
    Tn, D, G = hh_w.shape[0], hh_w.shape[1], hh_w.shape[2]
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in case["prim"]]
    xp = leaves[0].permute(2, 1, 3, 0, 4).reshape(x_proj.shape[2], -1, 4 * G)
    whh = leaves[1].reshape(Tn * D, G, 4 * G).to(torch.bfloat16)
    h0r = leaves[2].permute(1, 2, 0, 3).reshape(-1, G)
    c0r = leaves[3].permute(1, 2, 0, 3).reshape(-1, G)
    hs, hT, cT = lstm_cuda.lstm_merged_plain(xp, whh, h0r, c0r, B)
    outs = (_from_rows(hs, B, Tn, D), _from_rows(hT, B, Tn, D), _from_rows(cT, B, Tn, D))
    loss = sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, case["cts"]))
    ref = torch.autograd.grad(loss, leaves)
    _, ours = _autograd_through_layer(case["prim"], case["cts"])
    for name, o, r in zip(("dxp", "dhh", "dh0", "dc0"), ours, ref):
        _assert_normwise(o.numpy(), r.numpy(), 0.02, name)


def test_no_grad_runs_the_inference_kernel(monkeypatch):
    prim, _ = _inputs(2, 2, 5, 2, 8, seed=0)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in prim]

    def refuse(*a):
        raise AssertionError("LSTMMergedTrain built under no_grad")

    monkeypatch.setattr(lstm_cuda.LSTMMergedTrain, "apply", refuse)
    with torch.no_grad():
        hs, hT, cT = lstm_cuda.lstm_layer_merged_batched(*leaves)
    assert hs.grad_fn is None and not hs.requires_grad
    # no input that requires grad: the inference route too, grad mode or not
    hs2, _, _ = lstm_cuda.lstm_layer_merged_batched(*map(torch.from_numpy, prim))
    assert torch.equal(hs, hs2)
    with pytest.raises(AssertionError, match="no_grad"):
        lstm_cuda.lstm_layer_merged_batched(*leaves)


def test_train_wrappers_check_arguments_and_route_cpu():
    T, R, B, G = 4, 2, 3, 8
    xp = torch.zeros((T, R * B, 4 * G))
    whh = torch.zeros((R, G, 4 * G), dtype=torch.bfloat16)
    h0 = torch.zeros((R * B, G))
    counts = [f.launches for f in (lstm_cuda.lstm_merged_train_fwd,
                                   lstm_cuda.lstm_merged_bwd_step, lstm_cuda.lstm_merged_dw)]
    hs, hT, cT, gates, cs = lstm_cuda.lstm_merged_train_fwd(xp, whh, h0, h0, B)
    dxp, dh0, dc0 = lstm_cuda.lstm_merged_bwd_step(gates, cs, h0, whh, hs, h0, h0, B)
    dw = lstm_cuda.lstm_merged_dw(hs, h0, dxp, B)
    assert dxp.shape == gates.shape and dw.shape == whh.shape and dh0.shape == (R * B, G)
    # the CPU route runs the plain versions and launches nothing
    assert counts == [f.launches for f in (lstm_cuda.lstm_merged_train_fwd,
                                           lstm_cuda.lstm_merged_bwd_step,
                                           lstm_cuda.lstm_merged_dw)]
    with pytest.raises(TypeError, match="bfloat16"):
        lstm_cuda.lstm_merged_bwd_step(gates, cs, h0, whh.float(), hs, h0, h0, B)
    with pytest.raises(ValueError, match="dhs"):
        lstm_cuda.lstm_merged_bwd_step(gates, cs, h0, whh, hs[:-1], h0, h0, B)
    with pytest.raises(ValueError, match="contiguous"):
        lstm_cuda.lstm_merged_dw(hs, h0, dxp.transpose(0, 1).contiguous().transpose(0, 1), B)
    with pytest.raises(ValueError, match="R\\*B"):
        lstm_cuda.lstm_merged_train_fwd(xp, whh, h0, h0, 2)
