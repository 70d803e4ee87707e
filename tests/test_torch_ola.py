"""The normalized overlap-add: the port's plain version of the overlap-add
kernel (K7) against the JAX ``overlap_add_normalized`` in Pallas interpret
mode, and the port's ``_normalized_overlap_add`` / ``_overlap_add_chunks``
against the JAX engine's, for every ``ola_impl``.

All exact (``assert_array_equal``): both sides take the same f32 adds, in
the same order, and one multiply or divide per sample."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from umx_tpu.config import EngineConfig as JEngineConfig
from umx_tpu.engine.separator import _normalized_overlap_add as j_normalized_ola
from umx_tpu.engine.separator import _overlap_add_chunks as j_ola_chunks
from umx_tpu.ops.ola_pallas import overlap_add_normalized as j_overlap_add_normalized
from umx_tpu_torch.config import EngineConfig
from umx_tpu_torch.engine.separator import _normalized_overlap_add, _overlap_add_chunks
from umx_tpu_torch.ops import ola, ola_cuda


def _case(n_chunks, mid, seg, stride, seed=0):
    rng = np.random.default_rng(seed)
    ys = rng.standard_normal((n_chunks, *mid, seg)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, seg).astype(np.float32)
    return ys, w, (n_chunks - 1) * stride + seg


def _inv_sw(w, n_chunks, seg, stride, padded_len):
    sw = j_ola_chunks(jnp.broadcast_to(jnp.asarray(w), (n_chunks, seg)), stride, padded_len)
    return np.array(1.0 / sw)


@pytest.mark.parametrize(
    "n_chunks, mid, seg, stride",
    [
        (4, (4, 2), 512, 384),     # M = 8, the JAX package's own case
        (3, (3, 4, 2), 512, 384),  # three batch rows folded: M = 24
        (1, (2,), 512, 384),       # one chunk: no previous tail anywhere
        (3, (2,), 384, 384),       # no overlap: pure re-tiling
        (5, (1,), 640, 320),       # exactly 50 % overlap
    ],
)
def test_plain_ola_matches_jax_interpret(n_chunks, mid, seg, stride):
    ys, w, padded_len = _case(n_chunks, mid, seg, stride)
    inv = _inv_sw(w, n_chunks, seg, stride, padded_len)
    ref = j_overlap_add_normalized(
        jnp.asarray(ys), jnp.asarray(inv), stride, padded_len, impl="pallas", interpret=True
    )
    ours = ola_cuda.overlap_add_normalized(torch.from_numpy(ys), torch.from_numpy(inv), stride,
                                           padded_len)
    assert ours.shape == (*mid, padded_len)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_plain_ola_matches_jax_vmap_fold():
    # the JAX custom_vmap rule folds a batch axis into the kernel's rows;
    # the port folds every leading axis of ys into M the same way
    B, n_chunks, mid, seg, stride = 3, 3, (4, 2), 512, 384
    ys, w, padded_len = _case(n_chunks, (B, *mid), seg, stride, seed=4)
    inv = jnp.asarray(_inv_sw(w, n_chunks, seg, stride, padded_len))
    ref = jax.vmap(
        lambda y: j_overlap_add_normalized(y, inv, stride, padded_len, interpret=True),
        in_axes=1,
    )(jnp.asarray(ys))  # (B, *mid, padded_len)
    ours = ola_cuda.overlap_add_normalized(torch.from_numpy(ys), torch.from_numpy(np.array(inv)),
                                           stride, padded_len)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


@pytest.mark.parametrize("seg, stride", [(512, 128), (64, 48)])
def test_ola_returns_none_where_jax_does(seg, stride):
    # overlap above 50 %, and a stride with no divisor in [128, 4096]
    ys, w, padded_len = _case(3, (2,), seg, stride, seed=3)
    inv = _inv_sw(w, 3, seg, stride, padded_len)
    assert j_overlap_add_normalized(jnp.asarray(ys), jnp.asarray(inv), stride, padded_len,
                                    interpret=True) is None
    assert ola_cuda.overlap_add_normalized(torch.from_numpy(ys), torch.from_numpy(inv), stride,
                                           padded_len) is None


def test_kernel_wrapper_takes_the_plain_route_on_cpu_and_checks_shapes():
    ys, w, padded_len = _case(3, (8,), 512, 384, seed=5)
    ys_t = torch.from_numpy(ys)
    inv = torch.from_numpy(_inv_sw(w, 3, 512, 384, padded_len))
    before = ola_cuda.ola_normalized.launches
    out = ola_cuda.ola_normalized(ys_t, inv, 384)
    assert torch.equal(out, ola.ola_normalized_plain(ys_t, inv, 384))
    assert ola_cuda.ola_normalized.launches == before  # no kernel ran
    with pytest.raises(ValueError, match="inv_sw"):
        ola_cuda.ola_normalized(ys_t, inv[:-1], 384)
    with pytest.raises(ValueError, match="seg - stride"):
        ola_cuda.ola_normalized(ys_t, inv, 200)
    with pytest.raises(TypeError, match="float32"):
        ola_cuda.ola_normalized(ys_t.double(), inv, 384)


_JAX_IMPL = {"auto": "auto", "unroll": "unroll", "xla": "xla", "pallas": "pallas_interpret"}


@pytest.mark.parametrize("impl", ["auto", "unroll", "xla", "pallas"])
@pytest.mark.parametrize("seg, stride", [(512, 384), (512, 128)])
def test_normalized_overlap_add_matches_jax(impl, seg, stride):
    # (512, 128) has 75 % overlap: "pallas" falls back to "unroll" on both
    # sides and "xla" takes the slice-add loop
    n_chunks, mid = 4, (4, 2)
    ys, w, padded_len = _case(n_chunks, mid, seg, stride, seed=6)
    ref = j_normalized_ola(jnp.asarray(ys), jnp.asarray(w), stride, padded_len,
                           JEngineConfig(ola_impl=_JAX_IMPL[impl]))
    ours = _normalized_overlap_add(torch.from_numpy(ys), torch.from_numpy(w), stride, padded_len,
                                   EngineConfig(ola_impl=impl))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


@pytest.mark.parametrize("seg, stride", [(512, 384), (384, 384), (512, 128)])
def test_overlap_add_chunks_matches_jax(seg, stride):
    ys, _, padded_len = _case(3, (4, 2), seg, stride, seed=7)
    ref = j_ola_chunks(jnp.asarray(ys), stride, padded_len)
    ours = _overlap_add_chunks(torch.from_numpy(ys), stride, padded_len)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_ola_impl_rejects_what_the_port_does_not_implement():
    for bad in ("pallas_interpret", "xla_dus", "nope"):
        with pytest.raises(ValueError, match="ola_impl"):
            EngineConfig(ola_impl=bad)
