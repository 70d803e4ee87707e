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


# ---------------------------------------------------------------------------
# A numpy mirror of the kernel's work split and index map (csrc/ola.cu)
# ---------------------------------------------------------------------------

H100_BLOCKS = 132  # one block on each of an H100 SXM's SMs


def _warp_share(w: int, n_warps: int, L: int, V: int) -> tuple[int, int]:
    """The samples [a, b) that warp ``w`` of ``n_warps`` owns in every row
    (ola.cu's kernel): an equal share of the L // V vectors."""
    units = L // V
    return (w * units // n_warps) * V, ((w + 1) * units // n_warps) * V


def _runs(a: int, b: int, n_chunks: int, stride: int) -> list[tuple[int, int, int]]:
    """A warp's share cut into runs (k, first, end) that never cross a
    chunk boundary (ola_share's loop): the samples [first, end) lie in
    chunk k's stride, or, with k = n_chunks, in the last chunk's tail."""
    runs, n = [], a
    while n < b:
        k = n // stride
        e = min(b, (k + 1) * stride) if k < n_chunks else b
        runs.append((k, n, e))
        n = e
    return runs


def _value(flat):
    """The ys element at a flat index (n_chunks, M, seg): float32 values
    with full mantissas over eight binades (so that a sum rounds), made
    from the index so that no row of a large case needs to be held."""
    h = (flat.astype(np.uint64) * np.uint64(2654435761)) % np.uint64(2**32)
    mant = (h & np.uint64(0xFFFFFF)).astype(np.float64) / 2**24 - 0.5
    return (mant * np.exp2((h >> np.uint64(24)).astype(np.float64) % 8 - 3)).astype(np.float32)


def _kernel_mirror(n_chunks, M, seg, stride, inv_sw, rows, V, grid):
    """What the kernel writes to the given rows: the warps' shares, cut into
    runs at chunk boundaries, walked a vector at a time (lane i % 32 takes a
    run's i-th vector), rows inside."""
    L = inv_sw.shape[0]
    tail = seg - stride
    n_warps = ola_cuda.ola_blocks(L, V, grid) * ola_cuda.WARPS
    runs = [run for w in range(n_warps)
            for run in _runs(*_warp_share(w, n_warps, L, V), n_chunks, stride)]
    ks, firsts, ends = (np.array(c, np.int64) for c in zip(*runs))
    assert np.all((ends - firsts) % V == 0) and np.all(firsts % V == 0)  # whole vectors
    # every sample once, in every row: the runs tile [0, L) in order
    assert firsts[0] == 0 and ends[-1] == L and np.array_equal(firsts[1:], ends[:-1])
    k = np.repeat(ks, ends - firsts)  # the run's k, computed once a run
    s = np.arange(L)
    j = s - k * stride
    assert np.all((0 <= j) & (j < np.where(k < n_chunks, stride, tail)))
    vec_start = s - (s - np.repeat(firsts, ends - firsts)) % V
    has_prev = (k > 0) & (vec_start - k * stride < tail)  # tested once a vector
    assert np.array_equal(has_prev, (k > 0) & (j < tail))
    out = np.empty((len(rows), L), np.float32)
    for i, m in enumerate(rows):
        prev = np.where(has_prev, _value(((k - 1) * M + m) * seg + stride + j), np.float32(0))
        head = _value((np.minimum(k, n_chunks - 1) * M + m) * seg + j)
        v = np.where(k < n_chunks, head + prev, prev)
        out[i] = v * inv_sw
    return out


@pytest.mark.parametrize("M", [1, 3, 16])
@pytest.mark.parametrize("with_tail", [False, True])
@pytest.mark.parametrize("stride", [1, 3, 4, 1023, 1_984_500])
def test_kernel_mirror_is_bit_equal_to_plain(stride, with_tail, M):
    n_chunks = 3
    seg = stride * (2 if with_tail else 1)  # tail 0, or a tail equal to the stride
    L = n_chunks * stride + seg - stride
    rng = np.random.default_rng(stride + M)
    inv_sw = (1.0 / rng.uniform(0.5, 1.5, L)).astype(np.float32)
    rows = list(range(M)) if M * L <= 4_000_000 else [0, M // 2, M - 1]
    V = ola_cuda.ola_vector_width(seg, stride, 0, 256)
    assert V == (4 if stride % 4 == 0 else 1)
    mirror = _kernel_mirror(n_chunks, M, seg, stride, inv_sw, rows, V, H100_BLOCKS)
    for i, m in enumerate(rows):
        flat = (np.arange(n_chunks)[:, None] * M + m) * seg + np.arange(seg)
        ys_m = torch.from_numpy(_value(flat)[:, None, :])  # row m alone: (n_chunks, 1, seg)
        plain = ola.ola_normalized_plain(ys_m, torch.from_numpy(inv_sw), stride)[0]
        np.testing.assert_array_equal(mirror[i], plain.numpy(), err_msg=f"row {m}")


@pytest.mark.parametrize("grid", [1, 2, 5])
def test_kernel_mirror_with_shares_across_chunks(grid):
    # few warps: a warp's share spans several chunks and the last tail
    n_chunks, M, seg, stride = 4, 3, 96, 64
    L = n_chunks * stride + seg - stride
    inv_sw = (1.0 / np.random.default_rng(grid).uniform(0.5, 1.5, L)).astype(np.float32)
    for V in (1, 4):
        mirror = _kernel_mirror(n_chunks, M, seg, stride, inv_sw, list(range(M)), V, grid)
        flat = (np.arange(n_chunks)[:, None, None] * M + np.arange(M)[:, None]) * seg \
            + np.arange(seg)
        plain = ola.ola_normalized_plain(torch.from_numpy(_value(flat)),
                                         torch.from_numpy(inv_sw), stride)
        np.testing.assert_array_equal(mirror, plain.numpy())


def test_kernel_plan_functions():
    assert ola_cuda.ola_vector_width(2_646_000, 1_984_500, 0, 256, 1024) == 4
    assert ola_cuda.ola_vector_width(2_646_000, 1_984_500, 0, 8) == 1  # a pointer off 16 bytes
    assert ola_cuda.ola_vector_width(88_200, 66_150) == 1  # 2 s segments: stride 2 mod 4
    assert ola_cuda.ola_blocks(6_615_000, 4, H100_BLOCKS) == H100_BLOCKS
    assert ola_cuda.ola_blocks(3, 1, H100_BLOCKS) == 1
    for n_warps, L, V in ((1056, 6_615_000, 4), (7, 1001, 1), (8, 12, 4)):
        shares = [_warp_share(w, n_warps, L, V) for w in range(n_warps)]
        assert shares[0][0] == 0 and shares[-1][1] == L
        assert all(b0 == a1 for (_, b0), (a1, _) in zip(shares, shares[1:]))
        sizes = [b - a for a, b in shares]
        assert max(sizes) - min(sizes) <= V
    assert _runs(5, 30, 3, 10) == [(0, 5, 10), (1, 10, 20), (2, 20, 30)]
    assert _runs(25, 36, 3, 10) == [(2, 25, 30), (3, 30, 36)]
