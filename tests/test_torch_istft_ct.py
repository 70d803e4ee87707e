"""The fused Cooley-Tukey iSTFT: the port's plain version of the kernel
(K8) against the JAX ``istft_ct2_fused`` in Pallas interpret mode, the
port's ``istft_planes(istft_algo="ct2")`` against the JAX one, and the
pieces around it (``overlap_add``, ``window_sumsquare``, the geometry the
kernel refuses); then numpy mirrors of the kernel's transform, its run
plan and its overlap-add ring."""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from umx_tpu.config import DSPConfig as JDSPConfig
from umx_tpu.ops import istft_ct as j_istft_ct
from umx_tpu.ops import stft as j_stft
from umx_tpu_torch.config import DSPConfig
from umx_tpu_torch.ops import istft_ct, istft_ct_cuda
from umx_tpu_torch.ops import stft as t_stft

# The JAX package's own bound between its CT forms on unit-normal planes
# (tests/test_istft_ct.py): f32 sums in another order over 2049 bins.
CT_ATOL = 1e-5


def _planes(t, lead=(), n_bins=2049, seed=0):
    rng = np.random.default_rng(seed)
    re = rng.standard_normal((*lead, t, n_bins)).astype(np.float32)
    im = rng.standard_normal((*lead, t, n_bins)).astype(np.float32)
    return re, im


@pytest.mark.parametrize("t, lead, windowed", [(6, (), True), (12, (2,), False), (6, (2,), True)])
def test_plain_ct_matches_jax_fused_interpret(t, lead, windowed):
    re, im = _planes(t, lead, seed=t)
    win = j_stft.hann_window(4096) if windowed else None
    ref = j_istft_ct.istft_ct2_fused(jnp.asarray(re), jnp.asarray(im), 4096, 1024, window=win,
                                     kf=4, interpret=True)
    ours = istft_ct_cuda.istft_ct2(torch.from_numpy(re), torch.from_numpy(im), 4096, 1024,
                                   t_stft.hann_window(4096, "cpu") if windowed else None)
    assert ours.shape == (*lead, (t - 1) * 1024 + 4096)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=CT_ATOL, rtol=0)


@pytest.mark.parametrize("windowed", [True, False])
@pytest.mark.parametrize("n_fft", [1024, 2048, 3072, 8192])
def test_plain_ct_matches_jax_fused_interpret_at_every_n_fft(n_fft, windowed):
    """Every n_fft with 1024 | n_fft, as the JAX function takes it (3072:
    no power of two), 5 frames."""
    n_bins = n_fft // 2 + 1
    re, im = _planes(5, n_bins=n_bins, seed=n_fft)
    win = j_stft.hann_window(n_fft) if windowed else None
    ref = j_istft_ct.istft_ct2_fused(jnp.asarray(re), jnp.asarray(im), n_fft, n_fft // 4,
                                     window=win, kf=4, interpret=True)
    ours = istft_ct_cuda.istft_ct2(torch.from_numpy(re), torch.from_numpy(im), n_fft, n_fft // 4,
                                   t_stft.hann_window(n_fft, "cpu") if windowed else None)
    assert ours.shape == (4 * (n_fft // 4) + n_fft,)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=CT_ATOL, rtol=0)


def test_istft_planes_ct2_at_n_fft_2048_matches_the_dense_inverse():
    cfg = DSPConfig(n_fft=2048, hop=512)
    x = torch.from_numpy(np.random.default_rng(11).standard_normal((2, 9000)).astype(np.float32))
    re, im = t_stft.stft_planes(x, cfg)
    dense = t_stft.istft_planes(re, im, 9000, cfg)
    ct2 = t_stft.istft_planes(re, im, 9000, dataclasses.replace(cfg, istft_algo="ct2"))
    np.testing.assert_allclose(ct2.numpy(), dense.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(ct2.numpy(), x.numpy(), atol=1e-4, rtol=0)


def test_istft_planes_ct2_matches_jax():
    # the JAX ct2 arm needs the matmul DFT; both precisions at highest
    jcfg = JDSPConfig(fft_impl="matmul", dft_precision="highest", idft_precision="highest",
                      istft_algo="ct2_interpret")
    rng = np.random.default_rng(7)
    n = 16384
    x = rng.standard_normal((2, n)).astype(np.float32)
    re, im = j_stft.stft_planes(jnp.asarray(x), jcfg)
    ref = j_stft.istft_planes(re, im, n, jcfg)
    ours = t_stft.istft_planes(torch.from_numpy(np.array(re)), torch.from_numpy(np.array(im)),
                               n, DSPConfig(istft_algo="ct2"))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=CT_ATOL, rtol=0)
    # and the round trip stays within the STFT class of the dense inverse
    np.testing.assert_allclose(ours.numpy(), x, atol=1e-4, rtol=0)


def test_ct2_and_dense_inverse_agree():
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 3, 20000)).astype(np.float32))
    re, im = t_stft.stft_planes(x, DSPConfig())
    dense = t_stft.istft_planes(re, im, 20000, DSPConfig())
    ct2 = t_stft.istft_planes(re, im, 20000, DSPConfig(istft_algo="ct2"))
    # the same transform by two routes: f32 rounding of ~1e-6 on |x| ~ 4
    np.testing.assert_allclose(ct2.numpy(), dense.numpy(), atol=1e-5, rtol=0)


def test_overlap_add_and_window_sumsquare_match_jax():
    # exact: the same zero-padded piece grids summed in the same order
    frames = np.random.default_rng(1).standard_normal((2, 7, 4096)).astype(np.float32)
    np.testing.assert_array_equal(
        t_stft.overlap_add(torch.from_numpy(frames), 1024).numpy(),
        np.asarray(j_stft.overlap_add(jnp.asarray(frames), 1024)),
    )
    np.testing.assert_array_equal(
        t_stft.window_sumsquare(t_stft.hann_window(4096, "cpu"), 9, 1024, 11000).numpy(),
        np.asarray(j_stft.window_sumsquare(j_stft.hann_window(4096), 9, 1024, 11000)),
    )


def test_dc_and_nyquist_imaginary_parts_drop_out():
    re, im = _planes(5, seed=2)
    im2 = im.copy()
    im2[..., 0] = 0.0
    im2[..., -1] = 0.0
    a = istft_ct.istft_ct2_plain(torch.from_numpy(re), torch.from_numpy(im), 4096, 1024)
    b = istft_ct.istft_ct2_plain(torch.from_numpy(re), torch.from_numpy(im2), 4096, 1024)
    assert torch.equal(a, b)


def test_kernel_wrapper_route_and_geometry():
    re, im = (torch.from_numpy(a) for a in _planes(3, (2,), seed=4))
    before = istft_ct_cuda.istft_ct2.launches
    out = istft_ct_cuda.istft_ct2(re, im, 4096, 1024)
    assert torch.equal(out, istft_ct.istft_ct2_plain(re, im, 4096, 1024))
    assert istft_ct_cuda.istft_ct2.launches == before  # no kernel ran on the CPU
    with pytest.raises(ValueError, match="hop == n_fft/4"):
        istft_ct_cuda.istft_ct2(re, im, 4096, 512)
    small = torch.zeros((3, 1001))
    with pytest.raises(ValueError, match="1024 | n_fft"):
        istft_ct_cuda.istft_ct2(small, small, 2000, 500)
    # every n_fft with 1024 | n_fft runs (the CPU route: the plain version),
    # 8192 and 3072 (no power of two) as well as 4096
    for n_fft in (8192, 3072):
        big = torch.ones((3, n_fft // 2 + 1))
        out = istft_ct_cuda.istft_ct2(big, big, n_fft, n_fft // 4)
        assert torch.equal(out, istft_ct.istft_ct2_plain(big, big, n_fft, n_fft // 4))
    assert istft_ct_cuda.istft_ct2.launches == before
    with pytest.raises(ValueError, match="one-sided bins"):
        istft_ct_cuda.istft_ct2(re[..., :-1], im[..., :-1], 4096, 1024)
    with pytest.raises(ValueError, match="istft_algo"):
        DSPConfig(istft_algo="ct2_xla")
    with pytest.raises(ValueError, match="hop == n_fft/4"):
        t_stft.istft_planes(re, im, 4096, dataclasses.replace(DSPConfig(istft_algo="ct2"), hop=512))


# --- the kernel's structure, mirrored in numpy ------------------------------
# csrc/istft_ct.cu cannot run here; these mirrors follow its index maps line
# by line (the Hermitian unpacking, 2048 = 16 x 16 x 8 with the slots its
# radix-4 steps leave their outputs in, the piece each output goes to), its
# run plan and its walk over a run's frames with the 4-hop ring.

_ROT16 = {m: np.exp(2j * np.pi * m / 16) for m in (0, 1, 2, 3, 4, 6, 9)}


def _dft4(x, s):
    """In place on slots s of x (slots, lanes): slot n gets sum_k x[k] i^(n k)."""
    x0, x1, x2, x3 = (x[k].copy() for k in s)
    x[s[0]] = (x0 + x2) + (x1 + x3)
    x[s[2]] = (x0 + x2) - (x1 + x3)
    x[s[1]] = (x0 - x2) + 1j * (x1 - x3)
    x[s[3]] = (x0 - x2) - 1j * (x1 - x3)


def _dft16(x):
    for k2 in range(4):
        _dft4(x, (k2, 4 + k2, 8 + k2, 12 + k2))
    for slot, m in ((5, 1), (6, 2), (7, 3), (9, 2), (10, 4), (11, 6), (13, 3), (14, 6), (15, 9)):
        x[slot] *= _ROT16[m]
    for n1 in range(4):
        _dft4(x, (4 * n1, 4 * n1 + 1, 4 * n1 + 2, 4 * n1 + 3))


def _dft8(x):
    _dft4(x, (0, 2, 4, 6))
    _dft4(x, (1, 3, 5, 7))
    for slot, m in ((3, 2), (5, 4), (7, 6)):
        x[slot] *= _ROT16[m]
    for n1 in range(4):
        a, b = x[2 * n1].copy(), x[2 * n1 + 1].copy()
        x[2 * n1], x[2 * n1 + 1] = a + b, a - b


def _kernel_frame_mirror(re, im, window):
    """One frame as the kernel's 128 threads compute it → (4 pieces, 1024)."""
    n = 4096
    tid = np.arange(128)
    table = np.exp(2j * np.pi * np.arange(n) / n)
    # pass 1: thread j unpacks Z[128 k1 + j] and transforms over k1
    z = np.empty((16, 128), complex)
    for k1 in range(16):
        k = 128 * k1 + tid
        x = re[k] + 1j * np.where(k == 0, 0.0, im[k])
        xm = re[n // 2 - k] - 1j * np.where(k == 0, 0.0, im[n // 2 - k])  # conj X[N/2 - k]
        z[k1] = (x + xm) + 1j * table[k] * (x - xm)
    _dft16(z)
    sa = np.empty((16, 128), complex)  # A[n1][j]
    for n1 in range(16):
        sa[n1] = z[4 * (n1 & 3) + (n1 >> 2)] * table[(2 * n1 * tid) & (n - 1)]
    # pass 2: thread (n1, k3) = (tid / 8, tid % 8) transforms over k2
    n1_t, k3_t = tid >> 3, tid & 7
    for k2 in range(16):
        z[k2] = sa[n1_t, 8 * k2 + k3_t]
    _dft16(z)
    sb = np.empty((8, 256), complex)  # B[k3][16 n2 + n1]
    for n2 in range(16):
        sb[k3_t, 16 * n2 + n1_t] = z[4 * (n2 & 3) + (n2 >> 2)] * table[(32 * n2 * k3_t) & (n - 1)]
    # pass 3: columns tid and tid + 128 over k3; sample pair 2 (col + 256 n3)
    pieces = np.zeros((4, 1024))
    seen = np.zeros((4, 1024), int)
    for i in range(2):
        y = np.stack([sb[k3, tid + 128 * i] for k3 in range(8)])
        _dft8(y)
        for n3 in range(8):
            v = y[2 * (n3 & 3) + (n3 >> 2)] / n
            m = 2 * (tid + 128 * i) + 512 * n3  # the window entry the thread keeps
            off = 2 * (tid + 128 * i) + 512 * (n3 & 1)  # its ring entry 2 i + n3 % 2
            pieces[n3 >> 1, off] = v.real * window[m]
            pieces[n3 >> 1, off + 1] = v.imag * window[m + 1]
            seen[n3 >> 1, off] += 1
            seen[n3 >> 1, off + 1] += 1
    assert (seen == 1).all()  # every sample of the frame has exactly one owner
    return pieces


@pytest.mark.parametrize("seed", [0, 1])
def test_kernel_transform_mirror_is_the_windowed_inverse_real_dft(seed):
    rng = np.random.default_rng(seed)
    re, im = rng.standard_normal(2049), rng.standard_normal(2049)
    window = rng.uniform(0.5, 1.5, 4096)
    spec = re + 1j * im
    spec[0], spec[-1] = spec[0].real, spec[-1].real
    ref = np.fft.irfft(spec, 4096) * window
    got = _kernel_frame_mirror(re, im, window).reshape(4096)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)


def _check_shared_memory_banks():
    """The padded rows of the two exchanges: every access of a warp hits 32
    different banks."""
    lda, ldb = 136, 260
    for warp in range(4):
        tid = np.arange(32) + 32 * warp
        n1, k3 = tid >> 3, tid & 7
        for x in range(16):
            yield (x * lda + tid) % 32  # pass 1 writes A[n1 = x][tid]
            yield (n1 * lda + 8 * x + k3) % 32  # pass 2 reads A[n1][8 k2 + k3]
            yield (k3 * ldb + 16 * x + n1) % 32  # pass 2 writes B[k3][16 n2 + n1]
        for k in range(8):
            for i in range(2):
                yield (k * ldb + tid + 128 * i) % 32  # pass 3 reads B[k3][column]


def test_kernel_exchanges_are_free_of_bank_conflicts():
    for banks in _check_shared_memory_banks():
        assert len(set(banks.tolist())) == 32


@pytest.mark.parametrize("rows, frames, capacity", [
    (48, 2584, 396), (8, 2584, 396), (1, 1, 396), (1, 3, 396), (5, 37, 396), (3, 2, 4),
    (500, 9, 396), (7, 130, 1), (2, 61, 396), (1, 5000, 396),
])
def test_run_plan_covers_every_hop_once(rows, frames, capacity):
    per_row, hops_per_run = istft_ct_cuda.istft_run_plan(rows, frames, capacity)
    runs = istft_ct_cuda.istft_runs(rows, frames, capacity)
    hops = frames + 3
    assert len(runs) == rows * per_row
    assert per_row == 1 or rows * per_row <= capacity
    covered = np.zeros((rows, hops), int)
    for block, (row, a, b, f_lo, f_hi) in enumerate(runs):
        # the kernel derives its run from its block index
        assert (row, a) == (block // per_row, (block % per_row) * hops_per_run)
        assert 0 <= a < b <= hops and b - a <= hops_per_run
        covered[row, a:b] += 1
        # the run walks exactly the frames that reach its hops, inside the row
        reach = [t for t in range(frames) if any(a <= t + p < b for p in range(4))]
        assert list(range(f_lo, f_hi + 1)) == reach
        assert f_lo >= max(0, a - 3)  # at most 3 halo frames below the first hop
    assert (covered == 1).all()
    # rows x frames pairs: every frame is walked by the run of each hop it reaches
    if per_row > 1:
        assert hops_per_run >= 8 or per_row == -(-hops // hops_per_run)


def test_run_plan_refuses_nothing_to_do():
    with pytest.raises(ValueError, match="must be positive"):
        istft_ct_cuda.istft_run_plan(0, 5, 396)
    with pytest.raises(ValueError, match="must be positive"):
        istft_ct_cuda.istft_run_plan(2, 0, 396)


def _ring_walk(frames, hop, capacity):
    """The kernel's overlap-add: each run walks its frames down from the
    last, piece p of frame t into ring slot (t + p) % 4 (piece 0 assigns,
    the others add), and stores hop t + 3 (and hops 0..2 after frame 0)
    where the run owns it."""
    rows, n_frames, n_fft = frames.shape
    pieces = frames.reshape(rows, n_frames, 4, hop)
    out = np.full((rows, (n_frames + 3) * hop), np.nan, np.float32)
    stored = np.zeros((rows, n_frames + 3), int)
    for row, a, b, f_lo, f_hi in istft_ct_cuda.istft_runs(rows, n_frames, capacity):
        ring = np.zeros((4, hop), np.float32)
        for t in range(f_hi, f_lo - 1, -1):
            ring[t & 3] = pieces[row, t, 0]
            for p in (1, 2, 3):
                ring[(t + p) & 3] = ring[(t + p) & 3] + pieces[row, t, p]
            for h in range(t + 3, (0 if t == 0 else t + 3) - 1, -1):
                if a <= h < b:
                    out[row, h * hop : (h + 1) * hop] = ring[h & 3]
                    stored[row, h] += 1
    assert (stored == 1).all()
    return out


@pytest.mark.parametrize("rows, frames, capacity", [
    (5, 37, 396), (1, 3, 396), (1, 1, 396), (3, 2, 4), (2, 130, 396), (4, 9, 2), (2, 61, 7),
])
def test_ring_walk_is_overlap_add_bit_for_bit(rows, frames, capacity):
    """Runs that end inside a row, rows shorter than the ring, one block
    for several rows: the same sums in the same order as overlap_add."""
    hop = 16  # the order of the sums does not depend on the hop's width
    x = np.random.default_rng(rows * frames).standard_normal((rows, frames, 4 * hop)).astype(
        np.float32)
    ref = t_stft.overlap_add(torch.from_numpy(x), hop).numpy()
    np.testing.assert_array_equal(_ring_walk(x, hop, capacity), ref)


# --- the mixed-radix form (every n_fft but 4096), mirrored in numpy ---------
# csrc/istft_ct.cu's istft_ct2_mr_kernel: the Hermitian unpacking, then
# Stockham passes of the radices istft_radix_plan gives, each with the
# kernel's butterfly index j, its table twiddles and its write index, then
# the sample pairs each of its 256 threads owns in the ring.


@pytest.mark.parametrize("n_fft, plan", [
    (1024, (8, 8, 8)), (2048, (2, 8, 8, 8)), (3072, (3, 8, 8, 8)), (4096, (16, 16, 8)),
    (5120, (5, 8, 8, 8)), (8192, (8, 8, 8, 8)), (15360, (15, 8, 8, 8)), (16384, (16, 8, 8, 8)),
])
def test_radix_plan(n_fft, plan):
    assert istft_ct_cuda.istft_radix_plan(n_fft) == plan
    assert int(np.prod(plan)) == n_fft // 2


def test_kernel_takes_every_n_fft_up_to_16384_and_names_the_limit():
    """Up to 16384 a frame and its ring fit a block's shared memory; above,
    the device-memory form runs the same radices; 1024 | n_fft is the
    one limit, the JAX function's."""
    for k in range(1, 17):
        assert istft_ct_cuda.istft_radix_plan(1024 * k)
        assert istft_ct_cuda.istft_form(1024 * k) == "shared"
    for n, plan in ((32768, (8, 4, 8, 8, 8)), (17408, (17, 8, 8, 8)),
                    (24576, (3, 8, 8, 8, 8)), (65536, (8, 8, 8, 8, 8)), (49152, (3, 8, 2, 8, 8, 8))):
        assert istft_ct_cuda.istft_radix_plan(n) == plan
        assert istft_ct_cuda.istft_form(n) == "device"
    for bad in (3000, 512):
        with pytest.raises(ValueError, match="1024 k"):
            istft_ct_cuda.istft_radix_plan(bad)


def _dft_small(v):
    """dft_small: y[n] = sum_r v[r] e^(2 pi i n r / R), natural order."""
    R = v.shape[0]
    w = np.exp(2j * np.pi * np.outer(np.arange(R), np.arange(R)) / R)
    return w @ v


def _mixed_radix_frame_mirror(re, im, window, n_fft):
    """One frame as istft_ct2_mr_kernel computes it → the windowed frame,
    and how many threads own each sample."""
    M, threads = n_fft // 2, 256
    table = np.exp(2j * np.pi * np.arange(n_fft) / n_fft)
    k = np.arange(M)
    x = re[k] + 1j * np.where(k == 0, 0.0, im[k])
    xm = re[M - k] - 1j * np.where(k == 0, 0.0, im[M - k])  # conj X[N/2 - k]
    buf = (x + xm) + 1j * table[k] * (x - xm)
    ns = 1
    for R in istft_ct_cuda.istft_radix_plan(n_fft):
        nb, tw = M // R, n_fft // (ns * R)
        j = np.arange(nb)  # butterflies j = tid + 256 e
        assert set(range(nb)) == {t + threads * e for t in range(threads)
                                  for e in range(-(-nb // threads)) if t + threads * e < nb}
        v = np.stack([buf[j + r * nb] for r in range(R)])
        jm = j % ns
        for r in range(1, R):
            v[r] *= table[jm * r * tw]  # p = jm q TW < N
        v = _dft_small(v)
        out = np.empty_like(buf)
        d = (j // ns) * ns * R + jm
        for r in range(R):
            out[d + r * ns] = v[r]
        buf, ns = out, ns * R
    assert ns == M
    frame = np.empty(n_fft)
    frame[0::2], frame[1::2] = buf.real, buf.imag
    # the ring: thread tid owns pair q = tid + 256 e of every piece
    pairs = n_fft // 8
    owners = np.zeros(n_fft, int)
    for q in range(pairs):
        for p in range(4):
            n = p * pairs + q
            owners[2 * n] += 1
            owners[2 * n + 1] += 1
    return frame / n_fft * window, owners


@pytest.mark.parametrize("n_fft", [1024, 2048, 3072, 5120, 8192, 16384, 17408, 24576, 32768,
                                   49152])
def test_mixed_radix_mirror_is_the_windowed_inverse_real_dft(n_fft):
    rng = np.random.default_rng(n_fft)
    re, im = rng.standard_normal(n_fft // 2 + 1), rng.standard_normal(n_fft // 2 + 1)
    window = rng.uniform(0.5, 1.5, n_fft)
    spec = re + 1j * im
    spec[0], spec[-1] = spec[0].real, spec[-1].real
    ref = np.fft.irfft(spec, n_fft) * window
    got, owners = _mixed_radix_frame_mirror(re, im, window, n_fft)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
    assert (owners == 1).all()  # every sample of the frame has exactly one owner
