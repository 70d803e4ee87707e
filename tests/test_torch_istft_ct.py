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
@pytest.mark.parametrize("n_fft", [1024, 2048, 3072, 8192, 17408])
def test_plain_ct_matches_jax_fused_interpret_at_every_n_fft(n_fft, windowed):
    """Every n_fft with 1024 | n_fft, as the JAX function takes it (3072:
    no power of two; 17408: above 16384, where the card runs the cluster
    form), 5 frames."""
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
    up to 227 x 1024 they fit a thread-block cluster's, and the
    device-memory form takes the rest; the forms above 16384 run the same
    radices; 1024 | n_fft is the one limit, the JAX function's."""
    for k in range(1, 17):
        assert istft_ct_cuda.istft_radix_plan(1024 * k)
        assert istft_ct_cuda.istft_form(1024 * k) == "shared"
    for n, plan in ((32768, (8, 4, 8, 8, 8)), (17408, (17, 8, 8, 8)),
                    (24576, (3, 8, 8, 8, 8)), (65536, (8, 8, 8, 8, 8)), (49152, (3, 8, 2, 8, 8, 8))):
        assert istft_ct_cuda.istft_radix_plan(n) == plan
        assert istft_ct_cuda.istft_form(n) == "cluster"
    assert istft_ct_cuda.CLUSTER_N_FFT_MAX == 227 * 1024
    assert istft_ct_cuda.istft_form(227 * 1024) == "cluster"
    assert istft_ct_cuda.istft_form(228 * 1024) == "device"
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


# --- the cluster form (16384 < n_fft <= 227 x 1024), its plan and layout ----
# csrc/istft_ct.cu's istft_ct2_cluster_kernel: point k of a frame in block
# k % C of the cluster at k // C, ring pair q in block q % C; a radix pass's
# butterfly j in block j % C; 512 threads a block, 32 complex values staged
# a thread in a pass at most.

CL_THREADS, CL_STAGE = 512, 32


def test_cluster_size_is_the_smallest_that_holds_a_frame_and_its_ring():
    """At every n_fft = 1024 k above 16384: C = 2, 4 or 8, the smallest
    whose slices (8 n_fft / C bytes) fit the 227 KiB a block may ask for;
    the device-memory form above 227 x 1024; the form from n_fft alone."""
    for k in range(17, 300):
        n = 1024 * k
        C = istft_ct_cuda.istft_cluster_size(n)
        if k <= 227:
            assert istft_ct_cuda.istft_form(n) == "cluster" and C in (2, 4, 8)
            assert 8 * n // C <= istft_ct_cuda.BLOCK_SMEM_MAX
            assert C == 2 or 8 * n // (C // 2) > istft_ct_cuda.BLOCK_SMEM_MAX
            # the kernel's staging: each thread stages its share of every pass
            assert (n // 2) // C <= CL_STAGE * CL_THREADS
        else:
            assert istft_ct_cuda.istft_form(n) == "device" and C == 0
    assert [istft_ct_cuda.istft_cluster_size(1024 * k) for k in (17, 56, 57, 113, 114, 227)] == [
        2, 2, 4, 4, 8, 8]


@pytest.mark.parametrize("n_fft", [17408, 32768, 59392, 131072, 232448])
def test_cluster_layout_keeps_most_accesses_in_the_block(n_fft):
    """Every point and ring pair has one block; a radix pass's butterflies
    cover the pass once, each reads its points in its own block and writes
    to other blocks only while ns % C != 0; the odd first pass writes its
    own block's points; a thread's ring pairs read their frame points in its
    block; no thread stages more than the kernel's registers hold."""
    C = istft_ct_cuda.istft_cluster_size(n_fft)
    M, pairs = n_fft // 2, n_fft // 8
    ML, PL = M // C, pairs // C
    blocks = np.arange(C)[:, None]
    points = (blocks + C * np.arange(ML)[None]).ravel()
    assert sorted(points.tolist()) == list(range(M))
    ns, remote_passes = 1, []
    for i, R in enumerate(istft_ct_cuda.istft_radix_plan(n_fft)):
        if R not in (2, 4, 8):
            assert i == 0 and R % 2 == 1
            # outputs o = c + C il: in the block that writes them
            assert -(-ML // CL_THREADS) <= CL_STAGE
            ns = R
            continue
        nb = M // R
        assert nb % C == 0
        nbl = nb // C
        assert -(-nbl // CL_THREADS) <= CL_STAGE // R
        j = (blocks + C * np.arange(nbl)[None])  # (C, nbl)
        assert sorted(j.ravel().tolist()) == list(range(nb))
        for q in range(R):
            assert ((j + q * nb) % C == blocks).all()  # reads in the block
        d = (j // ns) * ns * R + j % ns
        writes = np.stack([d + q * ns for q in range(R)])
        assert sorted(writes.ravel().tolist()) == list(range(M))
        local = (writes % C == blocks[None]).all()
        assert local == (ns % C == 0)
        if not local:
            remote_passes.append(i)
        ns *= R
    assert ns == M
    # the last two radix-8 passes always stay in the block (ns >= 8 C there)
    assert all(i < len(istft_ct_cuda.istft_radix_plan(n_fft)) - 2 for i in remote_passes)
    q = blocks + C * np.arange(PL)[None]
    assert sorted(q.ravel().tolist()) == list(range(pairs))
    for p in range(4):
        assert ((p * pairs + q) % C == blocks).all()
    assert 8 * n_fft // C == 4 * 2 * ML + 8 * 4 * PL  # the shared memory of a block


@pytest.mark.parametrize("n_fft", [17408, 32768, 59392])
def test_cluster_pass_twiddles_are_the_tables_entries(n_fft):
    """The cluster form reads its radix passes' twiddles from
    ``pass_twiddles``: pass by pass (ns > 1), entry (q - 1, jm) of the
    cosines and of the sines is the table's entry jm q n_fft / (ns R), the
    value the device-memory form reads, so the two forms multiply by the
    same float32 twiddles."""
    table = istft_ct_cuda._table_np(n_fft)
    ptw = istft_ct_cuda.pass_twiddles(n_fft)
    off, ns = 0, 1
    for R in istft_ct_cuda.istft_radix_plan(n_fft):
        if ns > 1:
            jm = np.arange(ns)
            for q in range(1, R):
                p = jm * q * (n_fft // (ns * R))
                assert (p < n_fft).all()
                np.testing.assert_array_equal(ptw[off + (q - 1) * ns + jm], table[0, p])
                np.testing.assert_array_equal(ptw[off + (R - 1) * ns + (q - 1) * ns + jm],
                                              table[1, p])
            off += 2 * (R - 1) * ns
        ns *= R
    assert off == ptw.size


# --- the register form (n_fft = 1024 k up to 16384 but 4096), mirrored ------
# csrc/istft_ct.cu's istft_ct2_reg_kernel: three passes R1 x R2 x R3 with
# the 4096 form's index maps (k = R2 R3 k1 + R3 k2 + k3, n = n1 + R1 n2 +
# R1 R2 n3), its in-register transforms (dft_nat: a factor 3, 5 or 7, or
# 2 at 32, split off by Cooley-Tukey with constant twiddles), pass 1's
# twiddles from register_twiddles, pass 2's from the table at 2 R1 n2 k3,
# and the pieces and pairs each pass-3 column goes to.

SIX_SIZES = (1024, 2048, 3072, 5120, 8192, 16384)


def test_register_plans_multiply_to_half_n_fft_and_fit_the_block():
    """Every plan: R1 R2 R3 = n_fft / 2; R3 8 or 16 (a column keeps whole
    pieces); R2 R3 threads, whole warps, R3 | R2 R3 (pass 2's k3 is tid %
    R3); at most 32 complex points a thread in a pass (R1 <= 32, R2 and
    R3 <= 16: passes 2 and 3 take their butterflies one at a time); R1 a
    radix dft_nat splits into 2, 3, 5 or 7 times 4, 8 or 16; the block's
    shared memory within what a block may ask for; the odd k from 9 run
    the mixed-radix form, 4096 its own."""
    for k in range(1, 17):
        n = 1024 * k
        plan = istft_ct_cuda.istft_register_plan(n)
        form = istft_ct_cuda.istft_shared_form(n)
        if n == 4096:
            assert plan is None and form == "hand"
            continue
        if plan is None:
            assert k % 2 == 1 and k >= 9 and form == "mixed_radix"
            continue
        assert form == "register"
        R1, R2, R3 = plan
        assert R1 * R2 * R3 == n // 2
        assert R3 in (8, 16) and R2 in (8, 16) and R1 <= 32
        th, lda, ldb, smem = istft_ct_cuda.istft_register_layout(n)
        assert th == R2 * R3 and th % 32 == 0 and th % R3 == 0 and th <= 1024
        assert lda >= th and ldb >= R1 * R2
        assert smem <= istft_ct_cuda.BLOCK_SMEM_MAX
        if R1 not in (2, 4, 8, 16):
            B = 16 if R1 % 16 == 0 else 8 if R1 % 8 == 0 else 4 if R1 % 4 == 0 else 2
            assert R1 // B in (2, 3, 5, 7)
    assert all(istft_ct_cuda.istft_shared_form(n) == "register" for n in SIX_SIZES if n != 4096)
    with pytest.raises(ValueError, match="above the shared-memory forms"):
        istft_ct_cuda.istft_shared_form(17408)


def _reg_dft(x):
    """dft_nat on the first axis: y[n] = sum_m x[m] e^(2 pi i n m / R),
    natural order; the composite radices as the kernel splits them."""
    R = x.shape[0]
    if R in (1, 2, 4, 8, 16):
        w = np.exp(2j * np.pi * np.outer(np.arange(R), np.arange(R)) / R).astype(x.dtype)
        return np.tensordot(w, x, axes=(1, 0))
    if R in (3, 5, 7):  # dft_odd's symmetric sums
        H = (R - 1) // 2
        y = np.empty_like(x)
        y[0] = x.sum(0)
        for n in range(1, H + 1):
            m = range(1, H + 1)
            a = x[0] + sum(np.cos(2 * np.pi * n * q / R) * (x[q] + x[R - q]) for q in m)
            b = sum(np.sin(2 * np.pi * n * q / R) * (x[q] - x[R - q]) for q in m)
            y[n], y[R - n] = a + 1j * b, a - 1j * b
        return y
    B = 16 if R % 16 == 0 else 8 if R % 8 == 0 else 4 if R % 4 == 0 else 2
    A = R // B
    t = np.empty_like(x)
    for m2 in range(B):
        u = _reg_dft(x[[B * m1 + m2 for m1 in range(A)]])
        for n1 in range(A):
            t[n1 * B + m2] = u[n1] * np.exp(2j * np.pi * ((n1 * m2) % R) / R)
    y = np.empty_like(x)
    for n1 in range(A):
        v = _reg_dft(t[n1 * B:(n1 + 1) * B])
        for n2 in range(B):
            y[n1 + A * n2] = v[n2]
    return y


@pytest.mark.parametrize("R", [2, 3, 4, 5, 6, 7, 8, 10, 12, 16, 20, 24, 28, 32, 40])
def test_register_transforms_are_the_dft(R):
    x = np.random.default_rng(R).standard_normal((R, 3)) + 0j
    w = np.exp(2j * np.pi * np.outer(np.arange(R), np.arange(R)) / R)
    np.testing.assert_allclose(_reg_dft(x), w @ x, rtol=0, atol=1e-12)


def _register_frames(re, im, n_fft, dtype=complex):
    """Frames (T, n_fft) (window and 1/N not applied) as istft_ct2_reg_kernel
    computes them, every frame at once; ``dtype`` complex64 runs the passes
    in float32 with the table's float32 entries."""
    R1, R2, R3 = istft_ct_cuda.istft_register_plan(n_fft)
    M, th = n_fft // 2, R2 * R3
    rdt = np.float32 if dtype == np.complex64 else np.float64
    if dtype == np.complex64:
        tab = istft_ct_cuda._table_np(n_fft)
        table = (tab[0] + 1j * tab[1]).astype(dtype)
        tw = istft_ct_cuda.register_twiddles(n_fft).reshape(2, R1 - 1, th)
    else:
        table = np.exp(2j * np.pi * np.arange(n_fft) / n_fft)
        idx = (2 * np.arange(1, R1)[:, None] * np.arange(th)[None]) % n_fft
        tw = np.stack([np.cos(2 * np.pi * idx / n_fft), np.sin(2 * np.pi * idx / n_fft)])
    tw1 = (tw[0] + 1j * tw[1]).astype(dtype)  # (R1 - 1, th): entry (n1 - 1, j)
    re, im = re.astype(rdt), im.astype(rdt)
    T = re.shape[0]
    # pass 1: thread j reads bins k = th k1 + j and their mirrors
    j = np.arange(th)
    k = th * np.arange(R1)[:, None] + j[None]  # (R1, th)
    zero = (k == 0)
    x = re[:, k] + 1j * np.where(zero, 0, im[:, k])
    xm = re[:, M - k] - 1j * np.where(zero, 0, im[:, M - k])  # conj X[N/2 - k]
    z = ((x + xm) + 1j * table[k] * (x - xm)).astype(dtype)  # (T, R1, th)
    A = np.moveaxis(_reg_dft(np.moveaxis(z, 1, 0)), 0, 1).astype(dtype)  # A[t, n1, j]
    A[:, 1:] *= tw1
    # pass 2: butterfly b2 = (n1, k3) reads A[n1][R3 k2 + k3]
    b2 = np.arange(R1 * R3)
    n1, k3 = b2 // R3, b2 % R3
    y = np.stack([A[:, n1, R3 * k2 + k3] for k2 in range(R2)])  # (R2, T, b2)
    y = _reg_dft(y).astype(dtype)
    y *= np.stack([table[2 * R1 * n2 * k3] for n2 in range(R2)])[:, None]
    B = np.empty((T, R3, R1 * R2), dtype)
    for n2 in range(R2):
        B[:, k3, R1 * n2 + n1] = y[n2]
    # pass 3: column c over k3 -> z[c + R1 R2 n3]: piece n3 // Q3, pair
    # c + (M / R3) (n3 % Q3)
    yz = _reg_dft(np.moveaxis(B, 1, 0)).astype(dtype)  # (R3, T, c)
    q3, pairs = R3 // 4, M // 4
    frames = np.empty((T, n_fft), rdt)
    owners = np.zeros(n_fft, int)
    c = np.arange(R1 * R2)
    for n3 in range(R3):
        p, q = n3 // q3, c + (M // R3) * (n3 % q3)
        n = p * pairs + q
        assert (n == c + R1 * R2 * n3).all()  # the sample pair z[n] is
        frames[:, 2 * n], frames[:, 2 * n + 1] = yz[n3].real, yz[n3].imag
        owners[2 * n] += 1
        owners[2 * n + 1] += 1
    assert (owners == 1).all()  # every sample of a frame has one owner
    return frames


@pytest.mark.parametrize("n_fft", sorted(istft_ct_cuda.REGISTER_PLANS))
def test_register_mirror_is_the_windowed_inverse_real_dft(n_fft):
    rng = np.random.default_rng(n_fft + 1)
    re, im = rng.standard_normal((2, n_fft // 2 + 1)), rng.standard_normal((2, n_fft // 2 + 1))
    spec = re + 1j * im
    spec[:, 0], spec[:, -1] = spec[:, 0].real, spec[:, -1].real
    got = _register_frames(re, im, n_fft) / n_fft
    np.testing.assert_allclose(got, np.fft.irfft(spec, n_fft), rtol=0, atol=1e-12)


@pytest.mark.parametrize("n_fft", SIX_SIZES)
def test_register_order_in_float32_matches_plain_and_jax(n_fft):
    """The passes in float32 with the table's float32 twiddles, windowed
    (1/N folded into the window as the kernel does) and overlap-added
    through the kernel's ring walk: within 1e-5 of the plain version and of
    JAX's ``istft_ct2_fused`` (interpret mode), 6 frames, 2 rows."""
    hop, T, rows = n_fft // 4, 6, 2
    re, im = _planes(T, (rows,), n_bins=n_fft // 2 + 1, seed=n_fft + 2)
    win = t_stft.hann_window(n_fft, "cpu")
    w = (win.numpy() * np.float32(1.0 / n_fft)).astype(np.float32)
    frames = np.stack([_register_frames(re[r], im[r], n_fft, np.complex64) for r in range(rows)])
    got = _ring_walk((frames * w).astype(np.float32), hop, 396)
    plain = istft_ct.istft_ct2_plain(torch.from_numpy(re), torch.from_numpy(im), n_fft, hop,
                                     win).numpy()
    np.testing.assert_allclose(got, plain, rtol=0, atol=CT_ATOL)
    ref = j_istft_ct.istft_ct2_fused(jnp.asarray(re), jnp.asarray(im), n_fft, hop,
                                     window=j_stft.hann_window(n_fft), kf=4, interpret=True)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=CT_ATOL)


@pytest.mark.parametrize("n_fft", sorted(istft_ct_cuda.REGISTER_PLANS))
def test_register_exchanges_are_free_of_bank_conflicts(n_fft):
    """A warp's accesses to A and B each touch 32 different banks, and its
    ring entries (float2) are 32 neighbouring pairs, as in the 4096 form."""
    R1, R2, R3 = istft_ct_cuda.istft_register_plan(n_fft)
    th, lda, ldb, _ = istft_ct_cuda.istft_register_layout(n_fft)
    M = n_fft // 2
    checked = 0
    for warp in range(th // 32):
        tid = np.arange(32) + 32 * warp
        for n1 in range(R1):
            assert len(set(((n1 * lda + tid) % 32).tolist())) == 32  # pass 1 writes A
        for e in range(-(-(R1 * R3) // th)):
            b2 = tid + th * e
            b2 = b2[b2 < R1 * R3]
            n1, k3 = b2 // R3, b2 % R3
            for x in range(max(R2, 1)):
                assert len(set(((n1 * lda + R3 * x + k3) % 32).tolist())) == b2.size  # reads A
                assert len(set(((k3 * ldb + R1 * x + n1) % 32).tolist())) == b2.size  # writes B
                checked += 1
        for e in range(-(-(R1 * R2) // th)):
            c = tid + th * e
            c = c[c < R1 * R2]
            for k3 in range(R3):
                assert len(set(((k3 * ldb + c) % 32).tolist())) == c.size  # pass 3 reads B
            for m in range(R3 // 4):
                q = c + (M // R3) * m
                assert (np.diff(q) == 1).all()  # ring pairs: 256 contiguous bytes
    assert checked
