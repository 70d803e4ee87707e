"""K8, the fused Cooley-Tukey iSTFT kernel (``csrc/istft_ct.cu``).

:func:`istft_ct2` has the contract of ``istft_ct2_fused`` in
``umx_tpu/ops/istft_ct.py`` (the TPU kernel of that function): CPU
tensors run :func:`umx_tpu_torch.ops.istft_ct.istft_ct2_plain`, CUDA
tensors launch the kernel or raise.  No cuFFT, cuBLAS or ``torch.fft``
runs inside the kernel: those belong to the plain version only.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from umx_tpu_torch import _build
from umx_tpu_torch.ops.istft_ct import check_ct2_geometry, istft_ct2_plain

N_FFT = 4096  # UMX's transform: the kernel's hand-scheduled form
SHARED_N_FFT_MAX = 16384  # the largest n_fft whose frame and ring fit a block's shared memory
# Above, a thread-block cluster holds a frame and its ring (8 n_fft bytes)
# in its blocks' shared memory, C = 2, 4 or 8 blocks (portable cluster
# sizes), the smallest whose slices of 8 n_fft / C bytes fit the 227 KiB a
# block may ask for on an H100: so up to 8 x 227 KiB / 8 = 232448 = 227 x
# 1024; the device-memory form above that.
CLUSTER_SIZES = (2, 4, 8)
BLOCK_SMEM_MAX = 232448  # bytes of shared memory a block may ask for on an H100
CLUSTER_N_FFT_MAX = BLOCK_SMEM_MAX * CLUSTER_SIZES[-1] // 8
PIECES = 4  # hop = n_fft / 4: a frame reaches 4 output hops, a hop 4 frames
_MIN_HOPS = 8  # no run shorter than this, unless the row is
# the device-memory form's scratch slot a block: two buffers of n_fft/2
# complex values and the overlap-add ring, n_fft floats each
_BIG_SLOT_FLOATS = 3


# The register form's three passes (R1, R2, R3), R1 R2 R3 = n_fft / 2, at
# every n_fft = 1024 k up to 16384 it takes (``csrc/istft_ct.cu``:
# reg_kernel): R2 R3 threads a frame, one pass-1 butterfly each; R3 8 or 16
# (a thread keeps whole pieces of its columns); a factor 3, 5 or 7 of k
# folded into R1 (12 = 3 x 4, 10 = 5 x 2, 14 = 7 x 2, ...); at most 32
# complex points a thread in a pass.  Of the plans timed in turns
# (``chip_forms.py k8_register_forms``), the fastest at each n_fft without
# spills: more threads a frame and a smaller R1 won wherever R2 and R3
# (at most 16) could take them.
# 4096 runs its hand-scheduled 16 x 16 x 8 form, the odd k from 9 the
# mixed-radix form.
REGISTER_PLANS = {
    1024: (4, 16, 8), 2048: (8, 16, 8), 3072: (12, 16, 8), 5120: (10, 16, 16),
    6144: (12, 16, 16), 7168: (14, 16, 16), 8192: (16, 16, 16), 10240: (20, 16, 16),
    12288: (24, 16, 16), 14336: (28, 16, 16), 16384: (32, 16, 16),
}
SHARED_FORMS = ("hand", "register", "mixed_radix")


def istft_register_plan(n_fft: int) -> tuple[int, int, int] | None:
    """The register form's radices (R1, R2, R3) at ``n_fft``, or None where
    it has none (:data:`REGISTER_PLANS`)."""
    istft_radix_plan(n_fft)
    return REGISTER_PLANS.get(n_fft)


def istft_register_layout(n_fft: int) -> tuple[int, int, int, int]:
    """The register form's block at ``n_fft`` (``RegPlan`` in
    ``csrc/istft_ct.cu``): (threads R2 R3, LDA, LDB, dynamic shared memory
    in bytes).  A's R1 rows of R2 R3 points and B's R3 rows of R1 R2 are
    padded to LDA = R3 and LDB = 32 / R3 (mod 32) floats, so that no
    warp's access to either conflicts; the ring holds 4 hops of n_fft / 8
    sample pairs."""
    R1, R2, R3 = istft_register_plan(n_fft)
    th, cols = R2 * R3, R1 * R2
    lda = th + (R3 - th % 32) % 32
    ldb = cols + (32 // R3 - cols % 32) % 32
    return th, lda, ldb, 4 * (2 * R1 * lda + 2 * R3 * ldb) + 8 * PIECES * (n_fft // 8)


def istft_radices(n_fft: int) -> tuple[int, ...]:
    """The radices of the form that runs at ``n_fft`` (``istft_ct2.form[2]``
    after a launch there): the register form's plan where it has one, else
    :func:`istft_radix_plan`."""
    plan = istft_register_plan(n_fft)
    return plan if plan is not None else istft_radix_plan(n_fft)


def istft_shared_form(n_fft: int) -> str:
    """Which kernel holds a frame in a block's shared memory at ``n_fft`` <=
    ``SHARED_N_FFT_MAX``: "hand" (4096, 16 x 16 x 8), "register" (a plan in
    :data:`REGISTER_PLANS`) or "mixed_radix" (the odd k from 9: a pass of k
    points, then 8 x 8 x 8, the Stockham form; by name the register form's
    yardstick)."""
    if istft_form(n_fft) != "shared":
        raise ValueError(f"n_fft {n_fft} is above the shared-memory forms' {SHARED_N_FFT_MAX}")
    if n_fft == N_FFT:
        return "hand"
    return "register" if n_fft in REGISTER_PLANS else "mixed_radix"


def istft_radix_plan(n_fft: int) -> tuple[int, ...]:
    """The radices of the kernel's n_fft/2-point complex inverse, first
    pass first, in the hand-scheduled, mixed-radix, cluster and
    device-memory forms (the register form's are
    :func:`istft_register_plan`'s): 16 x 16 x 8 at 4096 (its
    hand-scheduled form); up to ``SHARED_N_FFT_MAX`` a pass of K =
    n_fft/1024 points (none at K = 1) and three radix-8 passes (the
    mixed-radix Stockham form in shared memory); above
    (the cluster and device-memory forms, :func:`istft_form`), the odd
    part of K as one pass, its power-of-two part in radix 8 (then 4 or 2),
    then three radix 8."""
    if n_fft < 1024 or n_fft % 1024:
        raise ValueError(f"the iSTFT kernel takes n_fft = 1024 k, got {n_fft}")
    if n_fft == N_FFT:
        return (16, 16, 8)
    k = n_fft // 1024
    if n_fft <= SHARED_N_FFT_MAX:
        return ((k,) if k > 1 else ()) + (8, 8, 8)
    odd = k
    while odd % 2 == 0:
        odd //= 2
    plan, two = [odd] if odd > 1 else [], k // odd
    while two > 1:
        r = 8 if two >= 8 else two
        plan.append(r)
        two //= r
    return (*plan, 8, 8, 8)


def istft_form(n_fft: int) -> str:
    """Where the kernel keeps a frame at ``n_fft``, from n_fft alone:
    "shared" (a block's shared memory: the hand-scheduled 4096 form, the
    register form and the mixed radix up to ``SHARED_N_FFT_MAX``,
    :func:`istft_shared_form`), "cluster" (the shared memory
    of a thread-block cluster, up to ``CLUSTER_N_FFT_MAX``) or "device" (a
    scratch slot a block in device memory, above)."""
    istft_radix_plan(n_fft)
    if n_fft <= SHARED_N_FFT_MAX:
        return "shared"
    return "cluster" if n_fft <= CLUSTER_N_FFT_MAX else "device"


def istft_cluster_size(n_fft: int, smem_per_block: int = BLOCK_SMEM_MAX) -> int:
    """The blocks of the cluster form's clusters at ``n_fft``: the
    smallest of ``CLUSTER_SIZES`` whose slices of a frame and its ring
    (8 n_fft / C bytes) fit ``smem_per_block``; 0 where none does."""
    return next((c for c in CLUSTER_SIZES if 8 * n_fft // c <= smem_per_block), 0)


@functools.lru_cache(maxsize=8)
def _table_np(n_fft: int) -> np.ndarray:
    # cos, sin of 2 pi i / n_fft in float64, rounded once to float32
    ph = 2.0 * np.pi * np.arange(n_fft, dtype=np.float64) / n_fft
    return np.stack([np.cos(ph), np.sin(ph)]).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _table(n_fft: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_table_np(n_fft)).to(device)


def pass_twiddles(n_fft: int) -> np.ndarray:
    """The cluster form's twiddles, entries of the table in the order its
    butterflies read them: for each radix pass of :func:`istft_radix_plan`
    with ns > 1 points done (the odd first pass has its own), the cosines
    (R - 1, ns) then the sines, entry (q - 1, jm) the table's entry
    jm q n_fft / (ns R), so that neighbouring butterflies read neighbouring
    addresses; the same float32 values, so the same bits."""
    table = _table_np(n_fft)
    blocks, ns = [], 1
    for R in istft_radix_plan(n_fft):
        if ns > 1:  # the odd pass, where there is one, is the first (ns = 1)
            idx = np.arange(1, R)[:, None] * np.arange(ns)[None] * (n_fft // (ns * R))
            blocks += [table[0, idx].ravel(), table[1, idx].ravel()]
        ns *= R
    return np.concatenate(blocks).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _pass_twiddles(n_fft: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(pass_twiddles(n_fft)).to(device)


def register_twiddles(n_fft: int, plan: tuple[int, int, int] | None = None) -> np.ndarray:
    """The register form's pass-1 twiddles (of ``plan``, by default
    :func:`istft_register_plan`'s): the cosines (R1 - 1, R2 R3), then the
    sines, entry (n1 - 1, j) the table's entry 2 n1 j mod n_fft
    (e^{2 pi i n1 j / (n_fft / 2)}), so that thread j's reads of one n1 are
    neighbours; the table's float32 values."""
    R1, R2, R3 = plan or istft_register_plan(n_fft)
    table = _table_np(n_fft)
    idx = (2 * np.arange(1, R1)[:, None] * np.arange(R2 * R3)[None]) % n_fft
    return np.concatenate([table[0, idx].ravel(), table[1, idx].ravel()]).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _register_twiddles(n_fft: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(register_twiddles(n_fft)).to(device)


def istft_run_plan(rows: int, n_frames: int, capacity: int) -> tuple[int, int]:
    """How the kernel's blocks share the work → (runs per row, output hops
    per run).  A row's (T + 3) output hops of ``hop`` samples are cut into
    equal runs of consecutive hops, one block each, so that rows × runs is
    about ``capacity`` (the blocks the device holds at once): fewer where
    a run would be shorter than 8 hops, one run a row where there are more
    rows than blocks."""
    if rows < 1 or n_frames < 1 or capacity < 1:
        raise ValueError(f"rows {rows}, frames {n_frames} and capacity {capacity} must be positive")
    hops = n_frames + PIECES - 1
    per_row = max(1, min(capacity // rows, -(-hops // _MIN_HOPS)))
    hops_per_run = -(-hops // per_row)
    return -(-hops // hops_per_run), hops_per_run


def istft_runs(rows: int, n_frames: int, capacity: int) -> list[tuple[int, int, int, int, int]]:
    """The runs of :func:`istft_run_plan`, one per block in block order:
    (row, first hop, end hop, first frame, last frame).  A run stores the
    hops [first, end) and walks the frames [first frame, last frame] down
    from the last: the frames that reach its hops, of which up to 3 below
    its first hop belong to the run before it as well (the halo)."""
    per_row, hops_per_run = istft_run_plan(rows, n_frames, capacity)
    hops = n_frames + PIECES - 1
    runs = []
    for row in range(rows):
        for part in range(per_row):
            a = part * hops_per_run
            b = min(a + hops_per_run, hops)
            runs.append((row, a, b, max(a - (PIECES - 1), 0), min(b - 1, n_frames - 1)))
    return runs


@functools.lru_cache(maxsize=None)
def istft_block_layout(index: int, n_fft: int, form: str | None = None) -> tuple[int, int]:
    """What the kernel at ``n_fft`` in ``form`` (None: :func:`istft_form`,
    and in shared memory :func:`istft_shared_form`) reports of itself on
    CUDA device ``index``, asked once: (the blocks the device holds at
    once, the dynamic shared memory a block asks for, in bytes); in the
    cluster form (the clusters the device holds at once, the same)."""
    import ctypes

    blocks, smem = ctypes.c_int(0), ctypes.c_int(0)
    lib = _build.library()
    form = form or istft_form(n_fft)
    if form == "shared":
        form = istft_shared_form(n_fft)
    with torch.cuda.device(index):
        if form == "cluster":
            err = lib.umx_istft_ct2_cluster_capacity(n_fft, istft_cluster_size(n_fft),
                                                     ctypes.addressof(blocks),
                                                     ctypes.addressof(smem))
        elif form == "register":
            err = lib.umx_istft_ct2_reg_capacity(n_fft, ctypes.addressof(blocks),
                                                 ctypes.addressof(smem))
        else:
            err = lib.umx_istft_ct2_capacity(n_fft, ctypes.addressof(blocks),
                                             ctypes.addressof(smem))
    _build.check(err, "umx_istft_ct2_capacity")
    if blocks.value < 1:
        raise RuntimeError(f"the iSTFT kernel at n_fft {n_fft} ({form}): "
                           "this device holds none of its blocks")
    return blocks.value, smem.value


def istft_ct2(re: torch.Tensor, im: torch.Tensor, n_fft: int, hop: int,
              window: torch.Tensor | None = None, *, _form: str | None = None) -> torch.Tensor:
    """Planes re/im (..., T, n_fft/2+1) f32 → raw overlap-added signal
    (..., (T-1)*hop + n_fft) with the window folded in (the caller divides
    by the window sum-of-squares).  Takes every n_fft with 1024 | n_fft and
    hop = n_fft/4, as the JAX function does, on either device.  One kernel
    launch transforms, windows and overlap-adds, in the form
    :func:`istft_form` picks from n_fft, and in shared memory
    :func:`istft_shared_form` (no frames buffer; above
    ``CLUSTER_N_FFT_MAX`` a scratch slot of 3 n_fft floats for each block
    of the grid; the private ``_form`` names "device" above
    ``SHARED_N_FFT_MAX``, for the checks that compare the two forms, which
    give the same bits, and "mixed_radix" where the register form runs, its
    yardstick); the run plan that ran is left in ``istft_ct2.form`` as
    (runs per row, hops per run, radices of the form that ran).  Counts
    ``istft_ct2.launches`` once per launch."""
    if re.dim() < 2 or tuple(im.shape) != tuple(re.shape):
        raise ValueError(f"re and im must both be (..., T, F), got {tuple(re.shape)}, {tuple(im.shape)}")
    *lead, T, F = re.shape
    check_ct2_geometry(n_fft, hop, F)
    if T < 1:
        raise ValueError("no frames")
    tensors = [("re", re), ("im", im)] + ([("window", window)] if window is not None else [])
    for name, t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != re.device:
            raise ValueError(f"{name} is on {t.device}, expected {re.device}")
    if window is not None and tuple(window.shape) != (n_fft,):
        raise ValueError(f"window must be ({n_fft},), got {tuple(window.shape)}")
    form = istft_form(n_fft)
    if form == "shared":
        form = istft_shared_form(n_fft)
    if _form is not None:
        if not ((_form == "device" and form in ("cluster", "device"))
                or (_form == "mixed_radix" and form == "register")):
            raise ValueError(f"form must be None or, above n_fft {SHARED_N_FFT_MAX}, 'device', or "
                             f"where the register form runs, 'mixed_radix'; got {_form!r} at "
                             f"n_fft {n_fft}")
        form = _form
    if re.device.type == "cpu":
        return istft_ct2_plain(re, im, n_fft, hop, window)
    if re.device.type != "cuda":
        raise ValueError(f"no kernel for device {re.device}")

    plan = istft_register_plan(n_fft) if form == "register" else istft_radix_plan(n_fft)
    rows = int(np.prod(lead)) if lead else 1
    dev = re.device
    capacity = istft_block_layout(dev.index, n_fft, form)[0]
    per_row, hops_per_run = istft_run_plan(rows, T, capacity)
    re_c = re.reshape(rows, T, F).contiguous()
    im_c = im.reshape(rows, T, F).contiguous()
    win = window.contiguous() if window is not None else None
    L = (T - 1) * hop + n_fft
    out = torch.empty((rows, L), dtype=torch.float32, device=dev)
    args = (re_c.data_ptr(), im_c.data_ptr(), _table(n_fft, dev).data_ptr(),
            win.data_ptr() if win is not None else None, out.data_ptr())
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _build.library()
    if form in ("hand", "mixed_radix"):
        err = lib.umx_istft_ct2(*args, rows, T, F, n_fft, hop, per_row, hops_per_run, stream)
    elif form == "register":
        re_p, im_p, table_p, win_p, out_p = args
        err = lib.umx_istft_ct2_reg(re_p, im_p, table_p, _register_twiddles(n_fft, dev).data_ptr(),
                                    win_p, out_p, rows, T, F, n_fft, hop, per_row, hops_per_run,
                                    stream)
    elif form == "cluster":
        re_p, im_p, table_p, win_p, out_p = args
        err = lib.umx_istft_ct2_cluster(re_p, im_p, table_p, _pass_twiddles(n_fft, dev).data_ptr(),
                                        win_p, out_p, rows, T, F, n_fft, hop,
                                        istft_cluster_size(n_fft), per_row, hops_per_run, stream)
    else:
        grid = min(rows * per_row, capacity)
        scratch = torch.empty(grid * _BIG_SLOT_FLOATS * n_fft, dtype=torch.float32, device=dev)
        err = lib.umx_istft_ct2_big(*args, scratch.data_ptr(), rows, T, F, n_fft, hop, per_row,
                                    hops_per_run, grid, stream)
    _build.check(err, "umx_istft_ct2")
    istft_ct2.launches += 1
    istft_ct2.form = (per_row, hops_per_run, plan)
    return out.reshape(*lead, L)


istft_ct2.launches = 0
istft_ct2.form = None
