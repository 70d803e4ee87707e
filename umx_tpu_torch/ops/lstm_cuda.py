"""The BLSTM recurrence kernels and their plain PyTorch versions: the
merged recurrence and its backward (``csrc/lstm_merged.cu``,
``csrc/lstm_train.cu``), the per-target recurrence
(``csrc/lstm_pertarget.cu``), and the float32 recurrence and its backward
(``csrc/lstm_scan.cu``, ``csrc/lstm_scan_train.cu``).

Every entry has the contract of the TPU kernel it replaces
(``umx_tpu/ops/lstm_pallas.py``): R independent chains of B rows each,
rows chain-major (``row = r*B + b``), W_hh in bf16, products of bf16
operands accumulated in f32, gate math and the c/h state (and in the
backward the dh/dc carries) in f32.

- K1 :func:`lstm_merged`: the inference recurrence (``_make_merged_kernel``),
  one launch per layer with W_hh resident in registers.
- K4 :func:`lstm_merged_train_fwd`: the same kernel with a flag that also
  writes the residuals of the backward, activated gates and c per step
  (``_make_merged_train_kernel``).
- K5 :func:`lstm_merged_bwd_step` and K6 :func:`lstm_merged_dw`: the
  reverse-time sweep, one resident launch per layer with W_hh in registers,
  and the weight gradient (``_make_merged_bwd_kernel``), a TMA-fed wgmma
  GEMM over clusters of two blocks (``csrc/lstm_dw.cu``, :func:`dw_plan`).
- K9 :func:`lstm_layer_pertarget`: the same function as K1 at one batch
  row in the per-target layout (T#, T, D, 4G), one launch per layer with
  each chain on a thread-block cluster that keeps its W_hh and state on
  chip (``_make_kernel``, reached by ``lstm_layer_pallas``).

K1, K4, K5 and K9 take every width, as the TPU kernels do
(:func:`merged_form`): up to G 512 the resident forms, with G % 8 != 0
padded by zero units (:func:`at_width`: a zero unit's gates are 0, its c
and h stay exactly 0 and it adds +0 to every real sum, so the cut result
is the unpadded function's); above G 512, where a warp's slice of W_hh no
longer fits its registers, the "wide" forms, padded the same way.  K1 and
K4 stay resident there: the same kernel in another block form
(:func:`merged_wide_plan`), its further k-tiles of bf16 W_hh in shared
memory; only where no block form holds one chain (above G 1952 on an
H100) do they stream W_hh from L2 each step (K10's streaming kernel with
the product's h rounded to bf16, the form they took before, kept by name
as their yardstick).  K5 keeps W_hh on the chip too, in a block form that
splits the contraction over a chain's blocks (:func:`merged_bwd_wide_plan`,
``csrc/lstm_train.cu``); above G 1024 it streams (K11's streaming sweep
with dg rounded to bf16, its yardstick by name).  K9 runs its chains
through the wide K1 where no cluster holds a chain's W_hh.
- K10 :func:`lstm_scan` (``csrc/lstm_scan.cu``): the float32 recurrence
  of the JAX package's ``lax.scan`` (``_bilstm_layer``, its
  ``lstm_impl="scan"``), no Pallas kernel: K1's layouts, but unrounded f32
  h against W_hh in its stored dtype (f32, or bf16 upcast exactly), f32
  FMA on the CUDA cores, any G; one launch per layer, W_hh resident on
  the chip (registers and shared memory) up to G 512, on the chip in the
  wide form's smaller shares over more blocks up to G 640, read from L2
  each step above (:func:`scan_form`).
- K10 with residuals :func:`lstm_scan_train_fwd`: the same kernel with a
  flag that also writes the activated gates and c per step, as K4 is K1.
- K11 :func:`lstm_scan_bwd_step` (``csrc/lstm_scan_train.cu``): the
  reverse-time float32 sweep, the scan's VJP (no bf16 anywhere), one
  launch per layer in K10's three forms (W_hh as stored in the resident
  and wide forms, a transposed copy in the streaming one); the weight
  gradient :func:`lstm_scan_dw` is a plain f32 ``torch.bmm``, as the JAX
  package leaves it to XLA.

A wrapper runs its plain version for CPU tensors only; for CUDA tensors it
launches its kernel or raises, and adds one to its ``launches`` count per
kernel run.  :class:`LSTMMergedTrain` is the ``torch.autograd.Function``
over K4 and K5 + K6, :class:`LSTMScanTrain` the one over K10 with
residuals and K11 + the f32 dW; :func:`lstm_layer_merged_batched` and
:func:`lstm_layer_scan_batched` take them when a gradient is wanted and
K1 / K10 otherwise, as the JAX package's custom VJP runs the inference
kernel for primal-only evaluation.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from umx_tpu_torch import _build


def _bf16(x):
    """Round f32 to bf16 and back (the operand rounding of every product)."""
    return x.to(torch.bfloat16).float()


def _hh_product(h, w, B: int, round_h: bool = True):
    """bf16(h) (R*B, G) @ W_hh per chain (R, G, 4G) → (R*B, 4G); h as it
    is with ``round_h`` False.  One row per chain runs beside a zero row: a
    CPU BLAS computes a one-row product (a matrix-vector product) in
    another order than a wider one, and a row of a batched call must have
    the bits of the same row alone (the serving batcher's rows)."""
    R, G = w.shape[0], w.shape[1]
    hb = (_bf16(h) if round_h else h).view(R, B, G)
    if B == 1:
        hb = torch.cat([hb, torch.zeros_like(hb)], dim=1)
    return torch.bmm(hb, w)[:, :B].reshape(R * B, 4 * G)


def _cell(pre, c, G: int):
    """Activated gates (i, f, g, o) of the pre-activations, new c, new h."""
    i = torch.sigmoid(pre[:, :G])
    f = torch.sigmoid(pre[:, G : 2 * G])
    g = torch.tanh(pre[:, 2 * G : 3 * G])
    o = torch.sigmoid(pre[:, 3 * G :])
    c = f * c + i * g
    return (i, f, g, o), c, o * torch.tanh(c)


def _recurrence_plain(xp, whh, h0, c0, B: int, round_h: bool, residuals: bool):
    """The plain recurrence loop of K1/K4 (``round_h``) and K10: one batched
    matmul per timestep; with ``residuals`` also the activated gates and c
    of every step."""
    T, RB, G4 = xp.shape
    G = whh.shape[1]
    w = whh.float()
    h, c = h0, c0
    hs = torch.empty((T, RB, G), dtype=torch.float32, device=xp.device)
    if residuals:
        cs = torch.empty_like(hs)
        gates = torch.empty((T, RB, G4), dtype=torch.float32, device=xp.device)
    for t in range(T):
        pre = xp[t] + _hh_product(h, w, B, round_h)
        act, c, h = _cell(pre, c, G)
        if residuals:
            gates[t] = torch.cat(act, dim=1)
            cs[t] = c
        hs[t] = h
    return (hs, h, c, gates, cs) if residuals else (hs, h, c)


def _dh_product(dg, wt, B: int):
    """dg (R*B, 4G) @ W_hhᵀ per chain (R, 4G, G) → (R*B, G), as the sum of
    the four gates' products in gate order, each a contraction over G (so
    zero units appended to each gate block add +0 at the end of a sum).
    One row per chain runs beside a zero row, as in :func:`_hh_product`."""
    R, G = wt.shape[0], wt.shape[2]
    d = dg.view(R, B, 4, G)
    if B == 1:
        d = torch.cat([d, torch.zeros_like(d)], dim=1)
    out = None
    for q in range(4):
        p = torch.bmm(d[:, :, q], wt[:, q * G:(q + 1) * G])
        out = p if out is None else out + p
    return out[:, :B].reshape(R * B, G)


def _sweep_plain(gates, cs, c0, whh, dhs, dhT, dcT, B: int, round_dg: bool):
    """The plain reverse-time sweep of K5 (``round_dg``: the gate
    cotangents rounded to bf16 before their product with W_hhᵀ) and K11,
    in the TPU backward kernel's operation order → (dxp, dh0, dc0)."""
    T, RB, G4 = gates.shape
    R, G = whh.shape[0], whh.shape[1]
    wt = whh.float().transpose(1, 2)  # (R, 4G, G)
    dxp = torch.empty((T, RB, G4), dtype=torch.float32, device=gates.device)
    dh, dc = dhT, dcT
    for t in range(T - 1, -1, -1):
        g4 = gates[t]
        i, f, g, o = g4[:, :G], g4[:, G : 2 * G], g4[:, 2 * G : 3 * G], g4[:, 3 * G :]
        cprev = cs[t - 1] if t > 0 else c0
        tc = torch.tanh(cs[t])
        dh = dh + dhs[t]
        do = dh * tc
        dct = dc + dh * o * (1.0 - tc * tc)
        dg = torch.cat([
            dct * g * i * (1.0 - i),
            dct * cprev * f * (1.0 - f),
            dct * i * (1.0 - g * g),
            do * o * (1.0 - o),
        ], dim=1)
        dxp[t] = dg
        dh = _dh_product(_bf16(dg) if round_dg else dg, wt, B)
        dc = dct * f
    return dxp, dh, dc


def lstm_merged_plain(xp, whh, h0, c0, B: int):
    """Plain PyTorch recurrence: one batched matmul per timestep.

    xp (T, R*B, 4G) f32, whh (R, G, 4G) bf16, h0/c0 (R*B, G) f32 →
    (hs (T, R*B, G), hT, cT).  h is rounded to bf16 before each product
    and the bf16 weights are exact in f32, so every product is exact and
    only the f32 summation order differs from the kernel."""
    return _recurrence_plain(xp, whh, h0, c0, B, round_h=True, residuals=False)


def lstm_merged_train_fwd_plain(xp, whh, h0, c0, B: int):
    """:func:`lstm_merged_plain` plus the residuals of the backward:
    returns (hs, hT, cT, gates (T, R*B, 4G) activated i|f|g|o, cs (T, R*B, G))."""
    return _recurrence_plain(xp, whh, h0, c0, B, round_h=True, residuals=True)


def lstm_merged_bwd_step_plain(gates, cs, c0, whh, dhs, dhT, dcT, B: int):
    """Plain reverse-time sweep, in the TPU backward kernel's operation
    order: returns (dxp (T, R*B, 4G), dh0, dc0), all f32.  The gate
    cotangents are rounded to bf16 before their product with W_hhᵀ and the
    dh/dc carries stay f32 (autograd through :func:`lstm_merged_plain`
    would round the dh carry to bf16 at every step instead)."""
    return _sweep_plain(gates, cs, c0, whh, dhs, dhT, dcT, B, round_dg=True)


def lstm_merged_dw_plain(hs, h0, dxp, B: int):
    """Plain weight gradient: dW[r] = Σ over t, b of bf16(h_{t-1})ᵀ bf16(dxp_t),
    h_{-1} = h0, f32 accumulation → (R, G, 4G)."""
    return lstm_scan_dw(_bf16(hs), _bf16(h0), _bf16(dxp), B)


def lstm_merged_bwd_plain(gates, cs, hs, h0, c0, whh, dhs, dhT, dcT, B: int):
    """Plain backward of one layer: (dxp, dW (R, G, 4G), dh0, dc0)."""
    dxp, dh0, dc0 = lstm_merged_bwd_step_plain(gates, cs, c0, whh, dhs, dhT, dcT, B)
    return dxp, lstm_merged_dw_plain(hs, h0, dxp, B), dh0, dc0


def _check(ref, specs):
    """Validate ``specs`` = [(name, tensor, shape, dtype)] against the
    reference tensor's device; returns "cpu" or "cuda" for the route."""
    for name, t, shape, dt in specs:
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} must be {tuple(shape)}, got {tuple(t.shape)}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if t.device != ref.device:
            raise ValueError(f"{name} is on {t.device}, expected {ref.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if ref.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {ref.device}")
    return ref.device.type


def _dims(xp_or_gates, whh, B: int):
    """(T, R, G) from a (T, R*B, 4G) tensor and whh (R, G, 4G)."""
    if xp_or_gates.dim() != 3:
        raise ValueError(f"expected (T, R*B, 4G), got shape {tuple(xp_or_gates.shape)}")
    T, RB, G4 = xp_or_gates.shape
    if whh.dim() != 3 or whh.shape[2] != G4 or G4 != 4 * whh.shape[1]:
        raise ValueError(f"whh must be (R, G, 4G) matching 4G={G4}, got {tuple(whh.shape)}")
    R, G = whh.shape[0], whh.shape[1]
    if B < 1 or RB != R * B:
        raise ValueError(f"rows {RB} != R*B = {R}*{B}")
    if T < 1:
        raise ValueError("no timesteps")
    return T, R, G


def _check_whh_vectors(whh, G: int):
    # the kernels read W_hh rows as 16-byte vectors of 8 bf16
    if G % 8 != 0 or whh.data_ptr() % 16 != 0:
        raise ValueError(f"the kernels need G % 8 == 0 and a 16-byte aligned whh (G={G})")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


# The resident kernels (K1 and K4, csrc/lstm_merged.cu; K5,
# csrc/lstm_train.cu): a block of 8 warps owns 32 hidden units of one chain,
# a launch takes up to 16 rows per chain (two mma n-tiles), and a warp's
# W_hh slice must fit 128 registers a thread.
RESIDENT_UNITS = 32
RESIDENT_ROWS = 16
RESIDENT_G_MAX = 512
# K5: flag words per chain (one 128-byte line, one word per producer block)
BWD_FLAG_WORDS = 32


def resident_blocks_per_chain(G: int) -> int:
    """Blocks that share one chain in a resident kernel: one per 32 hidden units."""
    return -(-G // RESIDENT_UNITS)


def resident_row_groups(B: int, rows: int = RESIDENT_ROWS) -> list[tuple[int, int]]:
    """(first row, rows) of a resident kernel's launches over B rows per
    chain: groups of ``rows`` (16, or 8 where a wide block form's shared
    memory holds no more), the last one ragged.  Rows are independent, so
    a row's result does not depend on its group."""
    return [(b0, min(rows, B - b0)) for b0 in range(0, B, rows)]


def chain_groups(R: int, per_chain: int, capacity: int, what: str) -> list[tuple[int, int]]:
    """(first chain, chains) of a kernel's launches over R chains of
    ``per_chain`` blocks each, on a device that holds ``capacity`` of its
    blocks at once: a launch's blocks must all be resident, because a
    chain's blocks wait for each other.  Raises where not even one chain
    fits."""
    per = capacity // per_chain
    if per < 1:
        raise RuntimeError(f"{what} needs {per_chain} co-resident blocks per chain; this "
                           f"device holds {capacity}")
    return [(r0, min(per, R - r0)) for r0 in range(0, R, per)]


def resident_chain_groups(R: int, G: int, capacity: int) -> list[tuple[int, int]]:
    """:func:`chain_groups` of a resident kernel (K1, K4, K5) at width G."""
    return chain_groups(R, resident_blocks_per_chain(G), capacity,
                        f"the resident recurrence at G = {G}")


def resident_exchange_words(R: int, G: int) -> int:
    """64-bit words of the forward's exchange buffer (K1, K4): per chain
    two steps of 16 rows of G/2 words (two bf16 values of h and the step's
    tag each)."""
    return R * 2 * RESIDENT_ROWS * (G // 2)


def bwd_exchange_elems(R: int, G: int) -> int:
    """bf16 elements of K5's exchange buffer: per chain two steps of 16
    rows of 4G gate cotangents (four times the forward's h)."""
    return R * 2 * RESIDENT_ROWS * 4 * G


def bwd_flag_words(R: int) -> int:
    """32-bit words of K5's flags: one line per chain, one word per block."""
    return R * BWD_FLAG_WORDS


_CUDA_ERROR_INVALID_CONFIGURATION = 9


@functools.lru_cache(maxsize=None)
def _resident_capacity(index: int, kernel: str, G: int = 0) -> int:
    """Blocks of resident kernel ``kernel`` ("K1", "K4" or "K5", the last
    at width G, which sets its shared memory) that CUDA device ``index``
    holds at once: a property of the device and the built kernel, asked
    once.  K1 and K4 in their own block form (8 warps) up to G 512."""
    if kernel == "K5":
        import ctypes

        blocks = ctypes.c_int(0)
        with torch.cuda.device(index):
            err = _build.library().umx_lstm_bwd_capacity(G, ctypes.addressof(blocks))
        if err == _CUDA_ERROR_INVALID_CONFIGURATION:
            raise RuntimeError("K5: this device has no cooperative launch, which the resident "
                               "recurrence needs")
        _build.check(err, "K5 capacity")
        return blocks.value
    return merged_layout(index, RESIDENT_G_MAX, kernel == "K4", RESIDENT_WARPS,
                         RESIDENT_ROWS)[0]


# The resident kernel's block forms (csrc/lstm_merged.cu:resident_kreg):
# (warps a block, k-tiles of 16 a warp keeps in registers).  A warp owns 4
# hidden units (one mma row tile of 16 gate columns); its k-tiles beyond the
# registers' sit in shared memory.  K1's own form, up to G 512, is the first.
MERGED_BLOCK_FORMS = ((8, 32), (10, 20), (6, 40), (4, 40))
RESIDENT_WARPS = 8
# registers a thread uses beside its register tiles (K1 at two n-tiles: 212,
# 128 of them W_hh; ptxas on sm_90a)
MERGED_OTHER_REGS = 84
MERGED_HPAD = 4  # words of padding a row of h in shared memory
# The widest G whose chain one of the block forms holds on an H100 (132 SMs,
# 227 KiB of shared memory a block, 64 Ki registers an SM): 4 warps of 16
# units, 122 blocks a chain, 40 k-tiles a warp in registers and 82 in shared
# memory beside h of 8 rows (227.5 of 227 KiB at G 1960).  Above it the
# wide K1/K4 stream W_hh (a chain is 8 G^2 bytes: 30.5 MB at 1952).
MERGED_WIDE_G_MAX = 1952


def merged_thread_regs(warps: int, regs_per_sm: int) -> int:
    """The registers a thread of a block of ``warps`` warps may have, one
    block an SM: an SM's registers are four partitions', a block's warps
    spread over them (ceil(warps / 4) on one), allotted 8 at a time, at
    most 255 (168 at 10 warps on an H100)."""
    per = regs_per_sm // 4 // (32 * -(-warps // 4))
    return min(255, per // 8 * 8)


def merged_block_smem(G: int, warps: int, rows: int) -> int:
    """Dynamic shared memory of a block of the resident kernel in the block
    form of ``warps`` warps at width G (a multiple of 8) and a row tile of
    ``rows`` (8 or 16): h of two steps (rows x (8 ceil(G/16) + 4) words)
    and 16 bytes a thread for each k-tile beyond its registers'
    (``csrc/lstm_merged.cu:resident_smem``)."""
    kreg = dict(MERGED_BLOCK_FORMS)[warps]
    kt = -(-G // 16)
    return 4 * 2 * rows * (8 * kt + MERGED_HPAD) + 16 * max(0, kt - kreg) * 32 * warps


class MergedWidePlan(NamedTuple):
    """A block form of the wide K1/K4 (:func:`merged_wide_plan`)."""

    warps: int
    units: int  # hidden units a block owns, 4 a warp
    kreg: int  # k-tiles a warp keeps in registers
    ksmem: int  # k-tiles a warp keeps in shared memory
    rows: int  # rows per chain a launch takes: 16, or 8
    blocks_per_chain: int
    chains_per_group: int  # chains a launch holds, one block an SM
    smem: int  # dynamic shared memory a block asks for


def merged_wide_plan(G: int, R: int, sms: int, smem_per_block: int,
                     regs_per_sm: int) -> MergedWidePlan | None:
    """The block form the wide K1 and K4 run R chains of width G (a
    multiple of 8) in, from the card's figures alone: ``sms``, the shared
    memory a block may ask for and the 32-bit registers of an SM (an H100:
    132, 232448, 65536).  A block is one SM; a form holds a chain where its
    blocks a chain are no more than the SMs, a thread's register tiles and
    other registers fit what it may have (:func:`merged_thread_regs`), and
    its shared memory (at 16 rows, else 8) fits a block.  Among those, the
    fewest chain groups win, then the most rows a launch, then the fewest
    units a block (the shortest step).
    None where no form holds one chain (G above ``MERGED_WIDE_G_MAX`` on
    an H100): the wide K1/K4 then stream W_hh."""
    if G < 8 or G % 8:
        raise ValueError(f"the block forms take G % 8 == 0, got {G}")
    best = None
    for warps, kreg in MERGED_BLOCK_FORMS:
        units = 4 * warps
        per_chain = -(-G // units)
        if per_chain > sms or 4 * kreg + MERGED_OTHER_REGS > merged_thread_regs(warps,
                                                                               regs_per_sm):
            continue
        rows = next((r for r in (RESIDENT_ROWS, 8)
                     if merged_block_smem(G, warps, r) <= smem_per_block), None)
        if rows is None:
            continue
        per = min(R, sms // per_chain)
        kt = -(-G // 16)
        plan = MergedWidePlan(warps, units, min(kt, kreg), max(0, kt - kreg), rows, per_chain,
                              per, merged_block_smem(G, warps, rows))
        key = (-(-R // per), -rows, units)
        if best is None or key < best[0]:
            best = (key, plan)
    return None if best is None else best[1]


# K5's block forms (csrc/lstm_train.cu:bww_kreg): (m-tiles of 16 units a
# warp takes of the chain's product, units a block owns, k-tiles of 16 gate
# columns a warp keeps in registers).  A block has 8 warps; it owns its
# units' 4 x units gate columns of the contraction (units / 4 local
# k-tiles) against every unit of the chain, so a warp has m-tiles x units /
# 4 tiles of W_hh^T, the first in registers, the rest in shared memory.
# The first form that holds G runs it: the sum order is the form's, so the
# form depends on G and the card alone, never on R or B.
BWD_BLOCK_FORMS = ((5, 40, 24), (8, 32, 20))
BWD_BLOCK_WARPS = 8
# registers a thread of each form uses beside its register tiles, by
# m-tiles a warp (ptxas on sm_90a gives both forms 255 a thread at two
# n-tiles of rows: 96 and 80 of them tiles)
BWD_BLOCK_OTHER_REGS = {5: 159, 8: 175}
BWD_BLOCK_FLAG_WORDS = 128  # flag words a chain: one per block
# The widest G the block forms hold (8 warps x 8 m-tiles x 16 units); above
# it the wide K5 streams W_hh.  At 1024 a chain is 32 blocks of 32 units,
# 8.4 MB of bf16 W_hh; R 8 run as two chain groups of four.
BWD_WIDE_G_MAX = 1024


def bwd_block_smem(mtw: int, units: int, kreg: int, rows: int) -> int:
    """Dynamic shared memory of a block of K5's block form at a row tile of
    ``rows`` (8 or 16): the shared tiles, 16 bytes a thread each, and the
    block's bf16 dg rows, rows x (2 units + 4) words
    (``csrc/lstm_train.cu:bww_smem_bytes``)."""
    return 16 * (mtw * units // 4 - kreg) * 32 * BWD_BLOCK_WARPS + 4 * rows * (2 * units + 4)


class BwdBlockPlan(NamedTuple):
    """A block form of the wide K5 (:func:`merged_bwd_wide_plan`)."""

    mtw: int  # m-tiles of 16 units a warp takes of the chain's product
    units: int  # units a block owns (and their 4 x units gate columns)
    kreg: int  # tiles of W_hh^T a warp keeps in registers
    ksmem: int  # tiles a warp keeps in shared memory
    rows: int  # rows per chain a launch takes: 16, or 8
    blocks_per_chain: int
    chains_per_group: int  # chains a launch holds, one block an SM
    smem: int  # dynamic shared memory a block asks for


def merged_bwd_wide_plan(G: int, R: int, sms: int, smem_per_block: int,
                         regs_per_sm: int) -> BwdBlockPlan | None:
    """The block form the wide K5 runs R chains of width G (a multiple of
    8) in, from the card's figures alone (:func:`merged_wide_plan`'s): the
    first form of ``BWD_BLOCK_FORMS`` whose warps' m-tiles cover the chain's
    units, whose blocks a chain are no more than the SMs (and its flag
    words), whose thread's registers fit what a thread of 8 warps may have
    (:func:`merged_thread_regs`) and whose shared memory (at 16 rows, else
    8) fits a block.  The form does not depend on R (a chain's bits do not
    depend on the chains beside it); R sets the chains a launch holds.
    None where no form holds one chain (G above ``BWD_WIDE_G_MAX`` on an
    H100): the wide K5 then streams W_hh."""
    if G < 8 or G % 8:
        raise ValueError(f"the block forms take G % 8 == 0, got {G}")
    for mtw, units, kreg in BWD_BLOCK_FORMS:
        per_chain = -(-G // units)
        if (-(-G // 16) > BWD_BLOCK_WARPS * mtw or per_chain > min(sms, BWD_BLOCK_FLAG_WORDS)
                or 4 * kreg + BWD_BLOCK_OTHER_REGS[mtw] > merged_thread_regs(BWD_BLOCK_WARPS,
                                                                             regs_per_sm)):
            continue
        rows = next((r for r in (RESIDENT_ROWS, 8)
                     if bwd_block_smem(mtw, units, kreg, r) <= smem_per_block), None)
        if rows is None:
            continue
        tiles = mtw * units // 4
        return BwdBlockPlan(mtw, units, kreg, tiles - kreg, rows, per_chain,
                            min(R, sms // per_chain), bwd_block_smem(mtw, units, kreg, rows))
    return None


def bwd_block_exchange_floats(R: int, G: int, blocks_per_chain: int) -> int:
    """f32 elements of the block form's exchange: per chain two steps of
    each block's partial sums, 16 rows of G units."""
    return R * 2 * blocks_per_chain * RESIDENT_ROWS * G


@functools.lru_cache(maxsize=None)
def bwd_block_layout(index: int, mtw: int, units: int, rows: int) -> tuple[int, int]:
    """What K5's block form (``mtw``, ``units``) reports of itself on CUDA
    device ``index`` at a row tile of ``rows``, asked once: (the blocks the
    device holds at once, the dynamic shared memory a block asks for)."""
    import ctypes

    blocks, smem = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(index):
        err = _build.library().umx_lstm_bwd_block_layout(mtw, units, rows,
                                                         ctypes.addressof(blocks),
                                                         ctypes.addressof(smem))
    if err == _CUDA_ERROR_INVALID_CONFIGURATION:
        raise RuntimeError("K5: this device has no cooperative launch, which the block form "
                           "needs")
    _build.check(err, "umx_lstm_bwd_block_layout")
    return blocks.value, smem.value


@functools.lru_cache(maxsize=None)
def device_limits(index: int) -> tuple[int, int, int]:
    """(SMs, the shared memory a block may ask for, registers an SM) of
    CUDA device ``index``: the figures :func:`merged_wide_plan` plans from."""
    import ctypes

    out = [ctypes.c_int(0) for _ in range(3)]
    with torch.cuda.device(index):
        err = _build.library().umx_device_limits(*(ctypes.addressof(v) for v in out))
    _build.check(err, "umx_device_limits")
    return tuple(v.value for v in out)


@functools.lru_cache(maxsize=None)
def merged_layout(index: int, G: int, resid: bool, warps: int, rows: int) -> tuple[int, int]:
    """What the resident kernel in the block form of ``warps`` warps
    reports of itself on CUDA device ``index`` at width G and a row tile of
    ``rows``, for K1 or (``resid``) K4, asked once: (the blocks the device
    holds at once, the dynamic shared memory a block asks for)."""
    import ctypes

    blocks, smem = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(index):
        err = _build.library().umx_lstm_merged_layout(G, int(resid), warps, rows,
                                                      ctypes.addressof(blocks),
                                                      ctypes.addressof(smem))
    if err == _CUDA_ERROR_INVALID_CONFIGURATION:
        raise RuntimeError("K1/K4: this device has no cooperative launch, which the resident "
                           "recurrence needs")
    _build.check(err, "umx_lstm_merged_layout")
    return blocks.value, smem.value


# the resident kernels (and K9) read W_hh rows as 16-byte vectors of 8 bf16
MERGED_G_ALIGN = 8


def _aligned(G: int) -> int:
    """G rounded up to a multiple of ``MERGED_G_ALIGN``."""
    return -(-G // MERGED_G_ALIGN) * MERGED_G_ALIGN


def merged_form(G: int) -> str:
    """The form K1, K4 and K5 take at width G, chosen before any launch:
    "resident" (W_hh in registers; G % 8 != 0 padded to the next multiple
    of 8) up to ``RESIDENT_G_MAX``, "wide" above (W_hh on the chip in a
    block form: K1 and K4 in a wider form of their kernel,
    :func:`merged_wide_plan`; K5 in a form that splits the contraction over
    a chain's blocks, :func:`merged_bwd_wide_plan`; each streaming W_hh
    where no block form holds a chain)."""
    if G < 1:
        raise ValueError(f"G must be positive, got {G}")
    return "resident" if G <= RESIDENT_G_MAX else "wide"


def merged_width(G: int) -> int:
    """The width the resident kernels and the block forms of K1, K4 and K5
    launch at: G rounded up to a multiple of 8 (the streaming yardsticks
    run at G itself)."""
    return _aligned(G)


def pad_width(t, kind: str, G: int, Gp: int):
    """``t`` at width Gp >= G, zero units appended: ``kind`` "units" pads
    the last axis (…, G); "gates" each of the four gate blocks of the last
    axis (…, 4G), laid out i|f|g|o with column gate·G + unit; "whh" the rows
    and the gate blocks of (…, G, 4G)."""
    if kind == "units":
        return torch.nn.functional.pad(t, (0, Gp - G)).contiguous()
    if kind == "gates":
        lead = t.shape[:-1]
        return torch.nn.functional.pad(t.reshape(*lead, 4, G), (0, Gp - G)).reshape(
            *lead, 4 * Gp).contiguous()
    if kind == "whh":
        return pad_width(torch.nn.functional.pad(t, (0, 0, 0, Gp - G)), "gates", G, Gp)
    raise ValueError(f"kind must be units, gates or whh, got {kind!r}")


def cut_width(t, kind: str, G: int, Gp: int):
    """:func:`pad_width`'s inverse: the first G units of each block."""
    if kind == "units":
        return t[..., :G].contiguous()
    if kind == "gates":
        lead = t.shape[:-1]
        return t.reshape(*lead, 4, Gp)[..., :G].reshape(*lead, 4 * G).contiguous()
    if kind == "whh":
        return cut_width(t[..., :G, :], "gates", G, Gp)
    raise ValueError(f"kind must be units, gates or whh, got {kind!r}")


def at_width(fn, G: int, Gp: int, args, kinds, out_kinds):
    """``fn(*args)`` run at width Gp: each argument padded by its kind of
    ``kinds`` (None: as it is), each output cut by its kind of
    ``out_kinds``.  Zero units leave the real units' results exact (a zero
    unit's pre-activations are 0: i = f = o = 1/2, g = 0, so its c and h
    stay 0, its gate cotangents are 0, and it adds 0 to every real sum)."""
    if Gp == G:
        return fn(*args)
    padded = [a if k is None else pad_width(a, k, G, Gp) for a, k in zip(args, kinds)]
    return tuple(cut_width(o, k, G, Gp) for o, k in zip(fn(*padded), out_kinds))


_FWD_KINDS = ("gates", "whh", "units", "units", None)
_FWD_OUT = ("units", "units", "units", "gates", "units")  # hs, hT, cT, gates, cs
_BWD_KINDS = ("gates", "units", "units", "whh", "units", "units", "units", None)
_BWD_OUT = ("gates", "units", "units")  # dxp, dh0, dc0


def _resident_plan(wrapper, kernel: str, xp, R: int, B: int, G: int):
    """Chain groups and row groups of one layer's launches; leaves the form
    in ``wrapper.form`` as (blocks per chain, blocks the device holds at
    once, chain groups, row groups)."""
    capacity = _resident_capacity(xp.device.index, kernel, G if kernel == "K5" else 0)
    chains = resident_chain_groups(R, G, capacity)
    rows = resident_row_groups(B)
    wrapper.form = (resident_blocks_per_chain(G), capacity, len(chains), len(rows))
    return [(r0, nr, b0, nb) for r0, nr in chains for b0, nb in rows]


MERGED_WIDE_FORMS = ("wide", "wide_streaming")


def _merged_forward(wrapper, xp, whh, h0, c0, B: int, residuals: bool, form: str | None):
    """K1 (``residuals`` False) or K4 on CUDA tensors, in the form of
    :func:`merged_form` at :func:`merged_width` (``form``: a wide form by
    name, for the checks that compare them), or their plain versions on
    CPU tensors: the launches of one layer, counted once in
    ``wrapper.launches``."""
    T, R, G = _dims(xp, whh, B)
    RB = R * B
    route = _check(xp, [
        ("xp", xp, xp.shape, torch.float32), ("whh", whh, whh.shape, torch.bfloat16),
        ("h0", h0, (RB, G), torch.float32), ("c0", c0, (RB, G), torch.float32),
    ])
    if form is not None and (form not in MERGED_WIDE_FORMS or merged_form(G) != "wide"):
        raise ValueError(f"form must be None or, above G {RESIDENT_G_MAX}, one of "
                         f"{MERGED_WIDE_FORMS}; got {form!r} at G = {G}")
    if route == "cpu":
        plain = lstm_merged_train_fwd_plain if residuals else lstm_merged_plain
        return plain(xp, whh, h0, c0, B)
    return _merged_launches(wrapper, xp, whh, h0, c0, B, residuals, form)


def _merged_launches(wrapper, xp, whh, h0, c0, B: int, residuals: bool, form: str | None = None):
    """K1 or K4 on checked CUDA tensors: K1's block form up to G 512, the
    wide block form of :func:`merged_wide_plan` above, or the streaming form
    where no block form holds a chain (or by name, ``form``)."""
    T, R, G = _dims(xp, whh, B)
    Gp = merged_width(G)
    plan = None
    if merged_form(G) == "wide":
        plan = merged_wide_plan(Gp, R, *device_limits(xp.device.index))
        form = form or ("wide" if plan is not None else "wide_streaming")
        if form == "wide_streaming":
            return _streaming_forward(wrapper, xp, whh, h0, c0, B, residuals)
        if plan is None:
            raise RuntimeError(f"no block form of the resident kernel holds one chain at G = "
                               f"{G} on this device")
    n = 5 if residuals else 3
    return at_width(lambda *a: _resident_forward(wrapper, *a, residuals, plan), G, Gp,
                    (xp, whh, h0, c0, B), _FWD_KINDS, _FWD_OUT[:n])


def _resident_forward(wrapper, xp, whh, h0, c0, B: int, residuals: bool,
                      plan: MergedWidePlan | None = None):
    """The resident K1 or K4 on checked CUDA tensors at G % 8 == 0: the
    launches of one layer over its chain and row groups, in K1's block form
    (``plan`` None) or a wide one."""
    T, R, G = _dims(xp, whh, B)
    RB = R * B
    _check_whh_vectors(whh, G)
    lib = _build.library()
    if plan is None:
        warps = RESIDENT_WARPS
        groups = _resident_plan(wrapper, "K4" if residuals else "K1", xp, R, B, G)
    else:
        warps = plan.warps
        capacity, smem = merged_layout(xp.device.index, G, residuals, warps, plan.rows)
        if smem != plan.smem:
            raise RuntimeError(f"the wide block form's shared memory {smem} is not the "
                               f"planned {plan.smem} (G {G}, {warps} warps, {plan.rows} rows)")
        chains = chain_groups(R, plan.blocks_per_chain, capacity,
                              f"the wide resident recurrence at G = {G}")
        rows = resident_row_groups(B, plan.rows)
        wrapper.form = ("wide", plan.blocks_per_chain, capacity, len(chains), len(rows),
                        plan.units)
        groups = [(r0, nr, b0, nb) for r0, nr in chains for b0, nb in rows]
    dev = xp.device
    hs = torch.empty((T, RB, G), dtype=torch.float32, device=dev)
    hT = torch.empty((RB, G), dtype=torch.float32, device=dev)
    cT = c0.clone()  # the kernel updates c in place
    hx = torch.zeros(resident_exchange_words(R, G), dtype=torch.int64, device=dev)
    extra = ()
    if residuals:
        extra = (torch.empty((T, RB, 4 * G), dtype=torch.float32, device=dev),  # gates
                 torch.empty((T, RB, G), dtype=torch.float32, device=dev))  # cs
    ptrs = [t.data_ptr() for t in extra] or [None, None]
    for launched, (r0, nr, b0, nb) in enumerate(groups):
        err = lib.umx_lstm_merged(
            xp.data_ptr(), whh.data_ptr(), h0.data_ptr(), cT.data_ptr(), hs.data_ptr(),
            hT.data_ptr(), *ptrs, hx.data_ptr(), T, R, B, G, warps, r0, nr, b0, nb,
            launched * T, _stream(xp),
        )
        _build.check(err, "umx_lstm_merged")
    wrapper.launches += 1
    return (hs, hT, cT, *extra)


def lstm_merged(xp, whh, h0, c0, B: int, *, _form: str | None = None):
    """K1: one BLSTM layer's recurrence for all chains (see module docstring).

    xp (T, R*B, 4G) f32, whh (R, G, 4G) bf16, h0/c0 (R*B, G) f32 →
    (hs (T, R*B, G), hT, cT).  One kernel launch runs all T steps of all
    chains and up to 16 rows per chain; further rows (and chains beyond
    what the device holds at once) are further launches of the same
    kernel.  Any G (:func:`merged_form`): up to 512 with W_hh resident in
    registers (G % 8 != 0 padded by zero units), above in a wide block
    form with W_hh in registers and shared memory
    (:func:`merged_wide_plan`; the private ``_form`` names "wide" or its
    streaming yardstick "wide_streaming", for the checks that compare
    them).  The form that ran is left in ``lstm_merged.form``: resident as
    (blocks per chain, blocks the device holds at once, chain groups, row
    groups), wide as ("wide", the same four, units a block), streaming as
    ("wide_streaming", the same four).  Increments ``lstm_merged.launches``
    once per layer."""
    return _merged_forward(lstm_merged, xp, whh, h0, c0, B, False, _form)


lstm_merged.launches = 0
lstm_merged.form = None


def lstm_merged_train_fwd(xp, whh, h0, c0, B: int, *, _form: str | None = None):
    """K4: :func:`lstm_merged` plus the residuals → (hs, hT, cT, gates
    (T, R*B, 4G) activated i|f|g|o, cs (T, R*B, G)).  The same kernel as
    K1, in the same form, with the residual stores compiled in: one launch
    per layer and group of rows, any B, any G, hs/hT/cT bit-equal to K1's
    (``_form`` as :func:`lstm_merged`'s).  Leaves its form in
    ``lstm_merged_train_fwd.form`` and counts
    ``lstm_merged_train_fwd.launches`` once per layer."""
    return _merged_forward(lstm_merged_train_fwd, xp, whh, h0, c0, B, True, _form)


lstm_merged_train_fwd.launches = 0
lstm_merged_train_fwd.form = None


def lstm_merged_bwd_step(gates, cs, c0, whh, dhs, dhT, dcT, B: int, *,
                         _form: str | None = None):
    """K5: the reverse-time sweep → (dxp (T, R*B, 4G), dh0, dc0), all f32.
    One launch runs all T steps (and the product that gives dh0) of all
    chains and up to 16 rows per chain; further rows and chains are
    further launches, any B.  Any G, in :func:`merged_form`'s form (G % 8
    != 0 padded by zero units): up to 512 resident (W_hh in registers, a
    block owns 32 units against all 4G gate columns), above in a block form
    that keeps bf16 W_hh in registers and shared memory with the
    contraction split over the chain's blocks (:func:`merged_bwd_wide_plan`;
    the private ``_form`` names "wide" or its streaming yardstick
    "wide_streaming", K11's streaming sweep with the gate cotangents rounded
    to bf16 for the product, which also runs where no block form holds a
    chain).  The form that ran is left in ``lstm_merged_bwd_step.form``:
    resident as (blocks per chain, blocks the device holds at once, chain
    groups, row groups), the block form as ("wide", the same four, units a
    block), streaming as ("wide_streaming", the same four).  Counts
    ``lstm_merged_bwd_step.launches`` once per sweep."""
    T, R, G = _dims(gates, whh, B)
    RB = R * B
    route = _check(gates, [
        ("gates", gates, gates.shape, torch.float32), ("cs", cs, (T, RB, G), torch.float32),
        ("c0", c0, (RB, G), torch.float32), ("whh", whh, whh.shape, torch.bfloat16),
        ("dhs", dhs, (T, RB, G), torch.float32), ("dhT", dhT, (RB, G), torch.float32),
        ("dcT", dcT, (RB, G), torch.float32),
    ])
    if _form is not None and (_form not in MERGED_WIDE_FORMS or merged_form(G) != "wide"):
        raise ValueError(f"form must be None or, above G {RESIDENT_G_MAX}, one of "
                         f"{MERGED_WIDE_FORMS}; got {_form!r} at G = {G}")
    if route == "cpu":
        return lstm_merged_bwd_step_plain(gates, cs, c0, whh, dhs, dhT, dcT, B)
    args = (gates, cs, c0, whh, dhs, dhT, dcT, B)
    Gp = merged_width(G)
    if merged_form(G) == "wide":
        plan = merged_bwd_wide_plan(Gp, R, *device_limits(gates.device.index))
        form = _form or ("wide" if plan is not None else "wide_streaming")
        if form == "wide_streaming":
            return _streaming_bwd(*args)
        if plan is None:
            raise RuntimeError(f"no block form of K5 holds one chain at G = {G} on this device")
        return at_width(lambda *a: _block_bwd(*a, plan), G, Gp, args, _BWD_KINDS, _BWD_OUT)
    return at_width(_resident_bwd, G, Gp, args, _BWD_KINDS, _BWD_OUT)


def _resident_bwd(gates, cs, c0, whh, dhs, dhT, dcT, B: int):
    """The resident K5 on checked CUDA tensors at G % 8 == 0."""
    T, R, G = _dims(gates, whh, B)
    RB = R * B
    _check_whh_vectors(whh, G)
    lib = _build.library()
    dev = gates.device
    plan = _resident_plan(lstm_merged_bwd_step, "K5", gates, R, B, G)
    dxp = torch.empty((T, RB, 4 * G), dtype=torch.float32, device=dev)
    dh0 = torch.empty((RB, G), dtype=torch.float32, device=dev)
    dc = dcT.clone()  # the kernel carries dc in place; it ends as dc0
    dgx = torch.empty(bwd_exchange_elems(R, G), dtype=torch.bfloat16, device=dev)
    flags = torch.zeros(bwd_flag_words(R), dtype=torch.int32, device=dev)
    for launched, (r0, nr, b0, nb) in enumerate(plan):
        err = lib.umx_lstm_bwd(
            gates.data_ptr(), cs.data_ptr(), c0.data_ptr(), whh.data_ptr(), dhs.data_ptr(),
            dhT.data_ptr(), dc.data_ptr(), dxp.data_ptr(), dh0.data_ptr(), dgx.data_ptr(),
            flags.data_ptr(), T, R, B, G, r0, nr, b0, nb, launched * T, _stream(gates),
        )
        _build.check(err, "umx_lstm_bwd")
    lstm_merged_bwd_step.launches += 1
    return dxp, dh0, dc


def _block_bwd(gates, cs, c0, whh, dhs, dhT, dcT, B: int, plan: BwdBlockPlan):
    """K5's block form on checked CUDA tensors at G % 8 == 0: the launches
    of one layer over the plan's chain and row groups."""
    T, R, G = _dims(gates, whh, B)
    RB = R * B
    _check_whh_vectors(whh, G)
    dev = gates.device
    capacity, smem = bwd_block_layout(dev.index, plan.mtw, plan.units, plan.rows)
    if smem != plan.smem:
        raise RuntimeError(f"K5's block form's shared memory {smem} is not the planned "
                           f"{plan.smem} (G {G}, {plan.units} units, {plan.rows} rows)")
    chains = chain_groups(R, plan.blocks_per_chain, capacity, f"K5's block form at G = {G}")
    rows = resident_row_groups(B, plan.rows)
    lstm_merged_bwd_step.form = ("wide", plan.blocks_per_chain, capacity, len(chains), len(rows),
                                 plan.units)
    dxp = torch.empty((T, RB, 4 * G), dtype=torch.float32, device=dev)
    dh0 = torch.empty((RB, G), dtype=torch.float32, device=dev)
    dc = dcT.clone()  # the kernel carries dc in place; it ends as dc0
    px = torch.empty(bwd_block_exchange_floats(R, G, plan.blocks_per_chain),
                     dtype=torch.float32, device=dev)
    flags = torch.zeros(R * BWD_BLOCK_FLAG_WORDS, dtype=torch.int32, device=dev)
    lib = _build.library()
    groups = [(r0, nr, b0, nb) for r0, nr in chains for b0, nb in rows]
    for launched, (r0, nr, b0, nb) in enumerate(groups):
        err = lib.umx_lstm_bwd_block(
            gates.data_ptr(), cs.data_ptr(), c0.data_ptr(), whh.data_ptr(), dhs.data_ptr(),
            dhT.data_ptr(), dc.data_ptr(), dxp.data_ptr(), dh0.data_ptr(), px.data_ptr(),
            flags.data_ptr(), T, R, B, G, plan.mtw, plan.units, r0, nr, b0, nb, launched * T,
            _stream(gates),
        )
        _build.check(err, "umx_lstm_bwd_block")
    lstm_merged_bwd_step.launches += 1
    return dxp, dh0, dc


lstm_merged_bwd_step.launches = 0
lstm_merged_bwd_step.form = None


# K6, the weight gradient, in two forms: "wgmma" (``csrc/lstm_dw.cu``), the
# Hopper form, a TMA-fed warpgroup-MMA GEMM over clusters of two blocks, at
# every G (where TMA cannot take the operands' strides, G % 4 != 0, at a
# width padded with zero units: :func:`dw_width`), its contraction split
# over slices of blocks where the tiles alone leave the card nearly empty;
# "mma_sync" (``csrc/lstm_train.cu``), the earlier tensor-core kernel, by
# name only, as the Hopper form's yardstick.
DW_FORMS = ("wgmma", "mma_sync")
DW_BM = 128  # dW rows (hidden units) a block
DW_BK = 32  # (t, b) pairs a stage
DW_CLUSTER = 2  # blocks a cluster: two unit tiles that share the dxp tile
# stages whose products a block sums in the tensor cores' registers before
# it adds them into its tile of dW in f32 (round to nearest), in order
DW_PROMOTE = 128
# Bytes of shared-memory traffic a block moves per 16 pairs at BN columns
# (TMA's f32 in, the rounding's f32 out and bf16 in, the two consumer
# warpgroups' bf16 out: 24 + 24 + 12 + 20 KiB at 256, 16 + 16 + 8 + 12 at
# 128): the form is bound by shared memory, so a block's time at BN is in
# proportion, which :func:`dw_plan` weighs against the waves.
DW_STAGE_SMEM = {256: 80 * 1024, 128: 52 * 1024}


def dw_form(G: int) -> str:
    """K6's form at width G: "wgmma" at every G (:func:`dw_width`)."""
    if G < 1:
        raise ValueError(f"G must be positive, got {G}")
    return "wgmma"


def dw_width(G: int) -> int:
    """The width K6's Hopper form runs at: G where TMA takes its strides (G %
    4 == 0), else :func:`merged_width`, the width K4 and K5 run at (zero
    units: a zero unit's h and gate cotangents are 0, so every real entry of
    dW gets the same products in the same order, and the padded rows and
    gate columns are cut)."""
    return G if G % 4 == 0 else merged_width(G)


class DwPlan(NamedTuple):
    """A launch of K6's Hopper form (:func:`dw_plan`)."""

    bn: int  # dW columns (gate columns) a block
    bp: int  # rows a step's box brings: B rounded up to a power of two, 32 above 32
    tb: int  # steps a stage (32 / bp)
    nbc: int  # boxes of 32 rows a step (B above 32; then tb is 1)
    stages: int  # stages of 32 (t, b) pairs of a chain, the last padded with zeros
    m_pairs: int  # clusters along the units: pairs of 128-unit tiles
    n_tiles: int  # tiles of bn columns
    clusters: int  # R x m_pairs x n_tiles: the clusters of one slice
    held: int  # clusters of this bn the card holds at once
    waves: int  # of clusters x slices
    slices: int  # slices of the contraction, one cluster each a tile
    per_slice: int  # stages a slice (the last slice may have fewer)


def dw_plan(T: int, R: int, B: int, G: int, held: dict[int, int]) -> DwPlan:
    """K6's Hopper form for R chains of B rows, T steps, width G (G % 4 ==
    0), from the card's figure ``held``: {columns a block (256, 128): the
    clusters of that kernel the card holds at once}.  The stage is 32
    (t, b) pairs: tb steps of B rows rounded up to a power of two (the
    extra rows read as zeros), or above 32 rows one 32-row box of one step.
    The tile is 128 units by 256 columns, or by 128 where that takes fewer
    waves by enough to pay for its higher cost a column
    (``DW_STAGE_SMEM``).  Where the clusters of the tiles fill at most half
    of what the card holds, the contraction is split into slices of
    consecutive stages: as many as the card holds such sets of clusters
    (at most one a stage), summed in slice order by a second pass; the
    shapes the paths give K6 take one slice (:func:`dw_slices`)."""
    if G < 4 or G % 4:
        raise ValueError(f"K6's Hopper form takes G % 4 == 0, got {G}")
    if min(T, R, B) < 1:
        raise ValueError(f"T, R and B must be positive, got {T}, {R}, {B}")
    if B > DW_BK:
        bp, nbc, tb = DW_BK, -(-B // DW_BK), 1
    else:
        bp, nbc = 1 << (B - 1).bit_length(), 1
        tb = DW_BK // bp
    m_tiles = -(-G // DW_BM)
    m_pairs = -(-m_tiles // DW_CLUSTER)
    best = None
    for bn in sorted(DW_STAGE_SMEM, reverse=True):
        if held.get(bn, 0) < 1:
            continue
        n_tiles = -(-4 * G // bn)
        clusters = R * m_pairs * n_tiles
        waves = -(-clusters // held[bn])
        plan = DwPlan(bn, bp, tb, nbc, -(-T * nbc // tb), m_pairs, n_tiles, clusters, held[bn],
                      waves, 1, -(-T * nbc // tb))
        if best is None or waves * DW_STAGE_SMEM[bn] < best.waves * DW_STAGE_SMEM[best.bn]:
            best = plan
    if best is None:
        raise RuntimeError(f"the card holds no cluster of K6's Hopper form: {held}")
    slices, per_slice = dw_slices(best.stages, best.clusters, best.held)
    return best._replace(slices=slices, per_slice=per_slice,
                         waves=-(-best.clusters * slices // best.held))


def dw_slices(stages: int, clusters: int, held: int) -> tuple[int, int]:
    """(slices, stages a slice) of a contraction of ``stages`` stages whose
    tiles take ``clusters`` clusters where the card holds ``held`` at once:
    held // clusters slices (one where the tiles fill more than half the
    card), at most one a stage, each of ceil(stages / slices) consecutive
    stages but the last, and none empty."""
    want = min(max(1, held // clusters), stages)
    per_slice = -(-stages // want)
    return -(-stages // per_slice), per_slice


def dw_tiles(plan: DwPlan) -> list[tuple[int, int, int]]:
    """(chain, first unit, first column) of every block of one slice of a
    launch, in block order: cluster c = block // 2 takes the unit tiles 2 (c %
    m_pairs) + {0, 1} (the second past G where the tiles are odd: it only
    brings its half of the shared dxp tile), column tile (c // m_pairs) %
    n_tiles, chain c // (m_pairs n_tiles) (``csrc/lstm_dw.cu``)."""
    out = []
    for block in range(DW_CLUSTER * plan.clusters):
        c, rank = divmod(block, DW_CLUSTER)
        mp, nt = c % plan.m_pairs, (c // plan.m_pairs) % plan.n_tiles
        out.append((c // (plan.m_pairs * plan.n_tiles), (2 * mp + rank) * DW_BM, nt * plan.bn))
    return out


def dw_blocks(plan: DwPlan) -> list[tuple[int, int, int, int, int]]:
    """(chain, first unit, first column, first stage, end stage) of every
    block of a launch, in block order: the tiles of :func:`dw_tiles` for
    each slice z in turn, slice z taking stages [z per_slice, min((z + 1)
    per_slice, stages)) (``csrc/lstm_dw.cu``)."""
    tiles = dw_tiles(plan)
    return [(r, m0, n0, z * plan.per_slice, min((z + 1) * plan.per_slice, plan.stages))
            for z in range(plan.slices) for r, m0, n0 in tiles]


def dw_stages(plan: DwPlan) -> list[tuple[int, int]]:
    """(t0, b0) of every stage, in order: its boxes are hs at (unit m0, row
    b0, chain, step t0 - 1) for tb steps (h_{t-1}; hs's step T - 1 and
    steps below 0 read as zeros) and dxp at (column, b0, chain, t0) for tb
    steps, bp rows each, those past B zeros; where t0 == 0, h0 at (m0, b0,
    chain): in place of hs's box where tb is 1 (then every stage of step 0,
    one a 32-row box, has its own), else into a region of its own that
    stage 0, the only one at t0 == 0, reads for its rows [0, bp)."""
    out = []
    for s in range(plan.stages):
        u0 = s * plan.tb
        out.append((u0 // plan.nbc, (u0 % plan.nbc) * DW_BK))
    return out


@functools.lru_cache(maxsize=None)
def dw_capacity(index: int) -> dict[int, tuple[int, int]]:
    """What K6's Hopper form reports of itself on CUDA device ``index``,
    asked once: {columns a block: (clusters the device holds at once, the
    dynamic shared memory a block asks for)}."""
    import ctypes

    out = {}
    with torch.cuda.device(index):
        for bn in DW_STAGE_SMEM:
            clusters, smem = ctypes.c_int(0), ctypes.c_int(0)
            err = _build.library().umx_lstm_dw_capacity(bn, ctypes.addressof(clusters),
                                                        ctypes.addressof(smem))
            _build.check(err, "umx_lstm_dw_capacity")
            out[bn] = (clusters.value, smem.value)
    return out


def lstm_merged_dw(hs, h0, dxp, B: int, *, _form: str | None = None):
    """K6: dW (R, G, 4G) f32 = Σ over t, b of bf16(h_{t-1})ᵀ bf16(dxp_t).
    Any G, in :func:`dw_form`'s form, at :func:`dw_width` (G % 4 != 0: the
    operands copied with zero units and dW cut inside the same library
    call; the trainer hands it operands already at K4's and K5's padded
    width); the private ``_form``
    names either of ``DW_FORMS``: "mma_sync", at G itself, is the Hopper
    form's yardstick.  The form that ran is left in ``lstm_merged_dw.form``:
    ("wgmma", columns a block, clusters of a slice, clusters held at once,
    waves) or ("mma_sync",), and the Hopper form's whole plan (slices
    included) in ``lstm_merged_dw.plan``.  Counts
    ``lstm_merged_dw.launches``, and by form ``lstm_merged_dw.form_launches``."""
    if hs.dim() != 3 or dxp.dim() != 3:
        raise ValueError(f"hs and dxp must be 3-d, got {tuple(hs.shape)}, {tuple(dxp.shape)}")
    T, RB, G = hs.shape
    if B < 1 or RB % B != 0:
        raise ValueError(f"rows {RB} are not a multiple of B = {B}")
    R = RB // B
    route = _check(hs, [
        ("hs", hs, hs.shape, torch.float32), ("h0", h0, (RB, G), torch.float32),
        ("dxp", dxp, (T, RB, 4 * G), torch.float32),
    ])
    form = _form or dw_form(G)
    if form not in DW_FORMS:
        raise ValueError(f"form must be None or one of {DW_FORMS}; got {_form!r} at G = {G}")
    if route == "cpu":
        return lstm_merged_dw_plain(hs, h0, dxp, B)
    if form == "wgmma":
        dw = _dw_wgmma(hs, h0, dxp, B)
    else:
        dw = torch.empty((R, G, 4 * G), dtype=torch.float32, device=hs.device)
        err = _build.library().umx_lstm_dw(
            hs.data_ptr(), h0.data_ptr(), dxp.data_ptr(), dw.data_ptr(), T, R, B, G, _stream(hs)
        )
        _build.check(err, "umx_lstm_dw")
        lstm_merged_dw.form = ("mma_sync",)
    lstm_merged_dw.launches += 1
    lstm_merged_dw.form_launches[form] += 1
    return dw


@functools.lru_cache(maxsize=256)
def _dw_plan_on(index: int, T: int, R: int, B: int, G: int) -> DwPlan:
    """:func:`dw_plan` from CUDA device ``index``'s figures, once a shape."""
    return dw_plan(T, R, B, G, {bn: c for bn, (c, _) in dw_capacity(index).items()})


def _dw_wgmma(hs, h0, dxp, B: int):
    """K6's Hopper form on checked CUDA tensors, one call of the library: at
    G % 4 != 0 a launch that copies the operands at :func:`dw_width` with
    zero units; one launch of :func:`dw_plan`'s plan there; where it has
    slices, or the width was padded, a launch that adds the partial dW in
    slice order and cuts the padding."""
    T, RB, G = hs.shape
    R = RB // B
    Gp = dw_width(G)
    if Gp == G and any(t.data_ptr() % 16 for t in (hs, h0, dxp)):
        raise ValueError("K6's Hopper form needs 16-byte aligned hs, h0 and dxp")
    plan = _dw_plan_on(hs.device.index, T, R, B, Gp)
    dev = hs.device
    dw = torch.empty((R, G, 4 * G), dtype=torch.float32, device=dev)
    n_parts = plan.slices * R * Gp * 4 * Gp if plan.slices > 1 or Gp != G else 0
    n_pad = (T * RB * 5 + RB) * Gp if Gp != G else 0
    scratch = torch.empty(n_parts + n_pad, dtype=torch.float32, device=dev) if n_parts else None
    base = scratch.data_ptr() if scratch is not None else None
    err = _build.library().umx_lstm_dw_wgmma(
        hs.data_ptr(), h0.data_ptr(), dxp.data_ptr(), dw.data_ptr(), base,
        base + 4 * n_parts if n_pad else None, T, R, B, G, Gp, plan.bn, plan.bp, plan.tb,
        plan.nbc, plan.stages, plan.slices, plan.per_slice, _stream(hs)
    )
    _build.check(err, "umx_lstm_dw_wgmma")
    lstm_merged_dw.form = ("wgmma", plan.bn, plan.clusters, plan.held, plan.waves)
    lstm_merged_dw.plan = plan
    return dw


lstm_merged_dw.launches = 0
lstm_merged_dw.form_launches = dict.fromkeys(DW_FORMS, 0)
lstm_merged_dw.form = None
lstm_merged_dw.plan = None


class LSTMMergedTrain(torch.autograd.Function):
    """Differentiable merged layer at the row level: K4 forward, K5 + K6
    backward (their plain versions on the CPU).

    forward(xp (T, R*B, 4G), hh_w (R, G, 4G) f32, h0, c0 (R*B, G), B) →
    (hs, hT, cT).  W_hh is rounded to bf16 inside, and its gradient leaves
    in f32 for the f32 ``hh_w`` (as the JAX package's custom VJP does).  On
    the card, at G % 8 != 0, the layer runs at :func:`merged_width` from
    end to end: its inputs are padded with zero units once, K4, K5 and K6
    run on the padded residuals and cotangents, and the outputs and
    gradients are cut once (``at_width``'s exactness, without a pad and cut
    around each kernel)."""

    @staticmethod
    def forward(ctx, xp, hh_w, h0, c0, B):
        whh = hh_w.to(torch.bfloat16).contiguous()
        G = whh.shape[1]
        Gp = merged_width(G) if xp.is_cuda else G
        args = (xp, whh, h0, c0)
        if Gp != G:
            args = tuple(pad_width(a, k, G, Gp) for a, k in zip(args, _FWD_KINDS))
        hs, hT, cT, gates, cs = lstm_merged_train_fwd(*args, B)
        ctx.save_for_backward(gates, cs, hs, args[2], args[3], args[1])
        ctx.B, ctx.G = B, G
        return tuple(cut_width(t, "units", G, Gp) for t in (hs, hT, cT))

    @staticmethod
    def backward(ctx, dhs, dhT, dcT):
        gates, cs, hs, h0, c0, whh = ctx.saved_tensors
        G, Gp = ctx.G, whh.shape[1]

        def ct(g, like):
            g = torch.zeros_like(like) if g is None else g.float().contiguous()
            return pad_width(g, "units", G, Gp) if g.shape[-1] != Gp else g

        dxp, dh0, dc0 = lstm_merged_bwd_step(
            gates, cs, c0, whh, ct(dhs, hs), ct(dhT, h0), ct(dcT, c0), ctx.B
        )
        need = ctx.needs_input_grad
        dw = cut_width(lstm_merged_dw(hs, h0, dxp, ctx.B), "whh", G, Gp) if need[1] else None
        return (cut_width(dxp, "gates", G, Gp) if need[0] else None, dw,
                cut_width(dh0, "units", G, Gp) if need[2] else None,
                cut_width(dc0, "units", G, Gp) if need[3] else None, None)


def _check_hh_dtype(hh_w, name: str = "hh_w"):
    if hh_w.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} must be float32 or bfloat16, got {hh_w.dtype}")


def lstm_pertarget_plain(x_proj, whh, h0, c0):
    """Plain PyTorch version of :func:`lstm_layer_pertarget`: one einsum
    over all chains per timestep, bf16-rounded h against the bf16 weights
    (exact in f32), f32 sums.

    x_proj (T#, T, D, 4G) f32, whh (T#, D, G, 4G) bf16, h0/c0 (T#, D, G)
    f32 → (hs (T#, T, D, G), hT, cT)."""
    n_targets, T, D, G4 = x_proj.shape
    G = G4 // 4
    R = n_targets * D
    w = whh.float().reshape(R, G, G4)
    h, c = h0, c0
    hs = torch.empty((n_targets, T, D, G), dtype=torch.float32, device=x_proj.device)
    for t in range(T):
        pre = x_proj[:, t] + _hh_product(h.reshape(R, G), w, 1).view(n_targets, D, G4)
        i = torch.sigmoid(pre[..., :G])
        f = torch.sigmoid(pre[..., G : 2 * G])
        g = torch.tanh(pre[..., 2 * G : 3 * G])
        o = torch.sigmoid(pre[..., 3 * G :])
        c = f * c + i * g
        h = o * torch.tanh(c)
        hs[:, t] = h
    return hs, h, c


# K9 (csrc/lstm_pertarget.cu): a cluster of up to 16 blocks per chain, a
# block of 16 warps that own 4 hidden units each.
PERTARGET_MAX_CLUSTER = 16
PERTARGET_WARP_UNITS = 4
PERTARGET_MAX_UNITS = 64
PERTARGET_MIN_UNITS = 32


def pertarget_units_per_block(G: int, cluster: int) -> int:
    """Hidden units a block of a ``cluster``-block chain owns: an even
    share of G, rounded up to a warp's 4."""
    per = -(-G // cluster)
    return -(-per // PERTARGET_WARP_UNITS) * PERTARGET_WARP_UNITS


def pertarget_cluster_choice(G: int, R: int, placeable, max_units: int = PERTARGET_MAX_UNITS):
    """The cluster K9 runs R chains of width G on → (blocks per cluster,
    units per block, waves).

    ``placeable`` maps a cluster size to the number of such clusters the
    device holds at once (0 or missing: it cannot); ``max_units`` is the
    most units a block of the kernel can own.  No size leaves a block
    fewer than 32 units (a cluster of one block takes any G up to
    ``max_units``).  Among the sizes that hold a chain the one with the
    fewest waves wins, then the fewest units per block (the shortest
    step), then the fewest blocks.  Raises by name where no size holds a
    chain (:func:`lstm_layer_pertarget` then runs the wide K1)."""
    best = _pertarget_best(G, R, placeable, max_units)
    if best is None:
        raise RuntimeError(
            f"umx_lstm_pertarget: no cluster of up to {PERTARGET_MAX_CLUSTER} blocks holds one "
            f"chain's W_hh (G x 4G bf16 = {G * 4 * G * 2} bytes at G = {G}) on this device: "
            f"clusters held at once by size {dict(placeable)}")
    return best


def _pertarget_best(G: int, R: int, placeable, max_units: int = PERTARGET_MAX_UNITS):
    """:func:`pertarget_cluster_choice`, or None where no size holds a chain."""
    best = None
    for cluster in range(1, PERTARGET_MAX_CLUSTER + 1):
        held = int(placeable.get(cluster, 0))
        units = pertarget_units_per_block(G, cluster)
        if held < 1 or units > max_units or cluster > max(1, G // PERTARGET_MIN_UNITS):
            continue
        key = (-(-R // held), units, cluster)
        if best is None or key < best:
            best = key
    if best is None:
        return None
    waves, units, cluster = best
    return cluster, units, waves


@functools.lru_cache(maxsize=None)
def _pertarget_placeable(index: int, G: int, R: int) -> dict[int, int]:
    """{cluster size: clusters of K9 that CUDA device ``index`` holds at
    once} for R chains of width G, sizes the kernel cannot take left out:
    a property of the device and the built kernel, asked once."""
    import ctypes

    held = (ctypes.c_int * (PERTARGET_MAX_CLUSTER + 1))()
    with torch.cuda.device(index):
        err = _build.library().umx_lstm_pertarget_clusters(G, R, ctypes.addressof(held))
    _build.check(err, "umx_lstm_pertarget_clusters")
    return {cl: held[cl] for cl in range(1, PERTARGET_MAX_CLUSTER + 1) if held[cl] > 0}


def lstm_layer_pertarget(x_proj, whh, h0, c0, *, _form: str | None = None):
    """K9: one BLSTM layer's recurrence for all targets and directions at
    one batch row, one kernel launch for all T steps (see module docstring).

    x_proj (T#, T, D, 4G) f32, whh (T#, D, G, 4G) bf16, h0/c0 (T#, D, G)
    f32 → (hs (T#, T, D, G), hT, cT).  Any G.  Each chain runs on a
    thread-block cluster that keeps its W_hh in registers and shared
    memory (G % 8 != 0 padded by zero units, :func:`at_width`);
    :func:`pertarget_cluster_choice` picks the cluster size among those
    the device can place.  Where none holds a chain's W_hh (G above about
    704 on an H100) the chains run through the wide K1 (the same function
    at one row per chain; the private ``_form`` as :func:`lstm_merged`'s).
    The form that ran is left in ``lstm_layer_pertarget.form``: (blocks per
    cluster, clusters the device holds at once, waves), or ("wide", …) as
    :func:`lstm_merged`'s.  Increments ``lstm_layer_pertarget.launches``
    once per kernel launch (once per layer through the wide K1)."""
    if x_proj.dim() != 4:
        raise ValueError(f"expected x_proj (T#, T, D, 4G), got shape {tuple(x_proj.shape)}")
    n_targets, T, D, G4 = x_proj.shape
    G = G4 // 4
    if G4 != 4 * G or tuple(whh.shape) != (n_targets, D, G, G4):
        raise ValueError(
            f"whh must be (T#, D, G, 4G) = {(n_targets, D, G, G4)}, got {tuple(whh.shape)}")
    if T < 1:
        raise ValueError("no timesteps")
    route = _check(x_proj, [
        ("x_proj", x_proj, x_proj.shape, torch.float32), ("whh", whh, whh.shape, torch.bfloat16),
        ("h0", h0, (n_targets, D, G), torch.float32), ("c0", c0, (n_targets, D, G), torch.float32),
    ])
    if route == "cpu":
        return lstm_pertarget_plain(x_proj, whh, h0, c0)
    R, Gp = n_targets * D, _aligned(G)
    placeable = _pertarget_placeable(x_proj.device.index, Gp, R)
    best = _pertarget_best(Gp, R, placeable)
    if _form is not None and best is not None:
        raise ValueError(f"form {_form!r}: a cluster holds a chain at G = {G}")
    if best is None:
        xp = x_proj.permute(1, 0, 2, 3).reshape(T, R, G4).contiguous()
        hs, hT, cT = _merged_launches(lstm_layer_pertarget, xp, whh.reshape(R, G, G4),
                                      h0.reshape(R, G), c0.reshape(R, G), 1, False, _form)
        return (hs.view(T, n_targets, D, G).permute(1, 0, 2, 3).contiguous(),
                hT.view(n_targets, D, G), cT.view(n_targets, D, G))
    return at_width(lambda *a: _pertarget_launch(*a, best, placeable), G, Gp,
                    (x_proj, whh, h0, c0), ("gates", "whh", "units", "units"),
                    ("units", "units", "units"))


def _pertarget_launch(x_proj, whh, h0, c0, best, placeable):
    """K9's cluster launch on checked CUDA tensors at G % 8 == 0."""
    n_targets, T, D, G4 = x_proj.shape
    G = G4 // 4
    cluster, units, waves = best
    _check_whh_vectors(whh, G)
    dev = x_proj.device
    hs = torch.empty((n_targets, T, D, G), dtype=torch.float32, device=dev)
    hT = torch.empty((n_targets, D, G), dtype=torch.float32, device=dev)
    cT = torch.empty((n_targets, D, G), dtype=torch.float32, device=dev)
    err = _build.library().umx_lstm_pertarget(
        x_proj.data_ptr(), whh.data_ptr(), h0.data_ptr(), c0.data_ptr(), hs.data_ptr(),
        hT.data_ptr(), cT.data_ptr(), T, n_targets, D, G, cluster, units, _stream(x_proj),
    )
    _build.check(err, "umx_lstm_pertarget")
    lstm_layer_pertarget.launches += 1
    lstm_layer_pertarget.form = (cluster, placeable[cluster], waves)
    return hs, hT, cT


lstm_layer_pertarget.launches = 0
lstm_layer_pertarget.form = None


def lstm_layer_pertarget_batched(x_proj, hh_w, h0, c0):
    """The per-target layer over a batch, in the layouts of
    :func:`lstm_layer_merged_batched`: K9 once per batch row (a batch
    axis over the TPU kernel serialises its grid the same way).  No
    gradient: an input that requires one raises, and training runs the
    merged kernels."""
    _check_hh_dtype(hh_w)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x_proj, hh_w, h0, c0)):
        raise RuntimeError('the per-target kernel (lstm_impl="pallas") has no backward: '
                           'take a gradient with lstm_impl="auto"')
    whh = hh_w.to(torch.bfloat16).contiguous()
    outs = [
        lstm_layer_pertarget(x_proj[b].float().contiguous(), whh, h0[b].float().contiguous(),
                             c0[b].float().contiguous())
        for b in range(x_proj.shape[0])
    ]
    return tuple(torch.stack(o) for o in zip(*outs))


def lstm_layer_merged_batched(x_proj, hh_w, h0, c0):
    """Batched merged layer, layouts as in the JAX package.

    x_proj (B, T#, T, D, 4G) f32; hh_w (T#, D, G, 4G) f32 or bf16 (bf16
    goes to the kernel as it is); h0/c0 (B, T#, D, G).
    Returns (hs (B, T#, T, D, G), hT (B, T#, D, G), cT (B, T#, D, G)).
    With grad enabled and an input that requires it, runs
    :class:`LSTMMergedTrain` (K4, and K5 + K6 in the backward); otherwise K1."""
    _check_hh_dtype(hh_w)
    Bsz, n_targets, _, D, G4 = x_proj.shape
    R, G = n_targets * D, G4 // 4
    xp, h0r, c0r = _chain_rows(x_proj, h0, c0)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x_proj, hh_w, h0, c0)):
        hh = hh_w.float().reshape(R, G, G4).contiguous()
        out = LSTMMergedTrain.apply(xp, hh, h0r, c0r, Bsz)
    else:
        whh = hh_w.to(torch.bfloat16).reshape(R, G, G4).contiguous()
        out = lstm_merged(xp, whh, h0r, c0r, Bsz)
    return _batched_outputs(*out, x_proj.shape)


def _chain_rows(x_proj, h0, c0):
    """The batched layouts x_proj (B, T#, T, D, 4G), h0/c0 (B, T#, D, G) →
    the kernels' (T, R*B, 4G) and (R*B, G), rows chain-major:
    row = ((t# * D) + d) * B + b."""
    Bsz, n_targets, T, D, G4 = x_proj.shape
    RB = n_targets * D * Bsz
    xp = x_proj.permute(2, 1, 3, 0, 4).reshape(T, RB, G4).contiguous()
    h0r = h0.float().permute(1, 2, 0, 3).reshape(RB, G4 // 4).contiguous()
    c0r = c0.float().permute(1, 2, 0, 3).reshape(RB, G4 // 4).contiguous()
    return xp, h0r, c0r


def _batched_outputs(hs, hT, cT, shape):
    """The kernels' (hs (T, R*B, G), hT, cT (R*B, G)) back in the batched
    layouts of an x_proj of ``shape``: (B, T#, T, D, G), (B, T#, D, G)."""
    Bsz, n_targets, T, D, G4 = shape
    G = G4 // 4
    hs = hs.view(T, n_targets, D, Bsz, G).permute(3, 1, 0, 2, 4)
    hT = hT.view(n_targets, D, Bsz, G).permute(2, 0, 1, 3)
    cT = cT.view(n_targets, D, Bsz, G).permute(2, 0, 1, 3)
    return hs, hT, cT


# K10 (csrc/lstm_scan.cu): a block owns 32 hidden units of one chain (20 in
# the wide form); a launch takes up to 16 rows per chain (fewer where the
# device's shared memory runs out, as its capacity query says), and the
# exchange buffer has room for 16 rows of each chain.
SCAN_UNITS = 32
SCAN_ROWS = 16
# The resident forms of K10 and K11 keep a block's share of W_hh (its 128
# gate columns x G rows, upcast to f32) on the chip up to this width,
# split between registers and shared memory (their capacity queries report
# the split: scan_block_layout).
SCAN_RESIDENT_G_MAX = 512
# Above it the wide forms keep it on the chip in smaller shares over more
# blocks (csrc/lstm_scan.cu:lstm_scan_wide_kernel,
# csrc/lstm_scan_train.cu:lstm_scan_bwd_wide_kernel): a block of 320
# threads (10 warps) owns 20 units and their 80 gate columns for all G rows
# (200 KiB of f32 at G 640), so R chains run as chain groups of what the
# card holds at once (:func:`scan_wide_plan`).  K10's half-warp owns a
# unit's four gate columns and its lanes the 16 strided parts of k (the
# resident form's lanes, one unit a half-warp), the first
# ``SCAN_WIDE_KREG`` iterations (a float4 each) in registers; K11's thread
# owns units tid and tid + 320 (hence ``SCAN_WIDE_G_MAX``), the first
# ``SCAN_BWD_WIDE_CREG`` columns of each in registers.  Wider layers stream
# W_hh from L2 each step.
SCAN_WIDE_UNITS = 20
SCAN_WIDE_WARPS = 10
SCAN_WIDE_KREG = 20
SCAN_BWD_WIDE_CREG = 48
# registers a thread of either wide form uses beside its W (ptxas on sm_90a)
SCAN_WIDE_OTHER_REGS = 64
SCAN_WIDE_G_MAX = 640
SCAN_FORMS = ("resident", "streaming", "wide")
# the forms' codes in the kernels' entry points
_SCAN_FORM_CODE = {"streaming": 0, "resident": 1, "wide": 2}


def scan_form(G: int, whh_dtype: torch.dtype) -> str:
    """The form K10, K10 with residuals and K11 take at width G, W_hh in
    ``whh_dtype`` (f32 or bf16, upcast to f32 on the chip either way):
    "resident" up to ``SCAN_RESIDENT_G_MAX``, "wide" up to
    ``SCAN_WIDE_G_MAX``, else "streaming".  Chosen from the width before any
    launch, never from the rows, the chains or a failed launch (on a card
    whose figures give the wide forms no plan, :func:`scan_wide_plan`, they
    stream there too)."""
    if whh_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"whh must be float32 or bfloat16, got {whh_dtype}")
    if G <= SCAN_RESIDENT_G_MAX:
        return "resident"
    return "wide" if G <= SCAN_WIDE_G_MAX else "streaming"


def _scan_form_for(G: int, whh_dtype: torch.dtype, form: str | None) -> str:
    """``form`` as asked for (None: :func:`scan_form`), raising by name for
    an unknown form or a form outside its widths."""
    if form is None:
        return scan_form(G, whh_dtype)
    if form not in SCAN_FORMS:
        raise ValueError(f"form must be one of {SCAN_FORMS} or None, got {form!r}")
    if form == "resident" and G > SCAN_RESIDENT_G_MAX:
        raise ValueError(f"the resident form holds W_hh on the chip up to G = "
                         f"{SCAN_RESIDENT_G_MAX}; got G = {G}")
    if form == "wide" and not SCAN_RESIDENT_G_MAX < G <= SCAN_WIDE_G_MAX:
        raise ValueError(f"the wide form takes {SCAN_RESIDENT_G_MAX} < G <= "
                         f"{SCAN_WIDE_G_MAX}; got G = {G}")
    return form


def scan_blocks_per_chain(G: int, units: int = SCAN_UNITS) -> int:
    """Blocks that share one chain in K10 / K11: one per ``units`` hidden
    units (32, or ``SCAN_WIDE_UNITS`` in the wide forms)."""
    return -(-G // units)


def scan_row_groups(B: int, rows: int) -> list[tuple[int, int, int]]:
    """(first row, rows, row tile) of K10's launches over B rows per chain,
    at most ``rows`` (the device's largest tile) a launch, the last group
    ragged; the row tile is the power of two the kernel is instantiated
    for.  Rows are independent, so a row's result does not depend on its
    group."""
    out = []
    for b0 in range(0, B, rows):
        nb = min(rows, B - b0)
        out.append((b0, nb, 1 << (nb - 1).bit_length()))
    return out


def scan_exchange_words(R: int, G: int) -> int:
    """64-bit words of K10's exchange buffer: per chain two steps of 16
    rows of G words (one f32 value of h and the step's tag each)."""
    return R * 2 * SCAN_ROWS * G


def scan_wide_smem(kernel: str, G: int, rows: int) -> int:
    """Dynamic shared memory of a block of the wide form of ``kernel``
    ("K10", "K10r" or "K11") at width G and a row tile of ``rows``: K10's
    W of the iterations beyond ``SCAN_WIDE_KREG`` (a float4 of four gates a
    thread and iteration) and h of 16 ceil(G/16) k rows at the resident
    form's padded row stride (``csrc/lstm_scan.cu:sw_smem``); K11's W of the
    columns beyond ``SCAN_BWD_WIDE_CREG`` (two f32 a thread and column) and
    two buffers of dg (``csrc/lstm_scan_train.cu:sbw_smem``)."""
    threads, cols = 32 * SCAN_WIDE_WARPS, 4 * SCAN_WIDE_UNITS
    if kernel == "K11":
        return 8 * (cols - SCAN_BWD_WIDE_CREG) * threads + 4 * 2 * cols * rows
    iters = -(-G // 16)
    stride = rows if rows <= 4 else rows + 4
    return (16 * max(0, iters - SCAN_WIDE_KREG) * threads
            + 4 * 16 * max(iters, SCAN_WIDE_KREG) * stride)


class ScanWidePlan(NamedTuple):
    """The wide form of K10 or K11 at one width (:func:`scan_wide_plan`)."""

    units: int  # hidden units a block owns (and their 4 x units gate columns)
    warps: int
    rows: int  # rows per chain a launch takes (the largest tile that fits)
    blocks_per_chain: int
    chains_per_group: int  # chains a launch holds, one block an SM
    smem: int  # dynamic shared memory a block asks for


def scan_wide_plan(G: int, R: int, sms: int, smem_per_block: int, regs_per_sm: int,
                   kernel: str = "K10") -> ScanWidePlan | None:
    """The wide form ``kernel`` ("K10", "K10r" or "K11") runs R chains of
    width G (512 < G) in, from the card's figures alone (``sms``, the
    shared memory a block may ask for and the 32-bit registers of an SM:
    an H100's 132, 232448, 65536).  A block is one SM; the form holds a
    chain where G is at most ``SCAN_WIDE_G_MAX``, its blocks a chain are no
    more than the SMs, a thread's W registers and other registers fit what
    a thread of 10 warps may have (:func:`merged_thread_regs`) and the
    shared memory of at least one row fits a block; the row tile is the
    largest of 16, 8, 4, 2, 1 that fits.  The form does not depend on R or
    B; R sets the chains a launch holds.  None where it holds no chain
    (above ``SCAN_WIDE_G_MAX`` on an H100): K10 and K11 then stream W_hh."""
    if G <= SCAN_RESIDENT_G_MAX:
        raise ValueError(f"the wide forms take G > {SCAN_RESIDENT_G_MAX}, got {G}")
    if kernel not in ("K10", "K10r", "K11"):
        raise ValueError(f"kernel must be K10, K10r or K11, got {kernel!r}")
    per_chain = scan_blocks_per_chain(G, SCAN_WIDE_UNITS)
    w_regs = 2 * SCAN_BWD_WIDE_CREG if kernel == "K11" else 4 * SCAN_WIDE_KREG
    if (G > SCAN_WIDE_G_MAX or per_chain > sms
            or w_regs + SCAN_WIDE_OTHER_REGS > merged_thread_regs(SCAN_WIDE_WARPS, regs_per_sm)):
        return None
    rows = next((r for r in (16, 8, 4, 2, 1) if scan_wide_smem(kernel, G, r) <= smem_per_block),
                None)
    if rows is None:
        return None
    return ScanWidePlan(SCAN_WIDE_UNITS, SCAN_WIDE_WARPS, rows, per_chain,
                        min(R, sms // per_chain), scan_wide_smem(kernel, G, rows))


@functools.lru_cache(maxsize=None)
def scan_block_layout(index: int, G: int, whh_bf16: bool, kernel: str = "K10",
                      form: str = "streaming") -> tuple[int, int, int, int]:
    """What ``kernel`` ("K10", "K10r" with the residual stores, or "K11";
    "K1w", "K4w", "K5w": the streaming K1, K4 and K5, the streaming kernels
    with bf16 operands) in ``form`` at width G, W_hh in bf16 or f32, reports
    of itself on CUDA device ``index``, asked once: (the largest row tile,
    the blocks of it held at once, the dynamic shared memory a block of that
    tile asks for, the bytes of a full block's share of W_hh that stay in
    registers, 0 in the streaming forms)."""
    import ctypes

    out = [ctypes.c_int(0) for _ in range(4)]
    ptrs = [ctypes.addressof(v) for v in out]
    lib = _build.library()
    code = _SCAN_FORM_CODE[form]
    with torch.cuda.device(index):
        if kernel in ("K1w", "K4w"):
            err = lib.umx_lstm_merged_streaming_capacity(G, int(kernel == "K4w"), *ptrs)
        elif kernel == "K5w":
            err = lib.umx_lstm_bwd_wide_capacity(G, *ptrs)
        elif kernel == "K11":
            err = lib.umx_lstm_scan_bwd_capacity(code, G, int(whh_bf16), *ptrs)
        else:
            err = lib.umx_lstm_scan_capacity(code, G, int(whh_bf16), int(kernel == "K10r"), *ptrs)
    if err == _CUDA_ERROR_INVALID_CONFIGURATION:
        raise RuntimeError(f"{kernel}: this device has no cooperative launch, which the "
                           "float32 recurrence needs")
    _build.check(err, f"{kernel} capacity")
    if out[0].value < 1:
        raise RuntimeError(f"{kernel}: one row (G = {G}) does not fit a block's shared memory "
                           "on this device")
    return tuple(v.value for v in out)


def _scan_capacity(index: int, G: int, whh_bf16: bool, kernel: str = "K10",
                   form: str = "streaming") -> tuple[int, int]:
    """(the largest row tile, the blocks of it held at once): the first two
    of :func:`scan_block_layout`."""
    return scan_block_layout(index, G, whh_bf16, kernel, form)[:2]


def _scan_device_form(kernel: str, ref, R: int, G: int, form: str, named: bool) -> str:
    """The form K10 / K11 runs in on the card: ``form`` as
    :func:`_scan_form_for` gave it, except that the wide form streams where
    the card's figures give it no plan (:func:`scan_wide_plan`), unless it
    was named (``named``), which raises.  Decided before any launch."""
    if form == "wide" and scan_wide_plan(G, R, *device_limits(ref.device.index), kernel) is None:
        if named:
            raise RuntimeError(f"{kernel}: the wide form holds no chain at G = {G} on this "
                               "device")
        return "streaming"
    return form


def _scan_plan(wrapper, kernel: str, ref, R: int, B: int, G: int, bf16: bool, form: str):
    """The launches of one K10 / K11 layer in ``form``, (r0, nr, b0, nb,
    row tile) each, row groups outermost; leaves the form in
    ``wrapper.form`` as (form, blocks per chain, blocks the device holds at
    once, chain groups, row groups), the wide form with the units a block
    as a sixth field (its plan, :func:`scan_wide_plan`, held to what the
    kernel reports of itself)."""
    rows, capacity, smem, _ = scan_block_layout(ref.device.index, G, bf16, kernel, form)
    per_chain = scan_blocks_per_chain(G)
    units = ()
    if form == "wide":
        wide = scan_wide_plan(G, R, *device_limits(ref.device.index), kernel)
        if wide is None:
            raise RuntimeError(f"{kernel}: the wide form holds no chain at G = {G} on this "
                               "device")
        if (rows, smem) != (wide.rows, wide.smem):
            raise RuntimeError(f"{kernel}'s wide form reports {rows} rows and {smem} bytes of "
                               f"shared memory, not the planned {wide.rows} and {wide.smem} "
                               f"(G {G})")
        per_chain, units = wide.blocks_per_chain, (wide.units,)
    chains = chain_groups(R, per_chain, capacity, kernel)
    groups = scan_row_groups(B, rows)
    wrapper.form = (form, per_chain, capacity, len(chains), len(groups), *units)
    return [(r0, nr, b0, nb, rt) for b0, nb, rt in groups for r0, nr in chains]


def lstm_scan_plain(xp, whh, h0, c0, B: int):
    """Plain PyTorch float32 recurrence (the JAX package's scan step): one
    f32 batched matmul per timestep of h, unrounded, against W_hh upcast
    from its stored dtype (exact).

    xp (T, R*B, 4G) f32, whh (R, G, 4G) f32 or bf16, h0/c0 (R*B, G) f32 →
    (hs (T, R*B, G), hT, cT)."""
    return _recurrence_plain(xp, whh, h0, c0, B, round_h=False, residuals=False)


def lstm_scan_train_fwd_plain(xp, whh, h0, c0, B: int):
    """:func:`lstm_scan_plain` plus the residuals of the backward: returns
    (hs, hT, cT, gates (T, R*B, 4G) activated i|f|g|o, cs (T, R*B, G))."""
    return _recurrence_plain(xp, whh, h0, c0, B, round_h=False, residuals=True)


def _scan_forward(wrapper, xp, whh, h0, c0, B: int, residuals: bool, form: str | None):
    """K10 (``residuals`` False) or K10 with its residual stores on CUDA
    tensors, in ``form`` (None: :func:`scan_form`), or their plain versions
    on CPU tensors: the launches of one layer over its chain and row
    groups, counted once in ``wrapper.launches``."""
    T, R, G = _dims(xp, whh, B)
    RB = R * B
    _check_hh_dtype(whh, "whh")
    route = _check(xp, [
        ("xp", xp, xp.shape, torch.float32), ("whh", whh, whh.shape, whh.dtype),
        ("h0", h0, (RB, G), torch.float32), ("c0", c0, (RB, G), torch.float32),
    ])
    named = form is not None
    form = _scan_form_for(G, whh.dtype, form)
    if route == "cpu":
        if residuals:
            return lstm_scan_train_fwd_plain(xp, whh, h0, c0, B)
        return lstm_scan_plain(xp, whh, h0, c0, B)
    lib = _build.library()
    dev = xp.device
    bf16 = whh.dtype == torch.bfloat16
    kernel = "K10r" if residuals else "K10"
    form = _scan_device_form(kernel, xp, R, G, form, named)
    plan = _scan_plan(wrapper, kernel, xp, R, B, G, bf16, form)
    hs = torch.empty((T, RB, G), dtype=torch.float32, device=dev)
    hT = torch.empty((RB, G), dtype=torch.float32, device=dev)
    cT = c0.clone()  # the kernel updates c in place
    hx = torch.zeros(scan_exchange_words(R, G), dtype=torch.int64, device=dev)
    extra = ()
    if residuals:
        extra = (torch.empty((T, RB, 4 * G), dtype=torch.float32, device=dev),  # gates
                 torch.empty((T, RB, G), dtype=torch.float32, device=dev))  # cs
    entry = "umx_lstm_scan_train" if residuals else "umx_lstm_scan"
    for launched, (r0, nr, b0, nb, rt) in enumerate(plan):
        err = getattr(lib, entry)(
            _SCAN_FORM_CODE[form], xp.data_ptr(), whh.data_ptr(), int(bf16), h0.data_ptr(),
            cT.data_ptr(),
            hs.data_ptr(), hT.data_ptr(), *(t.data_ptr() for t in extra), hx.data_ptr(),
            T, R, B, G, r0, nr, b0, nb, rt, launched * T, _stream(xp),
        )
        _build.check(err, entry)
    wrapper.launches += 1
    return (hs, hT, cT, *extra)


def lstm_scan(xp, whh, h0, c0, B: int, *, _form: str | None = None):
    """K10: one BLSTM layer's float32 recurrence for all chains (see
    module docstring and ``csrc/lstm_scan.cu``).

    xp (T, R*B, 4G) f32, whh (R, G, 4G) f32 or bf16, h0/c0 (R*B, G) f32 →
    (hs (T, R*B, G), hT, cT).  One cooperative launch runs all T steps of
    all chains and up to 16 rows per chain; further rows (and chains beyond
    what the device holds at once) are further launches of the same
    kernel.  Any G (:func:`scan_form`): W_hh resident on the chip up to G
    512, in the wide form's smaller shares over more blocks (chain groups
    of what the card holds, :func:`scan_wide_plan`) up to
    ``SCAN_WIDE_G_MAX``, streamed above; the private ``_form`` names one,
    for the checks that compare them (the wide form sums in the resident
    form's order).  The form that ran is left in ``lstm_scan.form`` as
    (form, blocks per chain, blocks the device holds at once, chain groups,
    row groups), the wide form with the units a block as a sixth field.
    Increments ``lstm_scan.launches`` once per layer.  CPU tensors run
    :func:`lstm_scan_plain`."""
    return _scan_forward(lstm_scan, xp, whh, h0, c0, B, False, _form)


lstm_scan.launches = 0
lstm_scan.form = None


def lstm_scan_train_fwd(xp, whh, h0, c0, B: int, *, _form: str | None = None):
    """K10 with residuals: :func:`lstm_scan` plus (gates (T, R*B, 4G)
    activated i|f|g|o, cs (T, R*B, G)).  The same kernel with the residual
    stores compiled in: hs/hT/cT are :func:`lstm_scan`'s bits in the same
    form.  Leaves its form in ``lstm_scan_train_fwd.form`` and counts
    ``lstm_scan_train_fwd.launches`` once per layer."""
    return _scan_forward(lstm_scan_train_fwd, xp, whh, h0, c0, B, True, _form)


lstm_scan_train_fwd.launches = 0
lstm_scan_train_fwd.form = None


def lstm_scan_bwd_step_plain(gates, cs, c0, whh, dhs, dhT, dcT, B: int):
    """Plain reverse-time float32 sweep, the VJP of :func:`lstm_scan_plain`
    in :func:`lstm_merged_bwd_step_plain`'s operation order without any
    bf16 rounding: returns (dxp (T, R*B, 4G), dh0, dc0), all f32, with
    dh = dg · W_hhᵀ (W_hh upcast from its stored dtype)."""
    return _sweep_plain(gates, cs, c0, whh, dhs, dhT, dcT, B, round_dg=False)


def scan_bwd_exchange_words(R: int, G: int, units: int = SCAN_UNITS) -> int:
    """64-bit words of K11's exchange buffer: per chain two steps of 16
    rows of G partial sums of dh from each of the chain's blocks of
    ``units`` units (each block publishes its own columns' share of
    dg · W_hhᵀ for every unit; ``SCAN_WIDE_UNITS`` in the wide form)."""
    return R * 2 * SCAN_ROWS * scan_blocks_per_chain(G, units) * G


def lstm_scan_bwd_step(gates, cs, c0, whh, dhs, dhT, dcT, B: int, *,
                       _form: str | None = None):
    """K11: the reverse-time float32 sweep of one layer → (dxp
    (T, R*B, 4G), dh0, dc0), all f32 (see ``csrc/lstm_scan_train.cu``).

    gates (T, R*B, 4G), cs (T, R*B, G) from :func:`lstm_scan_train_fwd`;
    c0, dhT, dcT (R*B, G) and dhs (T, R*B, G) f32; whh (R, G, 4G) f32 or
    bf16.  One cooperative launch runs all T steps of all chains and up to
    16 rows per chain; further rows and chains are further launches.  Any
    G (:func:`scan_form`): W_hh resident on the chip up to G 512 and in the
    wide form's smaller shares over more blocks up to ``SCAN_WIDE_G_MAX``
    (both read it as stored), streamed above (from a transposed copy); the
    private ``_form`` names one.  The resident and streaming forms give the
    same bits; the wide form sums over blocks of 20 units, in its own fixed
    order.  Leaves its form in ``lstm_scan_bwd_step.form`` (the wide form
    with its units a block, as :func:`lstm_scan`'s) and counts
    ``lstm_scan_bwd_step.launches`` once per sweep.  CPU tensors run
    :func:`lstm_scan_bwd_step_plain`."""
    T, R, G = _dims(gates, whh, B)
    RB = R * B
    _check_hh_dtype(whh, "whh")
    route = _check(gates, [
        ("gates", gates, gates.shape, torch.float32), ("cs", cs, (T, RB, G), torch.float32),
        ("c0", c0, (RB, G), torch.float32), ("whh", whh, whh.shape, whh.dtype),
        ("dhs", dhs, (T, RB, G), torch.float32), ("dhT", dhT, (RB, G), torch.float32),
        ("dcT", dcT, (RB, G), torch.float32),
    ])
    form = _scan_form_for(G, whh.dtype, _form)
    if route == "cpu":
        return lstm_scan_bwd_step_plain(gates, cs, c0, whh, dhs, dhT, dcT, B)
    lib = _build.library()
    dev = gates.device
    bf16 = whh.dtype == torch.bfloat16
    form = _scan_device_form("K11", gates, R, G, form, _form is not None)
    plan = _scan_plan(lstm_scan_bwd_step, "K11", gates, R, B, G, bf16, form)
    dxp = torch.empty((T, RB, 4 * G), dtype=torch.float32, device=dev)
    dh0 = torch.empty((RB, G), dtype=torch.float32, device=dev)
    dc = dcT.clone()  # the kernel carries dc in place; it ends as dc0
    units = SCAN_WIDE_UNITS if form == "wide" else SCAN_UNITS
    hx = torch.zeros(scan_bwd_exchange_words(R, G, units), dtype=torch.int64, device=dev)
    # the resident and wide forms load W_hh as stored; the streaming one
    # reads neighbouring units from one row of W_hh transposed (R, 4G, G)
    w = whh.transpose(1, 2).contiguous() if form == "streaming" else whh
    for launched, (r0, nr, b0, nb, rt) in enumerate(plan):
        err = lib.umx_lstm_scan_bwd(
            _SCAN_FORM_CODE[form], gates.data_ptr(), cs.data_ptr(), c0.data_ptr(),
            w.data_ptr(), int(bf16),
            dhs.data_ptr(), dhT.data_ptr(), dc.data_ptr(), dxp.data_ptr(), dh0.data_ptr(),
            hx.data_ptr(), T, R, B, G, r0, nr, b0, nb, rt, launched * T, _stream(gates),
        )
        _build.check(err, "umx_lstm_scan_bwd")
    lstm_scan_bwd_step.launches += 1
    return dxp, dh0, dc


lstm_scan_bwd_step.launches = 0
lstm_scan_bwd_step.form = None


def lstm_scan_dw(hs, h0, dxp, B: int):
    """The float32 weight gradient of one layer, dW[r] = Σ over t, b of
    h_{t-1}ᵀ dxp_t (h_{-1} = h0) → (R, G, 4G) f32: a plain ``torch.bmm``
    of the unrounded operands on either device (no kernel: the JAX package
    leaves this product to XLA)."""
    T, RB, G = hs.shape
    R, G4 = RB // B, dxp.shape[2]
    hprev = torch.cat([h0[None], hs[:-1]])
    hp = hprev.view(T, R, B, G).permute(1, 0, 2, 3).reshape(R, T * B, G)
    dg = dxp.view(T, R, B, G4).permute(1, 0, 2, 3).reshape(R, T * B, G4)
    return torch.bmm(hp.transpose(1, 2), dg)


class LSTMScanTrain(torch.autograd.Function):
    """Differentiable float32 layer at the row level: K10 with residuals
    forward, K11 + the f32 dW backward (their plain versions on the CPU).

    forward(xp (T, R*B, 4G), hh_w (R, G, 4G) f32 or bf16, h0, c0 (R*B, G),
    B) → (hs, hT, cT).  W_hh runs in its stored dtype, and its gradient
    leaves in hh_w's dtype."""

    @staticmethod
    def forward(ctx, xp, hh_w, h0, c0, B):
        whh = hh_w.contiguous()
        hs, hT, cT, gates, cs = lstm_scan_train_fwd(xp, whh, h0, c0, B)
        ctx.save_for_backward(gates, cs, hs, h0, c0, whh)
        ctx.B = B
        return hs, hT, cT

    @staticmethod
    def backward(ctx, dhs, dhT, dcT):
        gates, cs, hs, h0, c0, whh = ctx.saved_tensors

        def ct(g, like):
            return torch.zeros_like(like) if g is None else g.float().contiguous()

        dxp, dh0, dc0 = lstm_scan_bwd_step(
            gates, cs, c0, whh, ct(dhs, hs), ct(dhT, h0), ct(dcT, c0), ctx.B
        )
        need = ctx.needs_input_grad
        dw = lstm_scan_dw(hs, h0, dxp, ctx.B).to(whh.dtype) if need[1] else None
        return (dxp if need[0] else None, dw, dh0 if need[2] else None,
                dc0 if need[3] else None, None)


def lstm_layer_scan_batched(x_proj, hh_w, h0, c0):
    """The float32 layer over a batch, in the layouts of
    :func:`lstm_layer_merged_batched`: K10 over all T#·D chains × B rows,
    W_hh in its stored dtype (f32, or the quantized parameters' bf16).
    With grad enabled and an input that requires it, runs
    :class:`LSTMScanTrain` (K10 with residuals, and K11 + the f32 dW in the
    backward); otherwise K10."""
    _check_hh_dtype(hh_w)
    Bsz, n_targets, _, D, G4 = x_proj.shape
    xp, h0r, c0r = _chain_rows(x_proj, h0, c0)
    whh = hh_w.reshape(n_targets * D, G4 // 4, G4).contiguous()
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x_proj, hh_w, h0, c0)):
        out = LSTMScanTrain.apply(xp, whh, h0r, c0r, Bsz)
    else:
        out = lstm_scan(xp, whh, h0r, c0r, Bsz)
    return _batched_outputs(*out, x_proj.shape)


# ---- the streaming forms of K1, K4 and K5 (their yardstick above G 512,
# and their form where no block form holds a chain; csrc/lstm_scan.cu and
# csrc/lstm_scan_train.cu with their bf16 operand flags)


def _streaming_forward(wrapper, xp, whh, h0, c0, B: int, residuals: bool):
    """The streaming K1 (or K4 with ``residuals``) on checked CUDA tensors:
    K10's streaming kernel with bf16 W_hh and h rounded to bf16 for the
    product, K1's function with W_hh read from L2 each step.  Leaves
    ("wide_streaming", blocks per chain, blocks the device holds at once,
    chain groups, row groups) in ``wrapper.form`` and counts
    ``wrapper.launches`` once."""
    T, R, G = _dims(xp, whh, B)
    RB = R * B
    plan = _scan_plan(wrapper, "K4w" if residuals else "K1w", xp, R, B, G, True, "streaming")
    wrapper.form = ("wide_streaming", *wrapper.form[1:])
    dev = xp.device
    hs = torch.empty((T, RB, G), dtype=torch.float32, device=dev)
    hT = torch.empty((RB, G), dtype=torch.float32, device=dev)
    cT = c0.clone()  # the kernel updates c in place
    hx = torch.zeros(scan_exchange_words(R, G), dtype=torch.int64, device=dev)
    extra = ()
    if residuals:
        extra = (torch.empty((T, RB, 4 * G), dtype=torch.float32, device=dev),  # gates
                 torch.empty((T, RB, G), dtype=torch.float32, device=dev))  # cs
    ptrs = [t.data_ptr() for t in extra] or [None, None]
    lib = _build.library()
    for launched, (r0, nr, b0, nb, rt) in enumerate(plan):
        err = lib.umx_lstm_merged_streaming(
            xp.data_ptr(), whh.data_ptr(), h0.data_ptr(), cT.data_ptr(), hs.data_ptr(),
            hT.data_ptr(), *ptrs, hx.data_ptr(), T, R, B, G, r0, nr, b0, nb, rt, launched * T,
            _stream(xp),
        )
        _build.check(err, "umx_lstm_merged_streaming")
    wrapper.launches += 1
    return (hs, hT, cT, *extra)


def _streaming_bwd(gates, cs, c0, whh, dhs, dhT, dcT, B: int):
    """The streaming K5 on checked CUDA tensors (the block form's yardstick,
    and the wide K5 where no block form holds a chain): K11's streaming
    sweep with the gate cotangents rounded to bf16 for the product against
    a transposed bf16 copy of W_hh, K5's function, at any G.  Leaves
    ("wide_streaming", blocks per chain, blocks the device holds at once,
    chain groups, row groups) in ``lstm_merged_bwd_step.form``."""
    T, R, G = _dims(gates, whh, B)
    RB = R * B
    wrapper = lstm_merged_bwd_step
    plan = _scan_plan(wrapper, "K5w", gates, R, B, G, True, "streaming")
    wrapper.form = ("wide_streaming", *wrapper.form[1:])
    dev = gates.device
    dxp = torch.empty((T, RB, 4 * G), dtype=torch.float32, device=dev)
    dh0 = torch.empty((RB, G), dtype=torch.float32, device=dev)
    dc = dcT.clone()  # the kernel carries dc in place; it ends as dc0
    hx = torch.zeros(scan_bwd_exchange_words(R, G), dtype=torch.int64, device=dev)
    wt = whh.transpose(1, 2).contiguous()  # (R, 4G, G) bf16
    lib = _build.library()
    for launched, (r0, nr, b0, nb, rt) in enumerate(plan):
        err = lib.umx_lstm_bwd_wide(
            gates.data_ptr(), cs.data_ptr(), c0.data_ptr(), wt.data_ptr(), dhs.data_ptr(),
            dhT.data_ptr(), dc.data_ptr(), dxp.data_ptr(), dh0.data_ptr(), hx.data_ptr(),
            T, R, B, G, r0, nr, b0, nb, rt, launched * T, _stream(gates),
        )
        _build.check(err, "umx_lstm_bwd_wide")
    wrapper.launches += 1
    return dxp, dh0, dc
