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
  and the weight gradient (``_make_merged_bwd_kernel``).
- K9 :func:`lstm_layer_pertarget`: the same function as K1 at one batch
  row in the per-target layout (T#, T, D, 4G), one launch per layer with
  each chain on a thread-block cluster that keeps its W_hh and state on
  chip (``_make_kernel``, reached by ``lstm_layer_pallas``).

K1, K4, K5 and K9 take every width, as the TPU kernels do
(:func:`merged_form`): up to G 512 the resident forms, with G % 8 != 0
padded by zero units (:func:`at_width`: a zero unit's gates are 0, its c
and h stay exactly 0 and it adds +0 to every real sum, so the cut result
is the unpadded function's); above G 512, where a warp's slice of W_hh no
longer fits its registers, the "wide" forms: K10's and K11's streaming
kernels with a compile-time flag that rounds the product's h (K1, K4) or
dg (K5) to bf16, K1's and K5's functions with W_hh read from L2 each step.
K9 runs its chains through the wide K1 where no cluster holds a chain's
W_hh.
- K10 :func:`lstm_scan` (``csrc/lstm_scan.cu``): the float32 recurrence
  of the JAX package's ``lax.scan`` (``_bilstm_layer``, its
  ``lstm_impl="scan"``), no Pallas kernel: K1's layouts, but unrounded f32
  h against W_hh in its stored dtype (f32, or bf16 upcast exactly), f32
  FMA on the CUDA cores, any G; one launch per layer, W_hh resident on
  the chip (registers and shared memory) up to G 512, read from L2 each
  step above (:func:`scan_form`).
- K10 with residuals :func:`lstm_scan_train_fwd`: the same kernel with a
  flag that also writes the activated gates and c per step, as K4 is K1.
- K11 :func:`lstm_scan_bwd_step` (``csrc/lstm_scan_train.cu``): the
  reverse-time float32 sweep, the scan's VJP (no bf16 anywhere), one
  launch per layer in K10's two forms (W_hh as stored in the resident
  form, a transposed copy in the streaming one); the weight
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


def resident_row_groups(B: int) -> list[tuple[int, int]]:
    """(first row, rows) of a resident kernel's launches over B rows per
    chain: groups of 16, the last one ragged.  Rows are independent, so a
    row's result does not depend on its group."""
    return [(b0, min(RESIDENT_ROWS, B - b0)) for b0 in range(0, B, RESIDENT_ROWS)]


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
    once."""
    import ctypes

    blocks = ctypes.c_int(0)
    lib = _build.library()
    with torch.cuda.device(index):
        if kernel == "K5":
            err = lib.umx_lstm_bwd_capacity(G, ctypes.addressof(blocks))
        else:
            err = lib.umx_lstm_merged_capacity(int(kernel == "K4"), ctypes.addressof(blocks))
    if err == _CUDA_ERROR_INVALID_CONFIGURATION:
        raise RuntimeError(f"{kernel}: this device has no cooperative launch, which the "
                           "resident recurrence needs")
    _build.check(err, f"{kernel} capacity")
    return blocks.value


# the resident kernels (and K9) read W_hh rows as 16-byte vectors of 8 bf16
MERGED_G_ALIGN = 8


def _aligned(G: int) -> int:
    """G rounded up to a multiple of ``MERGED_G_ALIGN``."""
    return -(-G // MERGED_G_ALIGN) * MERGED_G_ALIGN


def merged_form(G: int) -> str:
    """The form K1, K4 and K5 take at width G, chosen before any launch:
    "resident" (W_hh in registers; G % 8 != 0 padded to the next multiple
    of 8) up to ``RESIDENT_G_MAX``, "wide" (W_hh from L2 each step, any G)
    above."""
    if G < 1:
        raise ValueError(f"G must be positive, got {G}")
    return "resident" if G <= RESIDENT_G_MAX else "wide"


def merged_width(G: int) -> int:
    """The width the merged kernels launch at: G rounded up to a multiple
    of 8 in the resident form, G itself in the wide form."""
    return G if merged_form(G) == "wide" else _aligned(G)


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


def _merged_forward(wrapper, xp, whh, h0, c0, B: int, residuals: bool):
    """K1 (``residuals`` False) or K4 on CUDA tensors, in the form of
    :func:`merged_form` at :func:`merged_width`, or their plain versions on
    CPU tensors: the launches of one layer, counted once in
    ``wrapper.launches``."""
    T, R, G = _dims(xp, whh, B)
    RB = R * B
    route = _check(xp, [
        ("xp", xp, xp.shape, torch.float32), ("whh", whh, whh.shape, torch.bfloat16),
        ("h0", h0, (RB, G), torch.float32), ("c0", c0, (RB, G), torch.float32),
    ])
    if route == "cpu":
        plain = lstm_merged_train_fwd_plain if residuals else lstm_merged_plain
        return plain(xp, whh, h0, c0, B)
    if merged_form(G) == "wide":
        return _wide_forward(wrapper, xp, whh, h0, c0, B, residuals)
    n = 5 if residuals else 3
    return at_width(lambda *a: _resident_forward(wrapper, *a, residuals), G, merged_width(G),
                    (xp, whh, h0, c0, B), _FWD_KINDS, _FWD_OUT[:n])


def _resident_forward(wrapper, xp, whh, h0, c0, B: int, residuals: bool):
    """The resident K1 or K4 on checked CUDA tensors at G % 8 == 0: the
    launches of one layer over its chain and row groups."""
    T, R, G = _dims(xp, whh, B)
    RB = R * B
    entry = "umx_lstm_merged_train" if residuals else "umx_lstm_merged"
    _check_whh_vectors(whh, G)
    lib = _build.library()
    plan = _resident_plan(wrapper, "K4" if residuals else "K1", xp, R, B, G)
    dev = xp.device
    hs = torch.empty((T, RB, G), dtype=torch.float32, device=dev)
    hT = torch.empty((RB, G), dtype=torch.float32, device=dev)
    cT = c0.clone()  # the kernel updates c in place
    hx = torch.zeros(resident_exchange_words(R, G), dtype=torch.int64, device=dev)
    extra = ()
    if residuals:
        extra = (torch.empty((T, RB, 4 * G), dtype=torch.float32, device=dev),  # gates
                 torch.empty((T, RB, G), dtype=torch.float32, device=dev))  # cs
    for launched, (r0, nr, b0, nb) in enumerate(plan):
        err = getattr(lib, entry)(
            xp.data_ptr(), whh.data_ptr(), h0.data_ptr(), cT.data_ptr(), hs.data_ptr(),
            hT.data_ptr(), *(t.data_ptr() for t in extra), hx.data_ptr(), T, R, B, G,
            r0, nr, b0, nb, launched * T, _stream(xp),
        )
        _build.check(err, entry)
    wrapper.launches += 1
    return (hs, hT, cT, *extra)


def lstm_merged(xp, whh, h0, c0, B: int):
    """K1: one BLSTM layer's recurrence for all chains (see module docstring).

    xp (T, R*B, 4G) f32, whh (R, G, 4G) bf16, h0/c0 (R*B, G) f32 →
    (hs (T, R*B, G), hT, cT).  One kernel launch runs all T steps of all
    chains and up to 16 rows per chain; further rows (and chains beyond
    what the device holds at once) are further launches of the same
    kernel.  Any G (:func:`merged_form`): up to 512 with W_hh resident in
    registers (G % 8 != 0 padded by zero units), the wide form above.  The
    form that ran is left in ``lstm_merged.form``: resident as (blocks per
    chain, blocks the device holds at once, chain groups, row groups), wide
    as ("wide", the same four).  Increments ``lstm_merged.launches`` once
    per layer."""
    return _merged_forward(lstm_merged, xp, whh, h0, c0, B, residuals=False)


lstm_merged.launches = 0
lstm_merged.form = None


def lstm_merged_train_fwd(xp, whh, h0, c0, B: int):
    """K4: :func:`lstm_merged` plus the residuals → (hs, hT, cT, gates
    (T, R*B, 4G) activated i|f|g|o, cs (T, R*B, G)).  The same kernel as
    K1, in the same form, with the residual stores compiled in: one launch
    per layer and group of 16 rows, any B, any G, hs/hT/cT bit-equal to
    K1's.  Leaves its form in ``lstm_merged_train_fwd.form`` and counts
    ``lstm_merged_train_fwd.launches`` once per layer."""
    return _merged_forward(lstm_merged_train_fwd, xp, whh, h0, c0, B, residuals=True)


lstm_merged_train_fwd.launches = 0
lstm_merged_train_fwd.form = None


def lstm_merged_bwd_step(gates, cs, c0, whh, dhs, dhT, dcT, B: int):
    """K5: the reverse-time sweep → (dxp (T, R*B, 4G), dh0, dc0), all f32.
    One launch runs all T steps (and the product that gives dh0) of all
    chains and up to 16 rows per chain; further rows and chains are
    further launches, any B.  Any G, in :func:`merged_form`'s form: up to
    512 resident (W_hh in registers, G % 8 != 0 padded by zero units), the
    wide form above (K11's streaming sweep with the gate cotangents rounded
    to bf16 for the product, from a transposed bf16 copy of W_hh).  Leaves
    its form in ``lstm_merged_bwd_step.form`` (as :func:`lstm_merged`'s)
    and counts ``lstm_merged_bwd_step.launches`` once per sweep."""
    T, R, G = _dims(gates, whh, B)
    RB = R * B
    route = _check(gates, [
        ("gates", gates, gates.shape, torch.float32), ("cs", cs, (T, RB, G), torch.float32),
        ("c0", c0, (RB, G), torch.float32), ("whh", whh, whh.shape, torch.bfloat16),
        ("dhs", dhs, (T, RB, G), torch.float32), ("dhT", dhT, (RB, G), torch.float32),
        ("dcT", dcT, (RB, G), torch.float32),
    ])
    if route == "cpu":
        return lstm_merged_bwd_step_plain(gates, cs, c0, whh, dhs, dhT, dcT, B)
    args = (gates, cs, c0, whh, dhs, dhT, dcT, B)
    if merged_form(G) == "wide":
        return _wide_bwd(*args)
    return at_width(_resident_bwd, G, merged_width(G), args, _BWD_KINDS, _BWD_OUT)


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


lstm_merged_bwd_step.launches = 0
lstm_merged_bwd_step.form = None


def lstm_merged_dw(hs, h0, dxp, B: int):
    """K6: dW (R, G, 4G) f32 = Σ over t, b of bf16(h_{t-1})ᵀ bf16(dxp_t).
    Counts ``lstm_merged_dw.launches``."""
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
    if route == "cpu":
        return lstm_merged_dw_plain(hs, h0, dxp, B)
    dw = torch.empty((R, G, 4 * G), dtype=torch.float32, device=hs.device)
    err = _build.library().umx_lstm_dw(
        hs.data_ptr(), h0.data_ptr(), dxp.data_ptr(), dw.data_ptr(), T, R, B, G, _stream(hs)
    )
    _build.check(err, "umx_lstm_dw")
    lstm_merged_dw.launches += 1
    return dw


lstm_merged_dw.launches = 0


class LSTMMergedTrain(torch.autograd.Function):
    """Differentiable merged layer at the row level: K4 forward, K5 + K6
    backward (their plain versions on the CPU).

    forward(xp (T, R*B, 4G), hh_w (R, G, 4G) f32, h0, c0 (R*B, G), B) →
    (hs, hT, cT).  W_hh is rounded to bf16 inside, and its gradient leaves
    in f32 for the f32 ``hh_w`` (as the JAX package's custom VJP does)."""

    @staticmethod
    def forward(ctx, xp, hh_w, h0, c0, B):
        whh = hh_w.to(torch.bfloat16).contiguous()
        hs, hT, cT, gates, cs = lstm_merged_train_fwd(xp, whh, h0, c0, B)
        ctx.save_for_backward(gates, cs, hs, h0, c0, whh)
        ctx.B = B
        return hs, hT, cT

    @staticmethod
    def backward(ctx, dhs, dhT, dcT):
        gates, cs, hs, h0, c0, whh = ctx.saved_tensors

        def ct(g, like):
            return torch.zeros_like(like) if g is None else g.float().contiguous()

        dxp, dh0, dc0 = lstm_merged_bwd_step(
            gates, cs, c0, whh, ct(dhs, hs), ct(dhT, h0), ct(dcT, c0), ctx.B
        )
        need = ctx.needs_input_grad
        dw = lstm_merged_dw(hs, h0, dxp, ctx.B) if need[1] else None
        return (dxp if need[0] else None, dw, dh0 if need[2] else None,
                dc0 if need[3] else None, None)


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


def lstm_layer_pertarget(x_proj, whh, h0, c0):
    """K9: one BLSTM layer's recurrence for all targets and directions at
    one batch row, one kernel launch for all T steps (see module docstring).

    x_proj (T#, T, D, 4G) f32, whh (T#, D, G, 4G) bf16, h0/c0 (T#, D, G)
    f32 → (hs (T#, T, D, G), hT, cT).  Any G.  Each chain runs on a
    thread-block cluster that keeps its W_hh in registers and shared
    memory (G % 8 != 0 padded by zero units, :func:`at_width`);
    :func:`pertarget_cluster_choice` picks the cluster size among those
    the device can place.  Where none holds a chain's W_hh (G above about
    704 on an H100) the chains run through the wide K1 (the same function
    at one row per chain).  The form that ran is left in
    ``lstm_layer_pertarget.form``: (blocks per cluster, clusters the device
    holds at once, waves), or ("wide", …) as :func:`lstm_merged`'s.
    Increments ``lstm_layer_pertarget.launches`` once per kernel launch."""
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
    if best is None:
        xp = x_proj.permute(1, 0, 2, 3).reshape(T, R, G4).contiguous()
        hs, hT, cT = _wide_forward(lstm_layer_pertarget, xp, whh.reshape(R, G, G4),
                                   h0.reshape(R, G), c0.reshape(R, G), 1, residuals=False)
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


# K10 (csrc/lstm_scan.cu): a block owns 32 hidden units of one chain; a
# launch takes up to 16 rows per chain (fewer where the device's shared
# memory runs out, as its capacity query says), and the exchange buffer
# has room for 16 rows of each chain.
SCAN_UNITS = 32
SCAN_ROWS = 16
# The resident forms of K10 and K11 keep a block's share of W_hh (its 128
# gate columns x G rows, upcast to f32) on the chip up to this width,
# split between registers and shared memory (their capacity queries report
# the split: scan_block_layout); wider layers stream it.
SCAN_RESIDENT_G_MAX = 512
SCAN_FORMS = ("resident", "streaming")


def scan_form(G: int, whh_dtype: torch.dtype) -> str:
    """The form K10, K10 with residuals and K11 take at width G, W_hh in
    ``whh_dtype`` (f32 or bf16, upcast to f32 on the chip either way):
    "resident" up to ``SCAN_RESIDENT_G_MAX``, else "streaming".  Chosen from
    the width before any launch, never from the rows, the chains or a
    failed launch."""
    if whh_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"whh must be float32 or bfloat16, got {whh_dtype}")
    return "resident" if G <= SCAN_RESIDENT_G_MAX else "streaming"


def _scan_form_for(G: int, whh_dtype: torch.dtype, form: str | None) -> str:
    """``form`` as asked for (None: :func:`scan_form`), raising by name for
    an unknown form or the resident form above its width."""
    if form is None:
        return scan_form(G, whh_dtype)
    if form not in SCAN_FORMS:
        raise ValueError(f"form must be one of {SCAN_FORMS} or None, got {form!r}")
    if form == "resident" and G > SCAN_RESIDENT_G_MAX:
        raise ValueError(f"the resident form holds W_hh on the chip up to G = "
                         f"{SCAN_RESIDENT_G_MAX}; got G = {G}")
    return form


def scan_blocks_per_chain(G: int) -> int:
    """Blocks that share one chain in K10: one per 32 hidden units."""
    return -(-G // SCAN_UNITS)


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


@functools.lru_cache(maxsize=None)
def scan_block_layout(index: int, G: int, whh_bf16: bool, kernel: str = "K10",
                      form: str = "streaming") -> tuple[int, int, int, int]:
    """What ``kernel`` ("K10", "K10r" with the residual stores, or "K11";
    "K1w", "K4w", "K5w": the wide merged forms, the streaming kernels with
    bf16 operands, ``form`` "wide") in ``form`` at width G, W_hh in bf16 or
    f32, reports of itself on CUDA device ``index``, asked once: (the
    largest row tile, the blocks of it held at once, the dynamic shared
    memory a block of that tile asks for, the bytes of a full block's share
    of W_hh that stay in registers, 0 in the streaming forms)."""
    import ctypes

    out = [ctypes.c_int(0) for _ in range(4)]
    ptrs = [ctypes.addressof(v) for v in out]
    lib = _build.library()
    resident = int(form == "resident")
    with torch.cuda.device(index):
        if kernel in ("K1w", "K4w"):
            err = lib.umx_lstm_merged_wide_capacity(G, int(kernel == "K4w"), *ptrs)
        elif kernel == "K5w":
            err = lib.umx_lstm_bwd_wide_capacity(G, *ptrs)
        elif kernel == "K11":
            err = lib.umx_lstm_scan_bwd_capacity(resident, G, int(whh_bf16), *ptrs)
        else:
            err = lib.umx_lstm_scan_capacity(resident, G, int(whh_bf16), int(kernel == "K10r"),
                                             *ptrs)
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


def _scan_plan(wrapper, kernel: str, ref, R: int, B: int, G: int, bf16: bool, form: str):
    """The launches of one K10 / K11 layer in ``form``, (r0, nr, b0, nb,
    row tile) each, row groups outermost; leaves the form in
    ``wrapper.form`` as (form, blocks per chain, blocks the device holds at
    once, chain groups, row groups)."""
    rows, capacity = _scan_capacity(ref.device.index, G, bf16, kernel, form)
    chains = chain_groups(R, scan_blocks_per_chain(G), capacity, kernel)
    groups = scan_row_groups(B, rows)
    wrapper.form = (form, scan_blocks_per_chain(G), capacity, len(chains), len(groups))
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
    form = _scan_form_for(G, whh.dtype, form)
    if route == "cpu":
        if residuals:
            return lstm_scan_train_fwd_plain(xp, whh, h0, c0, B)
        return lstm_scan_plain(xp, whh, h0, c0, B)
    lib = _build.library()
    dev = xp.device
    bf16 = whh.dtype == torch.bfloat16
    plan = _scan_plan(wrapper, "K10r" if residuals else "K10", xp, R, B, G, bf16, form)
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
            int(form == "resident"), xp.data_ptr(), whh.data_ptr(), int(bf16), h0.data_ptr(),
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
    kernel.  Any G: W_hh resident on the chip up to G 512, streamed above
    (:func:`scan_form`; the private ``_form`` names one, for the checks that
    compare them).  The form that ran is left in ``lstm_scan.form`` as (form, blocks per chain,
    blocks the device holds at once, chain groups, row groups).  Increments
    ``lstm_scan.launches`` once per layer.  CPU tensors run
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


def scan_bwd_exchange_words(R: int, G: int) -> int:
    """64-bit words of K11's exchange buffer: per chain two steps of 16
    rows of G partial sums of dh from each of the chain's blocks (each
    block publishes its own columns' share of dg · W_hhᵀ for every unit)."""
    return R * 2 * SCAN_ROWS * scan_blocks_per_chain(G) * G


def lstm_scan_bwd_step(gates, cs, c0, whh, dhs, dhT, dcT, B: int, *,
                       _form: str | None = None):
    """K11: the reverse-time float32 sweep of one layer → (dxp
    (T, R*B, 4G), dh0, dc0), all f32 (see ``csrc/lstm_scan_train.cu``).

    gates (T, R*B, 4G), cs (T, R*B, G) from :func:`lstm_scan_train_fwd`;
    c0, dhT, dcT (R*B, G) and dhs (T, R*B, G) f32; whh (R, G, 4G) f32 or
    bf16.  One cooperative launch runs all T steps of all chains and up to
    16 rows per chain; further rows and chains are further launches.  Any
    G: W_hh resident on the chip up to G 512 (read as stored), streamed
    above (from a transposed copy; :func:`scan_form`; the private ``_form``
    names one; both give the same bits).  Leaves its form in
    ``lstm_scan_bwd_step.form`` and counts ``lstm_scan_bwd_step.launches``
    once per sweep.  CPU tensors run :func:`lstm_scan_bwd_step_plain`."""
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
    plan = _scan_plan(lstm_scan_bwd_step, "K11", gates, R, B, G, bf16, form)
    dxp = torch.empty((T, RB, 4 * G), dtype=torch.float32, device=dev)
    dh0 = torch.empty((RB, G), dtype=torch.float32, device=dev)
    dc = dcT.clone()  # the kernel carries dc in place; it ends as dc0
    hx = torch.zeros(scan_bwd_exchange_words(R, G), dtype=torch.int64, device=dev)
    # the resident form loads W_hh as stored; the streaming one reads
    # neighbouring units from one row of W_hh transposed (R, 4G, G)
    w = whh if form == "resident" else whh.transpose(1, 2).contiguous()
    for launched, (r0, nr, b0, nb, rt) in enumerate(plan):
        err = lib.umx_lstm_scan_bwd(
            int(form == "resident"), gates.data_ptr(), cs.data_ptr(), c0.data_ptr(),
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


# ---- the wide forms of K1, K4 and K5 (G > 512; csrc/lstm_scan.cu and
# csrc/lstm_scan_train.cu with their bf16 operand flags)


def _wide_forward(wrapper, xp, whh, h0, c0, B: int, residuals: bool):
    """The wide K1 (or K4 with ``residuals``) on checked CUDA tensors: K10's
    streaming kernel with bf16 W_hh and h rounded to bf16 for the product,
    K1's function.  Leaves ("wide", blocks per chain, blocks the device
    holds at once, chain groups, row groups) in ``wrapper.form`` and counts
    ``wrapper.launches`` once."""
    T, R, G = _dims(xp, whh, B)
    RB = R * B
    plan = _scan_plan(wrapper, "K4w" if residuals else "K1w", xp, R, B, G, True, "wide")
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
        err = lib.umx_lstm_merged_wide(
            xp.data_ptr(), whh.data_ptr(), h0.data_ptr(), cT.data_ptr(), hs.data_ptr(),
            hT.data_ptr(), *ptrs, hx.data_ptr(), T, R, B, G, r0, nr, b0, nb, rt, launched * T,
            _stream(xp),
        )
        _build.check(err, "umx_lstm_merged_wide")
    wrapper.launches += 1
    return (hs, hT, cT, *extra)


def _wide_bwd(gates, cs, c0, whh, dhs, dhT, dcT, B: int):
    """The wide K5 on checked CUDA tensors: K11's streaming sweep with the
    gate cotangents rounded to bf16 for the product against a transposed
    bf16 copy of W_hh, K5's function."""
    T, R, G = _dims(gates, whh, B)
    RB = R * B
    wrapper = lstm_merged_bwd_step
    plan = _scan_plan(wrapper, "K5w", gates, R, B, G, True, "wide")
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
