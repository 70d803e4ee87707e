"""The BLSTM recurrence kernels and their plain PyTorch versions: the
merged recurrence and its backward (``csrc/lstm_merged.cu``,
``csrc/lstm_train.cu``) and the per-target recurrence
(``csrc/lstm_pertarget.cu``).

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

A wrapper runs its plain version for CPU tensors only; for CUDA tensors it
launches its kernel or raises, and adds one to its ``launches`` count per
kernel run.  :class:`LSTMMergedTrain` is the ``torch.autograd.Function``
over K4 and K5 + K6; :func:`lstm_layer_merged_batched` takes it when a
gradient is wanted and K1 otherwise, as the JAX package's custom VJP runs
the inference kernel for primal-only evaluation.
"""

from __future__ import annotations

import functools

import torch

from umx_tpu_torch import _build


def _bf16(x):
    """Round f32 to bf16 and back (the operand rounding of every product)."""
    return x.to(torch.bfloat16).float()


def _cell(pre, c, G: int):
    """Activated gates (i, f, g, o) of the pre-activations, new c, new h."""
    i = torch.sigmoid(pre[:, :G])
    f = torch.sigmoid(pre[:, G : 2 * G])
    g = torch.tanh(pre[:, 2 * G : 3 * G])
    o = torch.sigmoid(pre[:, 3 * G :])
    c = f * c + i * g
    return (i, f, g, o), c, o * torch.tanh(c)


def lstm_merged_plain(xp, whh, h0, c0, B: int):
    """Plain PyTorch recurrence: one batched matmul per timestep.

    xp (T, R*B, 4G) f32, whh (R, G, 4G) bf16, h0/c0 (R*B, G) f32 →
    (hs (T, R*B, G), hT, cT).  h is rounded to bf16 before each product
    and the bf16 weights are exact in f32, so every product is exact and
    only the f32 summation order differs from the kernel."""
    T, RB, G4 = xp.shape
    R, G = whh.shape[0], whh.shape[1]
    w = whh.float()
    h, c = h0, c0
    hs = torch.empty((T, RB, G), dtype=torch.float32, device=xp.device)
    for t in range(T):
        pre = xp[t] + torch.bmm(_bf16(h).view(R, B, G), w).view(RB, G4)
        _, c, h = _cell(pre, c, G)
        hs[t] = h
    return hs, h, c


def lstm_merged_train_fwd_plain(xp, whh, h0, c0, B: int):
    """:func:`lstm_merged_plain` plus the residuals of the backward:
    returns (hs, hT, cT, gates (T, R*B, 4G) activated i|f|g|o, cs (T, R*B, G))."""
    T, RB, G4 = xp.shape
    R, G = whh.shape[0], whh.shape[1]
    w = whh.float()
    h, c = h0, c0
    hs = torch.empty((T, RB, G), dtype=torch.float32, device=xp.device)
    cs = torch.empty_like(hs)
    gates = torch.empty((T, RB, G4), dtype=torch.float32, device=xp.device)
    for t in range(T):
        pre = xp[t] + torch.bmm(_bf16(h).view(R, B, G), w).view(RB, G4)
        act, c, h = _cell(pre, c, G)
        gates[t] = torch.cat(act, dim=1)
        cs[t] = c
        hs[t] = h
    return hs, h, c, gates, cs


def lstm_merged_bwd_step_plain(gates, cs, c0, whh, dhs, dhT, dcT, B: int):
    """Plain reverse-time sweep, in the TPU backward kernel's operation
    order: returns (dxp (T, R*B, 4G), dh0, dc0), all f32.  The gate
    cotangents are rounded to bf16 before their product with W_hhᵀ and the
    dh/dc carries stay f32 (autograd through :func:`lstm_merged_plain`
    would round the dh carry to bf16 at every step instead)."""
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
        dh = torch.bmm(_bf16(dg).view(R, B, G4), wt).view(RB, G)
        dc = dct * f
    return dxp, dh, dc


def lstm_merged_dw_plain(hs, h0, dxp, B: int):
    """Plain weight gradient: dW[r] = Σ over t, b of bf16(h_{t-1})ᵀ bf16(dxp_t),
    h_{-1} = h0, f32 accumulation → (R, G, 4G)."""
    T, RB, G = hs.shape
    R, G4 = RB // B, dxp.shape[2]
    hprev = torch.cat([h0[None], hs[:-1]])
    hp = _bf16(hprev).view(T, R, B, G).permute(1, 0, 2, 3).reshape(R, T * B, G)
    dg = _bf16(dxp).view(T, R, B, G4).permute(1, 0, 2, 3).reshape(R, T * B, G4)
    return torch.bmm(hp.transpose(1, 2), dg)


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


def resident_chain_groups(R: int, G: int, capacity: int) -> list[tuple[int, int]]:
    """(first chain, chains) of a resident kernel's launches over R chains
    on a device that holds ``capacity`` of its blocks at once: a launch's
    blocks must all be resident, because a chain's blocks wait for each
    other.  Raises where not even one chain fits."""
    per = capacity // resident_blocks_per_chain(G)
    if per < 1:
        raise RuntimeError(
            f"the resident recurrence needs {resident_blocks_per_chain(G)} co-resident blocks "
            f"per chain at G = {G}; this device holds {capacity}")
    return [(r0, min(per, R - r0)) for r0 in range(0, R, per)]


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


def _check_resident_width(what: str, G: int):
    if G > RESIDENT_G_MAX:
        raise RuntimeError(
            f"{what}: a warp's slice of W_hh must fit 128 registers a thread, "
            f"G <= {RESIDENT_G_MAX}; got G = {G}")


def _resident_plan(wrapper, kernel: str, xp, R: int, B: int, G: int):
    """Chain groups and row groups of one layer's launches; leaves the form
    in ``wrapper.form`` as (blocks per chain, blocks the device holds at
    once, chain groups, row groups)."""
    capacity = _resident_capacity(xp.device.index, kernel, G if kernel == "K5" else 0)
    chains = resident_chain_groups(R, G, capacity)
    rows = resident_row_groups(B)
    wrapper.form = (resident_blocks_per_chain(G), capacity, len(chains), len(rows))
    return [(r0, nr, b0, nb) for r0, nr in chains for b0, nb in rows]


def _resident_forward(wrapper, xp, whh, h0, c0, B: int, residuals: bool):
    """K1 (``residuals`` False) or K4 on CUDA tensors, or their plain
    versions on CPU tensors: the launches of one layer over its chain and
    row groups, counted once in ``wrapper.launches``."""
    T, R, G = _dims(xp, whh, B)
    RB = R * B
    route = _check(xp, [
        ("xp", xp, xp.shape, torch.float32), ("whh", whh, whh.shape, torch.bfloat16),
        ("h0", h0, (RB, G), torch.float32), ("c0", c0, (RB, G), torch.float32),
    ])
    if route == "cpu":
        plain = lstm_merged_train_fwd_plain if residuals else lstm_merged_plain
        return plain(xp, whh, h0, c0, B)
    entry = "umx_lstm_merged_train" if residuals else "umx_lstm_merged"
    _check_whh_vectors(whh, G)
    _check_resident_width(entry, G)
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
    chains and up to 16 rows per chain with W_hh resident in registers;
    further rows (and chains beyond what the device holds at once) are
    further launches of the same kernel.  G above 512 raises.  The form
    that ran is left in ``lstm_merged.form`` as (blocks per chain, blocks
    the device holds at once, chain groups, row groups).  Increments
    ``lstm_merged.launches`` once per layer."""
    return _resident_forward(lstm_merged, xp, whh, h0, c0, B, residuals=False)


lstm_merged.launches = 0
lstm_merged.form = None


def lstm_merged_train_fwd(xp, whh, h0, c0, B: int):
    """K4: :func:`lstm_merged` plus the residuals → (hs, hT, cT, gates
    (T, R*B, 4G) activated i|f|g|o, cs (T, R*B, G)).  The same resident
    kernel as K1 with the residual stores compiled in: one launch per layer
    and group of 16 rows, any B, hs/hT/cT bit-equal to K1's; G above 512
    raises.  Leaves its form in ``lstm_merged_train_fwd.form`` and counts
    ``lstm_merged_train_fwd.launches`` once per layer."""
    return _resident_forward(lstm_merged_train_fwd, xp, whh, h0, c0, B, residuals=True)


lstm_merged_train_fwd.launches = 0
lstm_merged_train_fwd.form = None


def lstm_merged_bwd_step(gates, cs, c0, whh, dhs, dhT, dcT, B: int):
    """K5: the reverse-time sweep → (dxp (T, R*B, 4G), dh0, dc0), all f32.
    One resident launch runs all T steps (and the product that gives dh0)
    of all chains and up to 16 rows per chain; further rows and chains are
    further launches, any B; G above 512 raises.  Leaves its form in
    ``lstm_merged_bwd_step.form`` and counts
    ``lstm_merged_bwd_step.launches`` once per sweep."""
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
    _check_whh_vectors(whh, G)
    _check_resident_width("umx_lstm_bwd", G)
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


def _check_hh_dtype(hh_w):
    if hh_w.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"hh_w must be float32 or bfloat16, got {hh_w.dtype}")


def lstm_pertarget_plain(x_proj, whh, h0, c0):
    """Plain PyTorch version of :func:`lstm_layer_pertarget`: one einsum
    over all chains per timestep, bf16-rounded h against the bf16 weights
    (exact in f32), f32 sums.

    x_proj (T#, T, D, 4G) f32, whh (T#, D, G, 4G) bf16, h0/c0 (T#, D, G)
    f32 → (hs (T#, T, D, G), hT, cT)."""
    n_targets, T, D, G4 = x_proj.shape
    G = G4 // 4
    w = whh.float()
    h, c = h0, c0
    hs = torch.empty((n_targets, T, D, G), dtype=torch.float32, device=x_proj.device)
    for t in range(T):
        pre = x_proj[:, t] + torch.einsum("jdg,jdgf->jdf", _bf16(h), w)
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
    chain."""
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
        raise RuntimeError(
            f"umx_lstm_pertarget: no cluster of up to {PERTARGET_MAX_CLUSTER} blocks holds one "
            f"chain's W_hh (G x 4G bf16 = {G * 4 * G * 2} bytes at G = {G}) on this device: "
            f"clusters held at once by size {dict(placeable)}")
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
    f32 → (hs (T#, T, D, G), hT, cT).  Each chain runs on a thread-block
    cluster that keeps its W_hh in registers and shared memory;
    :func:`pertarget_cluster_choice` picks the cluster size among those
    the device can place and raises where none holds a chain's W_hh.  The
    form that ran is left in ``lstm_layer_pertarget.form`` as (blocks per
    cluster, clusters the device holds at once, waves).  Increments
    ``lstm_layer_pertarget.launches`` once per kernel launch."""
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
    _check_whh_vectors(whh, G)
    dev = x_proj.device
    placeable = _pertarget_placeable(dev.index, G, n_targets * D)
    cluster, units, waves = pertarget_cluster_choice(G, n_targets * D, placeable)
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
    Bsz, n_targets, T, D, G4 = x_proj.shape
    G = G4 // 4
    R = n_targets * D
    # rows chain-major: row = ((t# * D) + d) * B + b
    xp = x_proj.permute(2, 1, 3, 0, 4).reshape(T, R * Bsz, G4).contiguous()
    h0r = h0.float().permute(1, 2, 0, 3).reshape(R * Bsz, G).contiguous()
    c0r = c0.float().permute(1, 2, 0, 3).reshape(R * Bsz, G).contiguous()
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x_proj, hh_w, h0, c0)):
        hh = hh_w.float().reshape(R, G, G4).contiguous()
        hs, hT, cT = LSTMMergedTrain.apply(xp, hh, h0r, c0r, Bsz)
    else:
        whh = hh_w.to(torch.bfloat16).reshape(R, G, G4).contiguous()
        hs, hT, cT = lstm_merged(xp, whh, h0r, c0r, Bsz)
    hs = hs.view(T, n_targets, D, Bsz, G).permute(3, 1, 0, 2, 4)
    hT = hT.view(n_targets, D, Bsz, G).permute(2, 0, 1, 3)
    cT = cT.view(n_targets, D, Bsz, G).permute(2, 0, 1, 3)
    return hs, hT, cT

