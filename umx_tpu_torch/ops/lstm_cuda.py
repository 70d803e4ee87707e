"""The merged BLSTM recurrence (kernel ``csrc/lstm_merged.cu``) and its
plain PyTorch version.

:func:`lstm_merged` has the contract of the TPU kernel it replaces
(``umx_tpu/ops/lstm_pallas.py:_make_merged_kernel``): R independent
chains of B rows each, rows chain-major (``row = r*B + b``), W_hh in
bf16, products of bf16 operands accumulated in f32, gate math and the
c/h state in f32.  :func:`lstm_layer_merged` and
:func:`lstm_layer_merged_batched` are the layer-level entries in the
JAX package's layouts.
"""

from __future__ import annotations

import torch

from umx_tpu_torch import _build


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
        hb = h.to(torch.bfloat16).float().view(R, B, G)
        gates = xp[t] + torch.bmm(hb, w).view(RB, G4)
        i = torch.sigmoid(gates[:, :G])
        f = torch.sigmoid(gates[:, G : 2 * G])
        g = torch.tanh(gates[:, 2 * G : 3 * G])
        o = torch.sigmoid(gates[:, 3 * G :])
        c = f * c + i * g
        h = o * torch.tanh(c)
        hs[t] = h
    return hs, h, c


def lstm_merged(xp, whh, h0, c0, B: int):
    """One BLSTM layer's recurrence for all chains (see module docstring).

    CUDA tensors launch the kernel (or raise); CPU tensors run
    :func:`lstm_merged_plain`.  Increments ``lstm_merged.launches`` once
    per kernel run (one run launches one step grid per timestep)."""
    if xp.dim() != 3:
        raise ValueError(f"xp must be (T, R*B, 4G), got shape {tuple(xp.shape)}")
    T, RB, G4 = xp.shape
    if whh.dim() != 3 or whh.shape[2] != G4 or G4 != 4 * whh.shape[1]:
        raise ValueError(
            f"whh must be (R, G, 4G) matching xp's 4G={G4}, got {tuple(whh.shape)}"
        )
    R, G = whh.shape[0], whh.shape[1]
    if B < 1 or RB != R * B:
        raise ValueError(f"xp rows {RB} != R*B = {R}*{B}")
    for name, t in (("h0", h0), ("c0", c0)):
        if tuple(t.shape) != (RB, G):
            raise ValueError(f"{name} must be ({RB}, {G}), got {tuple(t.shape)}")
    if T < 1:
        raise ValueError("xp has no timesteps")
    for name, t, dt in (
        ("xp", xp, torch.float32), ("whh", whh, torch.bfloat16),
        ("h0", h0, torch.float32), ("c0", c0, torch.float32),
    ):
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if t.device != xp.device:
            raise ValueError(f"{name} is on {t.device}, xp on {xp.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if xp.device.type == "cpu":
        return lstm_merged_plain(xp, whh, h0, c0, B)
    if xp.device.type != "cuda":
        raise ValueError(f"no kernel for device {xp.device}")
    # the kernel reads W_hh rows as 16-byte vectors of 8 bf16
    if G % 8 != 0 or whh.data_ptr() % 16 != 0:
        raise ValueError(f"the kernel needs G % 8 == 0 and a 16-byte aligned whh (G={G})")

    lib = _build.library()
    hs = torch.empty((T, RB, G), dtype=torch.float32, device=xp.device)
    hT = torch.empty((RB, G), dtype=torch.float32, device=xp.device)
    cT = c0.clone()  # the kernel updates c in place
    stream = torch.cuda.current_stream(xp.device).cuda_stream
    err = lib.umx_lstm_merged(
        xp.data_ptr(), whh.data_ptr(), h0.data_ptr(), cT.data_ptr(),
        hs.data_ptr(), hT.data_ptr(), T, R, B, G, stream,
    )
    _build.check(err, "umx_lstm_merged")
    lstm_merged.launches += 1
    return hs, hT, cT


lstm_merged.launches = 0


def lstm_layer_merged_batched(x_proj, hh_w, h0, c0):
    """Batched merged layer, layouts as in the JAX package.

    x_proj (B, T#, T, D, 4G) f32; hh_w (T#, D, G, 4G); h0/c0 (B, T#, D, G).
    Returns (hs (B, T#, T, D, G), hT (B, T#, D, G), cT (B, T#, D, G))."""
    Bsz, n_targets, T, D, G4 = x_proj.shape
    G = G4 // 4
    R = n_targets * D
    whh = hh_w.to(torch.bfloat16).reshape(R, G, G4).contiguous()
    # rows chain-major: row = ((t# * D) + d) * B + b
    xp = x_proj.permute(2, 1, 3, 0, 4).reshape(T, R * Bsz, G4).contiguous()
    h0r = h0.float().permute(1, 2, 0, 3).reshape(R * Bsz, G).contiguous()
    c0r = c0.float().permute(1, 2, 0, 3).reshape(R * Bsz, G).contiguous()
    hs, hT, cT = lstm_merged(xp, whh, h0r, c0r, Bsz)
    hs = hs.view(T, n_targets, D, Bsz, G).permute(3, 1, 0, 2, 4)
    hT = hT.view(n_targets, D, Bsz, G).permute(2, 0, 1, 3)
    cT = cT.view(n_targets, D, Bsz, G).permute(2, 0, 1, 3)
    return hs, hT, cT


def lstm_layer_merged(x_proj, hh_w, h0, c0):
    """Unbatched merged layer: x_proj (T#, T, D, 4G), hh_w (T#, D, G, 4G),
    h0/c0 (T#, D, G) → (hs (T#, T, D, G), hT (T#, D, G), cT (T#, D, G))."""
    hs, hT, cT = lstm_layer_merged_batched(x_proj[None], hh_w, h0[None], c0[None])
    return hs[0], hT[0], cT[0]
