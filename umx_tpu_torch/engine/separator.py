"""The demixing engine: the batched segment pipeline and the whole-track
programs.

A segment runs STFT → magnitude → crop/stack → mask network (pre,
recurrence, post) → Wiener-EM (or mix-phase masking) → iSTFT, over a
leading axis of segment rows.  A track is split into full-length
segments at a fixed stride (the last one zero-padded).  Streaming
configs thread the LSTM state from chunk to chunk (:func:`demix_fused`);
non-streaming configs run the chunks in groups of ``chunk_batch`` rows
at zero state (:func:`demix_fused_parallel`).  Either way the chunk
outputs, weighted by the triangular transition, are stacked
``(n_chunks, ..., seg)`` and finished by one normalized overlap-add
(:func:`_normalized_overlap_add`, ``EngineConfig.ola_impl``).  With
shifts ≥ 1 the track is front-padded by offsets drawn from
``np.random.default_rng(seed)`` and trimmed back; several shift passes
run as batch rows of one program when the memory planner says they fit.
A track longer than one program can hold (``SegmentConfig.window_chunks``)
runs as a chain of W-chunk windows (:func:`demix_windowed_window`) that
carry the LSTM state and the unnormalized overlap-add tail.  The host
loop (``Separator.demix(fused=False)``) runs one segment call per chunk
instead, for per-chunk progress or a caller's segment function.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from umx_tpu_torch.config import EngineConfig, storage_dtype
from umx_tpu_torch.engine.memory import (
    suggest_chunk_batch,
    suggest_max_batch,
    suggest_window_chunks,
)
from umx_tpu_torch.models.umx import (
    LSTMState,
    UMXParams,
    init_lstm_state,
    is_quantized,
    pipelined_hh,
    umx_post,
    umx_pre,
    umx_recurrence_batched,
    umx_recurrence_pipelined_step,
)
from umx_tpu_torch.ops.ola import overlap_add_chunks
from umx_tpu_torch.ops.ola_cuda import overlap_add_normalized
from umx_tpu_torch.ops.stft import crop_stack, istft_planes, masks_to_planes, stft_planes
from umx_tpu_torch.ops.wiener import wiener_filter_masks, wiener_out_dtype
from umx_tpu_torch.utils.profiling import span

# Shift passes batched into one program at most (batch rows of the
# recurrence kernel in the streaming program).
_MAX_SHIFT_BATCH = 16


def resolve_device(device=None) -> torch.device:
    """``torch.device`` for ``device``; None means the GPU.  A CUDA device
    without a usable GPU raises instead of running anywhere else: the CPU
    runs only what asks for it by name."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(dev)!r} requested but torch.cuda.is_available() is False")
    return dev


def to_host(t: torch.Tensor) -> np.ndarray:
    """The stems' copy from the device into pageable host memory, as a
    numpy array (the one place the demix, fleet, streaming and serving
    paths copy their results out)."""
    with span("umx.to_host"):
        return t.cpu().numpy()


def apply_masks(masks, mag, n_bins: int):
    """masks (..., T#, T, 2*n_bins) ⊙ mix magnitude (..., 2, T, n_bins) →
    per-target magnitudes (..., T#, 2, T, n_bins)."""
    return masks_to_planes(masks, n_bins) * mag.unsqueeze(-4)


def segment_pre(params: UMXParams, audio, cfg: EngineConfig):
    """The state-free front of a segment: audio (N, 2, n) → STFT planes
    re, im (N, 2, T, F) and the recurrence input x1 (N, T#, T, H) (STFT,
    magnitude, crop/stack, input norm + fc1 + bn1 + tanh)."""
    mcfg = cfg.model
    re, im = stft_planes(audio, cfg.dsp)  # (N, 2, T, F)
    mag = torch.sqrt(re * re + im * im)
    return re, im, umx_pre(params, crop_stack(mag, mcfg.nb_bins_cropped), mcfg)


def _seam_masks(params: UMXParams, x1, lstm_out, cfg: EngineConfig):
    """The network's masks (N, T#, T, 2F) from x1 and the recurrence
    output, stored in ``cfg.mask_dtype`` resolved for their device (the
    seam before the Wiener passes; float32 is a no-op)."""
    masks = umx_post(params, x1, lstm_out, cfg.model)
    return masks.to(storage_dtype(cfg.mask_dtype, masks.device))


def segment_post(params: UMXParams, re, im, x1, lstm_out, cfg: EngineConfig, n_samples: int):
    """The state-free back of a segment: the masks, the mask seam, then
    :func:`segment_finish` → waveforms (N, T#, 2, n_samples)."""
    return segment_finish(re, im, _seam_masks(params, x1, lstm_out, cfg), cfg, n_samples)


def segment_masks(params: UMXParams, audio, state: LSTMState, cfg: EngineConfig):
    """The first half of :func:`segment_forward_batched`: audio (N, 2, n)
    and state h/c (N, T#, L, D, G) → (STFT planes re, im (N, 2, T, F),
    masks (N, T#, T, 2F) in ``cfg.mask_dtype``, new state).  T# is the
    parameters' own target count, so a slice of the targets gives its
    slice of the masks."""
    re, im, x1 = segment_pre(params, audio, cfg)  # x1 (N, T#, T, H)
    lstm_out, new_state = umx_recurrence_batched(params, x1, state, cfg.model)
    return re, im, _seam_masks(params, x1, lstm_out, cfg), new_state


def segment_forward_batched(
    params: UMXParams, audio, state: LSTMState, cfg: EngineConfig, n_samples: int
):
    """Demix N segments at once: audio (N, 2, n_samples) and state h/c
    (N, T#, L, D, G) → (waveforms (N, T#, 2, n_samples), new state).

    The STFT, the network and the iSTFT run on the whole batch (the
    recurrence kernel takes the N rows per chain); the Wiener passes run
    row by row, because their max|x| scaling is per segment."""
    re, im, masks, new_state = segment_masks(params, audio, state, cfg)
    return segment_finish(re, im, masks, cfg, n_samples), new_state


def segment_finish(re, im, masks, cfg: EngineConfig, n_samples: int):
    """The second half of :func:`segment_forward_batched`: the STFT planes
    and all targets' masks (float32 or bfloat16) → waveforms (N, T#, 2,
    n_samples).  The fused Wiener passes read the masks and write their
    planes in their storage dtypes; the iSTFT upcasts the planes once."""
    mcfg = cfg.model
    if cfg.use_wiener:
        n, n_t, T = masks.shape[:3]
        rows = (wiener_filter_masks(re[i], im[i], masks[i], mcfg.n_bins, cfg.wiener)
                for i in range(n))
        if n == 1:
            tre, tim = (p[None] for p in next(rows))
        else:
            dt = wiener_out_dtype(cfg.wiener, re.device)
            tre = torch.empty((n, n_t, 2, T, mcfg.n_bins), dtype=dt, device=re.device)
            tim = torch.empty_like(tre)
            for i, (yre, yim) in enumerate(rows):
                tre[i], tim[i] = yre, yim
    else:
        # mix-phase reconstruction: mag * unit(x) = mask * x
        m = masks_to_planes(masks.float(), mcfg.n_bins)
        tre = m * re.unsqueeze(1)
        tim = m * im.unsqueeze(1)
    return istft_planes(tre, tim, n_samples, cfg.dsp)


def segment_forward(
    params: UMXParams, audio, state: LSTMState, cfg: EngineConfig, n_samples: int
):
    """Demix one segment: audio (2, n_samples), state (T#, L, D, G) →
    (waveforms (T#, 2, n_samples), new state); one row of
    :func:`segment_forward_batched`."""
    waves, st = segment_forward_batched(
        params, audio[None], LSTMState(h=state.h[None], c=state.c[None]), cfg, n_samples
    )
    return waves[0], LSTMState(h=st.h[0], c=st.c[0])


def transition_weight(segment_samples: int, power: float, device="cpu"):
    """Demucs triangular cross-fade weight; an odd length gets a one-sample
    plateau at the maximum."""
    half = segment_samples // 2
    up = torch.arange(1, half + 1, dtype=torch.float32, device=device)
    if segment_samples % 2:
        w = torch.cat([up, up[-1:], up.flip(0)])
    else:
        w = torch.cat([up, up.flip(0)])
    w = w / w.max()
    return w**power


def _slice_add(ys: torch.Tensor, stride: int, padded_len: int) -> torch.Tensor:
    """One slice-add per chunk (n_chunks, ..., seg) at offsets k*stride,
    in chunk order, into a float32 zero buffer."""
    n_chunks, *mid, seg = ys.shape
    out = torch.zeros((*mid, padded_len), dtype=torch.float32, device=ys.device)
    for k in range(n_chunks):
        out[..., k * stride : k * stride + seg] += ys[k]
    return out


def _overlap_add_chunks(ys: torch.Tensor, stride: int, padded_len: int) -> torch.Tensor:
    """Overlap-add chunks (n_chunks, ..., seg) at offsets k*stride.  For
    overlap ≤ 50 % each chunk splits at the stride and the heads and
    tails combine in one chunk-major → time-major pass
    (:func:`umx_tpu_torch.ops.ola.overlap_add_chunks`); otherwise the
    slice-adds."""
    if ys.shape[-1] - stride > stride:
        return _slice_add(ys, stride, padded_len)
    return overlap_add_chunks(ys, stride)


def _normalized_overlap_add(ys: torch.Tensor, weight: torch.Tensor, stride: int,
                            padded_len: int, cfg: EngineConfig) -> torch.Tensor:
    """Weighted-chunk overlap-add + weight-sum normalization: ys
    (n_chunks, *mid, seg) → (*mid, padded_len).

    ``ola_impl``: "auto"/"unroll" = one slice-add per chunk, then / sw
    (each sample sums its ≤ 2 addends in chunk order); "xla" = the pad+sum
    form, / sw; "pallas" = the overlap-add kernel (K7), × 1/sw.  On CUDA
    "pallas" runs the kernel at every stride and raises above 50 %
    overlap; on the CPU its plain version falls back to "unroll" where
    the JAX package's does."""
    n_chunks, seg = ys.shape[0], ys.shape[-1]
    sw = _overlap_add_chunks(weight.expand(n_chunks, seg), stride, padded_len)
    choice = "unroll" if cfg.ola_impl == "auto" else cfg.ola_impl
    if choice == "pallas":
        out = overlap_add_normalized(ys.float(), 1.0 / sw, stride, padded_len)
        if out is not None:
            return out
        choice = "unroll"
    if choice == "unroll":
        return _slice_add(ys, stride, padded_len) / sw
    return _overlap_add_chunks(ys.float(), stride, padded_len) / sw


def demix_fused(params: UMXParams, audio_p, state: LSTMState, cfg: EngineConfig,
                n_chunks: int, seg: int, stride: int):
    """Streaming whole-track demix of B stacked tracks: audio_p (B, 2, P)
    with P = (n_chunks-1)*stride + seg, state h/c (B, T#, L, D, G) →
    (stems (B, T#, 2, P), final state).  The chunk loop carries each
    track's state in its batch row."""
    ys, weight, state = _chunk_outputs(params, audio_p, state, cfg, n_chunks, seg, stride, 1)
    return _normalized_overlap_add(ys, weight, stride, audio_p.shape[-1], cfg), state


def demix_fused_parallel(params: UMXParams, audio_p, cfg: EngineConfig, n_chunks: int,
                         seg: int, stride: int, chunk_batch: int):
    """Non-streaming whole-track demix with the chunks run in groups:
    audio_p (..., 2, P) → stems (..., T#, 2, P).

    Without the state carry every segment is independent, so each group
    of ``chunk_batch`` chunks (× the leading batch of tracks) runs as the
    rows of one batched segment forward at zero state; the remainder
    group runs at its natural width."""
    lead, P = audio_p.shape[:-2], audio_p.shape[-1]
    ys, weight, _ = _chunk_outputs(params, audio_p.reshape(-1, 2, P), None, cfg, n_chunks, seg,
                                   stride, chunk_batch)
    ys = ys.view(n_chunks, *lead, cfg.model.n_targets, 2, seg)
    return _normalized_overlap_add(ys, weight, stride, P, cfg)


def _chunk_stack(cfg: EngineConfig, n_chunks: int, B: int, seg: int, device):
    """The transition weight and an empty stack (n_chunks, B, T#, 2, seg)
    in ``cfg.stems_stack_dtype`` resolved for ``device`` for the weighted
    chunk outputs (each weighted in float32, then stored)."""
    weight = transition_weight(seg, cfg.segment.transition_power, device)
    ys = torch.empty((n_chunks, B, cfg.model.n_targets, 2, seg),
                     dtype=storage_dtype(cfg.stems_stack_dtype, device), device=device)
    return weight, ys


def demix_fused_stream_groups(params: UMXParams, audio_p, state: LSTMState, cfg: EngineConfig,
                              n_chunks: int, seg: int, stride: int, chunk_batch: int):
    """Streaming whole-track demix of B stacked tracks with only the
    recurrence on the state chain (``stream_impl="groups"``): audio_p
    (B, 2, P), state h/c (B, T#, L, D, G) → (stems (B, T#, 2, P), final
    state), as :func:`demix_fused`.

    The chunks run in groups of ``chunk_batch`` (the remainder group at
    its natural width): :func:`segment_pre` and :func:`segment_post` over
    the group's width × B rows at once, the recurrence chunk by chunk in
    order, so the state flows chunk k → k+1 as in the scan."""
    B = audio_p.shape[0]
    weight, ys = _chunk_stack(cfg, n_chunks, B, seg, audio_p.device)
    for k0 in range(0, n_chunks, chunk_batch):
        width = min(chunk_batch, n_chunks - k0)
        rows = torch.stack([audio_p[:, :, k * stride : k * stride + seg]
                            for k in range(k0, k0 + width)])  # (width, B, 2, seg)
        re, im, x1 = segment_pre(params, rows.view(width * B, 2, seg), cfg)
        x1_k = x1.view(width, B, *x1.shape[1:])
        outs = []
        for k in range(width):
            lstm_out, state = umx_recurrence_batched(params, x1_k[k], state, cfg.model)
            outs.append(lstm_out)
        waves = segment_post(params, re, im, x1, torch.cat(outs), cfg, seg)
        torch.mul(weight, waves.view(width, B, *waves.shape[1:]), out=ys[k0 : k0 + width])
    return _normalized_overlap_add(ys, weight, stride, audio_p.shape[-1], cfg), state


def demix_fused_stream_pipelined(params: UMXParams, audio_p, state: LSTMState, cfg: EngineConfig,
                                 n_chunks: int, seg: int, stride: int):
    """Streaming whole-track demix of B stacked tracks with the recurrence
    layer-pipelined across chunks (``stream_impl="pipelined"``): audio_p
    (B, 2, P), state h/c (B, T#, L, D, G) → (stems (B, T#, 2, P), final
    state), as :func:`demix_fused`.

    Iteration i runs layer 1 of chunk i, layer 2 of chunk i-1 and layer 3
    of chunk i-2 as one merged-kernel call
    (:func:`~umx_tpu_torch.models.umx.umx_recurrence_pipelined_step`); the
    L-1 iterations of fill and drain stack only their active stages
    (R = 8, 16, 24 chains at UMX-L).  Layer l's incoming state goes to
    chunk 0's stage l and flows iteration to iteration.  Dense weights."""
    L = cfg.model.n_lstm_layers
    B = audio_p.shape[0]
    weight, ys = _chunk_stack(cfg, n_chunks, B, seg, audio_p.device)
    whh = pipelined_hh(params)
    pre = {}  # chunk k -> (re, im, x1), alive until its post half runs
    stage_in = {}  # (layer l, chunk k) -> the layer's input, alive one iteration
    stage_st = {l: (state.h[:, :, l], state.c[:, :, l]) for l in range(L)}
    for i in range(n_chunks + L - 1):
        if i < n_chunks:
            pre[i] = segment_pre(params, audio_p[:, :, i * stride : i * stride + seg], cfg)
            stage_in[0, i] = pre[i][2]
        layers = [l for l in range(L) if 0 <= i - l < n_chunks]
        outs, new_states = umx_recurrence_pipelined_step(
            params, [stage_in.pop((l, i - l)) for l in layers], [stage_st[l] for l in layers],
            layers, cfg.model, whh)
        for l, out, st in zip(layers, outs, new_states):
            stage_st[l] = st
            if l + 1 < L:
                stage_in[l + 1, i - l] = out
            else:
                re, im, x1 = pre.pop(i - l)
                torch.mul(weight, segment_post(params, re, im, x1, out, cfg, seg), out=ys[i - l])
    final = LSTMState(h=torch.stack([stage_st[l][0] for l in range(L)], dim=2),
                      c=torch.stack([stage_st[l][1] for l in range(L)], dim=2))
    return _normalized_overlap_add(ys, weight, stride, audio_p.shape[-1], cfg), final


def _chunk_outputs(params: UMXParams, a, state: LSTMState | None, cfg: EngineConfig,
                   n_chunks: int, seg: int, stride: int, chunk_batch: int):
    """The weighted chunk outputs of B stacked tracks a (B, 2, P): ys
    (n_chunks, B, T#, 2, seg), the transition weight and the final state.
    Streaming (``state`` given): the chunk loop, each track's state carried
    in its batch row.  Non-streaming (``state`` None): groups of
    ``chunk_batch`` chunks × B rows through one batched segment forward at
    zero state, the remainder group at its natural width."""
    B = a.shape[0]
    weight, ys = _chunk_stack(cfg, n_chunks, B, seg, a.device)
    n_t = cfg.model.n_targets
    if state is not None:
        for i in range(n_chunks):
            off = i * stride
            chunk_out, state = segment_forward_batched(
                params, a[:, :, off : off + seg], state, cfg, seg
            )
            torch.mul(weight, chunk_out, out=ys[i])
        return ys, weight, state
    for k0 in range(0, n_chunks, chunk_batch):
        width = min(chunk_batch, n_chunks - k0)
        rows = torch.stack([a[:, :, k * stride : k * stride + seg] for k in range(k0, k0 + width)])
        zero = init_lstm_state(cfg.model, a.device, batch=width * B)
        outs, _ = segment_forward_batched(params, rows.reshape(width * B, 2, seg), zero, cfg, seg)
        torch.mul(weight, outs.view(width, B, n_t, 2, seg), out=ys[k0 : k0 + width])
    return ys, weight, None


def demix_windowed_window(params: UMXParams, audio_w, state: LSTMState, tail, tail_w,
                          cfg: EngineConfig, W: int, seg: int, stride: int, chunk_batch: int = 1):
    """One W-chunk window of a windowed track: audio_w (2, (W-1)*stride +
    seg), state (1, T#, L, D, G), ``tail`` (T#, 2, seg - stride) and
    ``tail_w`` (seg - stride,) → (normalized stems of the window's first
    W*stride samples, next tail, next tail_w, next state).

    Two carries chain windows into the single program's result: the
    streaming LSTM state, and the overlap-add boundary.  The window's last
    chunk reaches seg - stride samples past its output region; their
    unnormalized stem sums and weight sums go to the next window, which
    adds them at its start before it normalizes.  At overlap ≤ 50 % every
    output sample sums the same (at most two) addends as in the single
    program, so the stems are bit-equal to it.  Non-streaming configs run
    the window's chunks in groups of ``chunk_batch`` and pass the state
    through."""
    padded_w = (W - 1) * stride + seg
    streaming = cfg.segment.streaming
    ys, weight, new_state = _chunk_outputs(
        params, audio_w[None], state if streaming else None, cfg, W, seg, stride,
        max(1, min(chunk_batch, W)),
    )
    acc = _slice_add(ys[:, 0], stride, padded_w)
    wsum = _overlap_add_chunks(weight.expand(W, seg), stride, padded_w)
    tail_len = padded_w - W * stride  # == seg - stride
    if tail_len:
        acc[..., :tail_len] += tail
        wsum[:tail_len] += tail_w
    out = acc[..., : W * stride] / wsum[: W * stride]
    # copies, so that the carried tail does not keep the window's whole
    # accumulator alive through the next window
    return (out, acc[..., W * stride :].clone(), wsum[W * stride :].clone(),
            new_state if streaming else state)


class Separator:
    """Demixer holding one model's parameters on one device: the GPU
    unless ``device`` names another (``"cpu"`` for the plain versions)."""

    def __init__(self, params: UMXParams, cfg: EngineConfig = EngineConfig(), device=None):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # full-f32 matmuls, as the reference computes them
            torch.backends.cuda.matmul.allow_tf32 = False
        self.params = params
        self.cfg = cfg
        self._window_plans: dict[int, int] = {}

    def _window_plan(self, resident_bytes: int) -> int:
        """The planner's window width, memoised: ``resident_bytes`` is
        rounded up to 256 MB buckets, so tracks of similar length share an
        entry without loosening the budget."""
        key = -(-resident_bytes // 2**28) * 2**28
        if key not in self._window_plans:
            self._window_plans[key] = suggest_window_chunks(
                self.cfg, params=self.params, resident_bytes=key, device=self.device
            )
        return self._window_plans[key]

    @classmethod
    def from_ggml(cls, path: str, cfg: EngineConfig | None = None, device=None,
                  quantized_hbm: bool = False) -> "Separator":
        """Load ggml weights onto ``device`` (default: the GPU); the model's hidden size
        overrides ``cfg``'s.  With ``quantized_hbm`` the u8/u16 matmul
        weights stay quantized on the device and are dequantized inside
        the matmuls (``ops/qmatmul.py``)."""
        from umx_tpu_torch.io.ggml import read_ggml
        from umx_tpu_torch.models.umx import params_from_ggml, quantized_params_from_ggml

        device = resolve_device(device)
        model = read_ggml(path, keep_quantized=quantized_hbm)
        if cfg is None:
            cfg = EngineConfig()
        if cfg.model.hidden_size != model.hidden_size:
            cfg = dataclasses.replace(
                cfg, model=dataclasses.replace(cfg.model, hidden_size=model.hidden_size)
            )
        build = quantized_params_from_ggml if quantized_hbm else params_from_ggml
        return cls(build(model, cfg.model, device), cfg, device)

    def _on_device(self, audio) -> bool:
        """Whether ``audio`` is a tensor that already lies on this
        separator's device ("cuda" means any index)."""
        if not isinstance(audio, torch.Tensor) or audio.device.type != self.device.type:
            return False
        return self.device.index is None or audio.device.index == self.device.index

    def _geometry(self, length: int):
        sr = self.cfg.dsp.sample_rate
        seg = self.cfg.segment.segment_samples(sr)
        stride = self.cfg.segment.stride_samples(sr)
        n_chunks = max(1, math.ceil(length / stride))
        return seg, stride, n_chunks, (n_chunks - 1) * stride + seg

    @torch.inference_mode()
    def demix(self, audio, progress=None, fused: bool | None = None,
              segment_fn=None) -> torch.Tensor:
        """Overlapping-segment demix of a track: audio (2, length) →
        (T#, 2, length) float32, in one of two modes.

        Fused (the default): non-streaming configs run the chunk groups at
        ``chunk_batch`` rows (0 = the memory planner's width), streaming
        configs the schedule ``stream_impl`` names (the chunk loop; with
        two chunks or more the groups of ``chunk_batch`` chunks, or the
        layer pipeline for dense weights), and one normalized overlap-add
        finishes the track.  Unless a stream arm runs, a track
        of more chunks than ``window_chunks`` allows (0 = what the planner
        says fits) runs windowed, decided before the track is placed on the
        device: a host array then streams window slices in
        and stems out and a CPU tensor returns, so device memory stays
        bounded for any length; a tensor already on the device gives a
        tensor on the device.

        Host loop (``fused=False``, and the default when ``progress`` or
        ``segment_fn`` is given): one ``segment_fn(params, chunk, state,
        cfg, seg)`` call per chunk (default :func:`segment_forward`; a
        serving batcher can take its place), each chunk's weighted output
        added into the track's buffers at its offset, the state carried
        only when the config streams.  ``progress(f)`` is called with
        ``(i + 1) / n_chunks`` after each chunk of the host loop, with
        ``(j + 1) / n_windows`` after each window, and with 1.0 after a
        fused run."""
        cfg = self.cfg
        if fused is None:
            fused = progress is None and segment_fn is None
        if segment_fn is None:
            segment_fn = segment_forward
        on_device = self._on_device(audio)
        length = audio.shape[1]
        seg, stride, n_chunks, padded_len = self._geometry(length)
        # the streaming arm that runs: the two schedules need two chunks
        # or more, and the pipelined one dense weights; they never window,
        # while the scan that runs in their place does
        arm = cfg.stream_impl if fused and cfg.segment.streaming and n_chunks > 1 else "scan"
        if arm == "pipelined" and is_quantized(self.params):
            arm = "scan"
        cb = cfg.segment.chunk_batch
        if fused and (not cfg.segment.streaming or arm == "groups") and cb <= 0:
            cb = suggest_chunk_batch(cfg, length / cfg.dsp.sample_rate, params=self.params,
                                     device=self.device)
        Wc = cfg.segment.window_chunks if fused and arm == "scan" else -1
        if Wc == 0:
            # a caller's device tensor and the result buffer stay resident
            # across windows; a host array's windows come and go
            resident = (2 + cfg.model.n_targets * 2) * padded_len * 4 if on_device else 0
            Wc = self._window_plan(resident)
            if n_chunks <= Wc:
                Wc = -1
            else:
                # even split: the same number of windows at the smallest W,
                # so the last window pads the fewest silent chunks
                Wc = -(-n_chunks // -(-n_chunks // Wc))
        if Wc > 0 and n_chunks > Wc:
            out = self._demix_windowed(audio, n_chunks, seg, stride, Wc, max(1, cb), progress)
            return out[..., :length]

        with span("umx.prepare"):
            audio = torch.as_tensor(np.asarray(audio, np.float32) if not on_device else audio)
            audio = audio.float().to(self.device)
            audio_p = torch.nn.functional.pad(audio, (0, padded_len - length))
        if not fused:
            out = self._demix_host_loop(audio_p, n_chunks, seg, stride, segment_fn, progress)
        else:
            with span("umx.program"):
                out = self._demix_fused(audio_p, arm, n_chunks, seg, stride, cb)
        if fused and progress is not None:
            progress(1.0)
        return out[..., :length]

    def _demix_fused(self, audio_p, arm: str, n_chunks: int, seg: int, stride: int, cb: int):
        """The fused program over audio_p (2, padded_len) on the device:
        the chunk groups at ``cb`` rows, or the streaming schedule
        ``arm``; (T#, 2, padded_len) normalized stems."""
        cfg = self.cfg
        if not cfg.segment.streaming:
            return demix_fused_parallel(self.params, audio_p, cfg, n_chunks, seg, stride,
                                        min(cb, n_chunks))
        state = init_lstm_state(cfg.model, self.device, batch=1)
        if arm == "groups":
            out, _ = demix_fused_stream_groups(self.params, audio_p[None], state, cfg, n_chunks,
                                               seg, stride, min(cb, n_chunks))
        elif arm == "pipelined":
            out, _ = demix_fused_stream_pipelined(self.params, audio_p[None], state, cfg,
                                                  n_chunks, seg, stride)
        else:
            out, _ = demix_fused(self.params, audio_p[None], state, cfg, n_chunks, seg, stride)
        return out[0]

    def _demix_host_loop(self, audio_p, n_chunks: int, seg: int, stride: int, segment_fn,
                         progress):
        """One ``segment_fn`` call per chunk of audio_p (2, padded_len) on
        the device; the weighted outputs and the weights are summed into
        (T#, 2, padded_len) and (padded_len,) buffers at each chunk's
        offset, then divided."""
        cfg = self.cfg
        padded_len = audio_p.shape[-1]
        weight = transition_weight(seg, cfg.segment.transition_power, self.device)
        out = torch.zeros((cfg.model.n_targets, 2, padded_len), device=self.device)
        sum_weight = torch.zeros((padded_len,), device=self.device)
        state = init_lstm_state(cfg.model, self.device)
        for i in range(n_chunks):
            off = i * stride
            chunk_out, new_state = segment_fn(self.params, audio_p[:, off : off + seg], state,
                                              cfg, seg)
            if cfg.segment.streaming:
                state = new_state
            out[..., off : off + seg] += weight * chunk_out
            sum_weight[off : off + seg] += weight
            if progress is not None:
                progress((i + 1) / n_chunks)
        return out / sum_weight

    @torch.inference_mode()
    def _demix_windowed(self, audio, n_chunks: int, seg: int, stride: int, W: int,
                        chunk_batch: int, progress=None):
        """ceil(n_chunks / W) windows of W chunks chained by the LSTM state
        and the unnormalized overlap-add tail (:func:`demix_windowed_window`);
        the last window is padded with silent chunks.  audio (2, length):
        a host array (or CPU tensor) has each window's slice copied in and
        its stems copied out as it finishes, and a CPU tensor returns; a
        tensor on the device has its windows written in place into one
        resident result buffer, which returns.  Either covers the whole
        padded length (n_windows*W - 1)*stride + seg.  ``progress(f)`` is
        called with ``(j + 1) / n_windows`` after each window."""
        cfg = self.cfg
        n_t = cfg.model.n_targets
        n_windows = -(-n_chunks // W)
        full_len = (n_windows * W - 1) * stride + seg
        on_device = self._on_device(audio)
        if not on_device:
            audio = torch.as_tensor(np.asarray(audio, np.float32))
        audio_p = torch.nn.functional.pad(audio.float(), (0, full_len - audio.shape[-1]))
        tail_len = seg - stride
        padded_w = (W - 1) * stride + seg
        state = init_lstm_state(cfg.model, self.device, batch=1)
        tail = torch.zeros((n_t, 2, tail_len), device=self.device)
        tail_w = torch.zeros((tail_len,), device=self.device)
        res = torch.empty((n_t, 2, full_len), device=self.device if on_device else "cpu")
        for j in range(n_windows):
            s0 = j * W * stride
            a = audio_p[:, s0 : s0 + padded_w].to(self.device)
            out_j, tail, tail_w, state = demix_windowed_window(
                self.params, a, state, tail, tail_w, cfg, W, seg, stride, chunk_batch
            )
            res[..., s0 : s0 + W * stride] = out_j
            if progress is not None:
                progress((j + 1) / n_windows)
        # the last window's tail is the end of the padded track
        res[..., full_len - tail_len :] = tail / tail_w
        return res

    def demix_track(self, audio, seed: int = 0, progress=None, fused: bool | None = None,
                    segment_fn=None) -> np.ndarray:
        """Full-track demix with the Demucs random-shift trick: each of
        ``cfg.shifts`` passes front-pads the track by an offset in
        [0, max_shift) and trims the output back; the passes are
        averaged.  Several passes run as batch rows of one program when
        the memory planner fits at least two, unless the host loop is
        asked for (``fused=False``, a ``progress`` callback or a
        ``segment_fn``; all three go on to :meth:`demix`).  Returns
        (T#, 2, length) float32 numpy."""
        cfg = self.cfg
        audio = np.asarray(audio, np.float32)
        length = audio.shape[1]
        if cfg.shifts <= 0:
            return to_host(self.demix(audio, progress, fused, segment_fn))

        max_shift = cfg.segment.max_shift_samples(cfg.dsp.sample_rate)
        rng = np.random.default_rng(seed)
        offsets = [int(rng.integers(0, max_shift)) for _ in range(cfg.shifts)]
        if cfg.shifts > 1 and fused is not False and segment_fn is None and progress is None:
            fit = suggest_max_batch(cfg, (length + max_shift) / cfg.dsp.sample_rate,
                                    params=self.params, device=self.device)
            if fit >= 2:
                return self._demix_shifts_batched(audio, offsets, max_shift,
                                                  min(fit, _MAX_SHIFT_BATCH))
        acc = None
        for offset in offsets:
            with span("umx.prepare"):
                shifted = np.pad(audio, ((0, 0), (offset, max_shift - offset)))
            out = self.demix(shifted, progress, fused, segment_fn)[..., offset : offset + length]
            acc = out if acc is None else acc + out
        return to_host(acc / cfg.shifts)

    @torch.inference_mode()
    def _demix_shifts_batched(self, audio: np.ndarray, offsets: list[int], max_shift: int,
                              max_batch: int) -> np.ndarray:
        """All shift passes as batch rows of the whole-track program, in
        groups of at most ``max_batch`` tracks."""
        from umx_tpu_torch.engine.fleet import _batched_demix

        cfg = self.cfg
        length = audio.shape[1]
        seg, stride, n_chunks, padded_len = self._geometry(length + max_shift)
        track = torch.from_numpy(audio).to(self.device)
        acc = None
        for g in range(0, len(offsets), max_batch):
            group = offsets[g : g + max_batch]
            batch = torch.zeros((len(group), 2, padded_len), device=self.device)
            for b, off in enumerate(group):
                batch[b, :, off : off + length] = track
            states = init_lstm_state(cfg.model, self.device, batch=len(group))
            fn = _batched_demix(cfg, n_chunks, seg, stride, batch=len(group), device=self.device)
            out_b, _ = fn(self.params, batch, states)
            for b, off in enumerate(group):
                contrib = out_b[b, ..., off : off + length]
                acc = contrib.clone() if acc is None else acc + contrib
        return to_host(acc / len(offsets))
