"""Plain PyTorch reference of Open-Unmix demixing and of its training step.

Written from the published description (open-unmix-pytorch's OpenUnmix
module, its ``filtering.wiener`` EM, the Demucs shift trick and the
transition-weighted overlap-add of umx.cpp's streaming demixer), for the
benchmark's comparison that decides ``correct``.  It imports torch and
numpy only: nothing of the system under test, and it takes none of that
system's derived tensors.  It reads the weights in the layout of the
published per-target state dicts and the raw audio, and works out every
spectrum, mask and estimate itself.

Precision.  The configuration states float32 weights and float32 matrix
products (TF32 off), with four narrower places, which this reference
applies where the configuration puts them: the recurrent product of the
LSTM takes h and W_hh rounded to bfloat16 (float32 sums), and the masks,
the Wiener estimates and the weighted chunk outputs are stored in
bfloat16.  The spectra and the Wiener EM run in float64.  ``products=
"tf32"`` rounds the operands of every float32 product to TF32 (10
mantissa bits, to nearest) before a float32 product: the control, the
precision one step below the stated one.

Departures from upstream, all of them the configuration's: the batch
norms run with their running statistics in training as in inference, and
are not trained (as the system's trainer states); the input and output
scales and means are one vector per channel in training (the stereo
halves are separate parameters, as the system trains them); the LSTM
state carries across segments in both directions (umx.cpp's streaming
LSTM).
"""

from __future__ import annotations

import math

import numpy as np
import torch

TARGETS = ("bass", "drums", "other", "vocals")


# ---------------------------------------------------------------------------
# Rounding
# ---------------------------------------------------------------------------


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32 (10 explicit mantissa bits), to
    nearest with ties away from zero, as the tensor cores' conversion
    rounds; infinities and NaNs pass."""
    bits = x.contiguous().view(torch.int32)
    rounded = (bits + 0x1000) & ~0x1FFF
    finite = torch.isfinite(x)
    return torch.where(finite, rounded.view(torch.float32), x)


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to bfloat16 and back."""
    return x.to(torch.bfloat16).to(x.dtype)


class _RoundBF16(torch.autograd.Function):
    """bfloat16 rounding of a product's operand whose gradient passes as
    it is (the recurrence's operands in training)."""

    @staticmethod
    def forward(ctx, x):
        return round_bf16(x)

    @staticmethod
    def backward(ctx, g):
        return g


def operand_bf16(x: torch.Tensor) -> torch.Tensor:
    return _RoundBF16.apply(x) if x.requires_grad else round_bf16(x)


class _RoundTF32(torch.autograd.Function):
    """TF32 rounding of a product's operand whose gradient passes as it is
    (the control's products in training)."""

    @staticmethod
    def forward(ctx, x):
        return round_tf32(x)

    @staticmethod
    def backward(ctx, g):
        return g


def operand_tf32(x: torch.Tensor) -> torch.Tensor:
    return _RoundTF32.apply(x) if x.requires_grad else round_tf32(x)


def matmul(a: torch.Tensor, b: torch.Tensor, products: str = "float32") -> torch.Tensor:
    """a @ b in float32 with TF32 off; ``products="tf32"`` rounds both
    operands to TF32 first (the control)."""
    if products == "tf32":
        a, b = operand_tf32(a), operand_tf32(b)
    elif products != "float32":
        raise ValueError(f"products must be float32 or tf32, got {products!r}")
    return torch.matmul(a, b)


# ---------------------------------------------------------------------------
# Weights: the published per-target state dicts, stacked over targets
# ---------------------------------------------------------------------------


def stacked(state_dicts: dict, key: str) -> torch.Tensor:
    """One state-dict entry of every target, stacked on a leading axis."""
    return torch.stack([state_dicts[t][key] for t in TARGETS])


class Weights:
    """The four targets' weights in product form (``x @ w``), stacked over
    targets: a view of the state dicts the reference reads."""

    def __init__(self, sd: dict, n_layers: int, duplicated_norms: bool = False):
        def stereo(key):
            v = stacked(sd, key)
            return v if duplicated_norms else torch.cat([v, v], dim=-1)

        self.input_mean = stereo("input_mean")
        self.input_scale = stereo("input_scale")
        self.output_scale = stereo("output_scale")
        self.output_mean = stereo("output_mean")
        self.fc1 = stacked(sd, "fc1.weight").transpose(1, 2)  # (T#, F, H)
        self.fc2 = stacked(sd, "fc2.weight").transpose(1, 2)  # (T#, 2H, H)
        self.fc3 = stacked(sd, "fc3.weight").transpose(1, 2)  # (T#, H, O)
        self.bn = {
            k: tuple(stacked(sd, f"{k}.{p}") for p in ("weight", "bias", "running_mean",
                                                       "running_var"))
            for k in ("bn1", "bn2", "bn3")
        }
        self.ih, self.hh, self.bias = [], [], []
        for layer in range(n_layers):
            ih, hh, b = [], [], []
            for rev in ("", "_reverse"):
                ih.append(stacked(sd, f"lstm.weight_ih_l{layer}{rev}").transpose(1, 2))
                hh.append(stacked(sd, f"lstm.weight_hh_l{layer}{rev}").transpose(1, 2))
                b.append(stacked(sd, f"lstm.bias_ih_l{layer}{rev}")
                         + stacked(sd, f"lstm.bias_hh_l{layer}{rev}"))
            self.ih.append(torch.stack(ih, dim=1))  # (T#, D, in, 4G)
            self.hh.append(torch.stack(hh, dim=1))  # (T#, D, G, 4G)
            self.bias.append(torch.stack(b, dim=1))  # (T#, D, 4G)


def _batchnorm(x, params, eps: float):
    w, b, rm, rv = params
    return (x - rm[:, None]) / torch.sqrt(rv[:, None] + eps) * w[:, None] + b[:, None]


# ---------------------------------------------------------------------------
# The mask network
# ---------------------------------------------------------------------------


def lstm_layer(xp: torch.Tensor, whh: torch.Tensor, h: torch.Tensor, c: torch.Tensor):
    """One layer's recurrence over time, forward and backward chains
    together: xp (N, T#, D, T, 4G) input projections with both biases
    (the backward chains' already in reversed time), whh (T#, D, G, 4G),
    h, c (N, T#, D, G).  The recurrent product takes h and W_hh rounded
    to bfloat16 with float32 sums; gates in the order i, f, g, o.
    Returns hs (N, T#, D, T, G) and the last h, c."""
    N, n_t, D, G = h.shape
    w = operand_bf16(whh).reshape(n_t * D, G, 4 * G)
    hs = []
    for t in range(xp.shape[3]):
        # chains on the batch axis of one product, the rows of a chain its rows
        hh = torch.bmm(operand_bf16(h).permute(1, 2, 0, 3).reshape(n_t * D, N, G), w)
        pre = xp[:, :, :, t] + hh.reshape(n_t, D, N, 4 * G).permute(2, 0, 1, 3)
        s = torch.sigmoid(pre)
        g = torch.tanh(pre[..., 2 * G : 3 * G])
        i, f, o = s[..., :G], s[..., G : 2 * G], s[..., 3 * G :]
        c = f * c + i * g
        h = o * torch.tanh(c)
        hs.append(h)
    return torch.stack(hs, dim=3), h, c


def masks(w: Weights, x: torch.Tensor, state, eps: float, products: str = "float32"):
    """The four targets' masks of N segments: x (N, T, 2·bins) cropped
    stereo magnitudes (float32), ``state`` (h, c) each (N, T#, L, D, G) →
    (masks (N, T#, T, 2·outputs) float32, new state)."""
    x = x.unsqueeze(1)  # (N, 1, T, F)
    x = (x + w.input_mean[:, None]) * w.input_scale[:, None]
    x1 = torch.tanh(_batchnorm(matmul(x, w.fc1, products), w.bn["bn1"], eps))  # (N, T#, T, H)
    h0, c0 = state
    inp, hT, cT = x1, [], []
    for layer in range(len(w.ih)):
        seq = torch.stack([inp, inp.flip(2)], dim=2)  # (N, T#, D, T, in)
        xp = matmul(seq, w.ih[layer], products) + w.bias[layer][:, :, None]
        hs, h, c = lstm_layer(xp, w.hh[layer], h0[:, :, layer], c0[:, :, layer])
        inp = torch.cat([hs[:, :, 0], hs[:, :, 1].flip(2)], dim=-1)  # (N, T#, T, 2G)
        hT.append(h)
        cT.append(c)
    y = matmul(torch.cat([x1, inp], dim=-1), w.fc2, products)
    y = torch.relu(_batchnorm(y, w.bn["bn2"], eps))
    y = _batchnorm(matmul(y, w.fc3, products), w.bn["bn3"], eps)
    m = torch.relu(y * w.output_scale[:, None] + w.output_mean[:, None])
    return m, (torch.stack(hT, dim=2), torch.stack(cT, dim=2))


# ---------------------------------------------------------------------------
# Spectra
# ---------------------------------------------------------------------------


def hann(n_fft: int, device, dtype=torch.float64) -> torch.Tensor:
    n = torch.arange(n_fft, dtype=torch.float64, device=device)
    return (0.5 - 0.5 * torch.cos(2 * math.pi * n / n_fft)).to(dtype)


def stft(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """Centered, reflect-padded, one-sided, unscaled STFT of x (..., n)
    in float64 → complex (..., T, bins)."""
    lead = x.shape[:-1]
    spec = torch.stft(x.reshape(-1, x.shape[-1]).double(), n_fft, hop, window=hann(n_fft, x.device),
                      center=True, pad_mode="reflect", normalized=False, onesided=True,
                      return_complex=True)
    return spec.transpose(-1, -2).reshape(*lead, spec.shape[-1], spec.shape[-2])


def istft(spec: torch.Tensor, n_fft: int, hop: int, n: int) -> torch.Tensor:
    """Inverse of :func:`stft` (the one-sided inverse ignores the
    imaginary parts of the DC and Nyquist bins), window-sum-square
    normalized: spec (..., T, bins) → (..., n) float64."""
    lead, (T, F) = spec.shape[:-2], spec.shape[-2:]
    spec = spec.reshape(-1, T, F).transpose(-1, -2).clone()
    spec[:, 0].imag = 0.0
    spec[:, -1].imag = 0.0
    out = torch.istft(spec, n_fft, hop, window=hann(n_fft, spec.device), center=True,
                      normalized=False, onesided=True, length=n)
    return out.reshape(*lead, n)


def crop_stack(mag: torch.Tensor, bins: int) -> torch.Tensor:
    """(..., 2, T, F) magnitudes → (..., T, 2·bins): left bins, then right."""
    return torch.cat([mag[..., 0, :, :bins], mag[..., 1, :, :bins]], dim=-1)


# ---------------------------------------------------------------------------
# Wiener EM
# ---------------------------------------------------------------------------


def wiener(mix: torch.Tensor, m: torch.Tensor, iterations: int, eps: float,
           scale_factor: float) -> torch.Tensor:
    """Multichannel Wiener EM of one segment (openunmix's
    ``filtering.wiener`` with softmask off): mix (2, T, F) complex128,
    masks m (S, 2, T, F) float64 → estimates (S, 2, T, F) complex128.
    The first estimates are mask × mix; the mix is scaled down by
    max(1, max|mix| / scale_factor) for the EM and the estimates scaled
    back."""
    max_abs = max(1.0, float(mix.abs().max()) / scale_factor)
    x = mix / max_abs
    y = m * x[None]
    for _ in range(iterations):
        v = (y.abs() ** 2).mean(dim=1)  # (S, T, F)
        R = torch.einsum("sctf,sdtf->sfcd", y, y.conj())
        R = R / (eps + v.sum(dim=1))[:, :, None, None]  # (S, F, 2, 2)
        Cxx = torch.einsum("stf,sfcd->tfcd", v.to(R.dtype), R)
        Cxx = Cxx + math.sqrt(eps) * torch.eye(2, dtype=R.dtype, device=R.device)
        a, b, c, d = Cxx[..., 0, 0], Cxx[..., 0, 1], Cxx[..., 1, 0], Cxx[..., 1, 1]
        det = a * d - b * c
        inv = torch.stack([torch.stack([d, -b], -1), torch.stack([-c, a], -1)], -2)
        inv = inv / det[..., None, None]  # (T, F, 2, 2)
        z = torch.einsum("tfkd,dtf->ktf", inv, x)  # Cxx^-1 x
        y = torch.einsum("sfck,ktf->sctf", R, z) * v[:, None]
    return y * max_abs


# ---------------------------------------------------------------------------
# Demixing a track
# ---------------------------------------------------------------------------


def transition_weight(seg: int, power: float, device) -> torch.Tensor:
    """Demucs's triangular cross-fade over ``seg`` samples, peak 1 (an odd
    length repeats the peak once), float64."""
    half = seg // 2
    up = torch.arange(1, half + 1, dtype=torch.float64, device=device)
    w = torch.cat([up, up[-1:], up.flip(0)]) if seg % 2 else torch.cat([up, up.flip(0)])
    return (w / w.max()) ** power


def shift_offset(seed: int, max_shift: int) -> int:
    """The track's shift: an offset in [0, max_shift) drawn from
    ``np.random.default_rng(seed)``, the first draw."""
    return int(np.random.default_rng(seed).integers(0, max_shift))


def demix(sd: dict, tracks: list, seeds: list, cfg: dict, device,
          products: str = "float32") -> list[np.ndarray]:
    """Reference stems of ``tracks`` ((2, n_i) float32 arrays), each with
    its shift seed: (T#, 2, n_i) float32 arrays.  The tracks run together
    as rows of each chunk step (a row stops counting past its own chunks;
    its state never mixes with another's).

    Per track: pad front by the shift offset and back to max_shift, cut
    into segments of ``segment_secs`` at the stride (1 - overlap), the last
    zero-padded; per segment the STFT, the masks with the LSTM state
    carried from the previous segment (stored bfloat16), Wiener EM
    (estimates stored bfloat16), the iSTFT; each segment's output weighted
    by the transition, stored bfloat16, overlap-added and divided by the
    weight sum; trimmed back by the offset."""
    sr, n_fft, hop = cfg["sample_rate"], cfg["n_fft"], cfg["n_hop"]
    seg = int(cfg["segment_secs"] * sr)
    stride = int((1.0 - cfg["overlap"]) * seg)
    max_shift = int(cfg["max_shift_secs"] * sr)
    shifts = cfg["shifts"]
    if shifts != 1:
        raise ValueError("the reference implements one shift pass")
    n_t, L, G = len(TARGETS), cfg["nb_layers"], cfg["hidden_size"] // 2
    bins, out_bins = cfg["max_bin"], cfg["nb_output_bins"]
    eps = cfg["bn_eps"]
    w = Weights(sd, L)
    weight = transition_weight(seg, cfg["transition_power"], device)
    padded, offsets, n_chunks = [], [], []
    for track, seed in zip(tracks, seeds):
        off = shift_offset(seed, max_shift) if max_shift > 0 else 0
        a = np.pad(np.asarray(track, np.float32), ((0, 0), (off, max_shift - off)))
        k = max(1, math.ceil(a.shape[1] / stride))
        a = np.pad(a, ((0, 0), (0, (k - 1) * stride + seg - a.shape[1])))
        padded.append(torch.from_numpy(a).to(device))
        offsets.append(off)
        n_chunks.append(k)
    N = len(tracks)
    acc = [torch.zeros((n_t, 2, p.shape[1]), dtype=torch.float64, device=device) for p in padded]
    wsum = [torch.zeros(p.shape[1], dtype=torch.float64, device=device) for p in padded]
    h = torch.zeros((N, n_t, L, 2, G), device=device)
    c = torch.zeros_like(h)
    for k in range(max(n_chunks)):
        rows = [i for i in range(N) if k < n_chunks[i]]
        audio = torch.stack([padded[i][:, k * stride : k * stride + seg] for i in rows])
        X = stft(audio, n_fft, hop)  # (n, 2, T, F) complex128
        x = crop_stack(X.abs(), bins).float()
        m, (h_new, c_new) = masks(w, x, (h[rows], c[rows]), eps, products)
        h[rows], c[rows] = h_new, c_new
        m = round_bf16(m).double()  # the mask seam
        m = m.reshape(*m.shape[:-1], 2, out_bins).movedim(-2, -3)  # (n, T#, 2, T, F)
        for j, i in enumerate(rows):
            y = wiener(X[j], m[j], cfg["wiener_iterations"], cfg["wiener_eps"],
                       cfg["wiener_scale_factor"])
            y = torch.complex(round_bf16(y.real.float()).double(),
                              round_bf16(y.imag.float()).double())  # the estimates' seam
            out = istft(y, n_fft, hop, seg)  # (T#, 2, seg)
            out = round_bf16((out * weight).float()).double()  # the stack's seam
            acc[i][..., k * stride : k * stride + seg] += out
            wsum[i][k * stride : k * stride + seg] += weight
    stems = []
    for i, track in enumerate(tracks):
        n = np.asarray(track).shape[1]
        s = (acc[i] / wsum[i])[..., offsets[i] : offsets[i] + n]
        stems.append(s.float().cpu().numpy())
    return stems


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

FROZEN = ("running_mean", "running_var")
DUPLICATED = ("input_mean", "input_scale", "output_scale", "output_mean")


def trainable_state(sd: dict) -> dict:
    """Leaf copies of the state dicts for training: every entry but the
    batch norms' running statistics requires a gradient, and the input and
    output scales and means are one vector per stereo channel."""
    out = {}
    for t in TARGETS:
        d = {}
        for k, v in sd[t].items():
            v = v.detach().clone().float()
            if k in DUPLICATED:
                v = torch.cat([v, v])
            d[k] = v.requires_grad_(not k.endswith(FROZEN))
        out[t] = d
    return out


def features(mix: torch.Tensor, targets: torch.Tensor, n_fft: int, hop: int, bins: int,
             seq_len: int):
    """The loss's inputs from raw audio: mix (B, 2, n), targets (B, T#, 2,
    n) → x (B, T, 2·bins), mix magnitude (B, 2, T, F), target magnitudes
    (B, T#, 2, T, F), float32, cut to ``seq_len`` frames."""
    mix_mag = stft(mix, n_fft, hop).abs()[..., :seq_len, :]
    tgt_mag = stft(targets, n_fft, hop).abs()[..., :seq_len, :]
    return crop_stack(mix_mag, bins).float(), mix_mag.float(), tgt_mag.float()


def mask_loss(sd: dict, x, mix_mag, tgt_mag, cfg: dict, products: str = "float32"):
    """Mean squared error between the masked mix magnitudes and the target
    magnitudes, all targets at once, the LSTM state zero for every row."""
    L, G, out_bins = cfg["nb_layers"], cfg["hidden_size"] // 2, cfg["nb_output_bins"]
    w = Weights(sd, L, duplicated_norms=True)
    B = x.shape[0]
    zero = torch.zeros((B, len(TARGETS), L, 2, G), device=x.device)
    m, _ = masks(w, x, (zero, zero), cfg["bn_eps"], products)  # (B, T#, T, 2F)
    m = m.reshape(*m.shape[:-1], 2, out_bins).movedim(-2, -3)  # (B, T#, 2, T, F)
    return torch.mean((m * mix_mag[:, None] - tgt_mag) ** 2)


def train(sd: dict, batches: list, cfg: dict, products: str = "float32"):
    """AdamW steps (decoupled weight decay, written out) on ``mask_loss``,
    one per batch of raw audio ``(mix, targets)``, from the weights
    ``sd``.  Returns (losses, the first step's gradients, the trained
    state dicts), the latter two as {target: {key: tensor}}."""
    tr = cfg["train"]
    lr, wd, (b1, b2), ae = tr["lr"], tr["weight_decay"], tr["betas"], tr["adam_eps"]
    state = trainable_state(sd)
    leaves = [(t, k) for t in TARGETS for k, v in state[t].items() if v.requires_grad]
    m = {tk: torch.zeros_like(state[tk[0]][tk[1]]) for tk in leaves}
    v = {tk: torch.zeros_like(state[tk[0]][tk[1]]) for tk in leaves}
    losses, first = [], None
    for step, (mix, targets) in enumerate(batches, start=1):
        x, mix_mag, tgt_mag = features(mix, targets, cfg["n_fft"], cfg["n_hop"], cfg["max_bin"],
                                       tr["seq_len"])
        loss = mask_loss(state, x, mix_mag, tgt_mag, cfg, products)
        grads = torch.autograd.grad(loss, [state[t][k] for t, k in leaves])
        losses.append(float(loss.detach()))
        if first is None:
            first = {t: {} for t in TARGETS}
            for (t, k), g in zip(leaves, grads):
                first[t][k] = g.detach().clone()
        with torch.no_grad():
            for (t, k), g in zip(leaves, grads):
                p = state[t][k]
                p.mul_(1.0 - lr * wd)
                m[t, k].mul_(b1).add_(g, alpha=1.0 - b1)
                v[t, k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
                denom = (v[t, k] / (1.0 - b2**step)).sqrt_().add_(ae)
                p.addcdiv_(m[t, k], denom, value=-lr / (1.0 - b1**step))
    trained = {t: {k: val.detach() for k, val in state[t].items()} for t in TARGETS}
    return losses, first, trained
