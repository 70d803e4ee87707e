"""Inputs made from ``--seed``: the weights, the audio and the draws.

The weights are Open-Unmix's per-target state dicts in their published
layout, drawn on the device in one call per target from a seeded
``torch.Generator``: every weight matrix ~ N(0, 1/fan_in), the norms'
scales near 1 and their shifts near 0, as a trained model's lie.  The
audio is seeded noise drawn on the device in one call, then copied to
the host, where a caller's decoded tracks would be.  Which sizes a
traffic mix runs is fixed by its file, not by the seed: the seed orders
them and fills them, so that every seed gives the same work.
"""

from __future__ import annotations

from statistics import NormalDist

import numpy as np
import torch

TARGETS = ("bass", "drums", "other", "vocals")


def derived_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one use (``tag``) of the run's ``--seed`` (any
    whole number, negative ones too)."""
    words = [seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF, 1 if seed < 0 else 0]
    words += [ord(ch) for ch in tag]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> 1)


def rng(seed: int, tag: str) -> np.random.Generator:
    return np.random.default_rng(derived_seed(seed, tag))


def generator(seed: int, tag: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(derived_seed(seed, tag))
    return g


def state_dict_shapes(cfg: dict) -> list[tuple[str, tuple, str]]:
    """(key, shape, kind) of one target's state dict at the configuration's
    sizes; kind says how the entry is drawn."""
    H, G = cfg["hidden_size"], cfg["hidden_size"] // 2
    F, O = cfg["max_bin"], cfg["nb_output_bins"]
    C = cfg["nb_channels"]
    out = [
        ("input_mean", (F,), "shift"), ("input_scale", (F,), "scale"),
        ("output_scale", (O,), "scale"), ("output_mean", (O,), "shift"),
        ("fc1.weight", (H, C * F), "matrix"), ("fc2.weight", (H, 2 * H), "matrix"),
        ("fc3.weight", (C * O, H), "matrix"),
    ]
    for name, dim in (("bn1", H), ("bn2", H), ("bn3", C * O)):
        out += [(f"{name}.weight", (dim,), "scale"), (f"{name}.bias", (dim,), "shift"),
                (f"{name}.running_mean", (dim,), "shift"), (f"{name}.running_var", (dim,), "var")]
    for layer in range(cfg["nb_layers"]):
        for rev in ("", "_reverse"):
            out += [(f"lstm.weight_ih_l{layer}{rev}", (4 * G, H), "matrix"),
                    (f"lstm.weight_hh_l{layer}{rev}", (4 * G, G), "matrix"),
                    (f"lstm.bias_ih_l{layer}{rev}", (4 * G,), "shift"),
                    (f"lstm.bias_hh_l{layer}{rev}", (4 * G,), "shift")]
    return out


def state_dicts(cfg: dict, seed: int, device) -> dict[str, dict[str, torch.Tensor]]:
    """The four targets' float32 state dicts on ``device``, from ``seed``:
    one normal draw per target, cut into the entries."""
    shapes = state_dict_shapes(cfg)
    sizes = [int(np.prod(s)) for _, s, _ in shapes]
    g = generator(seed, "weights", device)
    out = {}
    for t in TARGETS:
        flat = torch.randn(sum(sizes), generator=g, device=device, dtype=torch.float32)
        d, pos = {}, 0
        for (key, shape, kind), n in zip(shapes, sizes):
            v = flat[pos : pos + n].view(shape)
            pos += n
            if kind == "matrix":
                v = v * (1.0 / np.sqrt(shape[-1]))
            elif kind == "shift":
                v = v * 0.1
            elif kind == "scale":
                v = 1.0 + 0.1 * v
            else:  # a variance: positive, near 1
                v = 1.0 + 0.1 * v.abs()
            d[key] = v.contiguous()
        out[t] = d
    return out


def param_count(cfg: dict) -> int:
    """Parameters of the four targets' state dicts."""
    return len(TARGETS) * sum(int(np.prod(s)) for _, s, _ in state_dict_shapes(cfg))


def stratified_lengths(n: int, spec: dict, sample_rate: int) -> list[int]:
    """``n`` track lengths in samples: the quantiles at (i + 1/2)/n of a
    normal of ``spec["mean"]`` and ``spec["sd"]`` seconds, clipped to
    [``min``, ``max``] seconds.  The same for every seed."""
    nd = NormalDist(spec["mean"], spec["sd"])
    secs = [min(spec["max"], max(spec["min"], nd.inv_cdf((i + 0.5) / n))) for i in range(n)]
    return [int(round(s * sample_rate)) for s in secs]


def audio(lengths: list[int], seed: int, tag: str, device, level: float = 0.1,
          channels: int = 2) -> list[np.ndarray]:
    """Seeded stereo noise tracks ``(channels, n)`` float32 on the host, of
    the given lengths, drawn in one call on ``device``."""
    g = generator(seed, tag, device)
    total = channels * sum(lengths)
    flat = (torch.randn(total, generator=g, device=device) * level).cpu().numpy()
    out, pos = [], 0
    for n in lengths:
        out.append(flat[pos : pos + channels * n].reshape(channels, n))
        pos += channels * n
    return out


def stems_batch(batch: int, n_targets: int, samples: int, seed: int, tag: str, device,
                level: float = 0.05):
    """A training batch of raw audio: targets (B, T#, 2, n) seeded noise
    and their mix (B, 2, n), float32 on the host."""
    g = generator(seed, tag, device)
    targets = torch.randn((batch, n_targets, 2, samples), generator=g, device=device) * level
    return targets.sum(dim=1).cpu().numpy(), targets.cpu().numpy()
