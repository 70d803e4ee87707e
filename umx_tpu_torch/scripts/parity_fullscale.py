"""Full-scale golden parity of the port (counterpart of
``scripts/parity-fullscale.py``): the COMPLETE pipeline at UMX-L
production shape (hidden 1024, 60 s segment, T = 2584 frames, all 4
targets) against the independent oracle chain of ``eval/oracle.py``:

    torch.stft -> TorchUMX mask nets -> numpy Wiener-EM oracle -> torch.istft

on the host CPU in float32 (the Wiener oracle in complex128), so that no
device library becomes the reference for the port's own.  The port's side
is ``segment_forward`` on ``--device`` (default ``cuda``, which raises
without a GPU; ``cpu`` runs the kernels' plain versions), once per
variant:

    fp32       the defaults with the three storage seams pinned to float32
               (mask_dtype, wiener.out_dtype, stems_stack_dtype): the merged
               recurrence kernel, the Wiener kernels; every variant below but
               auto starts from it
    qhbm       quantized resident weights (u8/u16 planes, ops/qmatmul.py)
    pallas     lstm_impl="pallas_merged" (the merged kernel, as in the JAX
               script; the same program as fp32)
    pertarget  lstm_impl="pallas" (the per-target recurrence kernel)
    scan       lstm_impl="scan" (the float32 recurrence kernel: f32 h and
               W_hh; the JAX script's default config off a TPU, whose CPU
               fp32 row runs its scan)
    ct2        the Cooley-Tukey iSTFT kernel
    em2        wiener.iterations=2 (the --wiener-iters CLI path)
    nowiener   use_wiener=False (mask * mixture-phase path)
    quirk      wiener.psd="umxcpp" (reference PSD quirk, einsum path)
    stream2    TWO sequential half-length segments with the LSTM state
               carried across the boundary (streaming semantics,
               umx.cpp:167-171); the oracle carries nn.LSTM state the same way
    wiener_bf16  wiener.out_dtype="bfloat16" (the Wiener kernels' y planes
               rounded to bfloat16 before the iSTFT)
    wiener_f32   wiener.out_dtype="float32" (the same program as fp32)
    auto       the EngineConfig defaults as they are: the seams at "auto",
               bfloat16 on the GPU (masks read and Wiener planes written by
               the kernels in bfloat16), float32 on the CPU (fp32's program)

The JAX script's precision variants (high, idft_*, dft_*) raise by name:
the port's CLI accepts their flags, and each computes what fp32 computes
(float32 matmuls without TF32, cuFFT), so its row would be fp32's.  So do
its ct2_xla and ct2_interpret, which are XLA and Pallas forms.

Inputs and weights are the JAX harness's: tests/data/gspi_stereo.wav
tiled to the segment plus 0.01 * default_rng(0) noise, normalized to a
0.5 peak; ``synthetic_state_dicts(seed=7)`` through the ggml bytes
(quantized u8/u16) and parsed back.  The oracle consumes the dequantized
weights, so the quantized row isolates the port's error from the
quantization.  Prints one JSON line per variant, then a markdown table;
gates nothing.

    python -m umx_tpu_torch.scripts.parity_fullscale [--seg-secs 60]
           [--variants fp32,qhbm,...] [--hidden 1024] [--out F] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np

PORT_VARIANTS = ("fp32", "qhbm", "pallas", "pertarget", "scan", "ct2", "em2", "nowiener",
                 "quirk", "stream2", "wiener_bf16", "wiener_f32", "auto")
_SAME_AS_FP32 = ("the port accepts that flag, and every value of it computes what fp32 "
                 "computes")
# the JAX script's variants that select TPU precisions or an XLA / Pallas
# form: no row of the port's differs from fp32 for the first, and the
# second does not exist here
JAX_ONLY_VARIANTS = {
    "high": f"matmul_precision: {_SAME_AS_FP32} (float32 matmuls with TF32 off)",
    "ct2_xla": "the XLA einsum Cooley-Tukey stages (the port's ct2 is its kernel)",
    "ct2_interpret": "Pallas interpret mode",
    "idft_default": f"idft_precision: {_SAME_AS_FP32} (cuFFT or the ct2 kernel)",
    "idft_high": f"idft_precision: {_SAME_AS_FP32} (cuFFT or the ct2 kernel)",
    "dft_default": f"dft_precision: {_SAME_AS_FP32} (cuFFT)",
    "dft_high": f"dft_precision: {_SAME_AS_FP32} (cuFFT)",
}
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
GSPI = os.path.join(REPO, "tests", "data", "gspi_stereo.wav")


def check_variants(names) -> list[str]:
    """The variant names, each one the port runs; a JAX-only one raises
    ``ValueError`` naming it, an unknown one ``SystemExit``."""
    out = []
    for v in names:
        if v in JAX_ONLY_VARIANTS:
            raise ValueError(f"variant {v!r} has no row of its own in the port: it selects "
                             f"{JAX_ONLY_VARIANTS[v]}; use one of {', '.join(PORT_VARIANTS)}")
        if v not in PORT_VARIANTS:
            raise SystemExit(f"unknown variant {v}")
        out.append(v)
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--seg-secs", type=float, default=60.0)
    p.add_argument("--variants", default=",".join(PORT_VARIANTS))
    p.add_argument("--hidden", type=int, default=1024)
    p.add_argument("--out", default=None, help="write JSON results here")
    p.add_argument("--device", default=None,
                   help="torch device of the port's side: cuda (default) or cpu")
    return p


def err_row(variant, waves, waves_oracle, seg_secs, hidden, device, card) -> dict:
    """The JAX script's ``_err_row`` (error energy against the oracle's
    signal energy, whole and per stem), with the torch device type as
    ``backend`` and the card's name and power limit as ``device_name``."""
    sig = float(np.sum(waves_oracle**2))
    err = float(np.sum((waves - waves_oracle) ** 2))
    err_db = 10.0 * np.log10(sig / max(err, 1e-30))
    peak = float(np.abs(waves_oracle).max())
    max_abs = float(np.abs(waves - waves_oracle).max())
    per_stem = []
    for s in range(waves.shape[0]):
        ss = float(np.sum(waves_oracle[s] ** 2))
        se = float(np.sum((waves[s] - waves_oracle[s]) ** 2))
        per_stem.append(round(float(10.0 * np.log10(ss / max(se, 1e-30))), 1))
    return {
        "variant": variant,
        "seg_secs": seg_secs,
        "hidden": hidden,
        "backend": device.type,
        "waveform_err_db": round(err_db, 1),
        "waveform_max_abs_err": max_abs,
        "waveform_max_rel_err": max_abs / peak,
        "per_stem_err_db": per_stem,
        "device_name": card,
    }


class Parity:
    """The harness's shared state: the input segment, the weights, the
    oracle's waves per Wiener setting (computed once, on the host CPU) and
    the port's parameters on ``device``."""

    def __init__(self, hidden: int = 1024, seg_secs: float = 60.0, device=None):
        from umx_tpu_torch.config import EngineConfig, ModelConfig, SegmentConfig
        from umx_tpu_torch.engine.separator import resolve_device
        from umx_tpu_torch.io.audio import load_audio
        from umx_tpu_torch.io.ggml import read_ggml_bytes, write_ggml_bytes
        from umx_tpu_torch.models.umx import synthetic_state_dicts
        from umx_tpu_torch.utils.profiling import card_name

        self.device = resolve_device(device)
        self.card = card_name(self.device)
        self.hidden, self.seg_secs = hidden, seg_secs
        # the card's defaults (variant auto); the other variants start from
        # ``self.cfg``, the same with the storage seams pinned to float32
        self.auto_cfg = EngineConfig(model=ModelConfig(hidden_size=hidden),
                                     segment=SegmentConfig(segment_secs=seg_secs))
        self.cfg = self.auto_cfg.replace(
            mask_dtype="float32", stems_stack_dtype="float32",
            wiener=dataclasses.replace(self.auto_cfg.wiener, out_dtype="float32"))
        dcfg = self.cfg.dsp
        self.n = n = self.cfg.segment.segment_samples(dcfg.sample_rate)
        self.n_frames = dcfg.n_frames(n)

        # realistic input: the glockenspiel recording tiled to the segment,
        # plus broadband noise so every bin carries energy
        gspi = load_audio(GSPI)
        reps = -(-n // gspi.shape[1])
        audio = np.tile(gspi, (1, reps))[:, :n]
        rng = np.random.default_rng(0)
        audio = (audio + 0.01 * rng.standard_normal(audio.shape)).astype(np.float32)
        audio *= 0.5 / np.abs(audio).max()
        self.audio = audio

        # weights through the real artifact chain: state dicts -> ggml
        # bytes (quantized u8/u16) -> parsed back
        sds = synthetic_state_dicts(self.cfg.model, seed=7)
        self.model = read_ggml_bytes(write_ggml_bytes(hidden, sds), keep_quantized=True)
        self._params: dict[str, object] = {}
        self._shared = None  # the oracle's (mix spectrogram, target magnitudes)
        self._oracle: dict[tuple, np.ndarray] = {}  # its waves per Wiener setting
        self._stream2 = None
        self._win = None

    # ---- the oracle, on the host CPU -------------------------------------

    def _spec(self, aud: np.ndarray) -> np.ndarray:
        import torch

        d = self.cfg.dsp
        if self._win is None:
            self._win = torch.hann_window(d.n_fft, periodic=True)
        return torch.stft(
            torch.from_numpy(aud), n_fft=d.n_fft, hop_length=d.hop, window=self._win,
            center=True, pad_mode="reflect", normalized=False, onesided=True,
            return_complex=True,
        ).numpy().swapaxes(-1, -2)  # (2, T, F)

    def _istft(self, y: np.ndarray, length: int) -> np.ndarray:
        import torch

        d = self.cfg.dsp
        return np.stack([
            torch.istft(torch.from_numpy(y[s].swapaxes(-1, -2).copy()), n_fft=d.n_fft,
                        hop_length=d.hop, window=self._win, center=True, length=length).numpy()
            for s in range(y.shape[0])
        ])  # (S, 2, length)

    def _net_input(self, mag: np.ndarray) -> np.ndarray:
        nb = self.cfg.model.nb_bins_cropped
        return np.concatenate([mag[0, :, :nb], mag[1, :, :nb]], axis=-1)  # (T, 2*nb)

    @staticmethod
    def _target_mags(masks: np.ndarray, mag: np.ndarray) -> np.ndarray:
        t_count, f_bins = mag.shape[1], mag.shape[2]
        m = masks.reshape(4, t_count, 2, f_bins).transpose(0, 2, 1, 3)
        return (m * mag[None]).astype(np.float32)

    def _waves(self, spec, target_mags, length, use_wiener=True, iterations=1,
               psd="correct") -> np.ndarray:
        from umx_tpu_torch.eval.oracle import numpy_wiener_oracle

        if use_wiener:
            w = self.cfg.wiener
            y = numpy_wiener_oracle(spec.astype(np.complex64), target_mags, iterations, w.eps,
                                    w.scale_factor, psd=psd)
        else:
            # mask * mixture-phase path (reference inference.cpp:168-183
            # when wiener is compiled out)
            phase = np.exp(1j * np.angle(spec))[None]
            y = (target_mags * phase).astype(np.complex64)
        return self._istft(y, length)

    def oracle(self, use_wiener=True, iterations=1, psd="correct") -> np.ndarray:
        """The oracle's waves (S, 2, n) of the whole segment for one Wiener
        setting; the mask nets run once for all settings."""
        from umx_tpu_torch.eval.oracle import oracle_masks

        key = (use_wiener, iterations, psd)
        if key not in self._oracle:
            if self._shared is None:
                spec = self._spec(self.audio)
                mag = np.abs(spec)
                print("# oracle: mask nets...", file=sys.stderr)
                masks = oracle_masks(self.model.targets, self._net_input(mag), self.hidden)
                self._shared = spec, self._target_mags(masks, mag)
            print(f"# oracle: wiener/istft {key}...", file=sys.stderr)
            self._oracle[key] = self._waves(*self._shared, self.n, use_wiener, iterations, psd)
        return self._oracle[key]

    def _halves(self):
        half = self.n // 2
        return half, [self.audio[:, :half], self.audio[:, half:2 * half]]

    def oracle_stream2(self) -> np.ndarray:
        """The oracle over two half-length segments with nn.LSTM state
        carried across the boundary, concatenated (S, 2, 2 * (n // 2))."""
        from umx_tpu_torch.eval.oracle import oracle_masks_stream

        if self._stream2 is None:
            half, halves = self._halves()
            specs = [self._spec(h) for h in halves]
            mags = [np.abs(s) for s in specs]
            print("# oracle[stream2]: mask nets with carried state...", file=sys.stderr)
            masks_seq = oracle_masks_stream(self.model.targets,
                                            [self._net_input(m) for m in mags], self.hidden)
            self._stream2 = np.concatenate([
                self._waves(specs[i], self._target_mags(masks_seq[i], mags[i]), half)
                for i in range(2)
            ], axis=-1)
        return self._stream2

    # ---- the port, on its device -----------------------------------------

    def params(self, quantized: bool = False):
        from umx_tpu_torch.models.umx import params_from_ggml, quantized_params_from_ggml

        key = "qhbm" if quantized else "fp32"
        if key not in self._params:
            build = quantized_params_from_ggml if quantized else params_from_ggml
            self._params[key] = build(self.model, self.cfg.model, self.device)
        return self._params[key]

    def variant_config(self, variant: str):
        """(config, quantized weights, the oracle's Wiener setting) of a
        variant other than stream2."""
        cfg, mcfg, okey = self.cfg, self.cfg.model, {}
        if variant == "pallas":
            cfg = cfg.replace(model=dataclasses.replace(mcfg, lstm_impl="pallas_merged"))
        elif variant == "pertarget":
            cfg = cfg.replace(model=dataclasses.replace(mcfg, lstm_impl="pallas"))
        elif variant == "scan":
            cfg = cfg.replace(model=dataclasses.replace(mcfg, lstm_impl="scan"))
        elif variant == "ct2":
            cfg = cfg.replace(dsp=dataclasses.replace(cfg.dsp, istft_algo="ct2"))
        elif variant == "em2":
            cfg = cfg.replace(wiener=dataclasses.replace(cfg.wiener, iterations=2))
            okey = dict(iterations=2)
        elif variant == "nowiener":
            cfg = cfg.replace(use_wiener=False)
            okey = dict(use_wiener=False)
        elif variant == "quirk":
            cfg = cfg.replace(wiener=dataclasses.replace(cfg.wiener, psd="umxcpp"))
            okey = dict(psd="umxcpp")
        elif variant in ("wiener_bf16", "wiener_f32"):
            out_dtype = "bfloat16" if variant == "wiener_bf16" else "float32"
            cfg = cfg.replace(wiener=dataclasses.replace(cfg.wiener, out_dtype=out_dtype))
        elif variant == "auto":
            cfg = self.auto_cfg
        return cfg, variant == "qhbm", okey

    def ours(self, variant: str) -> np.ndarray:
        """The port's waves for ``variant`` (stems on the host)."""
        import torch

        from umx_tpu_torch.engine.separator import segment_forward, to_host
        from umx_tpu_torch.models.umx import init_lstm_state

        with torch.inference_mode():
            state = init_lstm_state(self.cfg.model, self.device)
            if variant == "stream2":
                print("# ours[stream2]: segment_forward x2 with carried state...",
                      file=sys.stderr)
                half, halves = self._halves()
                outs = []
                for h in halves:
                    w, state = segment_forward(self.params(), torch.from_numpy(h).to(self.device),
                                               state, self.cfg, half)
                    outs.append(to_host(w))
                return np.concatenate(outs, axis=-1)
            cfg, quantized, _ = self.variant_config(variant)
            print(f"# ours[{variant}]: segment_forward...", file=sys.stderr)
            audio = torch.from_numpy(self.audio).to(self.device)
            waves, _ = segment_forward(self.params(quantized), audio, state, cfg, self.n)
            return to_host(waves)

    def row(self, variant: str) -> dict:
        if variant == "stream2":
            waves_oracle = self.oracle_stream2()
        else:
            waves_oracle = self.oracle(**self.variant_config(variant)[2])
        return err_row(variant, self.ours(variant), waves_oracle, self.seg_secs, self.hidden,
                       self.device, self.card)


def print_table(rows: list[dict]) -> None:
    print("\n| variant | waveform err (dB below signal) | max rel err | per-stem err dB |")
    print("|---|---|---|---|")
    for r in rows:
        print(f"| {r['variant']} | {r['waveform_err_db']} | "
              f"{r['waveform_max_rel_err']:.2e} | {r['per_stem_err_db']} |")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    variants = check_variants(args.variants.split(","))
    par = Parity(args.hidden, args.seg_secs, args.device)
    print(f"# parity-fullscale: backend={par.device.type} [{par.card}] hidden={args.hidden} "
          f"seg={args.seg_secs}s T={par.n_frames}", file=sys.stderr)
    results = []
    for variant in variants:
        row = par.row(variant)
        results.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    print_table(results)
    return 0


if __name__ == "__main__":
    sys.exit(main())
