"""The system under test, built from a configuration file: the only module
of the harness that imports ``umx_tpu_torch``, and only inside its
functions."""

from __future__ import annotations

import numpy as np


def engine_config(cfg: dict):
    """The system's ``EngineConfig`` as the configuration states it."""
    from umx_tpu_torch.config import (
        DSPConfig, EngineConfig, ModelConfig, SegmentConfig, WienerConfig,
    )

    prec = cfg["precision"]
    return EngineConfig(
        dsp=DSPConfig(sample_rate=cfg["sample_rate"], n_fft=cfg["n_fft"], hop=cfg["n_hop"]),
        model=ModelConfig(hidden_size=cfg["hidden_size"], n_targets=len(cfg["targets"]),
                          n_lstm_layers=cfg["nb_layers"], nb_bins_cropped=cfg["max_bin"],
                          n_bins=cfg["nb_output_bins"], bn_eps=cfg["bn_eps"],
                          input_scaling=cfg["input_scaling"], lstm_impl=cfg["lstm_impl"]),
        wiener=WienerConfig(iterations=cfg["wiener_iterations"], eps=cfg["wiener_eps"],
                            scale_factor=cfg["wiener_scale_factor"],
                            out_dtype=prec["wiener_out_dtype"]),
        segment=SegmentConfig(segment_secs=cfg["segment_secs"], overlap=cfg["overlap"],
                              max_shift_secs=cfg["max_shift_secs"],
                              transition_power=cfg["transition_power"],
                              streaming=cfg["streaming"]),
        use_wiener=cfg["wiener_iterations"] > 0,
        shifts=cfg["shifts"],
        mask_dtype=prec["mask_dtype"],
        stems_stack_dtype=prec["stems_stack_dtype"],
    )


def params(sd: dict, cfg: dict, device):
    """The system's parameters from the benchmark's state dicts, through
    its own loader of published-layout weights."""
    from umx_tpu_torch.config import TARGETS
    from umx_tpu_torch.io.ggml import GGMLModel
    from umx_tpu_torch.models.umx import params_from_ggml

    host = {t: {k: np.ascontiguousarray(v.detach().cpu().numpy()) for k, v in sd[t].items()}
            for t in TARGETS}
    model = GGMLModel(hidden_size=cfg["hidden_size"], targets=host)
    return params_from_ggml(model, engine_config(cfg).model, device)
