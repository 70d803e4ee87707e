"""Evaluation (counterpart of ``umx_tpu.eval``): BSS-eval image metrics."""
