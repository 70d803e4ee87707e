"""Logging and profiling helpers (counterpart of ``umx_tpu.utils``)."""
