"""Minimal leveled logger, as ``umx_tpu.utils.logging``: the same
``UMX_TPU_LOG`` variable (debug|info|warn|quiet, default info), levels and
stderr format (``[   12.34s] info: ...``, seconds since import)."""

from __future__ import annotations

import os
import sys
import time

_LEVELS = {"debug": 10, "info": 20, "warn": 30, "quiet": 100}
_t0 = time.perf_counter()


def _level() -> int:
    return _LEVELS.get(os.environ.get("UMX_TPU_LOG", "info").lower(), 20)


def _emit(tag: str, *args):
    print(f"[{time.perf_counter() - _t0:8.2f}s] {tag}:", *args, file=sys.stderr, flush=True)


def debug(*args):
    if _level() <= 10:
        _emit("debug", *args)


def info(*args):
    if _level() <= 20:
        _emit("info", *args)


def warn(*args):
    if _level() <= 30:
        _emit("warn", *args)
