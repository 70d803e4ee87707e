"""The port's observability utilities (``umx_tpu_torch.utils``) against
``umx_tpu.utils``: the cases of ``tests/test_utils.py``, the timer's table
and JSON equal to the JAX class's for the same totals, the trace on the
CPU and the logger's lines equal to the JAX logger's after the timestamp."""

import json
import os
import re

import numpy as np
import pytest
import torch

from umx_tpu.utils import logging as jlog
from umx_tpu.utils.profiling import StageTimer as JStageTimer
from umx_tpu_torch.utils import logging as ulog
from umx_tpu_torch.utils.profiling import StageTimer, block_until_ready, device_trace


def test_stage_timer_accumulates_and_reports():
    t = StageTimer()
    with t.stage("a"):
        pass
    with t.stage("a"):
        pass
    with t.stage("b", block_on=torch.ones(4) * 2):
        pass
    with t.stage("c", block_on={"x": [torch.ones(2), (torch.zeros(3),)], "n": 3}):
        pass
    assert t.counts["a"] == 2 and t.counts["b"] == 1 and t.counts["c"] == 1
    rep = t.report()
    assert "a" in rep and "b" in rep and "mean_ms" in rep
    parsed = json.loads(t.as_json())
    assert parsed["a"]["calls"] == 2


def test_stage_timer_counts_a_stage_that_raises():
    t = StageTimer()
    with pytest.raises(ValueError):
        with t.stage("boom", block_on=[torch.ones(1)]):
            raise ValueError("x")
    assert t.counts["boom"] == 1 and t.totals["boom"] >= 0.0


def test_block_until_ready_returns_its_argument():
    tree = {"a": [torch.ones(2)], "b": (torch.zeros(1), 5)}
    assert block_until_ready(tree) is tree


def test_report_and_json_equal_jax_for_the_same_totals():
    totals = {"load_audio": 0.0123, "demix": 1.5, "write_stems": 0.25, "load_model": 0.75}
    counts = {"load_audio": 1, "demix": 3, "write_stems": 4, "load_model": 1}
    ours, theirs = StageTimer(), JStageTimer()
    for t in (ours, theirs):
        for k, v in totals.items():
            t.totals[k] = v
            t.counts[k] = counts[k]
    assert ours.report() == theirs.report()
    assert ours.as_json() == theirs.as_json()
    lines = ours.report().splitlines()
    assert lines[0].split() == ["stage", "total_s", "calls", "mean_ms"]
    assert [ln.split()[0] for ln in lines[1:]] == ["demix", "load_model", "write_stems",
                                                   "load_audio"]  # by total, descending
    assert StageTimer().report() == JStageTimer().report()  # header alone


def test_device_trace_on_the_cpu_writes_a_trace(tmp_path):
    log_dir = str(tmp_path / "trace")
    with device_trace(log_dir, device="cpu") as prof:
        x = torch.arange(4096.0).reshape(64, 64)
        (x @ x).sum()
    files = [f for f in os.listdir(log_dir) if f.endswith(".pt.trace.json")]
    assert len(files) == 1, os.listdir(log_dir)
    events = json.load(open(os.path.join(log_dir, files[0])))["traceEvents"]
    names = {e.get("name") for e in events}
    assert any(n and "mm" in n for n in names), sorted(n for n in names if n)[:20]
    assert any("mm" in e.key for e in prof.key_averages())


def test_device_trace_defaults_to_the_gpu_and_raises_without_one(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU error path cannot be reached")
    with pytest.raises(RuntimeError, match="cuda"):
        with device_trace(str(tmp_path / "t")):
            pass


def test_leveled_logging(capsys, monkeypatch):
    monkeypatch.setenv("UMX_TPU_LOG", "warn")
    ulog.info("hidden")
    ulog.warn("visible")
    err = capsys.readouterr().err
    assert "hidden" not in err
    assert "visible" in err

    monkeypatch.setenv("UMX_TPU_LOG", "debug")
    ulog.debug("dbg")
    assert "dbg" in capsys.readouterr().err

    monkeypatch.setenv("UMX_TPU_LOG", "quiet")
    ulog.warn("nothing")
    assert capsys.readouterr().err == ""


STAMP = re.compile(r"^\[ *\d+\.\d\ds\] ")


@pytest.mark.parametrize("level", [None, "debug", "info", "warn", "quiet", "bogus"])
def test_log_lines_equal_jax_after_the_timestamp(capsys, monkeypatch, level):
    if level is None:
        monkeypatch.delenv("UMX_TPU_LOG", raising=False)
    else:
        monkeypatch.setenv("UMX_TPU_LOG", level)
    out = {}
    for name, mod in (("ours", ulog), ("jax", jlog)):
        mod.debug("d", 1)
        mod.info("i", 2.5, np.float32(3))
        mod.warn("w")
        lines = capsys.readouterr().err.splitlines()
        assert all(STAMP.match(ln) for ln in lines), lines
        out[name] = [STAMP.sub("", ln) for ln in lines]
    assert out["ours"] == out["jax"]
