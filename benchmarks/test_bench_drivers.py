"""The traffic drivers at a tiny size on the CPU, through the whole run
but the look for a card: set-up, window, trace, comparison.  A sound run
comes out correct under the cell's own limits; the control (the
reference with TF32 products in the system's place) and each fault the
cell can have, planted under the timed path, come out not correct."""

import copy
import json
import time

import numpy as np
import pytest
import torch

from benchmarks import run as R
from benchmarks.harness import cells, faults, trace

CPU = torch.device("cpu")
SEED = 2**31 + 12345


def tiny(name: str) -> cells.Cell:
    """The cell with its widths and lengths cut to what a CPU test holds
    (hidden 16, n_fft 256, 0.25 s segments, tracks of 0.2–1 s; training at
    batch 2 × 8 frames); its limits as the cell states them."""
    cell = copy.deepcopy(cells.load_cell(name))
    cell.config.update(hidden_size=16, n_fft=256, n_hop=64, max_bin=40, nb_output_bins=129,
                       segment_secs=0.25, max_shift_secs=0.02)
    if "train" in cell.config:
        cell.config["train"].update(batch_size=2, seq_len=8)
    cell.traffic.update(album_tracks=4, pool_tracks=5, pool_batches=3,
                        length_s={"mean": 0.5, "sd": 0.2, "min": 0.2, "max": 1.0})
    return cell


def run_once(cell, traced=False, control=False, seconds=0.5):
    drv = cell.driver()
    run = R.Run(cell, SEED, CPU, traced)
    st = drv.setup(run)
    result = drv.window(run, st, seconds, trace.Recorder(traced))
    drv.release(st)
    numbers = drv.check(run, st, result, control=control)
    ok, checks = R.judge(numbers, cell.limits, result["attempted"], result["failed"])
    return ok, checks, result


DEMIX = ["umxl.catalogue", "umxl.track", "umxhq.catalogue"]
CELLS = DEMIX + ["umxhq.train"]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    ok, checks, result = run_once(tiny(name))
    assert result["attempted"] > 0 and result["failed"] == 0
    assert result["e2e"] and all(v > 0 for v in result["e2e"].values())
    assert ok, checks


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    ok, checks, _ = run_once(tiny(name), control=True)
    assert not ok, checks


def test_catalogue_work_counts():
    cell = tiny("umxl.catalogue")
    _, _, result = run_once(cell)
    w = result["work"]
    assert w["frames"] == w["segments"] * 173  # 0.25 s segments at hop 64
    assert sum(w["recurrence_calls"].values()) * 1 <= w["segments"] * 3


@pytest.mark.parametrize("fault", sorted(faults.DEMIX))
@pytest.mark.parametrize("name", DEMIX)
def test_demix_fault_is_not_correct(name, fault):
    with faults.DEMIX[fault]():
        ok, checks, _ = run_once(tiny(name))
    assert not ok, checks


@pytest.mark.parametrize("fault", sorted(faults.TRAIN))
def test_train_fault_is_not_correct(fault):
    with faults.TRAIN[fault]():
        ok, checks, _ = run_once(tiny("umxhq.train"))
    assert not ok, checks


def test_result_line_shape(capsys):
    cell = tiny("umxl.track")
    out = R.execute(cell, SEED, 0.3, False, CPU, time.time())
    R.report(out)
    captured = capsys.readouterr()
    line = json.loads(captured.out.strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert isinstance(line["correct"], bool) and line["attempted"] > 0
    assert set(line["metrics"]) == {"track_p90_s", "setup_s"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(line["checks"]) == {"stem_rel_l1"}
    assert set(line["checks"]["stem_rel_l1"]) == {"value", "limit"}
    # the compared numbers, each beside its limit, are the last lines of stderr
    assert captured.err.strip().splitlines()[-1].startswith("check stem_rel_l1 ")


def test_traced_line_carries_per_layer_metrics_only():
    cell = tiny("umxl.catalogue")
    out = R.execute(cell, SEED, 0.3, True, CPU, time.time())
    # no device on the CPU: the trace is empty, so only counts are read
    assert "setup_s" not in out["metrics"] and "demix_xrt" not in out["metrics"]
    assert set(out["metrics"]) <= {"rows_per_dispatch.demix"}
    assert np.isfinite(out["checks"]["stem_rel_l1"]["value"])
