"""The harness's files: discovery by name, ``BENCHMARK.json`` against the
files, the refusal without a card, and what the harness and its reference
import."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from benchmarks import run as R
from benchmarks.harness import cells, device

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())


def test_every_cell_finds_its_files():
    for w in BENCH["workloads"]:
        cell = cells.load_cell(w["name"])
        assert (cell.workload["config"], cell.workload["traffic"], cell.chips, cell.workload["why"]) \
            == (w["config"], w["traffic"], w["chips"], w["why"])
        drv = cell.driver()
        assert callable(drv.setup) and callable(drv.window) and callable(drv.check)
        assert cell.reference().__name__.startswith("benchmarks.reference.")
        assert cell.limits, f"{w['name']} has no limits"


def test_configurations_match_their_files():
    for c in BENCH["configs"]:
        data = json.loads((REPO / c["file"]).read_text())
        assert c["file"] == f"benchmarks/configs/{c['name']}.json"
        assert data["source"] == c["source"] and data["reduced"] == c["reduced"]
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


def test_metrics_match_their_readers():
    readers = cells.readers()
    assert sorted(readers) == sorted(m["name"] for m in BENCH["per_layer"])
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        r = readers[m["name"]]
        assert (r.UNIT, r.MOVES) == (m["unit"], m["moves"]) and m["moves"] in e2e
        # the cells that report the metric are those whose driver reports what it moves
        reporting = [w["name"] for w in BENCH["workloads"]
                     if m["moves"] in cells.load_cell(w["name"]).driver().E2E]
        assert m["workloads"] == reporting
    for w in BENCH["workloads"]:
        drv = cells.load_cell(w["name"]).driver()
        for name in drv.E2E:
            assert w["name"] in e2e[name]["workloads"] and e2e[name]["unit"] == drv.E2E[name]


def test_discovery_is_by_file_name(tmp_path, monkeypatch):
    for kind in ("configs", "traffic", "workloads", "drivers", "metrics", "reference"):
        (tmp_path / kind).mkdir()
    (tmp_path / "metrics" / "x.new.py").write_text('UNIT, MOVES = "%", "demix_xrt"\n'
                                                   "def read(r):\n    return 1.0\n")
    (tmp_path / "configs" / "c.json").write_text('{"reference": "umx"}')
    (tmp_path / "traffic" / "t.json").write_text('{"driver": "d"}')
    (tmp_path / "workloads" / "c.t.json").write_text('{"config": "c", "traffic": "t", "chips": 1}')
    monkeypatch.setattr(cells, "ROOT", tmp_path)
    assert list(cells.readers()) == ["x.new"]
    cell = cells.load_cell("c.t")
    assert cell.traffic == {"driver": "d"} and cell.chips == 1
    with pytest.raises(FileNotFoundError):
        cells.load_cell("missing")
    with pytest.raises(ValueError):
        cells.load_json("configs", "../escape")


def test_no_card_no_result():
    """Without a card the run refuses: no result line, exit code 2."""
    proc = subprocess.run([sys.executable, "-m", "benchmarks.run", "--workload", "umxl.track",
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=REPO,
                          capture_output=True, text=True, timeout=300,
                          env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 2 and proc.stdout == ""
    assert "no result" in proc.stderr


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module)
    return names


def test_no_source_imports_jax_or_the_jax_package():
    for path in ROOT.rglob("*.py"):
        tops = {n.split(".", 1)[0] for n in _imports(path)}
        assert not tops & set(device.FORBIDDEN), (path, tops & set(device.FORBIDDEN))


def test_the_reference_imports_nothing_of_the_system():
    for path in (ROOT / "reference").glob("*.py"):
        tops = {n.split(".", 1)[0] for n in _imports(path)}
        assert tops <= {"__future__", "math", "numpy", "torch"}, (path, tops)


def test_a_run_loads_no_forbidden_module():
    """What the harness, the drivers, the readers and the reference load in
    one process, compared by whole top-level names (``umx_tpu_torch``
    begins with ``umx_tpu`` and is not it)."""
    code = (
        "import sys\n"
        "from benchmarks.harness import cells, device\n"
        "for w in ('umxl.catalogue', 'umxl.track', 'umxhq.train'):\n"
        "    c = cells.load_cell(w); c.driver(); c.reference()\n"
        "cells.readers()\n"
        "import benchmarks.run, umx_tpu_torch.engine.fleet, umx_tpu_torch.train\n"
        "assert 'umx_tpu_torch' in sys.modules\n"
        "print(','.join(device.forbidden_modules()))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == ""


def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "umx_tpu_torch_fake_probe", object())
    assert "umx_tpu" not in device.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert "jax" in device.forbidden_modules()


def test_judge_needs_every_number_within_its_limit():
    assert R.judge({"a": 1.0}, {"a": 2.0}, 3, 0)[0]
    assert not R.judge({"a": 1.0}, {"a": 0.5}, 3, 0)[0]
    assert not R.judge({"a": 1.0}, {}, 3, 0)[0]  # a number with no limit
    assert not R.judge({"a": 1.0}, {"a": 2.0}, 3, 1)[0]  # a failed call
    assert not R.judge({"a": float("inf")}, {"a": 2.0}, 3, 0)[0]
