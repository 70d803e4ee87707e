"""Finding a cell's files by name.

Each configuration, traffic mix, cell, driver, per-layer metric and
reference is a file of its own under ``benchmarks/``; the harness finds
it by the name that ``BENCHMARK.json`` and the cell's own file give:

- ``configs/<config>.json``: the model configuration as it is run;
- ``traffic/<traffic>.json``: the traffic mix's parameters, and the name
  of the driver that offers it;
- ``workloads/<cell>.json``: the cell (``config``, ``traffic``,
  ``chips``, ``why``) and the limits of its comparison;
- ``drivers/<driver>.py``: how to drive one entry point of the system;
- ``metrics/<metric>.py``: a reader of one per-layer metric;
- ``reference/<reference>.py``: a plain reference, named by the
  configuration.

Adding any of them adds a file and edits none.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def check_name(name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"not a valid name: {name!r}")
    return name


def load_json(kind: str, name: str) -> dict:
    path = ROOT / kind / f"{check_name(name)}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path.relative_to(ROOT)})")
    return json.loads(path.read_text())


def load_module(kind: str, name: str):
    """The module ``<kind>/<name>.py`` (a name may hold dots, so it is
    loaded from its path)."""
    path = ROOT / kind / f"{check_name(name)}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path.relative_to(ROOT)})")
    mod_name = f"benchmarks.{kind}._{re.sub(r'[^A-Za-z0-9_]', '_', name)}"
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def names(kind: str, suffix: str) -> list[str]:
    """The names of the files of one kind, sorted."""
    return sorted(p.name[: -len(suffix)] for p in (ROOT / kind).glob(f"*{suffix}")
                  if not p.name.startswith("_"))


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])

    @property
    def limits(self) -> dict:
        return self.workload.get("limits", {})

    def driver(self):
        return load_module("drivers", self.traffic["driver"])

    def reference(self):
        return load_module("reference", self.config["reference"])


def load_cell(name: str) -> Cell:
    w = load_json("workloads", name)
    return Cell(name, w, load_json("configs", w["config"]), load_json("traffic", w["traffic"]))


def readers() -> dict:
    """Every per-layer metric's reader, by metric name."""
    return {n: load_module("metrics", n) for n in names("metrics", ".py")}
