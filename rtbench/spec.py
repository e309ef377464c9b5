"""``BENCHMARK.json`` and the files it names, found by name.

A cell ``<config>.<traffic>`` of ``BENCHMARK.json`` resolves to:

* ``rtbench/configs/<config>.json``: the world as it is run (``world``),
  its source, what was assumed and cut, and the plain reference that
  renders it (``reference``: a module of ``rtbench/reference``);
* ``rtbench/traffic/<traffic>.json``: the mix's parameters, and its
  ``kind``, the module of ``rtbench/kinds`` that drives it;
* ``rtbench/limits/<cell>.json``: the limit of each number that decides
  ``correct``, with the readings it was set from;
* ``rtbench/metrics/<metric>.py``: a per-layer metric's reader.

A new cell, mix or metric is new files and new entries; nothing here
changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import List

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict] = field(default_factory=list)
    per_layer: List[dict] = field(default_factory=list)

    def kind(self):
        return importlib.import_module(f"rtbench.kinds.{self.traffic['kind']}")

    def reference(self):
        return importlib.import_module(
            f"rtbench.reference.{self.config['reference']}")


def _reports(metric: dict, cell: str, e2e_names: List[str]) -> bool:
    """A metric with ``workloads`` is reported in those cells; a per-layer
    one without, in every cell that reports the metric it moves; an
    end-to-end one without, in every cell."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def load_cell(name: str, bench_path: Path = ROOT / "BENCHMARK.json",
              pkg: Path = PKG) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files."""
    bench = load_json(bench_path)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {bench_path} "
                       f"(have {', '.join(sorted(cells))})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(ROOT / configs[w["config"]]["file"])
    traffic = load_json(pkg / "traffic" / f"{w['traffic']}.json")
    limits = load_json(pkg / "limits" / f"{name}.json")
    e2e = [m for m in bench["end_to_end"] if _reports(m, name, [])]
    names = [m["name"] for m in e2e]
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, limits=limits, end_to_end=e2e,
                per_layer=per_layer)


def metric_reader(name: str, pkg: Path = PKG):
    """The module ``rtbench/metrics/<name>.py`` (names hold dots, so it is
    loaded from its path)."""
    path = pkg / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"rtbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
