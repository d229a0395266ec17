"""Find a cell's files by the names in ``BENCHMARK.json``.

A cell ``<config>.<mix>`` resolves to:

* the configuration's file (``file`` of its entry in ``configs``), whose
  ``reference`` key names ``benchmark/reference/<reference>.py``: the plain
  reference that makes the victims and judges the answers;
* the traffic mix ``benchmark/traffic/<mix>.json``, whose ``entry`` key
  names ``benchmark/entries/<entry>.py``: the one module that calls the
  program;
* each metric the cell reports, ``benchmark/metrics/<metric>.py``, a reader
  with ``read(ctx)`` that returns a number or None.

Adding a configuration, a mix, a cell or a metric adds files and entries;
it edits no file that is there.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


@dataclass
class Metric:
    name: str
    unit: str
    reader: ModuleType


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    reference: ModuleType
    entry: ModuleType
    end_to_end: list[Metric] = field(default_factory=list)
    per_layer: list[Metric] = field(default_factory=list)


def load_module(kind: str, name: str) -> ModuleType:
    """``benchmark/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = BENCH_DIR / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module {path}")
    modname = f"benchmark_{kind}_{name.replace('.', '_')}"
    if modname in sys.modules:
        return sys.modules[modname]
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[modname]
        raise
    return mod


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def _reported(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(bench: dict, name: str) -> Cell:
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    wl = by_name[name]
    cfg = next(c for c in bench["configs"] if c["name"] == wl["config"])
    config = load_json(ROOT / cfg["file"])
    traffic = load_json(BENCH_DIR / "traffic" / f"{wl['traffic']}.json")
    cell = Cell(
        name=name,
        chips=wl["chips"],
        config=config,
        traffic=traffic,
        reference=load_module("reference", config["reference"]),
        entry=load_module("entries", traffic["entry"]),
    )
    for key, out in (("end_to_end", cell.end_to_end), ("per_layer", cell.per_layer)):
        for m in bench[key]:
            if _reported(m, name):
                out.append(Metric(m["name"], m["unit"], load_module("metrics", m["name"])))
    return cell
