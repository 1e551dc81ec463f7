"""Find a cell's parts by name.

``BENCHMARK.json`` names each cell's configuration and traffic mix, and each
metric.  Every part is a file of its own under this folder:

* the configuration's ``file`` (``configs/<config>.json``): the deployment's
  sizes, its guarantees and the limits of the comparison; its ``kind`` names
  ``generators/<kind>.py`` (which makes the operator on the card) and
  ``reference/<kind>.py`` (the plain operator the reference rebuilds from the
  same data);
* ``traffic/<traffic>.json``: the parameters of the one generator in
  :mod:`bench_h100.harness`; its ``route`` names ``routes/<route>.json``, the
  launch counters that show which engine a call took;
* ``metrics/<metric>.py``: one reader a metric, with its layer, unit and
  source.  A metric is reported in the cells its ``workloads`` lists, and an
  end-to-end metric without that key in every cell.  A quantity split by
  cells, so that each part has its own bound (``solve_ms`` and
  ``solve_ms.history``), is read by the one reader of its first part.

A later cell, mix or metric is new files and a new entry in ``BENCHMARK.json``;
no file here needs an edit for it.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: Path, name: str) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(f"bench_h100: no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark(repo: Path = REPO) -> dict:
    return load_json(repo / "BENCHMARK.json")


def traffic(name: str) -> dict:
    return load_json(ROOT / "traffic" / f"{name}.json")


def route(name: str) -> dict:
    return load_json(ROOT / "routes" / f"{name}.json")


def generator(kind: str) -> ModuleType:
    return _module(ROOT / "generators" / f"{kind}.py",
                   f"bench_h100.generators.{kind}")


def reference(kind: str) -> ModuleType:
    return _module(ROOT / "reference" / f"{kind}.py",
                   f"bench_h100.reference.{kind}")


def metric(name: str) -> ModuleType:
    """The reader of metric ``name``: ``metrics/<name>.py``, or for a name
    split by cells (``solve_ms.history``), the reader of the part before
    the first dot."""
    path = ROOT / "metrics" / f"{name}.py"
    base = name if path.is_file() else name.split(".")[0]
    return _module(ROOT / "metrics" / f"{base}.py",
                   f"bench_h100.metrics.{base}")


@dataclass(frozen=True)
class Cell:
    """One workload of ``BENCHMARK.json`` with its parts loaded."""

    name: str
    chips: int
    config: dict
    traffic: dict
    route: dict
    end_to_end: tuple   # ((spec, module), ...) in BENCHMARK.json's order
    per_layer: tuple    # ((spec, module), ...) reported in this cell


def config(name: str, bench: dict | None = None) -> dict:
    """The configuration ``name`` from the ``file`` BENCHMARK.json gives it."""
    bench = benchmark() if bench is None else bench
    by_name = {c["name"]: c for c in bench["configs"]}
    if name not in by_name:
        raise KeyError(f"bench_h100: no configuration {name!r} in "
                       f"BENCHMARK.json")
    return load_json(REPO / by_name[name]["file"])


def cell(name: str, bench: dict | None = None) -> Cell:
    bench = benchmark() if bench is None else bench
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"bench_h100: no workload {name!r} in BENCHMARK.json "
                       f"(have {', '.join(sorted(by_name))})")
    w = by_name[name]
    cfg = config(w["config"], bench)
    tr = traffic(w["traffic"])
    e2e = tuple((m, metric(m["name"])) for m in bench["end_to_end"]
                if "workloads" not in m or name in m["workloads"])
    layer = tuple((m, metric(m["name"])) for m in bench["per_layer"]
                  if name in m["workloads"])
    return Cell(name=name, chips=int(w["chips"]), config=cfg, traffic=tr,
                route=route(tr["route"]), end_to_end=e2e, per_layer=layer)
