"""Finds everything a cell needs by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix. The configuration's file is the one ``BENCHMARK.json`` gives; the
traffic mix is ``traffic/<traffic>.json``. A metric is
``metrics/<name>.py``, a module with ``read(run) -> float | None``;
where that file is missing, the reader of the name's part before its
first dot, so that ``pack_us_per_pod.burst`` and
``pack_us_per_pod.tail``, one quantity read in cells that move different
end-to-end metrics, share ``metrics/pack_us_per_pod.py``. A later cell,
configuration or metric is new files and new entries, never an edit.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
PKG_NAME = os.path.basename(PKG_DIR)
ROOT = os.path.dirname(PKG_DIR)


class SpecError(RuntimeError):
    """The benchmark's description does not hold what a run needs."""


@dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    better: str
    source: str
    workloads: Optional[tuple]
    bound: Optional[float]

    def applies_to(self, cell: str) -> bool:
        return self.workloads is None or cell in self.workloads


@dataclass(frozen=True)
class Cell:
    name: str
    config_name: str
    config: Dict[str, Any]
    traffic_name: str
    traffic: Dict[str, Any]
    chips: int
    root: str
    end_to_end: List[Metric]
    per_layer: List[Metric]


def _load_json(path: str) -> Any:
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError as e:
        raise SpecError(f"missing {os.path.relpath(path, ROOT)}") from e


def load_benchmark(root: str = ROOT) -> Dict[str, Any]:
    return _load_json(os.path.join(root, "BENCHMARK.json"))


def _metrics(bench: Dict[str, Any], kind: str) -> List[Metric]:
    out = []
    for m in bench.get(kind, []):
        wl = m.get("workloads")
        out.append(Metric(
            name=m["name"], unit=m["unit"], better=m["better"],
            source=m["source"],
            workloads=tuple(wl) if wl is not None else None,
            bound=m.get("bound"),
        ))
    return out


def load_cell(name: str, root: str = ROOT, bench: Optional[dict] = None) -> Cell:
    """The cell ``name`` with its configuration, traffic and metrics."""
    bench = bench if bench is not None else load_benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SpecError(f"no workload named {name!r} in BENCHMARK.json")
    cfg_entry = next(
        (c for c in bench["configs"] if c["name"] == entry["config"]), None)
    if cfg_entry is None:
        raise SpecError(f"no configuration named {entry['config']!r}")
    config = _load_json(os.path.join(root, cfg_entry["file"]))
    pkg = os.path.join(root, PKG_NAME)
    traffic = dict(_load_json(
        os.path.join(pkg, "traffic", f"{entry['traffic']}.json")))
    e2e = [m for m in _metrics(bench, "end_to_end") if m.applies_to(name)]
    layer = [m for m in _metrics(bench, "per_layer") if m.applies_to(name)]
    return Cell(
        name=name, config_name=entry["config"], config=config,
        traffic_name=entry["traffic"], traffic=traffic,
        chips=int(entry["chips"]), root=root, end_to_end=e2e,
        per_layer=layer,
    )


def load_reader(metric: str, root: str = ROOT):
    """The ``read`` function of ``metrics/<metric>.py``, or else of
    ``metrics/<stem>.py``, the stem being the name before its first dot."""
    for name in (metric, metric.split(".", 1)[0]):
        path = os.path.join(root, PKG_NAME, "metrics", f"{name}.py")
        if os.path.exists(path):
            break
    else:
        raise SpecError(f"no reader for metric {metric!r}")
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name.replace('.', '__')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
