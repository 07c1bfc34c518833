"""What one cell is made of, found by name.

`BENCHMARK.json` (at the root) names each cell's configuration and
traffic. The harness finds the rest as files of their own:

- the configuration: the file its entry names (`benchmark/configs/
  <name>.yaml`), holding the model's settings as run, its source, its
  cut and its `task` (the driver in `benchmark/harness/tasks/`);
- the traffic mix: `benchmark/traffic/<traffic>.json`, the parameters
  the task's generator reads;
- the limits of the comparison that decides `correct`:
  `benchmark/limits/<cell>.json`;
- each per-layer metric: `benchmark/metrics/<name>.py`, whose `read(ctx)`
  returns the value or None;
- FLOP and byte counts: `benchmark/counts/<name>.py`.

A cell, configuration, traffic mix or metric is added by adding files and
entries; no file of the harness names one.
"""
import importlib.util
import json
import os
from dataclasses import dataclass, field
from types import ModuleType
from typing import Any, Dict, List

import yaml

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, float]
    end_to_end: List[Dict[str, Any]] = field(default_factory=list)
    per_layer: List[Dict[str, Any]] = field(default_factory=list)
    root: str = ROOT


def _read_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def bench_dir(root: str) -> str:
    return os.path.join(root, "benchmark")


def load_cell(name: str, root: str = ROOT) -> Cell:
    spec = _read_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json; cells: {sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    with open(os.path.join(root, conf["file"])) as f:
        config = yaml.safe_load(f)
    traffic = _read_json(os.path.join(bench_dir(root), "traffic", f"{w['traffic']}.json"))
    limits = _read_json(os.path.join(bench_dir(root), "limits", f"{name}.json"))
    e2e = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if name in m.get("workloads", [name] if m["moves"] in reported else [])]
    return Cell(name, int(w["chips"]), config, traffic, limits, e2e, layer, root)


def load_module(kind: str, name: str, root: str = ROOT) -> ModuleType:
    """benchmark/<kind>/<name>.py, imported by its path (a metric's name may
    hold dots)."""
    path = os.path.join(bench_dir(root), kind, f"{name}.py")
    mod_spec = importlib.util.spec_from_file_location(f"benchmark_{kind}_{name}", path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module
