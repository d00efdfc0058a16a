"""BENCHMARK.json and the files it names, found by name: a configuration is
`configs/<name>.json` (the file the manifest gives), a traffic mix
`traffic/<name>.json`, a cell's limits `limits/<cell>.json`, a per-layer
metric `metrics/<name>.py` with a `read(ctx)` that returns a number or
None, reported in the cells its `workloads` lists. Adding a cell, a mix or a metric adds files and edits none."""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional

PORTBENCH = Path(__file__).resolve().parents[1]
ROOT = PORTBENCH.parent


@dataclass(frozen=True)
class Cell:
    name: str
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    chips: int
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell(name: str, root: Path = ROOT, bench: Optional[dict] = None) -> Cell:
    bench = bench or manifest(root)
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are "
                       f"{[w['name'] for w in bench['workloads']]}")
    w = found[0]
    cfg_entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    # an end-to-end metric without a list of cells (setup_s) is every
    # cell's; a per-layer metric lists its cells
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    layer = [m for m in bench["per_layer"] if name in m["workloads"]]
    limits_path = root / "portbench" / "limits" / f"{name}.json"
    return Cell(name=name, config_name=w["config"], config=load_json(root / cfg_entry["file"]),
                traffic_name=w["traffic"],
                traffic=load_json(root / "portbench" / "traffic" / f"{w['traffic']}.json"),
                chips=w["chips"], limits=load_json(limits_path)["limits"],
                end_to_end=e2e, per_layer=layer)


def reader(metric: str, root: Path = ROOT) -> Callable:
    path = root / "portbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
