"""A cell by its name: its entry in BENCHMARK.json, its configuration file, its
traffic file, its driver and its per-layer metrics' readers, each found by the
name BENCHMARK.json gives it. Adding a cell, a configuration, a mix or a metric
adds files and entries; nothing here names one."""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent  # benchmark/


@dataclass
class Cell:
    name: str
    entry: dict          # the workload's entry
    config: dict         # configs/<config>.json, with its name
    traffic: dict        # traffic/<traffic>.json, with its name
    end_to_end: list     # the end-to-end metrics this cell reports
    per_layer: list      # the per-layer metrics this cell reports


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def reports(metric: dict, cell: str, e2e_names: set) -> bool:
    """Whether `cell` reports `metric`: its `workloads` list, else (a per-layer
    metric) every cell that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") in e2e_names if "moves" in metric else True


def load_cell(bench: dict, name: str, root: Path = HERE) -> Cell:
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")
    entry = entries[name]
    config = load_json(root / "configs" / f"{entry['config']}.json")
    config["name"] = entry["config"]
    traffic = load_json(root / "traffic" / f"{entry['traffic']}.json")
    traffic["name"] = entry["traffic"]
    e2e = [m for m in bench["end_to_end"] if reports(m, name, set())]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if reports(m, name, names)]
    return Cell(name, entry, config, traffic, e2e, layer)


def driver(kind: str, root: Path = HERE):
    """drivers/<kind>.py, the code of one kind of traffic."""
    return _module(root / "drivers" / f"{kind}.py", f"benchmark_driver_{kind}")


def reader(metric: str, root: Path = HERE):
    """metrics/<metric>.py: `read(obs) -> float | None`."""
    return _module(root / "metrics" / f"{metric}.py", "benchmark_metric_" + metric.replace(".", "_"))


def _module(path: Path, name: str):
    if not path.is_file():
        raise SystemExit(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
