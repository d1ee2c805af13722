"""What a cell is made of, found by name from ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
Each piece is a file of its own, so that a later change adds a cell by
adding files and entries and edits none that are there:

- the configuration: the ``file`` its entry in ``configs`` names;
- the traffic mix: ``port_bench/traffic/<traffic>.json``;
- the limits of the correctness check: ``port_bench/limits/<cell>.json``;
- every metric, end to end or per layer: ``port_bench/metrics/<name>.py``,
  whose ``read(facts)`` returns the number, or None where it finds nothing.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list = field(default_factory=list)  # metric entries
    per_layer: list = field(default_factory=list)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def reports(metric: dict, cell: str) -> bool:
    """Whether ``cell`` reports ``metric``: it is listed under the metric's
    ``workloads``, or the metric lists none."""
    return cell in metric.get("workloads", (cell,))


def load_cell(name: str, bench: dict | None = None, root: Path = ROOT) -> Cell:
    bench = bench if bench is not None else load_json(root / "BENCHMARK.json")
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(work)}")
    w = work[name]
    centry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = dict(load_json(root / centry["file"]), name=w["config"])
    traffic = load_json(root / "port_bench" / "traffic" / f"{w['traffic']}.json")
    limits_file = root / "port_bench" / "limits" / f"{name}.json"
    limits = load_json(limits_file)["limits"] if limits_file.exists() else {}
    e2e = [m for m in bench["end_to_end"] if reports(m, name)]
    layer = [m for m in bench["per_layer"] if reports(m, name)]
    return Cell(name, w["chips"], config, traffic, limits, e2e, layer)


def reader(metric: str, root: Path = ROOT):
    """The ``read`` function of ``port_bench/metrics/<metric>.py``."""
    path = root / "port_bench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"port_bench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(entries: list, facts: dict, root: Path = ROOT) -> dict:
    """{name: {value, unit}} of each metric whose reader finds a number."""
    out = {}
    for m in entries:
        value = reader(m["name"], root)(facts)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
