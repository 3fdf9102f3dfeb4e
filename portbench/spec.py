"""Find a cell's pieces by name: ``BENCHMARK.json`` at the checkout's root
names the cell's configuration and traffic; each lives in a file of its own
(``configs/<name>.json``, ``traffic/<name>.json``), and each per-layer
metric in ``metrics/<name>.py``.  A later change adds a configuration, a
traffic mix or a metric as new files and new entries, and edits nothing
here."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # the checkout


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list  # metric entries of BENCHMARK.json that this cell reports
    per_layer: list


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(name: str, bench: dict | None = None, root: str = ROOT) -> Cell:
    """The cell ``name`` with its configuration and traffic files read."""
    bench = bench or load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(os.path.join(root, configs[w["config"]]["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, "portbench", "traffic", f"{w['traffic']}.json")) as f:
        traffic = json.load(f)
    return Cell(name, w["chips"], config, traffic,
                [m for m in bench["end_to_end"] if _reports(m, name)],
                [m for m in bench["per_layer"] if _reports(m, name)])


def metric_module(name: str, root: str = ROOT):
    """``metrics/<name>.py``: its ``read(ctx)``, and what it instruments (``trace.Instruments``)."""
    path = os.path.join(root, "portbench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
