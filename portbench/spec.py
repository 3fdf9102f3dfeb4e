"""Find a cell's pieces by name: ``BENCHMARK.json`` at the checkout's root
names the cell's configuration and traffic; each lives in a file of its own
(``configs/<name>.json``, ``traffic/<name>.json``), and each per-layer
metric in ``metrics/<name>.py``.  A configuration's ``"family"`` names the
module of its model family, ``families/<name>.py`` (``"relaxvqa"`` where
the key is absent): everything of the cell that knows the model
(``family_module``).  A later change adds a configuration of any family, a
traffic mix or a metric as new files and new entries, and edits nothing
here."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # the checkout
DEFAULT_FAMILY = "relaxvqa"


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list  # metric entries of BENCHMARK.json that this cell reports
    per_layer: list
    family: object  # the configuration's families/<name>.py module


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
                [m for m in bench["per_layer"] if _reports(m, name)],
                family_module(config.get("family", DEFAULT_FAMILY), root))


def _load(kind: str, name: str, root: str):
    path = os.path.join(root, "portbench", kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_module(name: str, root: str = ROOT):
    """``metrics/<name>.py``: its ``read(ctx)``, and what it instruments (``trace.Instruments``)."""
    return _load("metrics", name, root)


def family_module(name: str, root: str = ROOT):
    """``families/<name>.py``, the model family a configuration's ``"family"``
    names.  It supplies, each taking the cell first where it takes one:

    - ``sample(traffic)``: {group: raw frame indices}, the frames of a clip
      grouped as the program takes them (``clips.pool`` makes them);
    - ``build(cell, seed, device)`` -> (program, states): the program under
      test, with ``enqueue(clip)`` -> a device handle and ``finish(handle)``
      -> (host vector, score), and the seeded states the reference gets too;
      the attributes that metrics' ``HOOKS`` name are the program's;
    - ``references(cell, states, pool, device, precision="f32")`` -> {clip
      index: the plain reference's answer}, in the configuration's
      ``control_precision`` for the control (``control.py``);
    - ``gaps(cell, vec, score, ref)`` -> {number: reading}, one answer
      against its clip's reference, the numbers of the configuration's
      ``limits``; ``served(cell, ref)`` -> (vector, score): the reference's
      answer as the program serves one;
    - ``video_flops(cell, clip)`` and ``peak_flops(cell)``, which ``mfu``
      divides;
    - ``launch_counts()`` -> {name: count}, the program's launch counters
      that a traced stretch reports;
    - ``notes(cell, refs)`` -> further fields of ``control.py``'s readings.
    """
    folder = os.path.join(root, "portbench", "families")
    present = sorted(f[:-3] for f in os.listdir(folder) if f.endswith(".py"))
    if name not in present:
        raise KeyError(f"no model family {name!r} (portbench/families/{name}.py); there are {present}")
    return _load("families", name, root)
