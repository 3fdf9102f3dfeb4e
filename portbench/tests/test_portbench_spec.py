"""Every cell of BENCHMARK.json resolves to its configuration, traffic and
metric files, and a new configuration, traffic mix or metric needs only new
files and new entries."""

import json
import os
import shutil

import pytest

from portbench import spec

from .helpers import ROOT

BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_to_its_files(name):
    cell = spec.resolve(name)
    entry = next(w for w in BENCH["workloads"] if w["name"] == name)
    assert cell.config["name"] == entry["config"]
    assert cell.traffic["name"] == entry["traffic"]
    assert cell.config["reduced"] == next(c for c in BENCH["configs"] if c["name"] == entry["config"])["reduced"]
    assert set(cell.config["limits"]) == {"frame_resnet", "frame_vit", "ori_resnet", "merged_pool", "ori_vit",
                                          "merged_vit", "mos"}
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2, names
    assert cell.per_layer, "every cell reports a per-layer metric"
    for m in cell.end_to_end + cell.per_layer:
        assert callable(spec.metric_module(m["name"]).read), m["name"]


def test_benchmark_names_and_paths():
    assert BENCH["paths"] == ["portbench"] and BENCH["command"] == ["python3", "portbench/run.py"]
    for c in BENCH["configs"]:
        assert c["file"].startswith("portbench/configs/") and os.path.exists(os.path.join(ROOT, c["file"]))
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        for w in m.get("workloads", []):
            moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
            assert w in moved.get("workloads", CELLS), (m["name"], w)


def test_a_new_cell_needs_only_new_files_and_entries(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*") if p.is_file()}
    cfg = json.loads((root / "portbench/configs/relaxvqa-bf16.json").read_text())
    cfg["name"] = "relaxvqa-bf16-copy"
    (root / "portbench/configs/relaxvqa-bf16-copy.json").write_text(json.dumps(cfg))
    traffic = json.loads((root / "portbench/traffic/konvid540-stream.json").read_text())
    traffic.update(name="ugc360-stream", width=640, height=360, clip_seconds=20)
    (root / "portbench/traffic/ugc360-stream.json").write_text(json.dumps(traffic))
    (root / "portbench/metrics/new_metric.py").write_text("def read(ctx):\n    return 1.5\n")
    bench["configs"].append(dict(bench["configs"][0], name="relaxvqa-bf16-copy",
                                 file="portbench/configs/relaxvqa-bf16-copy.json"))
    bench["workloads"].append({"name": "new-cell", "config": "relaxvqa-bf16-copy", "traffic": "ugc360-stream",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "new_metric", "unit": "ms", "better": "lower", "source": "program_span",
                               "layer": "x", "moves": "videos_per_s", "workloads": ["new-cell"]})
    bench["end_to_end"][0]["workloads"].append("new-cell")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.resolve("new-cell", root=str(root))
    assert cell.traffic["width"] == 640 and cell.config["name"] == "relaxvqa-bf16-copy"
    assert "new_metric" in [m["name"] for m in cell.per_layer]
    assert spec.metric_module("new_metric", root=str(root)).read(None) == 1.5
    assert all(p.read_bytes() == b for p, b in before.items()), "no file that was there changed"
