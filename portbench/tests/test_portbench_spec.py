"""Every cell of BENCHMARK.json resolves to its configuration, traffic and
metric files, and a new configuration, traffic mix or metric needs only new
files and new entries."""

import json
import os
import shutil

import pytest

from portbench import clips, counts, spec

from .helpers import ROOT, tiny_run

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


TOY_FAMILY = '''"""A toy family: every second frame (no successors) through one 3D convolution,
its mean a channel the vector, a linear layer the score; the reference the
same arithmetic in float64."""

import math

import numpy as np
import torch
import torch.nn.functional as F

from portbench import clips, counts, weights

SHAPES = [("conv.weight", (4, 1, 3, 3, 3), "conv"), ("conv.bias", (4,), "linear"),
          ("fc.weight", (1, 4), "linear"), ("fc.bias", (1,), "linear")]


def sample(traffic):
    return {"run": list(range(0, clips.n_frames(traffic), 2))}


def _luma(clip, dtype):
    y = clip.groups["run"][:, :clip.h * clip.w].reshape(-1, clip.h, clip.w)
    return torch.from_numpy(y.astype(np.float64) / 255.0).to(dtype)[None, None]


class Program:
    def __init__(self, w):
        self.conv = torch.nn.Conv3d(1, 4, 3, padding=1)
        self.fc = torch.nn.Linear(4, 1)
        self.conv.load_state_dict({"weight": w["conv.weight"], "bias": w["conv.bias"]})
        self.fc.load_state_dict({"weight": w["fc.weight"], "bias": w["fc.bias"]})

    @torch.no_grad()
    def enqueue(self, clip):
        return self.conv(_luma(clip, torch.float32)).mean(dim=(2, 3, 4))[0]

    @torch.no_grad()
    def finish(self, feat):
        return feat.numpy(), float(self.fc(feat)[0])


def build(cell, seed, device):
    w = weights.draw(SHAPES, weights.sub_seed(seed, "head"), torch.float32, device)
    return Program(w), w


def references(cell, states, pool, device, precision="f32"):
    w = {k: v.to(torch.float64) for k, v in states.items()}
    out = {}
    for i, clip in enumerate(pool):
        feat = F.conv3d(_luma(clip, torch.float64), w["conv.weight"], w["conv.bias"], padding=1).mean(dim=(2, 3, 4))[0]
        out[i] = (feat.numpy(), float(feat @ w["fc.weight"][0] + w["fc.bias"][0]))
    return out


def gaps(cell, vec, score, ref):
    rel = float(np.linalg.norm(vec - ref[0]) / np.linalg.norm(ref[0]))
    d = abs(score - ref[1])
    return {"features": rel if math.isfinite(rel) else math.inf, "score": d if math.isfinite(d) else math.inf}


def served(cell, ref):
    return ref


def video_flops(cell, clip):
    return 2.0 * 27 * 4 * len(clip.groups["run"]) * clip.h * clip.w


def peak_flops(cell):
    return counts.PEAK_FLOPS["f32"]


def launch_counts():
    return {}


def notes(cell, refs):
    return {}
'''


def _checkout(tmp_path):
    """A copy of the benchmark's files -> (root, BENCHMARK.json's entries, every file's bytes)."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*") if p.is_file()}
    return root, json.loads(json.dumps(BENCH)), before


def test_a_new_cell_needs_only_new_files_and_entries(tmp_path, monkeypatch):
    root, bench, before = _checkout(tmp_path)
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

    # a second family: its own sampler, program, reference, numbers and limits
    (root / "portbench/families/toy.py").write_text(TOY_FAMILY)
    (root / "portbench/configs/toy-conv3d.json").write_text(json.dumps(
        {"name": "toy-conv3d", "family": "toy", "reduced": [],
         "limits": {"features": 1e-5, "score": 1e-5}}))
    traffic.update(name="toy-run", width=32, height=32, framerate=4, clip_seconds=2, pool=2, warmup_videos=1,
                   trace_after=0.0, trace_videos=2)
    (root / "portbench/traffic/toy-run.json").write_text(json.dumps(traffic))
    bench["configs"].append({"name": "toy-conv3d", "source": "https://arxiv.org/abs/2207.02595",
                             "file": "portbench/configs/toy-conv3d.json", "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "toy-cell", "config": "toy-conv3d", "traffic": "toy-run", "chips": 1,
                               "why": "a test"})
    bench["end_to_end"][0]["workloads"].append("toy-cell")
    next(m for m in bench["per_layer"] if m["name"] == "mfu")["workloads"].append("toy-cell")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.resolve("new-cell", root=str(root))
    assert cell.traffic["width"] == 640 and cell.config["name"] == "relaxvqa-bf16-copy"
    assert cell.family.__file__ == str(root / "portbench/families/relaxvqa.py")
    assert "new_metric" in [m["name"] for m in cell.per_layer]
    assert spec.metric_module("new_metric", root=str(root)).read(None) == 1.5

    toy = spec.resolve("toy-cell", root=str(root))
    assert toy.family.__file__ == str(root / "portbench/families/toy.py")
    assert [m["name"] for m in toy.end_to_end] == ["videos_per_s", "setup_s"]
    assert [m["name"] for m in toy.per_layer] == ["mfu"]
    res = tiny_run(toy, seconds=1.0, trace=1)
    assert res["correct"] is True and res["failed"] == 0, res["checks"]
    assert set(res["checks"]) == {"features", "score"}
    assert set(res["metrics"]) == {"mfu"}
    # mfu's operations are the family's: 100 x videos x flops / window / peak, a whole number of videos
    clip = clips.pool(toy.traffic, toy.family.sample(toy.traffic), 1, "cpu")[0]
    assert clip.groups["run"].shape == (4, 32 * 32 * 3 // 2)
    videos = (res["metrics"]["mfu"]["value"] / 100 * res["device"]["window_s"] * counts.PEAK_FLOPS["f32"]
              / toy.family.video_flops(toy, clip))
    assert videos == pytest.approx(round(videos), rel=1e-9) and round(videos) >= 1

    finish = toy.family.Program.finish
    monkeypatch.setattr(toy.family.Program, "finish", lambda self, feat: (finish(self, feat)[0],
                                                                          finish(self, feat)[1] + 1e-3))
    res = tiny_run(toy, seconds=0.5)
    assert res["correct"] is False and res["checks"]["score"]["value"] > 1e-5
    assert all(p.read_bytes() == b for p, b in before.items()), "no file that was there changed"


def test_a_config_without_family_is_relaxvqa():
    for name in CELLS:
        cell = spec.resolve(name)
        assert "family" not in cell.config
        assert cell.family.__file__ == os.path.join(ROOT, "portbench", "families", "relaxvqa.py")


def test_an_unknown_family_names_the_families(tmp_path):
    root, bench, _ = _checkout(tmp_path)
    cfg = json.loads((root / "portbench/configs/relaxvqa-f32.json").read_text())
    (root / "portbench/configs/relaxvqa-f32.json").write_text(json.dumps(dict(cfg, family="swin3d")))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    with pytest.raises(KeyError, match=r"'swin3d'.*\['relaxvqa'\]"):
        spec.resolve("f32-konvid540-stream", root=str(root))
