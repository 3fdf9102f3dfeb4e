"""The FAST-VQA cell (``fastvqa-bf16-konvid540-stream``, family
``families/fastvqa.py``): its sampler and offsets, a CPU rehearsal of the
cell at a tiny size (a small Swin, 240x240 frames, the kernels' plain
versions), a fault the check must catch, and, on the card, the control.

    python3 -m pytest portbench/tests/test_portbench_fastvqa.py
    python3 -m pytest portbench/tests -m card     # on the card
"""

import copy
import json

import numpy as np
import pytest

from portbench import check, clips, control, spec

from .helpers import tiny_run

CELL = "fastvqa-bf16-konvid540-stream"


def tiny_fastvqa(**traffic) -> spec.Cell:
    """A small Swin (depths 2/2/2/2, width 32, windows (2, 7, 7)) on 240x240
    clips of 20 frames (the clips wrap around), two clips in the pool."""
    cell = spec.resolve(CELL)
    cell.config = copy.deepcopy(cell.config)
    cell.config["backbone"].update(depths=[2, 2, 2, 2], num_heads=[1, 2, 4, 8], embed_dim=32, window_size=[2, 7, 7])
    cell.config["backbone_dtype"] = "f32"
    cell.traffic = copy.deepcopy(cell.traffic)
    cell.traffic.update(dict(width=240, height=240, framerate=4, clip_seconds=5, pool=2, warmup_videos=1,
                             trace_videos=1, trace_after=0.0), **traffic)
    return cell


def test_sampler_and_offsets():
    cell = spec.resolve(CELL)
    groups = cell.family.sample(cell.traffic)
    assert list(groups) == ["clip0", "clip1", "clip2", "clip3"]
    assert [g[0] for g in groups.values()] == [16, 48, 80, 112] and all(len(g) == 32 for g in groups.values())
    assert len(set().union(*groups.values())) == 80
    tiny = tiny_fastvqa()
    pool = clips.pool(tiny.traffic, tiny.family.sample(tiny.traffic), 5, "cpu")
    a, b = (tiny.family.offsets(2**31 + 3, c) for c in pool)
    assert a.shape == (4, 7, 7, 2) and a.max() < 2 and not np.array_equal(a, b)
    assert np.array_equal(a, tiny.family.offsets(2**31 + 3, pool[0]))
    assert cell.family.swin_flops(32, **cell.family.model_kwargs(cell)) == pytest.approx(175.6e9, rel=1e-3)


def test_rehearsal_result_line_and_trace():
    cell = tiny_fastvqa()
    res = tiny_run(cell, seconds=1.0)
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["metrics"]) == {"videos_per_s", "setup_s"}
    assert set(res["checks"]) == {"head_map", "feat", "score"}
    assert all(v["value"] < 1e-4 for v in res["checks"].values()), res["checks"]  # f32 against f32
    json.loads(json.dumps(res))
    res = tiny_run(cell, seconds=1.5, trace=1)
    assert res["correct"] is True
    # the CPU has no device operations: only the host's readers say something
    assert set(res["metrics"]) <= {m["name"] for m in cell.per_layer}
    assert "mfu" in res["metrics"] and "k4_roofline" not in res["metrics"]


def test_an_altered_answer_is_caught(monkeypatch):
    cell = tiny_fastvqa()
    finish = cell.family.Program.finish
    off = 2 * cell.config["limits"]["score"]

    def altered(self, handle):
        vec, score = finish(self, handle)
        return vec, score + off

    monkeypatch.setattr(cell.family.Program, "finish", altered)
    res = tiny_run(cell, seconds=0.5)
    assert res["correct"] is False and res["checks"]["score"]["value"] > cell.config["limits"]["score"]


@pytest.mark.card
def test_fastvqa_control_fails_and_program_passes(card):
    """At the cell's own sizes with a pool of two clips: the bf16 program
    passes the check, the fp8 control fails it."""
    cell = spec.resolve(CELL)
    cell.traffic = dict(cell.traffic, pool=2)
    r = control.readings(cell, 2**31 + 11, "cuda")
    limits = cell.config["limits"]
    assert check.judge(r["lower"], limits)[0], r["lower"]
    assert not check.judge(r["control"], limits)[0], r["control"]
