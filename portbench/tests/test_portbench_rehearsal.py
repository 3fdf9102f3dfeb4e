"""The harness's pieces rehearsed on the CPU at a tiny size (ViT depth 2,
64x64 frames, the kernels' plain versions): the result line's shape, the
traced run's stretch, the seeded inputs."""

import json
import math

import numpy as np
import pytest

from portbench import clips, harness, spec

from .helpers import tiny_cell, tiny_run

DEVICE_KEYS = {"platform", "kind", "count", "memory_peak_bytes"}
CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_result_line(name):
    cell = tiny_cell(name)
    res = tiny_run(cell)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
    for m in cell.end_to_end:
        v = res["metrics"][m["name"]]
        assert v["unit"] == m["unit"] and math.isfinite(v["value"]) and v["value"] > 0
    assert DEVICE_KEYS <= set(res["device"])
    assert set(res["checks"]) == set(cell.config["limits"])
    json.loads(json.dumps(res))


@pytest.mark.parametrize("in_flight", [2, 0])
def test_traced_run(in_flight):
    cell = tiny_cell("f32-konvid540-stream", in_flight=in_flight, trace_after=0.4, trace_videos=1)
    res = tiny_run(cell, trace=1, seconds=2.5)
    assert res["correct"] is True
    assert res["device"]["window_s"] > 0 and "busy_s" in res["device"]
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    # the CPU has no device operations: the readers of the device trace find nothing and say nothing
    assert set(res["metrics"]) <= {m["name"] for m in cell.per_layer}
    assert "host_enqueue_ms.stream" in res["metrics"] and "k1_roofline" not in res["metrics"]


def test_chunked_path_and_same_sizes_for_every_seed():
    cell = tiny_cell("bf16-qualcomm1080-stream", clip_seconds=10)  # 20 pairs: more than the 16 a flow call takes
    groups = cell.family.sample(cell.traffic)
    a, b = (clips.pool(cell.traffic, groups, s, "cpu") for s in (5, 2**31 + 7))
    frames = [c.groups["frames"].shape for c in a]
    assert frames == [c.groups["frames"].shape for c in b] == [(20, 64 * 64 * 3 // 2)] * 2
    assert not np.array_equal(a[0].groups["frames"], b[0].groups["frames"])
    assert np.array_equal(a[0].groups["nexts"], clips.pool(cell.traffic, groups, 5, "cpu")[0].groups["nexts"])
    res = tiny_run(cell, seconds=0.5)
    assert res["correct"] is True


def test_no_card_no_result(capsys):
    args = harness.parse(["--workload", "bf16-konvid540-stream", "--seed", "1", "--seconds", "1"])
    assert args.trace == 0
    assert harness.main(["--workload", "bf16-konvid540-stream", "--seed", "1", "--seconds", "1"], 0.0) != 0
    assert capsys.readouterr().out == ""
