"""The readers of the program's spans (``portbench/spans.py`` and the
metrics that read it): exact values on a hand-built trace, nothing from the
device-trace readers on the CPU, every new metric resolved for its cells."""

import pytest

from portbench import harness, spans, spec
from portbench.trace import DeviceOp, Trace

from .helpers import tiny_cell, tiny_run

US = 1000  # ns
STAGE_METRICS = [f"stage_device_ms.{s}" for s in spans.STAGES]
NEW = STAGE_METRICS + ["launches_per_video", "upload_host_ms", "enqueue_idle.stream", "enqueue_idle.single"]


def hand_trace(with_spans: bool = True, with_ops: bool = True) -> Trace:
    """A 1,000 us stretch.  Host: relaxtpu.enqueue 100-600 holding upload
    110-200 and fragments 250-500, which holds flow 300-400; five launch
    calls inside the enqueue (one of them, at 330, lost its device record)
    and one outside.  Device: work of an earlier video 0-300, then the copy
    launched in upload, a kernel launched in flow, one in fragments, one in
    the enqueue alone and one outside the program; idle 520-560 (the host
    inside the enqueue) and 900-1000 (outside)."""
    host = [(0, 1000, "portbench.stretch")]
    if with_spans:
        host += [(100, 600, "relaxtpu.enqueue"), (110, 200, "relaxtpu.upload"),
                 (250, 500, "relaxtpu.fragments"), (300, 400, "relaxtpu.flow")]
    host += [(150, 155, "cudaMemcpyAsync"), (260, 265, "cudaLaunchKernel"), (320, 325, "cudaLaunchKernel"),
             (330, 335, "cudaLaunchKernel"), (550, 555, "cudaLaunchKernel"), (650, 655, "cudaLaunchKernel"),
             (340, 341, "cudaStreamSynchronize"), (560, 561, "aten::add")]
    host = sorted((s * US, e * US, n) for s, e, n in host)
    ops = [DeviceOp("earlier", 0, 300, None), DeviceOp("Memcpy HtoD", 300, 450, 150),
           DeviceOp("flow_kernel", 450, 500, 320), DeviceOp("fragment_kernel", 500, 520, 260),
           DeviceOp("remainder_kernel", 560, 700, 550), DeviceOp("outside_kernel", 700, 900, 650)]
    ops = [DeviceOp(o.name, o.start * US, o.end * US, None if o.launched is None else o.launched * US)
           for o in ops] if with_ops else []
    return Trace(ops, {"portbench.stretch": [(0, 1000 * US)]}, host, 0, 1000 * US)


def context(trace: Trace, videos: int) -> harness.Context:
    return harness.Context({}, {}, 0.0, 1.0, [], trace=trace, stretch_videos=videos)


def read(name: str, ctx):
    return spec.metric_module(name).read(ctx)


@pytest.mark.parametrize("videos", [1, 2])
def test_readers_on_a_hand_built_trace(videos, capsys):
    ctx = context(hand_trace(), videos)
    ms = 1e-3 / videos  # us -> ms a video
    # self attribution: each operation to the innermost span that held its launch
    want = {"upload": 150 * ms, "flow": 50 * ms, "fragments": 20 * ms}
    for stage in spans.STAGES:
        assert read(f"stage_device_ms.{stage}", ctx) == (pytest.approx(want[stage]) if stage in want else None)
    assert read("launches_per_video", ctx) == pytest.approx(4 / videos)  # the outside kernel is not counted
    assert read("upload_host_ms", ctx) == pytest.approx(90 * ms)
    for kind in ("stream", "single"):
        assert read(f"enqueue_idle.{kind}", ctx) == pytest.approx(4.0)  # 40 of 1,000 us
        assert read(f"enqueue_idle.{kind}", ctx) <= read(f"device_idle.{kind}", ctx) == pytest.approx(14.0)
    sp = spans.summary(ctx)
    assert sp.device_ms["enqueue"] == pytest.approx(140 * ms)  # the remainder
    assert sp.coverage() == pytest.approx(220 / 360)
    assert sp.host_self_ms == pytest.approx({"enqueue": 160 * ms, "upload": 90 * ms, "fragments": 150 * ms,
                                             "flow": 100 * ms})
    assert sp.idle_s == pytest.approx({"enqueue": 40e-6, "outside": 100e-6})
    assert (sp.in_enqueue_calls, sp.in_enqueue_launches) == (5, 4)
    assert sp.dropped == [("cudaLaunchKernel", pytest.approx(0.670))]
    err = capsys.readouterr().err
    assert err.count("relaxtpu.enqueue ranges in the stretch") == 1, "reported once a run"
    assert ("MISMATCH" in err) == (videos != 1)
    assert "1 calls without a record (dropped); cudaLaunchKernel 0.670 ms before the stretch's end" in err


def test_innermost_span_at_boundaries():
    ranges = [(0, 10, "a"), (2, 5, "b"), (3, 4, "c"), (6, 8, "d")]
    assert spans._innermost(ranges, [-1, 0, 2, 3.5, 4.5, 5.5, 7, 10, 11]) == [-1, 0, 1, 2, 1, 0, 3, 0, -1]


@pytest.mark.parametrize("with_spans,with_ops", [(False, True), (True, False)], ids=["no_spans", "no_device_ops"])
def test_readers_say_nothing_without_what_they_read(with_spans, with_ops):
    """A program without spans (an older commit) gives no value; without device
    operations (the CPU) only the host reader gives one."""
    ctx = context(hand_trace(with_spans, with_ops), 1)
    got = {name: read(name, ctx) for name in NEW}
    if with_spans:
        assert {k for k, v in got.items() if v is not None} == {"upload_host_ms"}
    else:
        assert all(v is None for v in got.values())
    assert all(read(name, context(None, 0)) is None for name in NEW)


def test_traced_cpu_rehearsal_reports_the_host_reader_only(capfd):
    cell = tiny_cell("f32-konvid540-stream", trace_after=0.4, trace_videos=1)
    res = tiny_run(cell, trace=1, seconds=2.5)
    assert res["correct"] is True
    got = set(res["metrics"]) & set(NEW)
    assert got == {"upload_host_ms"} and res["metrics"]["upload_host_ms"]["value"] > 0
    err = capfd.readouterr().err
    assert "relaxtpu.enqueue ranges in the stretch" in err and "MISMATCH" not in err


@pytest.mark.parametrize("name", NEW)
def test_every_new_metric_resolves_for_its_cells(name):
    entry = next(m for m in spec.load_benchmark()["per_layer"] if m["name"] == name)
    assert entry["source"] == "program_span" and entry["workloads"]
    mod = spec.metric_module(name)
    assert callable(mod.read) and not hasattr(mod, "CALLS") and not hasattr(mod, "HOOKS"), "instruments nothing"
    for cell in entry["workloads"]:
        assert name in [m["name"] for m in spec.resolve(cell).per_layer]
