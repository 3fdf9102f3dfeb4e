"""The serving programs' spans (``relaxtpu_torch.utils.profiling.span``):
the tree each program records under a profiler, nothing recorded without
one, the same vector either way, and the call sites the benchmark's
instruments patch left where they look them up.

Small size: 64x64, 4 frames + 4 pairs, a depth-2 ViT, f32, on the CPU.
"""

import json

import numpy as np
import pytest
import torch

import relaxtpu_torch.features.pipeline as pipeline
from relaxtpu_torch.features.pipeline import FLOW_LIVE_PLANES, FeatureExtractor
from relaxtpu_torch.models.initutil import random_init_
from relaxtpu_torch.models.resnet import ResNet50
from relaxtpu_torch.models.vit import ViT
from relaxtpu_torch.ops.colorspace import unpack_i420, yuv420_to_bgr
from relaxtpu_torch.utils import profiling

H = W = 64
N_FRAMES = N_PAIRS = 4


@pytest.fixture(scope="module")
def fx():
    return FeatureExtractor(random_init_(ResNet50(), 0).state_dict(), random_init_(ViT(depth=2), 1).state_dict(),
                            dtype=torch.float32, vit_depth=2, device="cpu")


@pytest.fixture(scope="module")
def clip():
    rng = np.random.default_rng(7)
    frames = rng.integers(0, 256, (N_FRAMES, H * W * 3 // 2), dtype=np.uint8)
    nexts = rng.integers(0, 256, (N_PAIRS, H * W * 3 // 2), dtype=np.uint8)
    return frames, nexts


def bgr(i420: np.ndarray) -> np.ndarray:
    return yuv420_to_bgr(*unpack_i420(torch.from_numpy(i420), H, W)).numpy()


@pytest.fixture
def two_chunks(fx, monkeypatch):
    """A flow budget of two pairs at 64x64: four pairs take the chunked path."""
    monkeypatch.setattr(fx, "flow_budget", 2 * H * W * 4 * FLOW_LIVE_PLANES)
    assert fx.max_pair_batch(H, W) == 2


def span_tree(prof) -> str:
    """The profiler's ``relaxtpu.*`` ranges as a nested string,
    ``name(child child ...)``, children in the order they opened."""
    events = sorted(((e.time_range.start, -e.time_range.end, e.name[len("relaxtpu."):])
                     for e in prof.events() if e.name.startswith("relaxtpu.")))
    root = {"name": "", "children": []}
    stack = [(float("inf"), root)]
    for start, neg_end, name in events:
        while stack[-1][0] <= start:
            stack.pop()
        node = {"name": name, "children": []}
        stack[-1][1]["children"].append(node)
        stack.append((-neg_end, node))

    def text(node):
        inner = " ".join(text(c) for c in node["children"])
        return f"{node['name']}({inner})" if inner else node["name"]
    return " ".join(text(c) for c in root["children"])


def profiled(run):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = run()
    return out, span_tree(prof)


ONE_VIDEO = "upload upload colorspace colorspace fragments(flow) prep prep resnet aggregate vit aggregate"
CHUNK = "colorspace fragments(flow) prep resnet aggregate vit aggregate"
PROGRAMS = {
    "i420": (lambda fx, f, n: fx.video_feature_async_i420(f, n, H, W), f"enqueue({ONE_VIDEO})"),
    "bgr": (lambda fx, f, n: fx.video_feature_async(bgr(f), bgr(f), bgr(n)),
            "enqueue(upload upload upload fragments(flow) prep prep resnet aggregate vit aggregate)"),
    "batch": (lambda fx, f, n: fx.video_features_batch_i420([f[:2], f[2:]], [n[:2], n[2:]], H, W),
              f"enqueue({ONE_VIDEO})"),
    "frames_dev": (lambda fx, f, n: fx.frame_features_dev(torch.from_numpy(bgr(f))),
                   "enqueue(prep resnet aggregate vit)"),
    "pairs_dev": (lambda fx, f, n: fx.pair_features_dev(torch.from_numpy(bgr(f)), torch.from_numpy(bgr(n))),
                  "enqueue(fragments(flow) prep resnet aggregate vit aggregate aggregate)"),
}


@pytest.mark.parametrize("program", list(PROGRAMS))
def test_each_program_records_one_root_holding_its_stages(fx, clip, program):
    run, want = PROGRAMS[program]
    _, tree = profiled(lambda: run(fx, *clip))
    assert tree == want


def test_chunked_path_records_one_fragments_and_backbone_pair_a_chunk(fx, clip, two_chunks):
    _, tree = profiled(lambda: fx.video_feature_async_i420(*clip, H, W))
    frames = "prep resnet aggregate vit"
    assert tree == f"enqueue(upload upload colorspace {frames} {CHUNK} {CHUNK} aggregate)"


@pytest.mark.parametrize("chunked", [False, True], ids=["one_chunk", "two_chunks"])
def test_vector_identical_with_and_without_profiler(fx, clip, chunked, request):
    if chunked:
        request.getfixturevalue("two_chunks")
    plain = fx.video_feature_async_i420(*clip, H, W)
    traced, _ = profiled(lambda: fx.video_feature_async_i420(*clip, H, W))
    assert plain.shape == (35203,)
    np.testing.assert_array_equal(plain.numpy(), traced.numpy())


def test_without_profiler_no_range_is_opened(fx, clip, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) opened with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert profiling.span("enqueue") is profiling.span("flow")
    fx.video_feature_async_i420(*clip, H, W)


@pytest.mark.parametrize("chunked", [False, True], ids=["one_chunk", "two_chunks"])
@pytest.mark.parametrize("traced", [False, True], ids=["untraced", "traced"])
def test_flow_calls_go_through_the_module_global(fx, clip, monkeypatch, request, chunked, traced):
    """The benchmark's ``flow_device_ms`` patches ``pipeline.farneback_flow``:
    every flow call of the program must still reach the patched name."""
    if chunked:
        request.getfixturevalue("two_chunks")
    calls = []
    inner = pipeline.farneback_flow

    def counted(*a, **kw):
        calls.append(a[0].shape[0])
        return inner(*a, **kw)

    monkeypatch.setattr(pipeline, "farneback_flow", counted)
    run = lambda: fx.video_feature_async_i420(*clip, H, W)  # noqa: E731
    profiled(run) if traced else run()
    assert calls == ([2, 2] if chunked else [N_PAIRS])


def test_profile_dir_trace_carries_the_spans(fx, clip, tmp_path):
    """``trace_to`` (``extract --profile-dir``) writes the spans into its Chrome trace."""
    with profiling.trace_to(str(tmp_path), torch.device("cpu")):
        fx.video_feature_async_i420(*clip, H, W)
    (path,) = tmp_path.glob("trace_*.json")
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert {f"relaxtpu.{s}" for s in ("enqueue", "upload", "colorspace", "fragments", "flow", "prep", "resnet",
                                       "vit", "aggregate")} <= names
