"""The port's dataset tools and the rest of the slice's host-side pieces
against the JAX package: the ``metadata`` CLI's four flows (directory scan,
info ``.mat`` for CVD2014 and LIVE-Qualcomm, LIVE-VQC CSV passthrough,
LSVQ CSV probe), the ``greyscale`` CLI, the serving-mode choice, the link
probe, ``warmup`` and ``serve --warm`` with a depth-2 extractor, the
refusal of a CUDA index other than 0, and the stream a kernel launches on.

Bounds: the CSV files and the JSON lines are byte-equal to the JAX CLI's
(the port writes with the ``csv`` module what pandas writes for JAX).
"""

import contextlib
import io
import json
import os
import types

import cv2
import numpy as np
import pytest
import scipy.io
import torch

import relaxtpu.cli.__main__ as jax_cli
from relaxtpu.ops.colorspace import bgr_to_yuv420, pack_i420
from relaxtpu.parity import synthetic_correlated_video
from relaxtpu.utils.linkprobe import pick_serving_mode as jax_pick
from relaxtpu_torch import _native
from relaxtpu_torch.cli import __main__ as cli
from relaxtpu_torch.device import resolve_device
from relaxtpu_torch.features.pipeline import FeatureExtractor
from relaxtpu_torch.models.initutil import random_init_
from relaxtpu_torch.models.resnet import ResNet50
from relaxtpu_torch.models.vit import ViT
from relaxtpu_torch.utils.linkprobe import measure_link, pick_serving_mode

H, W = 120, 160


def write_video(path: str, frames: np.ndarray, fourcc: str = "mp4v", fps: int = 4) -> None:
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*fourcc), fps, (frames.shape[2], frames.shape[1]))
    for f in frames:
        vw.write(f)
    vw.release()


def frames_of(seed: int, h: int = H, w: int = W, grey: bool = False) -> np.ndarray:
    frames, nxt = synthetic_correlated_video(np.random.default_rng(seed), 2, h, w)
    out = np.concatenate([frames, nxt])
    if grey:
        out = np.repeat(out[..., 1:2], 3, axis=-1)
    return out


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    """mp4s of two sizes, a broken mp4, a stray file, CVD2014-style .avi and
    LIVE-Qualcomm-style .yuv files."""
    d = tmp_path_factory.mktemp("videos")
    write_video(str(d / "v1.mp4"), frames_of(1))
    write_video(str(d / "v2.mp4"), frames_of(2, 96, 128), fps=6)
    write_video(str(d / "grey.mp4"), frames_of(3, grey=True))
    (d / "broken.mp4").write_bytes(b"not a video")
    (d / "notes.txt").write_text("not a video either")
    write_video(str(d / "c1.avi"), frames_of(4), fourcc="MJPG")
    write_video(str(d / "c2.avi"), frames_of(5, 96, 128), fourcc="MJPG")
    for i in (1, 2):
        pack_i420(*bgr_to_yuv420(frames_of(5 + i, 48, 64))).tofile(d / f"q{i}.yuv")
    return d


def run_both(argv: list, out_port: str, out_jax: str, capsys) -> tuple:
    """The port's CLI and the JAX CLI on ``argv`` -> their JSON lines."""
    cli.main([*argv, "--output", out_port])
    ours = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    jax_cli.main([*argv, "--output", out_jax])
    theirs = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    return ours, theirs


def assert_same_file(a: str, b: str) -> None:
    with open(a) as fa, open(b) as fb:
        assert fa.read() == fb.read()


@pytest.mark.parametrize("flow", ["scan", "info_mat_cvd", "info_mat_qualcomm", "live_vqc", "lsvq"])
def test_metadata_matches_jax(videos, tmp_path, capsys, flow):
    argv = ["metadata", "--video-dir", str(videos)]
    if flow.startswith("info_mat"):
        qualcomm = flow.endswith("qualcomm")
        names = ["q1.yuv", "q2"] if qualcomm else ["c1.avi", "c2"]
        mat = str(tmp_path / "info.mat")
        scipy.io.savemat(mat, {"video_names": np.array([[n] for n in names], dtype=object),
                               "scores": np.array([[61.5], [40.25]])})
        argv += ["--info-mat", mat, "--video-type", "live_qualcomm" if qualcomm else "cvd_2014"]
        if qualcomm:
            argv += ["--framerate", "30"]
    elif flow == "live_vqc":
        src = tmp_path / "vqc.csv"
        src.write_text("vid,mos,width,height,framerate,extra\nA001.mp4,71.5,1920,1080,29.97,x\n"
                       "A002.mp4,55,,1080,30,y\n")
        argv += ["--csv", str(src), "--video-type", "live_vqc"]
    elif flow == "lsvq":
        src = tmp_path / "lsvq.csv"
        src.write_text("name,p1,mos,width,height,frame_number\nv1,1,3.25,160,120,4\nmissing,2,2.5,64,48,9\n"
                       "v2,3,4.0,128,96,4\n")
        argv += ["--csv", str(src), "--video-type", "lsvq"]
    ours, theirs = run_both(argv, str(tmp_path / "port.csv"), str(tmp_path / "jax.csv"), capsys)
    assert ours == {**theirs, "output": str(tmp_path / "port.csv")}
    assert_same_file(tmp_path / "port.csv", tmp_path / "jax.csv")
    n = {"scan": 6, "info_mat_cvd": 2, "info_mat_qualcomm": 2, "live_vqc": 2, "lsvq": 2}[flow]
    assert ours["n_videos"] == n


def test_greyscale_matches_jax(videos, tmp_path, capsys):
    meta = tmp_path / "meta.csv"
    meta.write_text("vid,mos\nv1,3.0\ngrey,2.0\nmissing,1.0\n")
    root = tmp_path / "root"
    os.makedirs(root / "KoNViD_1k_videos")
    for vid in ("v1", "grey"):
        os.symlink(videos / f"{vid}.mp4", root / "KoNViD_1k_videos" / f"{vid}.mp4")
    argv = ["greyscale", "--dataset", "konvid_1k", "--metadata-csv", str(meta), "--root", str(root)]
    ours, theirs = run_both(argv, str(tmp_path / "port.csv"), str(tmp_path / "jax.csv"), capsys)
    assert ours == {"output": str(tmp_path / "port.csv"), "n_greyscale": 1} and ours["n_greyscale"] == theirs["n_greyscale"]
    assert_same_file(tmp_path / "port.csv", tmp_path / "jax.csv")
    assert (tmp_path / "port.csv").read_text() == "Index,vid,Is Greyscale\n1,grey,True\n"


def test_pick_serving_mode_matches_jax():
    for nbytes in (1e4, 1e6, 2.5e7, 4e8):
        for rate in (10.0, 900.0, 25000.0):
            for rtt in (0.02, 1.0, 60.0):
                link = {"link_MBps": rate, "link_MBps_worst": rate, "rtt_ms": rtt}
                assert pick_serving_mode(int(nbytes), link) == jax_pick(int(nbytes), link)
                assert pick_serving_mode(int(nbytes), link, batch=8) == jax_pick(int(nbytes), link, batch=8)


def test_measure_link_on_cpu():
    link = measure_link(n_mb=1, reps=2, device="cpu")
    assert set(link) == {"link_MBps", "link_MBps_worst", "rtt_ms"}
    assert link["link_MBps"] >= link["link_MBps_worst"] > 0 and link["rtt_ms"] >= 0


@pytest.fixture(scope="module")
def small_extractor():
    """A depth-2 CPU extractor, run with one torch thread: pytest-xdist runs
    several test processes at once, and a thread pool per process larger
    than its share of the cores makes each wait at its pool's barriers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield FeatureExtractor(random_init_(ResNet50(), 0).state_dict(), random_init_(ViT(depth=2), 1).state_dict(),
                           dtype=torch.float32, vit_depth=2, device="cpu")
    torch.set_num_threads(n)




def test_warmup_runs_each_program(small_extractor, capsys, monkeypatch):
    """``warmup``: one record a resolution and count, with the JAX package's
    keys; auto runs the I420 and the BGR program, bgr the BGR one."""
    calls = []
    for name in ("video_feature_async_i420", "video_feature_async"):
        inner = getattr(small_extractor, name)
        monkeypatch.setattr(small_extractor, name,
                            lambda *a, inner=inner, name=name: calls.append((name, len(a[0]))) or inner(*a))
    monkeypatch.setattr(cli, "_build_extractor", lambda args: small_extractor)
    cli.main(["warmup", "--resolutions", f"{H}x{W}", "--counts", "2", "1", "--device", "cpu"])
    recs = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [(r["resolution"], r["frames"], r["pairs"], r["bucket"]) for r in recs] == [
        (f"{H}x{W}", 1, 1, 1), (f"{H}x{W}", 2, 2, 1)]
    assert all(r["compile_s"] > 0 for r in recs) and set(recs[0]) == {
        "resolution", "frames", "pairs", "bucket", "compile_s"}
    assert calls == [("video_feature_async_i420", 1), ("video_feature_async", 1),
                     ("video_feature_async_i420", 2), ("video_feature_async", 2)]
    calls.clear()
    cli.main(["warmup", "--resolutions", f"{H}x{W}", "--counts", "1", "--ingest", "bgr", "--device", "cpu"])
    assert calls == [("video_feature_async", 1)]


def test_serve_warm(small_extractor, capsys, monkeypatch, caplog):
    """``serve --warm`` runs the programs before the ready line."""
    pred = types.SimpleNamespace(extractor=small_extractor)
    monkeypatch.setattr(cli, "_build_extractor", lambda args: None)
    monkeypatch.setattr(cli, "_load_predictor", lambda args, extractor: pred)
    monkeypatch.setattr("sys.stdin", io.StringIO(""))
    with caplog.at_level("INFO", logger="relaxtpu_torch.cli"):
        cli.main(["serve", "--model", "m.npz", "--imputer", "i.pkl", "--scaler", "s.pkl", "--device", "cpu",
                  "--warm", f"{H}x{W}", "--warm-counts", "1", "--ingest", "bgr"])
    assert capsys.readouterr().out == '{"status": "ready"}\n'
    warmed = [r.args for r in caplog.records if r.msg == "warmed %s"]
    assert [(w["resolution"], w["frames"], w["pairs"]) for w in warmed] == [(f"{H}x{W}", 1, 1)]


def test_cuda_index_refused(monkeypatch):
    """An index at or past the device count is refused, naming the count;
    the others pass."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for dev in ("cuda:1", torch.device("cuda", 3)):
        with pytest.raises(ValueError, match="this host has 1 CUDA device$"):
            resolve_device(dev)
    assert resolve_device("cuda:0") == torch.device("cuda", 0)
    assert resolve_device(None) == torch.device("cuda")
    with pytest.raises(ValueError, match="1 CUDA device"):
        FeatureExtractor({}, {}, device="cuda:1")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert resolve_device("cuda:3") == torch.device("cuda", 3)
    with pytest.raises(ValueError, match="this host has 4 CUDA devices"):
        resolve_device("cuda:4")


def test_launch_uses_the_tensors_device_stream(monkeypatch):
    """The C call runs with the tensors' device current (a ``<<<>>>``
    launch goes to the current device), on that device's stream."""
    asked, got, current = [], [], []

    @contextlib.contextmanager
    def device_guard(device):
        current.append(device)
        yield
        current.pop()

    monkeypatch.setattr(torch.cuda, "device", device_guard)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: asked.append(device) or types.SimpleNamespace(cuda_stream=1234))
    monkeypatch.setitem(_native._fns, "relax_probe", lambda *args: got.append((args, list(current))) or 0)
    dev = torch.device("cuda", 1)
    _native.launch("relax_probe", dev, 7, 8)
    assert asked == [dev] and got == [((7, 8, 1234), [dev])] and current == []
    monkeypatch.setitem(_native._fns, "relax_probe", lambda *args: 700)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        _native.launch("relax_probe", dev)
