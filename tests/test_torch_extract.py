"""``python -m relaxtpu_torch.cli extract`` end to end on the CPU.

A ``live_qualcomm``-named dataset of 2 raw I420 clips at 120x160 (4 raw
frames at 4 fps: 2 frames and 2 pairs each), given by ``--metadata-csv``
and ``--root``; ``--device cpu --f32``; the port's extractor carries the
torch oracles' weights (depth-2 ViT), the JAX one the same weights through
relaxtpu's porters.  Checked: the ``full`` rows against the port's
``video_feature_i420`` (equal) and JAX's ``video_feature`` on the host
converter's BGR frames, with the port's native decoder forced off (per-segment
cosine >= 0.99999, mean relative error <= 1e-4, the pipeline test's bounds;
tests/test_torch_ingest.py holds extract to the JAX CLI with it loaded); an
ablation mode's per-row matrices
against JAX's ``frame_features`` (the same bounds, per row) and the
assembled matrix; ``--save-mat`` through both packages' loaders; a JAX
``FeatureStore`` reading the port's store; resume; ``--profile-dir``; the
JSON line; and the refusals.
"""

import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relaxtpu.data.store import FeatureStore as JaxStore
from relaxtpu.data.store import load_mat_features as jax_load_mat
from relaxtpu.features.pipeline import FeatureExtractor as JaxExtractor
from relaxtpu.models import port_torch_resnet50, port_torch_vit
from relaxtpu.ops.colorspace import bgr_to_yuv420, pack_i420
from relaxtpu.oracle import build_torch_resnet50, build_torch_vit, compare_segments
from relaxtpu.parity import synthetic_correlated_video
from relaxtpu_torch.cli import __main__ as cli
from relaxtpu_torch.data.store import FeatureStore, load_mat_features
from relaxtpu_torch.features.pipeline import FeatureExtractor
from relaxtpu_torch.io import native
from relaxtpu_torch.io.video import DecoderUnavailable, _yuv420_to_bgr_limited, decode_video_inputs_i420
from relaxtpu_torch.models.porters import resnet50_from_jax, vit_from_jax

H, W = 120, 160
VIDS = ("clip_a", "clip_b")


@pytest.fixture(scope="module")
def extractors():
    rn = port_torch_resnet50(build_torch_resnet50(seed=0).state_dict())
    vit = port_torch_vit(build_torch_vit(depth=2, seed=1).state_dict(), depth=2)
    jfx = JaxExtractor(rn, vit, dtype=jnp.float32, vit_depth=2)
    tfx = FeatureExtractor(resnet50_from_jax(rn), vit_from_jax(vit, depth=2),
                           dtype=torch.float32, vit_depth=2, device="cpu")
    return jfx, tfx


def write_meta(path, rows, columns=("vid", "mos", "framerate", "width", "height")) -> str:
    with open(path, "w") as f:
        f.write(",".join(columns) + "\n")
        f.writelines(",".join(str(r[c]) for c in columns) + "\n" for r in rows)
    return str(path)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """<root>/LIVE-Qualcomm/<vid>.yuv and a metadata CSV; each clip's decoded
    buffers and the host converter's BGR frames."""
    root = tmp_path_factory.mktemp("data")
    os.makedirs(root / "LIVE-Qualcomm")
    clips = {}
    for seed, vid in enumerate(VIDS, start=3):
        frames, nxt = synthetic_correlated_video(np.random.default_rng(seed), 2, H, W)
        chain = np.stack([frames[0], nxt[0], frames[1], nxt[1]])
        path = str(root / "LIVE-Qualcomm" / f"{vid}.yuv")
        pack_i420(*bgr_to_yuv420(chain)).tofile(path)
        fbuf, nbuf, h, w = decode_video_inputs_i420(path, 4.0, W, H)
        bgr = [np.stack([_yuv420_to_bgr_limited(f.reshape(h * 3 // 2, w), w, h) for f in b]) for b in (fbuf, nbuf)]
        clips[vid] = {"i420": (fbuf, nbuf, h, w), "frames": bgr[0], "nxt": bgr[1]}
    rows = [{"vid": v, "mos": 50.0 + i, "framerate": 4.0, "width": W, "height": H} for i, v in enumerate(VIDS)]
    return str(root), write_meta(root / "meta.csv", rows), clips


def run_extract(root, meta, out, *extra, capsys):
    cli.main(["extract", "--dataset", "live_qualcomm", "--metadata-csv", meta, "--root", root,
              "--output", str(out), "--device", "cpu", "--f32", *extra])
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.fixture
def port_cli(extractors, monkeypatch):
    """``extract`` with the fixture's extractor in place of seeded random
    depth-12 backbones."""
    monkeypatch.setattr(cli, "_build_extractor", lambda args: extractors[1])


@pytest.fixture
def no_native(monkeypatch):
    """The port's native decoder forced off, as on a host without libav: a
    .yuv file then goes up as I420 from the numpy reader, whose frames the
    JAX package's numpy converter gives."""
    monkeypatch.setattr(native, "available", lambda: False)


def test_full_mode_matches_port_and_jax(extractors, dataset, port_cli, no_native, tmp_path, capsys):
    jfx, tfx = extractors
    root, meta, clips = dataset
    line = run_extract(root, meta, tmp_path, "--save-mat", str(tmp_path / "f.mat"), capsys=capsys)
    assert line == {"dataset": "live_qualcomm", "mode": "full", "shape": [2, 35203]}
    store = FeatureStore(str(tmp_path))
    rows = np.stack([store.get("live_qualcomm", i) for i in range(2)])
    for row, vid in zip(rows, VIDS):
        c = clips[vid]
        np.testing.assert_array_equal(row, tfx.video_feature_i420(*c["i420"]))
        want = jfx.video_feature(c["frames"], c["frames"][: len(c["nxt"])], c["nxt"])
        for seg, r in compare_segments(row, want).items():
            assert r["cosine"] >= 0.99999 and r["mean_abs_err_over_mean_abs"] <= 1e-4, (seg, r)
    mat = np.load(tmp_path / "live_qualcomm_features.npy")
    np.testing.assert_array_equal(mat, rows)
    for load in (load_mat_features, jax_load_mat):
        np.testing.assert_array_equal(load(str(tmp_path / "f.mat"), "live_qualcomm"), mat.astype(float))
    np.testing.assert_array_equal(JaxStore(str(tmp_path)).assemble("live_qualcomm", 2), mat)


def test_ablation_mode_rows_and_profile(extractors, dataset, port_cli, no_native, tmp_path, capsys):
    """``--mode layer_stack``: per-frame ResNet stacks under the
    ``<dataset>_<mode>`` tag, their mean in the matrix; a trace in
    ``--profile-dir``."""
    jfx, _ = extractors
    root, meta, clips = dataset
    line = run_extract(root, meta, tmp_path / "out", "--mode", "layer_stack",
                       "--profile-dir", str(tmp_path / "trace"), capsys=capsys)
    assert line == {"dataset": "live_qualcomm", "mode": "layer_stack", "shape": [2, 13120]}
    store = FeatureStore(str(tmp_path / "out"))
    for i, vid in enumerate(VIDS):
        got = store.get("live_qualcomm_layer_stack", i)
        want = jfx.frame_features(clips[vid]["frames"])[0]
        assert got.shape == want.shape == (2, 13120)
        for a, b in zip(got.astype(np.float64), want.astype(np.float64)):
            assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) >= 0.99999
            assert np.abs(a - b).mean() / np.abs(b).mean() <= 1e-4
    mat = np.load(tmp_path / "out" / "live_qualcomm_layer_stack_features.npy")
    np.testing.assert_allclose(mat, np.stack([store.get("live_qualcomm_layer_stack", i).mean(0)
                                              for i in range(2)]), rtol=0, atol=0)
    traces = os.listdir(tmp_path / "trace")
    assert len(traces) == 1 and os.path.getsize(tmp_path / "trace" / traces[0]) > 0


def test_resume_skips_stored_videos(dataset, port_cli, tmp_path, capsys, monkeypatch):
    root, meta, _ = dataset
    first = run_extract(root, meta, tmp_path, "--mode", "frame_diff", "--network", "vit", capsys=capsys)
    mat = np.load(tmp_path / "live_qualcomm_frame_diff_features.npy")
    assert first["shape"] == [2, 2304] and np.isfinite(mat).all()
    os.remove(tmp_path / "live_qualcomm_frame_diff" / "video_2.npy")
    done = []
    extract_one = cli._extract_one
    monkeypatch.setattr(cli, "_extract_one", lambda *a: done.append(a[-4]) or extract_one(*a))
    assert run_extract(root, meta, tmp_path, "--mode", "frame_diff", "--network", "vit",
                       capsys=capsys) == first
    assert len(done) == 1  # only the second video, which the store lacked
    run_extract(root, meta, tmp_path, "--mode", "frame_diff", "--network", "vit", capsys=capsys)
    assert len(done) == 1
    np.testing.assert_array_equal(np.load(tmp_path / "live_qualcomm_frame_diff_features.npy"), mat)


def test_default_backbones_on_cpu(dataset, tmp_path, capsys):
    """The seeded random depth-12 backbones that ``extract`` builds without
    weight files, on a mode that runs only ResNet."""
    root, meta, _ = dataset
    line = run_extract(root, meta, tmp_path, "--mode", "layer", "--layer", "last_layer", capsys=capsys)
    assert line["shape"] == [2, 2048]
    assert np.isfinite(np.load(tmp_path / "live_qualcomm_layer_features.npy")).all()


@pytest.mark.parametrize("case", ["n_data", "no_width", "empty_framerate", "container"])
def test_extract_refuses(dataset, port_cli, tmp_path, capsys, monkeypatch, case):
    root, meta, _ = dataset
    argv = ["extract", "--dataset", "live_qualcomm", "--metadata-csv", meta, "--root", root,
            "--output", str(tmp_path), "--device", "cpu"]
    row = {"vid": VIDS[0], "mos": 50.0, "framerate": 4.0, "width": W, "height": H}
    if case == "n_data":
        argv += ["--n-data", "2"]  # without torchrun or a process group: no mesh, no one-device run
        err, match = RuntimeError, "start it with torchrun"
    elif case == "no_width":
        argv[4] = write_meta(tmp_path / "m.csv", [row], ("vid", "mos", "framerate", "height"))
        err, match = ValueError, "'width'"
    elif case == "empty_framerate":
        argv[4] = write_meta(tmp_path / "m.csv", [dict(row, framerate="")])
        err, match = ValueError, "'framerate'"
    else:  # a container dataset on a host with neither decoder
        argv[2] = "konvid_1k"
        monkeypatch.setattr(native, "available", lambda: False)
        monkeypatch.setitem(sys.modules, "cv2", None)
        err, match = DecoderUnavailable, "cv2 is not installed"
    with pytest.raises(err, match=match):
        cli.main(argv)
