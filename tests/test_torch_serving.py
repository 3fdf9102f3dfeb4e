"""The port's serving paths against the JAX package and against its own
single-video path: the batched multi-video program, the chunked
long/high-res path, ``enqueue_file``, the serve loop and ``predict-batch``,
and the device-resident resize matrices.

Small size: 120x160, a depth-2 ViT, f32, seeded numpy inputs; weights come
from the torch oracles, go into JAX through relaxtpu's porters and into the
port through ``relaxtpu_torch.models.porters``.  Bounds: per-segment cosine
>= 0.99999 and mean relative error <= 1e-4 (``assert_vectors_close``)
unless a test states a tighter one.
"""

import io
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relaxtpu.features.pipeline import FeatureExtractor as JaxExtractor
from relaxtpu.models import port_torch_resnet50, port_torch_vit
from relaxtpu.oracle import build_torch_resnet50, build_torch_vit, compare_segments
from relaxtpu.ops.colorspace import bgr_to_yuv420, pack_i420
from relaxtpu.parity import synthetic_correlated_video
from relaxtpu_torch.cli import __main__ as cli
from relaxtpu_torch.features.pipeline import FeatureExtractor, pair_chunks, prev_frame_runs
from relaxtpu_torch.io import native
from relaxtpu_torch.model.mlp import Mlp
from relaxtpu_torch.model.scalers import FeatureScaler
from relaxtpu_torch.models.initutil import random_init_
from relaxtpu_torch.models.porters import resnet50_from_jax, vit_from_jax
from relaxtpu_torch.ops.resize import device_matrix, weight_matrix
from relaxtpu_torch.predict import VideoQualityPredictor

H, W = 120, 160
COUNTS = [(2, 2), (3, 2), (2, 1)]  # (frames, pairs) of the batched videos


def assert_vectors_close(ours, theirs, mean_rel: float = 1e-4):
    assert ours.shape == theirs.shape == (35203,)
    for seg, r in compare_segments(ours, theirs).items():
        assert r["cosine"] >= 0.99999, (seg, r)
        assert r["mean_abs_err_over_mean_abs"] <= mean_rel, (seg, r)


def i420_video(seed: int, n_frames: int, n_pairs: int):
    """Packed I420 sampled frames (F, H*W*3/2) and successors (P, ...)."""
    frames, nxt = synthetic_correlated_video(np.random.default_rng(seed), n_frames, H, W)
    return pack_i420(*bgr_to_yuv420(frames)), pack_i420(*bgr_to_yuv420(nxt[:n_pairs]))


@pytest.fixture(scope="module", autouse=True)
def no_native():
    """The port's native decoder forced off, as on a host without libav: a
    raw .yuv clip then takes the I420 route, the one the serve loop and
    ``predict-batch`` (its batched program at ``--batch 2``) take there."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "available", lambda: False)
        yield


@pytest.fixture(scope="module")
def extractors():
    rn = port_torch_resnet50(build_torch_resnet50(seed=0).state_dict())
    vit = port_torch_vit(build_torch_vit(depth=2, seed=1).state_dict(), depth=2)
    jfx = JaxExtractor(rn, vit, dtype=jnp.float32, vit_depth=2)
    tfx = FeatureExtractor(resnet50_from_jax(rn), vit_from_jax(vit, depth=2),
                           dtype=torch.float32, vit_depth=2, device="cpu")
    return jfx, tfx


@pytest.fixture(scope="module")
def videos():
    return [i420_video(10 + i, f, p) for i, (f, p) in enumerate(COUNTS)]


@pytest.fixture(scope="module")
def batched(extractors, videos):
    vecs = extractors[1].video_features_batch_i420([v[0] for v in videos], [v[1] for v in videos], H, W)
    assert vecs.shape == (len(videos), 35203) and vecs.device.type == "cpu"
    return vecs.numpy()


def test_batched_matches_jax(extractors, videos, batched):
    want = np.asarray(extractors[0].video_features_batch_i420(
        [v[0] for v in videos], [v[1] for v in videos], H, W, bucket=1))
    for ours, theirs in zip(batched, want):
        assert_vectors_close(ours, theirs)


def test_batched_matches_single(extractors, videos, batched):
    for (fbuf, nbuf), vec in zip(videos, batched):
        assert_vectors_close(vec, extractors[1].video_feature_i420(fbuf, nbuf, H, W), mean_rel=1e-5)


def test_batched_chunks_match_one_chunk(extractors, videos, batched, monkeypatch):
    """chunk=2 splits the flat axis of 5 pairs into 2 + 2 + 1 (the middle
    chunk spans two videos): the uint8 fragments are identical and the
    vectors agree to 1e-6."""
    tfx = extractors[1]
    frags = {}

    def recording(chunk):
        inner = FeatureExtractor._fragments

        def fragments(prev, nxt):
            out = inner(prev, nxt)
            frags.setdefault(chunk, []).append(out)
            return out
        return fragments

    got = {}
    for chunk in (0, 2):
        monkeypatch.setattr(tfx, "_fragments", recording(chunk))
        got[chunk] = tfx.video_features_batch_i420(
            [v[0] for v in videos], [v[1] for v in videos], H, W, chunk=chunk).numpy()
    assert [len(frags[0]), len(frags[2])] == [1, 3]
    for i in range(2):
        torch.testing.assert_close(torch.cat([f[i] for f in frags[2]]), frags[0][0][i], rtol=0, atol=0)
    for ours, theirs in zip(got[2], got[0]):
        assert_vectors_close(ours, theirs, mean_rel=1e-6)
    np.testing.assert_allclose(got[0], batched, rtol=0, atol=0)


def test_prev_frame_runs():
    # videos of (3, 2), (2, 2), (4, 3) frames and pairs: frame rows 0-2, 3-4, 5-8
    assert prev_frame_runs([3, 2, 4], [2, 2, 3], 0, 7) == [(0, 2), (3, 5), (5, 8)]
    assert prev_frame_runs([3, 2, 4], [2, 2, 3], 1, 3) == [(1, 2), (3, 4)]
    assert prev_frame_runs([3, 2, 4], [2, 2, 3], 4, 6) == [(5, 7)]


def test_pair_chunks():
    assert pair_chunks(5, 2) == [(0, 2), (2, 4), (4, 5)]
    assert pair_chunks(4, 2) == [(0, 2), (2, 4)]
    assert pair_chunks(3, 16) == pair_chunks(3, 0) == [(0, 3)]
    assert pair_chunks(0, 2) == pair_chunks(0, 0) == []


def test_chunked_path_matches_unchunked_and_jax(extractors, monkeypatch):
    """5 pairs with max_pair_batch forced to 2: frames once, then one pair
    walk of 3 chunks, the sums added on the device."""
    jfx, tfx = extractors
    fbuf, nbuf = i420_video(20, 5, 5)
    unchunked = tfx.video_feature_i420(fbuf, nbuf, H, W)
    want = np.asarray(jfx._video_feature_async_i420_chunked(fbuf, nbuf, H, W, 2, bucket=1))
    calls = []
    inner = FeatureExtractor._pair_rows

    def spy(self, *args):
        calls.append(args[-1])
        return inner(self, *args)

    monkeypatch.setattr(FeatureExtractor, "max_pair_batch", lambda self, h, w: 2)
    monkeypatch.setattr(FeatureExtractor, "_pair_rows", spy)
    got = tfx.video_feature_i420(fbuf, nbuf, H, W)
    assert calls == [2]
    assert_vectors_close(got, unchunked, mean_rel=1e-5)
    assert_vectors_close(got, want)


@pytest.fixture(scope="module")
def predictor(extractors):
    scaler = FeatureScaler(fill=np.zeros(1), scale=np.ones(1), offset=np.zeros(1))
    return VideoQualityPredictor(extractors[1], random_init_(Mlp(), 2).state_dict(), scaler)


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """Two raw I420 clips whose frames at 4 fps sample 2 frames and 2 pairs."""
    d = tmp_path_factory.mktemp("clips")
    paths = []
    for i in range(2):
        frames, nxt = synthetic_correlated_video(np.random.default_rng(30 + i), 2, H, W)
        chain = np.stack([frames[0], nxt[0], frames[1], nxt[1]])
        paths.append(str(d / f"clip{i}.yuv"))
        pack_i420(*bgr_to_yuv420(chain)).tofile(paths[-1])
    return paths


@pytest.fixture(scope="module")
def file_mos(predictor, clips):
    return [predictor.predict_file(p, framerate=4.0, width=W, height=H) for p in clips]


def test_enqueue_file_returns_device_vector(predictor, clips, file_mos):
    vec = predictor.enqueue_file(clips[0], framerate=4.0, width=W, height=H)
    assert isinstance(vec, torch.Tensor) and vec.device == predictor.extractor.device
    assert vec.shape == (35203,) and vec.dtype == torch.float32
    assert predictor.predict_feature(vec) == file_mos[0]
    assert predictor.predict_feature(vec.numpy()) == file_mos[0]


def test_serve_loop_answers_in_order(predictor, clips, file_mos):
    requests = [
        clips[0],  # a bare path: the geometry comes from the defaults
        json.dumps({"video": clips[1], "framerate": 4, "width": W, "height": H}),
        "{not json",
        json.dumps({"video": clips[0] + ".missing"}),
    ]
    out = io.StringIO()
    cli.serve_loop(predictor, iter(requests), out, in_flight=1,
                   defaults=dict(framerate=4.0, width=W, height=H))
    lines = [json.loads(line) for line in out.getvalue().splitlines()]
    assert lines[0] == {"status": "ready"}
    assert lines[1] == {"video": clips[0], "predicted_mos": file_mos[0]}
    assert lines[2] == {"video": clips[1], "predicted_mos": file_mos[1]}
    assert lines[3]["video"] is None and lines[3]["error"].startswith("bad request")
    assert lines[4]["video"] == clips[0] + ".missing" and "error" in lines[4]
    assert len(lines) == 5


@pytest.mark.parametrize("batch", [1, 2])
def test_predict_batch_cli(predictor, clips, file_mos, tmp_path, capsys, monkeypatch, batch):
    """One JSON line and one CSV row a video, in input order (the directory
    first, its files sorted, then the file named after it); ``--batch 2``
    runs the first two through the batched I420 program."""
    monkeypatch.setattr(cli, "_build_extractor", lambda args: None)
    monkeypatch.setattr(cli, "_load_predictor", lambda args, extractor: predictor)
    batched = []
    inner = predictor.extractor.video_features_batch_i420
    monkeypatch.setattr(predictor.extractor, "video_features_batch_i420",
                        lambda *a: batched.append(len(a[0])) or inner(*a))
    out_csv = tmp_path / "scores.csv"
    vdir = tmp_path / "vids"
    vdir.mkdir()
    for i in (1, 0):
        (vdir / f"v{i}.yuv").write_bytes(open(clips[i], "rb").read())
    cli.main(["predict-batch", "--videos", str(vdir), clips[1], "--framerate", "4",
              "--width", str(W), "--height", str(H), "--batch", str(batch),
              "--model", "m.npz", "--imputer", "i.pkl", "--scaler", "s.pkl",
              "--device", "cpu", "--output-csv", str(out_csv)])
    want = [(str(vdir / "v0.yuv"), file_mos[0]), (str(vdir / "v1.yuv"), file_mos[1]),
            (clips[1], file_mos[1])]
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [(r["video"], r["predicted_mos"]) for r in lines] == [(p, pytest.approx(m, abs=1e-4)) for p, m in want]
    assert batched == ([2] if batch == 2 else [])
    rows = out_csv.read_text().splitlines()
    assert rows[0] == "video,predicted_mos" and len(rows) == 4
    assert [r.split(",")[0] for r in rows[1:]] == [p for p, _ in want]


def test_resize_matrix_cached_on_device():
    dev = torch.device("cpu")
    m = device_matrix(540, 224, "lanczos3", True, dev)
    assert device_matrix(540, 224, "lanczos3", True, dev) is m
    np.testing.assert_array_equal(m.numpy(), weight_matrix(540, 224, "lanczos3", True))
    assert device_matrix(540, 224, "linear", True, dev) is not m
