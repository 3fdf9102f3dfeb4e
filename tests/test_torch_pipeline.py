"""The port's whole slice against the JAX package: the 35,203-dim vector
(BGR and I420 ingest) and the MOS of ``predict_file`` on a raw .yuv clip
(against the JAX package's ``predict_file`` on the same file).

Small size: 2 frames and 2 pairs at 120x160, a depth-2 ViT, f32.  Weights
come from the torch oracles, go into JAX through relaxtpu's porters and into
the port through ``relaxtpu_torch.models.porters``.  Bounds: per-segment
cosine >= 0.99999 and mean relative error <= 1e-4 on the vector, 1e-4 on
the MOS.  Measured on the BGR vector (seed 1): cosine 1.00000000 in every
segment, mean relative error 5.1e-6 (resnet_stack), 2.7e-6 (vit_pool),
5.2e-7 (frag_resnet), 3.5e-6 (frag_vit).
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relaxtpu.features.pipeline import FeatureExtractor as JaxExtractor
from relaxtpu.models import port_torch_resnet50, port_torch_vit
from relaxtpu.oracle import build_torch_resnet50, build_torch_vit, compare_segments
from relaxtpu.ops.colorspace import bgr_to_yuv420, pack_i420
from relaxtpu.parity import synthetic_correlated_video
from relaxtpu_torch.features.pipeline import FeatureExtractor
from relaxtpu_torch.io.video import decode_video_inputs_i420
from relaxtpu_torch.models.porters import resnet50_from_jax, vit_from_jax

H, W = 120, 160
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def assert_vectors_close(ours, theirs):
    assert ours.shape == theirs.shape == (35203,)
    for seg, r in compare_segments(ours, theirs).items():
        assert r["cosine"] >= 0.99999, (seg, r)
        assert r["mean_abs_err_over_mean_abs"] <= 1e-4, (seg, r)


@pytest.fixture(scope="module")
def extractors():
    rn = port_torch_resnet50(build_torch_resnet50(seed=0).state_dict())
    vit = port_torch_vit(build_torch_vit(depth=2, seed=1).state_dict(), depth=2)
    jfx = JaxExtractor(rn, vit, dtype=jnp.float32, vit_depth=2)
    tfx = FeatureExtractor(resnet50_from_jax(rn), vit_from_jax(vit, depth=2),
                           dtype=torch.float32, vit_depth=2, device="cpu")
    return jfx, tfx


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """A raw I420 clip whose frames at 4 fps sample 2 frames and 2 pairs."""
    frames, nxt = synthetic_correlated_video(np.random.default_rng(3), 2, H, W)
    chain = np.stack([frames[0], nxt[0], frames[1], nxt[1]])
    path = str(tmp_path_factory.mktemp("clip") / "clip.yuv")
    pack_i420(*bgr_to_yuv420(chain)).tofile(path)
    return path


@pytest.fixture(scope="module")
def jax_i420_vector(extractors, clip):
    """JAX's I420 program on the port reader's packed buffers: the two I420
    programs held together on the same bytes.  (A file-level result of the
    JAX package decodes the .yuv file through BGR; ``predict_file`` is held
    to that below.)"""
    fbuf, nbuf, h, w = decode_video_inputs_i420(clip, 4.0, W, H)
    assert (len(fbuf), len(nbuf)) == (2, 2)
    return np.asarray(extractors[0].video_feature_async_i420(fbuf, nbuf, h, w))


def test_vector_bgr_matches_jax(extractors):
    jfx, tfx = extractors
    frames, nxt = synthetic_correlated_video(np.random.default_rng(1), 2, H, W)
    prev = frames[: len(nxt)]
    assert_vectors_close(tfx.video_feature(frames, prev, nxt), jfx.video_feature(frames, prev, nxt))


def test_vector_i420_matches_jax(extractors, clip, jax_i420_vector):
    fbuf, nbuf, h, w = decode_video_inputs_i420(clip, 4.0, W, H)
    assert_vectors_close(extractors[1].video_feature_i420(fbuf, nbuf, h, w), jax_i420_vector)


@pytest.fixture(scope="module")
def head_files(tmp_path_factory):
    """A random MLP snapshot (relaxtpu's .npz) and sklearn imputer/scaler pkls."""
    import joblib
    from sklearn.impute import SimpleImputer
    from sklearn.preprocessing import MinMaxScaler

    from relaxtpu.model.mlp import Mlp
    from relaxtpu.model.train import ModelSnapshot
    from relaxtpu.utils.checkpoint import save_snapshot

    rng = np.random.default_rng(4)
    v = Mlp().init(jax.random.PRNGKey(0), jnp.zeros((2, 35203)), train=False)
    stats = {"bn1": {"mean": rng.normal(0, 0.1, 256).astype(np.float32),
                     "var": rng.uniform(0.5, 1.5, 256).astype(np.float32)}}
    d = tmp_path_factory.mktemp("head")
    save_snapshot(str(d / "mlp.npz"), ModelSnapshot(v["params"], stats))
    feats = rng.normal(0, 1, (8, 35203))
    feats[0, ::7] = np.nan
    imp = SimpleImputer(strategy="mean").fit(feats)
    joblib.dump(imp, d / "imputer.pkl")
    joblib.dump(MinMaxScaler().fit(imp.transform(feats)), d / "scaler.pkl")
    return str(d / "mlp.npz"), str(d / "imputer.pkl"), str(d / "scaler.pkl")


def test_predict_file_mos_matches_jax(extractors, clip, head_files):
    """The port's ``predict_file`` on the .yuv file against the JAX
    package's ``predict_file`` on the same file: both decode it as the JAX
    package does (the native rawvideo decoder where it loads)."""
    from relaxtpu.model.scalers import FeatureScaler as JaxScaler
    from relaxtpu.predict import VideoQualityPredictor as JaxPredictor
    from relaxtpu.utils.checkpoint import load_snapshot
    from relaxtpu_torch.model.scalers import FeatureScaler
    from relaxtpu_torch.models.porters import mlp_from_jax
    from relaxtpu_torch.predict import VideoQualityPredictor
    from relaxtpu_torch.utils.checkpoint import load_snapshot_variables

    model, imputer, scaler = head_files
    snap = load_snapshot(model)
    want = JaxPredictor(
        extractors[0], {"params": snap.params, "batch_stats": snap.batch_stats},
        JaxScaler.load_reference_pkls(imputer, scaler),
    ).predict_file(clip, framerate=4.0, width=W, height=H)
    pred = VideoQualityPredictor(
        extractors[1], mlp_from_jax(load_snapshot_variables(model)),
        FeatureScaler.load_reference_pkls(imputer, scaler),
    )
    got = pred.predict_file(clip, framerate=4.0, width=W, height=H)
    assert np.isfinite(got)
    assert abs(got - want) <= 1e-4, (got, want)


@pytest.mark.slow
def test_cli_predict_on_cpu(clip, head_files):
    """``python -m relaxtpu_torch.cli predict --device cpu`` prints one JSON
    line with a finite MOS (seeded random backbones, depth 12)."""
    model, imputer, scaler = head_files
    out = subprocess.run(
        [sys.executable, "-m", "relaxtpu_torch.cli", "predict", "--video", clip,
         "--framerate", "4", "--width", str(W), "--height", str(H), "--model", model,
         "--imputer", imputer, "--scaler", scaler, "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=600, check=True,
    )
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["video"] == clip and np.isfinite(line["predicted_mos"])
