"""The port takes calls written for the JAX package's API.

- ``warmup --bucket`` parses, and ``bucket=`` is accepted by the video
  programs and the sharded evaluator: JAX pads each video's frame and pair
  counts to a multiple of the bucket; the port runs each video at its own
  counts, so it ignores the value and gives the same vector.
- The parameters the port named otherwise take JAX's keyword names too
  (``df``, ``train_df``/``test_df``, ``h_patches``/``w_patches``,
  ``img_rgb_f01``, and ``DistributedMlpTrainStep``'s ``cfg`` in JAX's third
  position), with the same results as the port's own names.

Small size on the CPU: 120x160 clips, a depth-2 ViT with seeded weights,
torch on one thread.  Every comparison is exact: the two calls run the same
code.
"""

import dataclasses

import cv2
import numpy as np
import pytest
import torch

from relaxtpu.cli.__main__ import build_parser as jax_build_parser
from relaxtpu.ops.colorspace import bgr_to_yuv420, pack_i420
from relaxtpu.parity import synthetic_correlated_video
from relaxtpu_torch.cli import __main__ as cli
from relaxtpu_torch.data import greyscale, recover, splits
from relaxtpu_torch.features.pipeline import FeatureExtractor
from relaxtpu_torch.io.video import _yuv420_to_bgr_limited
from relaxtpu_torch.model import protocol
from relaxtpu_torch.model.train import TrainConfig
from relaxtpu_torch.models import resnet, vit
from relaxtpu_torch.models.initutil import random_init_
from relaxtpu_torch.parallel.eval import ShardedVideoEvaluator
from relaxtpu_torch.parallel.mesh import make_mesh
from relaxtpu_torch.parallel.train_dp import DistributedMlpTrainStep
from relaxtpu_torch.utils import report

H, W = 120, 160
JAX_WARMUP = ["warmup", "--resolutions", f"{H}x{W}", "--bucket", "8", "--counts", "2", "--ingest", "yuv"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def extractor():
    rs = random_init_(resnet.ResNet50(), 0).state_dict()
    vs = random_init_(vit.ViT(depth=2), 1).state_dict()
    return FeatureExtractor(rs, vs, dtype=torch.float32, vit_depth=2, device="cpu")


@pytest.fixture(scope="module")
def clip():
    """BGR frames, prev, next and the packed I420 stacks of 2 frames and 2
    pairs (the pairs' first frames are the sampled frames)."""
    frames, nxt = synthetic_correlated_video(np.random.default_rng(3), 2, H, W)
    return frames, nxt, pack_i420(*bgr_to_yuv420(frames)), pack_i420(*bgr_to_yuv420(nxt))


@pytest.fixture(scope="module")
def vector(extractor, clip):
    """The I420 program's vector with no bucket: every call below must give it."""
    return extractor.video_feature_async_i420(clip[2], clip[3], H, W).numpy()


# ---------------------------------------------------------------- --bucket
def test_warmup_parses_the_jax_command_line_and_runs(extractor, monkeypatch, capsys):
    """JAX's ``warmup --bucket 8`` line parses with both parsers; the port's
    ``cmd_warmup`` then runs its one resolution and count, unpadded."""
    jax_args = jax_build_parser()[0].parse_args(JAX_WARMUP)
    parser, _ = cli.build_parser()
    args = parser.parse_args([*JAX_WARMUP, "--device", "cpu"])
    assert args.bucket == jax_args.bucket == 8
    assert (args.resolutions, args.counts, args.ingest) == (jax_args.resolutions, jax_args.counts, jax_args.ingest)
    monkeypatch.setattr(cli, "_build_extractor", lambda a: extractor)
    args.fn(args)
    recs = [line for line in capsys.readouterr().out.splitlines() if line.startswith("{")]
    assert len(recs) == 1 and '"frames": 2' in recs[0] and '"bucket": 1' in recs[0], recs


@pytest.mark.parametrize("method", ["video_feature_async_i420", "video_feature_async_yuv",
                                    "video_feature_async", "video_features_batch_i420",
                                    "ShardedVideoEvaluator.videos_batch_feature_i420"])
def test_bucket_keyword_accepted_and_ignored(extractor, clip, vector, method):
    frames, nxt, fbuf, nbuf = clip
    if method == "video_feature_async_i420":
        got = extractor.video_feature_async_i420(fbuf, nbuf, H, W, bucket=8)
    elif method == "video_feature_async_yuv":
        got = extractor.video_feature_async_yuv(bgr_to_yuv420(frames), bgr_to_yuv420(nxt), bucket=8)
    elif method == "video_feature_async":  # the I420 stacks' frames, as the host converter gives them
        frames, nxt = (np.stack([_yuv420_to_bgr_limited(row.reshape(H * 3 // 2, W), W, H) for row in b])
                       for b in (fbuf, nbuf))
        got = extractor.video_feature_async(frames, frames, nxt, bucket=8)
    elif method == "video_features_batch_i420":
        got = extractor.video_features_batch_i420([fbuf], [nbuf], H, W, bucket=8)[0]
    else:
        ev = ShardedVideoEvaluator(extractor, make_mesh(device="cpu"))
        got = ev.videos_batch_feature_i420([fbuf], [nbuf], H, W, bucket=8)[0]
        want = extractor.video_features_batch_i420([fbuf], [nbuf], H, W)[0]
        np.testing.assert_array_equal(got.numpy(), want.numpy())
        return
    if method == "video_features_batch_i420":  # the batched program sums its means in another order
        np.testing.assert_allclose(got.numpy(), vector, rtol=1e-4, atol=1e-5)
    else:
        np.testing.assert_array_equal(got.numpy(), vector)


# ----------------------------------------------------------- keyword names
def _meta(n: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"vid": np.array([f"v{seed}_{i}" for i in range(n)], dtype=object),
            "mos": rng.uniform(1, 5, n)}


def _features(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(n, 6))


def _grey_clip(path) -> str:
    out = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 4, (32, 32))
    for i in range(3):
        out.write(np.full((32, 32, 3), 40 * i + 60, np.uint8))
    out.release()
    return str(path)


def _holdout(**names):
    cfg = TrainConfig(n_repeats=1, n_splits=2, batch_size=8, epochs=2, hidden_features=8, use_swa=False,
                      use_bn=False, patience=2)
    best, median, results = protocol.run_repeated_holdout(**names, features=_features(40, 1), cfg=cfg,
                                                         device="cpu")
    return [dataclasses.astuple(r) for r in results], median


# name -> (a call given {the parameter's name: value}, {JAX name: port name})
CASES = {
    "split_other": (lambda **kw: splits.split_other(**kw, features=_features(20, 0), test_size=0.25,
                                                    random_state=3), {"df": "meta"}),
    "split_lsvq": (lambda **kw: splits.split_lsvq(**kw, train_features=_features(12, 0),
                                                  test_features=_features(8, 1), grey_train=[2]),
                   {"train_df": "train_meta", "test_df": "test_meta"}),
    "split_cross_dataset": (lambda **kw: splits.split_cross_dataset(
        **kw, train_features=_features(12, 0), test_features=_features(8, 1), train_name="konvid_1k"),
        {"train_df": "train_meta", "test_df": "test_meta"}),
    "recover_median_split": (lambda **kw: recover.recover_median_split(
        **kw, features=_features(20, 0), median_test_vids=["v0_3", "v0_7", "v0_11"]), {"df": "meta"}),
    "against_baseline": (lambda **kw: report.against_baseline(**kw, baseline=report.REFERENCE_FINETUNED),
                         {"df": "rows"}),
    "resnet_preprocess": (lambda **kw: resnet.resnet_preprocess(**kw), {"img_rgb_f01": "rgb01"}),
    "vit_preprocess": (lambda **kw: vit.vit_preprocess(**kw), {"img_rgb_f01": "img_rgb01"}),
}
VALUES = {"meta": lambda: _meta(20, 0), "train_meta": lambda: _meta(12, 1), "test_meta": lambda: _meta(8, 2),
          "rows": lambda: [{"method": "ours", "dataset": "konvid_1k", "SRCC": 0.5}],
          "rgb01": lambda: torch.rand((2, 3, 8, 8), generator=torch.Generator().manual_seed(0)),
          "img_rgb01": lambda: torch.rand((2, 3, 8, 8), generator=torch.Generator().manual_seed(0))}


def _same(a, b):
    if isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, torch.Tensor):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("name", sorted(CASES))
def test_jax_keyword_names(name):
    call, names = CASES[name]
    port = call(**{p: VALUES[p]() for p in names.values()})
    jax = call(**{j: VALUES[p]() for j, p in names.items()})
    _same(jax, port)
    with pytest.raises(TypeError, match="two names of one argument"):
        j, p = next(iter(names.items()))
        call(**{j: VALUES[p](), p: VALUES[p]()}, **{jj: VALUES[pp]() for jj, pp in names.items() if jj != j})


def test_greyscale_report_takes_df(tmp_path):
    meta = {"vid": np.array(["grey", "missing"], dtype=object), "mos": np.ones(2)}
    path = {"grey": _grey_clip(tmp_path / "grey.mp4"), "missing": str(tmp_path / "missing.mp4")}
    want = greyscale.greyscale_report(meta, path.get)
    assert want == [{"Index": 0, "vid": "grey", "Is Greyscale": True}]
    assert greyscale.greyscale_report(df=meta, video_path_fn=path.get) == want


def test_run_repeated_holdout_takes_df():
    meta = _meta(40, 5)
    _same(_holdout(df=meta), _holdout(meta=meta))


def test_interpolate_pos_embed_takes_jax_arguments():
    """JAX's ``(pos_embed, h_patches, w_patches)`` by position and by keyword,
    the port's ``(hp, wp)`` likewise; a table given is the one resized."""
    model = random_init_(vit.ViT(depth=1), 2)
    want = model.interpolate_pos_embed(14, 16)
    assert want.shape == (1, 14 * 16 + 1, 768)
    for got in (model.interpolate_pos_embed(model.pos_embed, 14, 16),
                model.interpolate_pos_embed(pos_embed=model.pos_embed, h_patches=14, w_patches=16),
                model.interpolate_pos_embed(h_patches=14, w_patches=16),
                model.interpolate_pos_embed(hp=14, wp=16)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    other = torch.randn_like(model.pos_embed)
    got = model.interpolate_pos_embed(other, h_patches=14, w_patches=16)
    with torch.no_grad():
        model.pos_embed.copy_(other)
    torch.testing.assert_close(got, model.interpolate_pos_embed(14, 16), rtol=0, atol=0)


def test_distributed_step_takes_cfg_in_the_jax_position():
    """``DistributedMlpTrainStep(mesh, input_dim, cfg, ...)``: the third
    argument is JAX's unread ``cfg``, not ``hidden``."""
    mesh = make_mesh(device="cpu")
    step = DistributedMlpTrainStep(mesh, 8, TrainConfig(), hidden=4, drop_rate=0.0)
    assert (step.input_dim, step.hidden, step.drop_rate) == (8, 4, 0.0)
    assert DistributedMlpTrainStep(mesh, 8).hidden == 256
