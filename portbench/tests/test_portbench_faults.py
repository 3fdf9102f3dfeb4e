"""The check fails a run whose timed path is broken underneath: the harness's
look for a card skipped, the rest of a run driven on the CPU at a tiny size."""

import pytest

from relaxtpu_torch.features.pipeline import FeatureExtractor
from relaxtpu_torch.predict import VideoQualityPredictor

from .helpers import tiny_cell, tiny_run


def test_sound_run_is_correct():
    assert tiny_run(tiny_cell())["correct"] is True


def test_half_the_pairs_left_out(monkeypatch):
    vec = FeatureExtractor._videos_vec

    def half(self, frames, pairs, n_frames, n_pairs, chunk):
        kept = [n // 2 for n in n_pairs]  # the mean taken over the first half of the pairs
        return vec(self, frames, pairs, n_frames, kept, chunk)

    monkeypatch.setattr(FeatureExtractor, "_videos_vec", half)
    res = tiny_run(tiny_cell())
    assert res["correct"] is False
    assert res["checks"]["ori_resnet"]["value"] > res["checks"]["ori_resnet"]["limit"]


@pytest.mark.parametrize("where", ["vector", "mos"])
def test_answer_altered_where_it_is_produced(monkeypatch, where):
    if where == "vector":
        enqueue = FeatureExtractor.video_feature_async_i420

        def altered(self, *a, **kw):
            v = enqueue(self, *a, **kw).clone()
            v[20000] += 0.01 * v.norm()  # one entry of the original fragments' ResNet stack
            return v

        monkeypatch.setattr(FeatureExtractor, "video_feature_async_i420", altered)
    else:
        score = VideoQualityPredictor.predict_feature
        monkeypatch.setattr(VideoQualityPredictor, "predict_feature", lambda self, v: score(self, v) + 0.05)
    assert tiny_run(tiny_cell())["correct"] is False


def test_failed_request_is_counted(monkeypatch):
    def broken(self, *a, **kw):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    cell = tiny_cell(warmup_videos=0)
    monkeypatch.setattr(FeatureExtractor, "video_feature_async_i420", broken)
    res = tiny_run(cell, seconds=0.2)
    assert res["failed"] == res["attempted"] >= 1 and res["correct"] is False


@pytest.mark.parametrize("limits", ["misnamed", "missing", "extra"])
def test_limits_that_the_numbers_do_not_match_raise(limits):
    cell = tiny_cell()
    named = dict(cell.config["limits"])
    first = next(iter(named))
    if limits == "misnamed":
        named["x_" + first] = named.pop(first)
    elif limits == "missing":
        named.pop(first)
    else:
        named["unread"] = 1.0
    cell.config["limits"] = named
    with pytest.raises(ValueError, match="has limits for"):
        tiny_run(cell, seconds=0.3)
