"""FAST-VQA (Wu et al., ECCV 2022, arXiv 2207.02595; the FAST-B model): grid
mini-patch fragments of a video through Video Swin-T (arXiv 2106.13230) with
gated relative-position biases, a per-position quality head, the mean score.

The sampler takes a clip's frames as FAST-VQA samples a video at test time:
4 clips of 32 frames at interval 2, spread evenly over the video (groups
``clip0``-``clip3``; 80 distinct frames of a 192-frame KoNViD-1k clip).  The
fragments' offsets (one (row, column) pair a grid cell and clip) are drawn
from the seed and the clip's content (``offsets``), so the program and the
reference draw the same ones for a clip.  The program is the port's
``FastVQAExtractor.enqueue_i420`` on the clips' host I420 and its
``finish``; the weights are drawn on the card from the seed; the plain
reference is ``portbench/reference/fastvqa.py``.

The answer is a vector: the per-position scores of the 4 views (4 x 784),
then each view's mean final feature (4 x 768).  The numbers compared, each
the worst over all answers:

- ``head_map``: the relative L2 error ||answer - reference|| / ||reference||
  of the 4 x 784 per-position scores;
- ``feat``: the largest over the views of the relative L2 error of a
  view's mean-pooled 768 final features;
- ``score``: the absolute error of the video's score (the mean of the
  per-position scores; seeded so that scores spread over 0-100) against the
  reference's own score.
"""

from __future__ import annotations

import math
import zlib

import numpy as np

from portbench import clips, counts, weights
from portbench.reference import fastvqa as ref

VIEWS = 4
GROUPS = tuple(f"clip{i}" for i in range(VIEWS))
_STREAM = 21  # this family's draws of the seed (weights.sub_seed's streams are the ReLaX family's)


def sample(traffic: dict) -> dict:
    """Raw indices of each clip's frames (FAST-VQA's test-time clips)."""
    return dict(zip(GROUPS, ref.sample_clips(clips.n_frames(traffic), VIEWS, ref.CLIP_LEN, ref.INTERVAL)))


def _seed(seed: int, *key: int) -> int:
    return int(np.random.SeedSequence([int(seed), _STREAM, *key]).generate_state(1, np.uint64)[0] >> np.uint64(1))


def offsets(seed: int, clip: clips.Clip) -> np.ndarray:
    """(4, 7, 7, 2) offsets of one video, drawn from the seed and a checksum
    of its first frame."""
    key = zlib.crc32(clip.groups[GROUPS[0]][0, :65536].tobytes())
    rng = np.random.default_rng(_seed(seed, 1, key))
    rows, cols = (max(r // ref.FRAGMENTS - ref.FSIZE, 0) for r in (clip.h, clip.w))
    out = np.zeros((VIEWS, ref.FRAGMENTS, ref.FRAGMENTS, 2), np.int64)
    for k, n in ((0, rows), (1, cols)):
        if n:
            out[..., k] = rng.integers(0, n, (VIEWS, ref.FRAGMENTS, ref.FRAGMENTS))
    return out


def state_spec(names_shapes) -> list:
    """(name, shape, kind) for ``weights.draw``: linear weights N(0,
    1/fan_in), convolutions He-normal, LayerNorms identity, biases and the
    bias tables N(0, 0.02^2) (the tables scaled after the draw)."""
    spec = []
    for name, shape in names_shapes:
        if ".norm" in name or name.startswith("backbone.norm"):
            kind = "one" if name.endswith("weight") else "zero"
        elif name.endswith("weight"):
            kind = "conv" if len(shape) == 5 else "linear"
        else:
            kind = "token"
        spec.append((name, tuple(shape), kind))
    return spec


def model_kwargs(cell) -> dict:
    """The backbone's shape from the configuration's ``backbone`` block."""
    b = cell.config["backbone"]
    return dict(depths=tuple(b["depths"]), heads=tuple(b["num_heads"]), embed_dim=b["embed_dim"],
                window=tuple(b["window_size"]))


class Program:
    """The port's FAST-VQA program; offsets for each video from the seed."""

    def __init__(self, fx, seed: int):
        self.fx, self.seed = fx, seed

    def enqueue(self, clip: clips.Clip):
        return self.fx.enqueue_i420([clip.groups[g] for g in GROUPS], clip.h, clip.w, offsets(self.seed, clip))

    def finish(self, handle) -> tuple:
        return self.fx.finish(handle)


def build(cell, seed: int, device) -> tuple:
    """The kernel library, seeded weights on the card -> the program, and the
    f32 state dict and the seed that the reference gets too."""
    import torch

    from relaxtpu_torch.features.fastvqa import FastVQAExtractor
    from relaxtpu_torch.models.swin3d import FastVQA

    if torch.device(device).type == "cuda":
        from relaxtpu_torch import _native

        _native.lib()
    seeded = cell.config["seeded"]
    shapes = [(k, v.shape) for k, v in FastVQA(**model_kwargs(cell)).state_dict().items()]
    sd = weights.draw(state_spec(shapes), _seed(seed, 0), torch.float32, device)
    for k in sd:
        if k.endswith("bias_table"):
            sd[k] = sd[k] * (seeded["table_std"] / 0.02)
    sd["vqa_head.fc_last.weight"] = sd["vqa_head.fc_last.weight"] * seeded["head_pred_gain"]
    sd["vqa_head.fc_last.bias"] = torch.full_like(sd["vqa_head.fc_last.bias"], seeded["head_pred_bias"])
    dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[cell.config["backbone_dtype"]]
    return Program(FastVQAExtractor(sd, dtype, device, **model_kwargs(cell)), seed), (sd, seed)


def references(cell, states, pool: list, device, precision: str = "f32") -> dict:
    """clip index -> the plain reference's (per-position scores (4, 784),
    mean features (4, 768), score)."""
    sd, seed = states
    kw = model_kwargs(cell)
    r = ref.Reference(sd, device, precision, depths=kw["depths"], heads=kw["heads"], window=kw["window"])
    return {i: r.answer([clip.groups[g] for g in GROUPS], clip.h, clip.w, offsets(seed, clip))
            for i, clip in enumerate(pool)}


def _rel(a: np.ndarray, b: np.ndarray) -> float:
    err = np.linalg.norm(a.astype(np.float64) - b.astype(np.float64)) / max(np.linalg.norm(b.astype(np.float64)), 1e-30)
    return float(err) if np.isfinite(err) else math.inf


def gaps(cell, vec: np.ndarray, score: float, ref_answer) -> dict:
    scores, feats, ref_score = ref_answer
    n = scores.size
    got_f = vec[n:].reshape(feats.shape)
    d = abs(float(score) - ref_score)
    return {"head_map": _rel(vec[:n], scores.reshape(-1)),
            "feat": max(_rel(got_f[v], feats[v]) for v in range(len(feats))),
            "score": d if math.isfinite(d) else math.inf}


def served(cell, ref_answer) -> tuple:
    scores, feats, score = ref_answer
    return np.concatenate([scores.reshape(-1), feats.reshape(-1)]).astype(np.float32), score


def swin_flops(t: int, depths, embed_dim: int, window, side: int = 224, **_) -> float:
    """Forward operations of one view of t x side x side: the patch
    embedding, per block the qkv, attention (Q K^T and P V over each
    window's tokens), projection and MLP products, the patch mergings and the
    head (a multiply-add is two; norms, GELU and softmax not counted)."""
    tokens, c, n = (t // 2) * (side // 4) ** 2, embed_dim, math.prod(window)
    total = 2.0 * tokens * c * (3 * 2 * 4 * 4)
    for i, depth in enumerate(depths):
        # qkv 3 C^2, Q K^T and P V over N keys, proj C^2, MLP 2 x 4 C^2: multiply-adds a token
        total += depth * 2.0 * tokens * (3 * c * c + 2 * n * c + c * c + 8 * c * c)
        if i < len(depths) - 1:
            tokens //= 4
            total += 2.0 * tokens * 4 * c * 2 * c
            c *= 2
    return total + 2.0 * tokens * (c * 64 + 64)


def video_flops(cell, clip: clips.Clip) -> float:
    return VIEWS * swin_flops(len(clip.groups[GROUPS[0]]), side=ref.FRAGMENTS * ref.FSIZE, **model_kwargs(cell))


def peak_flops(cell) -> float:
    return counts.PEAK_FLOPS[cell.config["backbone_dtype"]]


def launch_counts() -> dict:
    """The program's launch counter of K4."""
    from relaxtpu_torch.ops.window_attention import window_mha

    return {"k4": window_mha.launches}


def notes(cell, refs: dict) -> dict:
    """The reference's score by clip (the seeded head's spread)."""
    return {"ref_score": [refs[c][2] for c in sorted(refs)]}
