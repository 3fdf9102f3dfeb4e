"""ReLaX-VQA (arXiv 2407.11496), the family of every configuration without a
``"family"`` key: residual and Farneback-flow fragments, ResNet-50 and DINO
ViT-B/16 features, the 35,203-dim vector, an MLP head to a MOS.

The sampler takes frames as the ReLaX-VQA reference samples a file: every
``frame_interval_for(framerate)``-th frame, each with its successor as the
second frame of a pair.  The program is the port's public entry:
``FeatureExtractor.video_feature_async_i420`` on a clip's host I420 frames
and successors, then ``VideoQualityPredictor.predict_feature`` on the
fetched vector.  ResNet-50, ViT-B/16, the head and the scaler are drawn on
the card from the seed (``weights``); the plain reference is
``portbench/reference``.

The numbers compared, each the worst over all answers:

- the relative L2 error ||answer - reference|| / ||reference|| of each part
  of the 35,203-dim vector: the frames' ResNet-50 layer stack and ViT
  stats, and of the fragments the original-frame stack and ViT stats and
  the merged (residual + flow image) fragment's pool stats and ViT stats;
- the absolute error of the MOS, on the head's 0-100 scale (a KoNViD-1k
  MOS of 1-5 is mapped back to it, so that one limit holds for every
  dataset), against the reference's imputer, scaler and head applied to
  the answer's own vector: the vector's numbers hold the features, this
  one the scoring of them.  (The MOS against the reference's own MOS would
  be the features' error projected on one direction, which separates no
  precision from the next: its sign and size swing from clip to clip.)

The flow image's patch choice is a cut through a ranking of integer scores:
where two patches' scores lie within the configuration's ``swap_slack`` of
the cut, a rounding-level change of the flow may swap them, and either answer
is right.  So the reference's answer is a set: its own vector, and the
vectors with any of those swaps made (``Reference.answer``).  An answer is
held against the member nearest to it, found pair by pair (``nearest``).
"""

from __future__ import annotations

import math

import numpy as np

from portbench import clips, counts, weights
from portbench.reference import Reference, to_100, to_served

STACK, POOL, VIT = 13120, 2051, 2304
PARTS = {  # name -> slice of the vector
    "frame_resnet": slice(0, STACK),
    "frame_vit": slice(STACK, STACK + VIT),
    "ori_resnet": slice(STACK + VIT, 2 * STACK + VIT),
    "merged_pool": slice(2 * STACK + VIT, 2 * STACK + VIT + POOL),
    "ori_vit": slice(2 * STACK + VIT + POOL, 2 * STACK + 2 * VIT + POOL),
    "merged_vit": slice(2 * STACK + 2 * VIT + POOL, 2 * STACK + 3 * VIT + POOL),
}


def frame_interval_for(framerate: float) -> int:
    """The reference's sampling interval: half the frame rate, rounded down."""
    return math.ceil(framerate / 2) if framerate < 2 else int(framerate / 2)


def sample(traffic: dict) -> dict:
    """Raw indices of the sampled frames and of the pairs' second frames."""
    n = clips.n_frames(traffic)
    step = max(frame_interval_for(traffic["framerate"]), 1)
    firsts = list(range(0, n, step))
    return {"frames": firsts, "nexts": [f + 1 for f in firsts if f + 1 < n]}


class Program:
    """The port's extractor and predictor; ``resnet`` and ``vit`` are the
    extractor's networks, which metrics' ``HOOKS`` name."""

    def __init__(self, extractor, predictor):
        self.fx, self.pred = extractor, predictor
        self.resnet, self.vit = extractor.resnet, extractor.vit

    def enqueue(self, clip: clips.Clip):
        return self.fx.video_feature_async_i420(clip.groups["frames"], clip.groups["nexts"], clip.h, clip.w)

    def finish(self, vec) -> tuple:
        host = vec.cpu().numpy()
        return host, self.pred.predict_feature(host)


def build(cell, seed: int, device) -> tuple:
    """The kernel library, seeded weights on the card -> the program, and the
    state dicts and scaler that the reference gets too."""
    import torch

    from relaxtpu_torch.features.pipeline import FeatureExtractor
    from relaxtpu_torch.model.scalers import FeatureScaler
    from relaxtpu_torch.predict import VideoQualityPredictor

    if torch.device(device).type == "cuda":
        from relaxtpu_torch import _native

        _native.lib()
    cfg, seeded = cell.config, cell.config["seeded"]
    dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[cfg["backbone_dtype"]]
    depth = cfg["vit"]["depth"]
    rn, vit = weights.backbones(seed, depth, dtype, device)
    head = weights.head(seed, cfg["head"]["in_features"], device, seeded["head_pred_bias"], seeded["head_pred_gain"])
    base = np.ones(cfg["head"]["in_features"])
    for part, sl in PARTS.items():
        base[sl] = 1.0 / seeded["scaler_part_rms"][part]
    scaler = weights.scaler(seed, base, seeded["scaler_log_scale_std"], seeded["scaler_offset_std"])
    fx = FeatureExtractor(rn, vit, dtype=dtype, vit_depth=depth, device=device)
    pred = VideoQualityPredictor(fx, head, FeatureScaler(**scaler), video_type=cell.traffic["video_type"])
    return Program(fx, pred), (rn, vit, head, scaler)


def references(cell, states, pool: list, device, precision: str = "f32") -> dict:
    """clip index -> the plain reference's (vector, swaps, prediction function)."""
    rn, vit, head, scaler = states
    ref = Reference(rn, vit, head, scaler, cell.config["vit"]["depth"], cell.traffic["video_type"], device, precision,
                    cell.config["swap_slack"])
    return {i: (*ref.answer(clip.groups["frames"], clip.groups["nexts"], clip.h, clip.w), ref.pred100)
            for i, clip in enumerate(pool)}


def nearest(vec: np.ndarray, ref_vec: np.ndarray, swaps: list) -> np.ndarray:
    """The member of the reference's set nearest to ``vec`` in the merged
    parts (relative squared errors added): greedily, pair by pair, the
    reference's own choice or one of its swaps, until nothing changes."""
    if not swaps:
        return ref_vec
    sl = [PARTS["merged_pool"], PARTS["merged_vit"]]
    w = np.zeros(len(ref_vec))
    for s in sl:
        w[s] = 1.0 / max(float(np.sum(ref_vec[s].astype(np.float64) ** 2)), 1e-30)
    r = ref_vec.astype(np.float64)
    chosen = [None] * len(swaps)
    e = vec.astype(np.float64) - r
    for _ in range(3):
        changed = False
        for i, options in enumerate(swaps):
            base = e + (options[chosen[i]] if chosen[i] is not None else 0.0)  # the error with this pair unswapped
            costs = [float(np.sum(w * base**2))] + [float(np.sum(w * (base - d) ** 2)) for d in options]
            best = int(np.argmin(costs))
            pick = None if best == 0 else best - 1
            if pick != chosen[i]:
                chosen[i], changed = pick, True
                e = base - (options[pick] if pick is not None else 0.0)
        if not changed:
            break
    return vec.astype(np.float64) - e


def gaps(cell, vec: np.ndarray, mos: float, ref) -> dict:
    """One answer's numbers against the reference's ``(vector, swaps,
    prediction function on 0-100)``."""
    ref_vec, swaps, pred100 = ref
    video_type = cell.traffic["video_type"]
    near = nearest(vec, ref_vec, swaps) if np.isfinite(vec).all() else ref_vec
    out = {}
    for name, sl in PARTS.items():
        a, r = vec[sl].astype(np.float64), near[sl].astype(np.float64)
        err = np.linalg.norm(a - r) / max(np.linalg.norm(r), 1e-30)
        out[name] = float(err) if np.isfinite(err) else math.inf
    d = abs(to_100(float(mos), video_type) - float(pred100(vec))) if np.isfinite(vec).all() else math.inf
    out["mos"] = d if math.isfinite(d) else math.inf
    return out


def served(cell, ref) -> tuple:
    """The reference's vector and the MOS its head gives it, as served."""
    vec, _, pred100 = ref
    return vec, to_served(pred100(vec), cell.traffic["video_type"])


def video_flops(cell, clip: clips.Clip) -> float:
    """Backbone operations of one video: F frames and 2 P fragments through both networks."""
    return counts.video_flops(len(clip.groups["frames"]), len(clip.groups["nexts"]), cell.config["vit"]["depth"])


def peak_flops(cell) -> float:
    return counts.PEAK_FLOPS[cell.config["backbone_dtype"]]


def launch_counts() -> dict:
    """The program's launch counters of the three kernels."""
    from relaxtpu_torch.ops.attention import mha
    from relaxtpu_torch.ops.boxsolve import box_blur_solve
    from relaxtpu_torch.ops.warp import update_matrices

    return {"k1": update_matrices.launches, "k2": box_blur_solve.launches, "k3": mha.launches}


def notes(cell, refs: dict) -> dict:
    """The reference's MOS on 0-100, its RMS a part (``seeded.scaler_part_rms``
    was measured so) and the pairs with swaps, by clip."""
    rms = {k: float(sum((refs[c][0][sl].astype("float64") ** 2).mean() ** 0.5 for c in refs) / len(refs))
           for k, sl in PARTS.items()}
    return {"pred100": [refs[c][2](refs[c][0]) for c in sorted(refs)], "ref_rms": rms,
            "pairs_with_swaps": [len(refs[c][1]) for c in sorted(refs)]}
