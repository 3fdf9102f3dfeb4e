"""How ``correct`` is decided: every answer of the window against the plain
reference on the same clip.

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

A non-finite answer reads infinity.  Each number has the limit that the
configuration file gives it.
"""

from __future__ import annotations

import math

import numpy as np

from .reference import to_100

STACK, POOL, VIT = 13120, 2051, 2304
PARTS = {  # name -> slice of the vector
    "frame_resnet": slice(0, STACK),
    "frame_vit": slice(STACK, STACK + VIT),
    "ori_resnet": slice(STACK + VIT, 2 * STACK + VIT),
    "merged_pool": slice(2 * STACK + VIT, 2 * STACK + VIT + POOL),
    "ori_vit": slice(2 * STACK + VIT + POOL, 2 * STACK + 2 * VIT + POOL),
    "merged_vit": slice(2 * STACK + 2 * VIT + POOL, 2 * STACK + 3 * VIT + POOL),
}
NUMBERS = tuple(PARTS) + ("mos",)


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


def gaps(vec: np.ndarray, mos: float, ref, video_type: str) -> dict:
    """One answer's numbers against the reference's ``(vector, swaps,
    prediction function on 0-100)``."""
    ref_vec, swaps, pred100 = ref
    near = nearest(vec, ref_vec, swaps) if np.isfinite(vec).all() else ref_vec
    out = {}
    for name, sl in PARTS.items():
        a, r = vec[sl].astype(np.float64), near[sl].astype(np.float64)
        err = np.linalg.norm(a - r) / max(np.linalg.norm(r), 1e-30)
        out[name] = float(err) if np.isfinite(err) else math.inf
    d = abs(to_100(float(mos), video_type) - float(pred100(vec))) if np.isfinite(vec).all() else math.inf
    out["mos"] = d if math.isfinite(d) else math.inf
    return out


def worst(answers, refs: dict, video_type: str) -> dict:
    """answers: (clip index, vector, served MOS); refs: clip index -> the
    reference's (vector, swaps, prediction function) -> each number's worst
    reading.  Equal answers of one clip are read once."""
    out, seen = dict.fromkeys(NUMBERS, 0.0), set()
    for clip, vec, mos in answers:
        key = (clip, vec.tobytes(), float(mos))
        if key in seen:
            continue
        seen.add(key)
        for k, v in gaps(vec, mos, refs[clip], video_type).items():
            out[k] = max(out[k], v)
    return out


def judge(readings: dict, limits: dict) -> tuple[bool, dict]:
    """-> (every reading within its limit, {name: {"value", "limit"}})."""
    table = {k: {"value": readings[k], "limit": limits[k]} for k in NUMBERS}
    return all(v["value"] <= v["limit"] for v in table.values()), table
