"""Seeded weights, head and scaler, drawn on the device in a few large calls.

Every normally distributed tensor of a state dict comes from one ``randn``
over their total size, scaled by a per-element standard deviation (convs
He-normal, linears 1/sqrt(fan_in), class token and positions 0.02, BN
running means 0.1); BN running variances from one ``rand`` (0.5 to 1.5);
norm weights one and biases zero.  The state dicts hold views of one buffer
each, in the type the backbones are served in.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .reference import models

STREAMS = {"resnet": 1, "vit": 2, "head": 3, "scaler": 4, "clips": 5}


def sub_seed(seed: int, stream: str, index: int = 0) -> int:
    """A 63-bit seed for one use of ``--seed`` (any whole number >= 0)."""
    return int(np.random.SeedSequence([int(seed), STREAMS[stream], index]).generate_state(2, np.uint64)[0] >> np.uint64(1))


def _std(kind: str, shape: tuple) -> float:
    fan_in = math.prod(shape[1:])
    return {"conv": math.sqrt(2.0 / max(fan_in, 1)), "linear": fan_in**-0.5, "token": 0.02, "bn_mean": 0.1}[kind]


@torch.no_grad()
def draw(spec: list, seed: int, dtype: torch.dtype, device) -> dict:
    """A state dict for ``spec`` ((name, shape, kind) in order) from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    normal = [(n, s, k) for n, s, k in spec if k in ("conv", "linear", "token", "bn_mean")]
    sizes = [math.prod(s) for _, s, _ in normal]
    std = torch.repeat_interleave(torch.tensor([_std(k, s) for _, s, k in normal], dtype=torch.float32),
                                  torch.tensor(sizes)).to(device)
    flat = (torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32) * std).to(dtype)
    var = [(n, s) for n, s, k in spec if k == "bn_var"]
    vsizes = [math.prod(s) for _, s in var]
    vflat = (torch.rand(sum(vsizes), generator=gen, device=device, dtype=torch.float32) + 0.5).to(dtype)
    out = dict(zip((n for n, _, _ in normal), (t.view(s) for t, (_, s, _) in zip(flat.split(sizes), normal))))
    out.update(zip((n for n, _ in var), (t.view(s) for t, (_, s) in zip(vflat.split(vsizes), var))))
    for name, shape, kind in spec:
        if kind in ("one", "zero"):
            out[name] = (torch.ones if kind == "one" else torch.zeros)(shape, dtype=dtype, device=device)
        elif kind == "count":
            out[name] = torch.zeros((), dtype=torch.int64, device=device)
    return {n: out[n] for n, _, _ in spec}


def backbones(seed: int, vit_depth: int, dtype: torch.dtype, device) -> tuple[dict, dict]:
    """ResNet-50 and ViT-B/16 state dicts in the served type."""
    return (draw(models.spec_resnet50(), sub_seed(seed, "resnet"), dtype, device),
            draw(models.spec_vit(vit_depth), sub_seed(seed, "vit"), dtype, device))


def head(seed: int, in_features: int, device, pred_bias: float, pred_gain: float) -> dict:
    """The MLP head in float32; its output layer gains ``pred_gain`` and the
    bias ``pred_bias``, so the raw prediction spreads over the MOS scale as a
    fitted head's does."""
    sd = draw(models.spec_head(in_features), sub_seed(seed, "head"), torch.float32, device)
    sd["fc3.weight"] = sd["fc3.weight"] * pred_gain
    sd["fc3.bias"] = torch.full_like(sd["fc3.bias"], pred_bias)
    return sd


def scaler(seed: int, base_scale: np.ndarray, log_scale_std: float, offset_std: float) -> dict:
    """Imputer fill and min-max map (``x * scale + offset``), float64 on the
    host: each feature's scale is ``base_scale`` (one over its part's typical
    size) times a seeded log-normal factor."""
    n = len(base_scale)
    rng = np.random.default_rng(sub_seed(seed, "scaler"))
    return {"fill": rng.normal(size=n), "scale": base_scale * np.exp(rng.normal(0.0, log_scale_std, n)),
            "offset": rng.normal(0.0, offset_std, n)}
