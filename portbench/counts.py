"""The yardstick's arithmetic: peaks of one NVIDIA H100 SXM (data sheet,
dense, at 700 W) and the backbones' operations, counted from shapes.  A
multiply-add counts as two operations.  Each kernel's own count lives in
its roofline metric's file (``metrics/k*_roofline.py``)."""

from __future__ import annotations

from .reference import models

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}  # f32 outside the tensor cores: TF32 off
# adds alone: one a lane a cycle, half the data sheet's f32 rate, which counts an FMA as two
F32_ADDS_PER_S = PEAK_FLOPS["f32"] / 2


def _conv_flops(cin: int, cout: int, k: int, hw_out: int) -> float:
    return 2.0 * cin * cout * k * k * hw_out * hw_out


def resnet50_flops(side: int = 224) -> float:
    """Forward operations of one image: every convolution (BN, ReLU, pools
    and the taps' means are not counted)."""
    s = (side + 2 * 3 - 7) // 2 + 1  # conv1, stride 2
    total = _conv_flops(3, 64, 7, s)
    s = (s + 2 - 3) // 2 + 1  # max pool
    cin = 64
    for blocks, width, stride in models.RESNET_STAGES:
        for b in range(blocks):
            st = stride if b == 0 else 1
            so = (s - 1) // st + 1
            total += _conv_flops(cin, width, 1, s) + _conv_flops(width, width, 3, so) + _conv_flops(width, 4 * width, 1, so)
            if b == 0:
                total += _conv_flops(cin, 4 * width, 1, so)
            cin, s = 4 * width, so
    return total


def vit_flops(depth: int = 12, side: int = 224) -> float:
    """Forward operations of one image: the patch projection, and per block
    the qkv, attention (QK^T and PV), projection and MLP products."""
    d, p = models.VIT_DIM, models.VIT_PATCH
    n = (side // p) ** 2 + 1
    embed = 2.0 * (n - 1) * 3 * p * p * d
    block = 2.0 * n * d * 3 * d + 2.0 * 2 * n * n * d + 2.0 * n * d * d + 2.0 * 2 * n * d * models.VIT_MLP
    return embed + depth * block


def video_flops(n_frames: int, n_pairs: int, vit_depth: int = 12) -> float:
    """Backbone operations of one video: F frames and 2 P fragments through both networks."""
    return (n_frames + 2 * n_pairs) * (resnet50_flops() + vit_flops(vit_depth))


def bound_s(nbytes: float, ops: float, ops_per_s: float) -> float:
    """The least seconds the card could take: bytes at the memory rate or
    operations at ``ops_per_s``, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, ops / ops_per_s)
