"""The yardstick's operation and byte counts against hand counts."""

import pytest
import torch

from portbench import counts, spec


def test_resnet50_flops_at_224():
    # conv1 (7x7, 3->64, 112x112), then per stage: the first block's 1x1 with its
    # downsample, 3x3 at stride, 1x1; the other blocks 1x1, 3x3, 1x1 at the stage's size
    hand = 2 * 3 * 64 * 49 * 112 * 112
    size, cin = 56, 64
    for blocks, width, stride in ((3, 64, 1), (4, 128, 2), (6, 256, 2), (3, 512, 2)):
        out = size // stride
        hand += 2 * (cin * width * size * size + width * width * 9 * out * out + width * 4 * width * out * out
                     + cin * 4 * width * out * out)
        hand += (blocks - 1) * 2 * (4 * width * width + width * width * 9 + width * 4 * width) * out * out
        size, cin = out, 4 * width
    assert counts.resnet50_flops() == hand
    # torchvision: 4.09 GMACs, of them 2.05e6 in the classifier, which the taps do not run
    assert counts.resnet50_flops() == pytest.approx(2 * (4.0892e9 - 2.048e6), rel=1e-4)


def test_vit_b16_flops_at_224():
    n, d = 197, 768
    block = 2 * n * d * 3 * d + 2 * 2 * n * n * d + 2 * n * d * d + 2 * 2 * n * d * 4 * d
    hand = 2 * 196 * 768 * 768 + 12 * block
    assert counts.vit_flops() == hand
    assert counts.vit_flops() == pytest.approx(2 * 17.58e9, rel=2e-3)  # ViT-B/16: 17.6 GMACs


def test_video_flops_of_a_540p_video():
    assert counts.video_flops(16, 16) == pytest.approx(2.08e12, rel=0.01)  # 48 images


def test_kernel_bounds_at_one_shape():
    k1, k2, k3 = (spec.metric_module(f"k{i}_roofline") for i in (1, 2, 3))
    # K1 at the 540p finest level, 16 pairs: 17 floats a pixel by bytes (80 ops a pixel at 67e12 is shorter)
    px = 16 * 540 * 960
    flow = torch.empty(16, 2, 540, 960)
    assert k1.bound_s(None, None, flow) == pytest.approx(px * 17 * 4 / 3.35e12)
    # K2 at winsize 15: 7 floats a pixel against 155 adds a pixel at 33.5e12
    m = torch.empty(16, 5, 540, 960)
    assert k2.bound_s(m, 15) == pytest.approx(max(px * 28 / 3.35e12, px * 155 / 33.5e12))
    # K3 over (48, 197, 12, 64): bf16 by bytes, f32 by operations
    b, n, h, d = 48, 197, 12, 64
    q16, q32 = torch.empty(b, n, h, d, dtype=torch.bfloat16), torch.empty(b, n, h, d)
    assert k3.bound_s(q16, q16, q16, 0.125) == pytest.approx(4 * b * n * h * d * 2 / 3.35e12)
    assert k3.bound_s(q32, q32, q32, 0.125) == pytest.approx(4 * b * h * n * n * d / 67e12)
