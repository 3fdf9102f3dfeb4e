"""Frozen feature-layout spec for the 35,203-dim ReLaX-VQA vector.

Own copy of ``relaxtpu/features/layout.py:23-46`` (the port imports nothing
of relaxtpu).  Per-video vector = concat of four per-frame-averaged segments:

1. resnet_stack (13,120): full frames, ResNet-50 channel means of 15 taps.
2. vit_pool      (2,304): full frames, ViT patch-token mean|max|std.
3. frag_resnet  (15,171): ori-fragment resnet_stack | merged-fragment pool
   (2,048 avgpool | mean | max | std).
4. frag_vit      (4,608): ori-fragment ViT stats | merged-fragment ViT stats.
"""

RESNET_STACK_DIM = 64 + 3 * 256 + 4 * 512 + 4 * 1024 + 3 * 2048  # 13,120
VIT_POOL_DIM = 3 * 768  # 2,304
RESNET_POOL_DIM = 2048 + 3  # 2,051
FRAG_RESNET_DIM = RESNET_STACK_DIM + RESNET_POOL_DIM  # 15,171
FRAG_VIT_DIM = 2 * VIT_POOL_DIM  # 4,608

FEATURE_LAYOUT = (
    ("resnet_stack", RESNET_STACK_DIM),
    ("vit_pool", VIT_POOL_DIM),
    ("frag_resnet", FRAG_RESNET_DIM),
    ("frag_vit", FRAG_VIT_DIM),
)

TOTAL_FEATURE_DIM = sum(d for _, d in FEATURE_LAYOUT)
assert TOTAL_FEATURE_DIM == 35203


def segment_slices() -> dict[str, slice]:
    out = {}
    off = 0
    for name, dim in FEATURE_LAYOUT:
        out[name] = slice(off, off + dim)
        off += dim
    return out
