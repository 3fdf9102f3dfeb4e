"""An independent torch + cv2 + PIL reference of the feature pipeline, for
``parity.feature_parity`` (own copy of ``relaxtpu/oracle.py``).

It computes the 35,203-dim vector with the reference's own stack: PIL
resizes, torchvision-style transforms, plain torch backbones with
torchvision / DINO names, cv2 Farneback and colour conversion, numpy
fragment assembly.  It uses nothing of the port's pipeline (no
``relaxtpu_torch.ops`` or ``features`` module but the layout spec), so the
same state dicts drive this reference and ``features.pipeline``, and the
comparison covers the whole composition.  It runs on the CPU.

Reference semantics:
- ResNet transform: PIL RGB -> Resize((224, 224)) bilinear -> ToTensor ->
  ImageNet Normalize; ViT transform: PIL LANCZOS resize to 224 if needed,
  ToTensor only.
- 15-tap layer stack with spatial means; the 2,051 pool hstack[vec, mean,
  max, std]; the ViT's 2,304 token mean | max | std.
- Fragments: per-16x16 abs-sum scores, top-196 by argsort(-scores), re-sorted
  by (row, col), raster-packed into a 224x224 canvas; the residual's
  positions reused for the original frame's fragment.
- Flow: cv2.calcOpticalFlowFarneback(.5, 3, 15, 3, 5, 1.2, 0) and its HSV
  image; merge by addWeighted 0.5 / 0.5; segment means concatenated
  resnet | vit | frag_resnet | frag_vit.
"""

from __future__ import annotations

import numpy as np

RESNET_TAP_ORDER = (
    ["conv1"]
    + [f"layer1.{i}" for i in range(3)]
    + [f"layer2.{i}" for i in range(4)]
    + [f"layer3.{i}" for i in range(4)]
    + [f"layer4.{i}" for i in range(3)]
)

_IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
_IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


# --------------------------------------------------------------- torch models
def _load_covering(model, state_dict) -> None:
    """Load ``state_dict``, requiring it to COVER the model.

    Real checkpoints carry extras the oracle doesn't define (torchvision's
    ``fc.*``, DINO's head keys) — those are fine to skip.  A key the model
    needs but the checkpoint lacks would silently leave seeded-random weights
    in an oracle whose whole premise is sharing the pipeline's weights, so
    missing keys raise instead.
    """
    import torch

    missing, _unexpected = model.load_state_dict(
        {k: torch.as_tensor(v) for k, v in state_dict.items()}, strict=False
    )
    if missing:
        raise ValueError(
            f"oracle checkpoint does not cover the model; missing keys: {missing}"
        )


def build_torch_resnet50(state_dict=None, seed: int = 0):
    """torchvision-naming ResNet-50 that returns every tap in one forward.

    With ``state_dict=None``, weights are seeded-random and BN running stats
    randomized: the same FLOPs and weight path as a pretrained checkpoint.
    """
    import torch
    import torch.nn as tnn

    class Bottleneck(tnn.Module):
        def __init__(self, cin, width, stride):
            super().__init__()
            cout = width * 4
            self.conv1 = tnn.Conv2d(cin, width, 1, bias=False)
            self.bn1 = tnn.BatchNorm2d(width)
            self.conv2 = tnn.Conv2d(width, width, 3, stride, 1, bias=False)
            self.bn2 = tnn.BatchNorm2d(width)
            self.conv3 = tnn.Conv2d(width, cout, 1, bias=False)
            self.bn3 = tnn.BatchNorm2d(cout)
            self.relu = tnn.ReLU()
            if stride != 1 or cin != cout:
                self.downsample = tnn.Sequential(
                    tnn.Conv2d(cin, cout, 1, stride, bias=False),
                    tnn.BatchNorm2d(cout),
                )
            else:
                self.downsample = None

        def forward(self, x):
            idt = x if self.downsample is None else self.downsample(x)
            y = self.relu(self.bn1(self.conv1(x)))
            y = self.relu(self.bn2(self.conv2(y)))
            y = self.bn3(self.conv3(y))
            return self.relu(y + idt)

    class ResNet50Taps(tnn.Module):
        def __init__(self):
            super().__init__()
            self.conv1 = tnn.Conv2d(3, 64, 7, 2, 3, bias=False)
            self.bn1 = tnn.BatchNorm2d(64)
            self.relu = tnn.ReLU()
            self.maxpool = tnn.MaxPool2d(3, 2, 1)
            cfg = [(3, 64, 1), (4, 128, 2), (6, 256, 2), (3, 512, 2)]
            cin = 64
            for si, (n, w, s) in enumerate(cfg, 1):
                blocks = [
                    Bottleneck(cin if bi == 0 else w * 4, w, s if bi == 0 else 1)
                    for bi in range(n)
                ]
                cin = w * 4
                setattr(self, f"layer{si}", tnn.Sequential(*blocks))

        def forward(self, x):
            taps = {}
            y = self.conv1(x)
            taps["conv1"] = y  # pre-BN module output, like the reference hook
            y = self.maxpool(self.relu(self.bn1(y)))
            for si in range(1, 5):
                for bi, blk in enumerate(getattr(self, f"layer{si}")):
                    y = blk(y)
                    taps[f"layer{si}.{bi}"] = y
            taps["avgpool"] = y.mean(dim=(2, 3))
            return taps

    torch.manual_seed(seed)
    model = ResNet50Taps().eval()
    if state_dict is not None:
        _load_covering(model, state_dict)
    else:
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for m in model.modules():
                if isinstance(m, tnn.BatchNorm2d):
                    m.running_mean.copy_(
                        torch.randn(m.running_mean.shape, generator=gen) * 0.1
                    )
                    m.running_var.copy_(
                        torch.rand(m.running_var.shape, generator=gen) + 0.5
                    )
    return model


def build_torch_vit(state_dict=None, depth: int = 12, seed: int = 0):
    """DINO-naming ViT-B/16 returning patch tokens (B, 196, 768)."""
    import torch
    import torch.nn as tnn

    dim, heads = 768, 12

    class Block(tnn.Module):
        def __init__(self):
            super().__init__()
            self.norm1 = tnn.LayerNorm(dim, eps=1e-6)
            self.norm2 = tnn.LayerNorm(dim, eps=1e-6)
            self.attn = tnn.Module()
            self.attn.qkv = tnn.Linear(dim, dim * 3, bias=True)
            self.attn.proj = tnn.Linear(dim, dim)
            self.mlp = tnn.Module()
            self.mlp.fc1 = tnn.Linear(dim, dim * 4)
            self.mlp.fc2 = tnn.Linear(dim * 4, dim)

        def forward(self, x):
            b, n, c = x.shape
            qkv = (
                self.attn.qkv(self.norm1(x))
                .reshape(b, n, 3, heads, c // heads)
                .permute(2, 0, 3, 1, 4)
            )
            q, k, v = qkv[0], qkv[1], qkv[2]
            a = ((q @ k.transpose(-2, -1)) * (c // heads) ** -0.5).softmax(dim=-1)
            y = (a @ v).transpose(1, 2).reshape(b, n, c)
            x = x + self.attn.proj(y)
            return x + self.mlp.fc2(tnn.functional.gelu(self.mlp.fc1(self.norm2(x))))

    class ViTTokens(tnn.Module):
        def __init__(self):
            super().__init__()
            self.cls_token = tnn.Parameter(torch.randn(1, 1, dim) * 0.02)
            self.pos_embed = tnn.Parameter(torch.randn(1, 197, dim) * 0.02)
            self.patch_embed = tnn.Module()
            self.patch_embed.proj = tnn.Conv2d(3, dim, 16, 16)
            self.blocks = tnn.Sequential(*[Block() for _ in range(depth)])
            self.norm = tnn.LayerNorm(dim, eps=1e-6)

        def forward(self, x):
            b = x.shape[0]
            y = self.patch_embed.proj(x).flatten(2).transpose(1, 2)
            y = torch.cat([self.cls_token.expand(b, -1, -1), y], dim=1)
            y = self.blocks(y + self.pos_embed)
            return self.norm(y)[:, 1:]

    torch.manual_seed(seed)
    model = ViTTokens().eval()
    if state_dict is not None:
        _load_covering(model, state_dict)
    return model


# ----------------------------------------------------------------- transforms
def _to_pil_rgb(img_bgr: np.ndarray):
    from PIL import Image

    return Image.fromarray(np.ascontiguousarray(img_bgr[..., ::-1]))


def resnet_input(img_bgr: np.ndarray):
    """PIL bilinear Resize(224) + ToTensor + ImageNet Normalize -> (1,C,H,W)."""
    import torch
    from PIL import Image

    img = _to_pil_rgb(img_bgr)
    if img.size != (224, 224):
        img = img.resize((224, 224), Image.Resampling.BILINEAR)
    x = np.asarray(img, np.float32) / 255.0
    x = (x - _IMAGENET_MEAN) / _IMAGENET_STD
    return torch.from_numpy(x.transpose(2, 0, 1))[None]


def vit_input(img_bgr: np.ndarray):
    """PIL LANCZOS resize to 224 if needed, ToTensor only -> (1,C,H,W)."""
    import torch
    from PIL import Image

    img = _to_pil_rgb(img_bgr)
    if img.size != (224, 224):
        img = img.resize((224, 224), Image.Resampling.LANCZOS)
    x = np.asarray(img, np.float32) / 255.0
    return torch.from_numpy(x.transpose(2, 0, 1))[None]


# ------------------------------------------------------------------ fragments
def patch_grid_scores(img: np.ndarray, patch: int = 16) -> np.ndarray:
    """Per-patch abs-sum score grid (float64, exact int accumulation)."""
    h, w = img.shape[:2]
    gh, gw = h // patch, w // patch
    crop = img[: gh * patch, : gw * patch].astype(np.int64)
    return np.abs(crop).reshape(gh, patch, gw, patch, -1).sum(axis=(1, 3, 4)).astype(
        np.float64
    )


def top_positions(scores: np.ndarray, top_n: int = 196) -> list[tuple[int, int]]:
    """Top-n grid cells by score (argsort(-scores) order), re-sorted (y, x)."""
    flat_order = np.argsort(-scores.ravel())[:top_n]
    ys, xs = np.unravel_index(flat_order, scores.shape)
    return sorted(zip(ys.tolist(), xs.tolist()))


def pack_fragment(
    img: np.ndarray, positions, patch: int = 16, target: int = 224
) -> np.ndarray:
    """Raster-pack the selected patches into a (target, target, C) canvas."""
    per_row = target // patch
    out = np.zeros((target, target, img.shape[2]), img.dtype)
    for k, (y, x) in enumerate(positions):
        r, c = divmod(k, per_row)
        out[r * patch : (r + 1) * patch, c * patch : (c + 1) * patch] = img[
            y * patch : (y + 1) * patch, x * patch : (x + 1) * patch
        ]
    return out


def flow_to_bgr_ref(flow: np.ndarray) -> np.ndarray:
    """Reference flow visualization: hue=angle, sat=255, val=minmax magnitude."""
    import cv2

    mag, ang = cv2.cartToPolar(flow[..., 0], flow[..., 1])
    hsv = np.zeros((*flow.shape[:2], 3), np.uint8)
    hsv[..., 0] = ang * 180 / np.pi / 2
    hsv[..., 1] = 255
    hsv[..., 2] = cv2.normalize(mag, None, 0, 255, cv2.NORM_MINMAX)
    return cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR)


# ---------------------------------------------------------------- aggregation
def layer_stack_feature_torch(taps: dict) -> np.ndarray:
    """(13,120): spatial mean per tap, concatenated in reference order."""
    parts = [
        taps[name][0].detach().numpy().mean(axis=(1, 2)) for name in RESNET_TAP_ORDER
    ]
    return np.hstack(parts)


def resnet_pool_feature_np(vec2048: np.ndarray) -> np.ndarray:
    """(2,051): hstack[vec, mean, max, std] (std ddof=0)."""
    return np.hstack([vec2048, vec2048.mean(), vec2048.max(), vec2048.std()])


def vit_stats_np(tokens: np.ndarray) -> np.ndarray:
    """(2,304): token-wise mean/max/std over the 196 patch tokens."""
    return np.hstack([tokens.mean(axis=0), tokens.max(axis=0), tokens.std(axis=0)])


# -------------------------------------------------------------- full pipeline
def reference_video_feature(
    frames_bgr: np.ndarray, next_bgr: np.ndarray, rn_model, vit_model
) -> np.ndarray:
    """The reference pipeline, literally: (frames, successors) -> (35203,).

    ``frames_bgr``: sampled frames (the pairs' first frames are its prefix,
    as in the reference's ffmpeg selects); ``next_bgr``: successor frames.
    """
    import cv2
    import torch

    with torch.no_grad():
        rn_rows, vit_rows = [], []
        for f in frames_bgr:
            taps = rn_model(resnet_input(f))
            rn_rows.append(layer_stack_feature_torch(taps))
            tokens = vit_model(vit_input(f))[0].numpy()
            vit_rows.append(vit_stats_np(tokens))

        frag_rn_rows, frag_vit_rows = [], []
        for prev, nxt in zip(frames_bgr[: len(next_bgr)], next_bgr):
            residual = cv2.absdiff(nxt, prev)
            positions = top_positions(patch_grid_scores(residual))
            diff_frag = pack_fragment(residual, positions)
            ori_frag = pack_fragment(prev, positions)
            flow = cv2.calcOpticalFlowFarneback(
                cv2.cvtColor(prev, cv2.COLOR_BGR2GRAY),
                cv2.cvtColor(nxt, cv2.COLOR_BGR2GRAY),
                None, 0.5, 3, 15, 3, 5, 1.2, 0,
            )
            flow_img = flow_to_bgr_ref(flow)
            flow_frag = pack_fragment(flow_img, top_positions(patch_grid_scores(flow_img)))
            merged = cv2.addWeighted(diff_frag, 0.5, flow_frag, 0.5, 0)

            taps_ori = rn_model(resnet_input(ori_frag))
            pool = rn_model(resnet_input(merged))["avgpool"][0].numpy()
            frag_rn_rows.append(
                np.hstack([layer_stack_feature_torch(taps_ori), resnet_pool_feature_np(pool)])
            )
            tok_ori = vit_model(vit_input(ori_frag))[0].numpy()
            tok_mer = vit_model(vit_input(merged))[0].numpy()
            frag_vit_rows.append(np.hstack([vit_stats_np(tok_ori), vit_stats_np(tok_mer)]))

    return np.concatenate([
        np.mean(rn_rows, axis=0),
        np.mean(vit_rows, axis=0),
        np.mean(frag_rn_rows, axis=0),
        np.mean(frag_vit_rows, axis=0),
    ]).astype(np.float32)


# ------------------------------------------------------------------ reporting
def compare_segments(ours: np.ndarray, theirs: np.ndarray) -> dict:
    """Per-segment cosine similarity and relative error report."""
    from relaxtpu_torch.features.layout import segment_slices

    out = {}
    for name, sl in segment_slices().items():
        a = ours[sl].astype(np.float64)
        b = theirs[sl].astype(np.float64)
        denom = np.linalg.norm(a) * np.linalg.norm(b)
        scale = np.abs(b).mean() + 1e-9
        out[name] = {
            "cosine": float(a @ b / (denom + 1e-12)),
            "mean_abs_err_over_mean_abs": float(np.abs(a - b).mean() / scale),
            "max_abs_err_over_mean_abs": float(np.abs(a - b).max() / scale),
        }
    return out
