"""Video Swin-T (Liu et al., arXiv 2106.13230) with FAST-VQA's gated
relative-position bias and quality head (Wu et al., ECCV 2022, arXiv
2207.02595, the FAST-B model).

The JAX package has no counterpart: FAST-VQA is the port's second model
family.  Inference only (dropout and drop-path are identity).  Parameter
names follow Video Swin and FAST-VQA, so a checkpoint's state dict loads as
it is: ``backbone.patch_embed.proj``, ``backbone.patch_embed.norm``,
``backbone.layers.{i}.blocks.{j}.norm1 / attn.qkv / attn.proj /
attn.relative_position_bias_table / attn.fragment_position_bias_table /
norm2 / mlp.fc1 / mlp.fc2``, ``backbone.layers.{i}.downsample.norm /
reduction``, ``backbone.norm``, ``vqa_head.fc_hid / fc_last``.

- Input: RGB uint8 fragments (B views, T, H, W, 3) (the mosaic of
  ``features/fastvqa.py``), normalised by ImageNet's mean and std.
- Patch embedding: Conv3d(3, 96, (2, 4, 4), stride (2, 4, 4)), LayerNorm.
- Four stages of depths 2/2/6/2, widths 96/192/384/768, heads 3/6/12/24
  (head width 32), MLP ratio 4 with GELU; patch merging after stages 1-3:
  the four 2x2 neighbours concatenated in Video Swin's order, LayerNorm(4C),
  Linear(4C, 2C) without bias; a final LayerNorm.
- Block: ``x += proj(attn(window(roll(norm1(x), -s))))`` reversed and rolled
  back, then ``x += fc2(gelu(fc1(norm2(x))))``; windows (8, 7, 7), shifted
  by (4, 3, 3) on odd blocks, clipped to the grid along an axis where the
  grid is no larger (Video Swin's ``get_window_size``).  The attention is
  K4 (``ops/window_attention.py``), which does the roll and the partition
  by index: the block applies ``qkv`` to the grid as it lies.
- GRPB on stages 1-3 (FAST-VQA's ``frag_biases``: on, on, on, off): two
  tables, ``relative_position_bias_table`` for pairs inside one mini-patch
  of the mosaic and ``fragment_position_bias_table`` for pairs across
  mini-patches (the mapping is assumed: see ``reference_fastvqa.py``); a
  mini-patch is ``mini_patch / 4 / 2^stage`` tokens a side (8, 4, 2 at 32 px).
- Head (FAST-VQA's ``VQAHead``): Conv3d(768, 64, 1), GELU, Conv3d(64, 1, 1)
  on the final feature map, in f32.  A view's score is the mean over its
  positions, the video's the mean over its views.

In bf16 the backbone runs in bf16 (LayerNorm statistics, GELU and K4's
softmax in f32 inside their kernels); the bias tables and the head stay in
f32.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from relaxtpu_torch.device import upload
from relaxtpu_torch.ops.window_attention import effective_window, table_rows, window_mha
from relaxtpu_torch.utils.profiling import span

MEAN = (123.675, 116.28, 103.53)  # RGB, 0-255
STD = (58.395, 57.12, 57.375)
DEPTHS = (2, 2, 6, 2)
HEADS = (3, 6, 12, 24)
EMBED_DIM = 96
WINDOW = (8, 7, 7)
PATCH = (2, 4, 4)
FRAG_BIASES = (True, True, True, False)
HEAD_HIDDEN = 64
TABLES = ("relative_position_bias_table", "fragment_position_bias_table")


class WindowAttention3D(nn.Module):
    def __init__(self, dim: int, heads: int, window, gated: bool):
        super().__init__()
        self.heads, self.window, self.gated = heads, tuple(window), gated
        self.scale = (dim // heads) ** -0.5
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        rows = table_rows(window)
        self.relative_position_bias_table = nn.Parameter(torch.zeros(rows, heads))
        if gated:
            self.fragment_position_bias_table = nn.Parameter(torch.zeros(rows, heads))

    def tables(self) -> tuple:
        return tuple(getattr(self, n) for n in TABLES[: 1 + self.gated])

    def attend(self, qkv: torch.Tensor, grid, window, shift, patch: int, out=None) -> torch.Tensor:
        """K4 over the grid's packed projections (B, L, 3 C) -> (B, L, C)."""
        with span("window_attention"):
            return window_mha(qkv, grid, window, shift, self.heads, self.tables(), patch if self.gated else 0,
                              self.scale, out=out)

    def forward(self, x: torch.Tensor, grid, window, shift, patch: int) -> torch.Tensor:
        """x (B, L, C) in grid order -> (B, L, C)."""
        return self.proj(self.attend(self.qkv(x), grid, window, shift, patch))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class SwinTransformerBlock3D(nn.Module):
    def __init__(self, dim: int, heads: int, window, shift, gated: bool):
        super().__init__()
        self.window, self.shift = tuple(window), tuple(shift)
        self.norm1 = nn.LayerNorm(dim)
        self.attn = WindowAttention3D(dim, heads, window, gated)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = Mlp(dim, 4 * dim)

    # the block in three steps, so that a serving program can launch K4 between the other two
    def pre(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, D, H, W, C) -> qkv (B, D*H*W, 3 C) of norm1(x)."""
        b, *_, c = x.shape
        return self.attn.qkv(self.norm1(x).reshape(b, -1, c))

    def attend(self, qkv: torch.Tensor, grid, patch: int, out=None) -> torch.Tensor:
        window, shift = effective_window(grid, self.window, self.shift)
        return self.attn.attend(qkv, grid, window, shift, patch, out)

    def post(self, x: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
        x = x + self.attn.proj(o).view_as(x)
        return x + self.mlp(self.norm2(x))

    def forward(self, x: torch.Tensor, patch: int) -> torch.Tensor:
        """x (B, D, H, W, C)."""
        return self.post(x, self.attend(self.pre(x), tuple(x.shape[1:4]), patch))


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x):
        x = torch.cat([x[:, :, 0::2, 0::2], x[:, :, 1::2, 0::2], x[:, :, 0::2, 1::2], x[:, :, 1::2, 1::2]], -1)
        return self.reduction(self.norm(x))


class BasicLayer(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, window, gated: bool, downsample: bool):
        super().__init__()
        shift = tuple(w // 2 for w in window)
        self.blocks = nn.ModuleList(
            SwinTransformerBlock3D(dim, heads, window, (0, 0, 0) if i % 2 == 0 else shift, gated)
            for i in range(depth))
        self.downsample = PatchMerging(dim) if downsample else None


class PatchEmbed3D(nn.Module):
    def __init__(self, dim: int = EMBED_DIM, patch=PATCH):
        super().__init__()
        self.proj = nn.Conv3d(3, dim, kernel_size=patch, stride=patch)
        self.norm = nn.LayerNorm(dim)

    def forward(self, x):
        """(B, 3, T, H, W) -> (B, T/2, H/4, W/4, C)."""
        return self.norm(self.proj(x).permute(0, 2, 3, 4, 1))


class SwinTransformer3D(nn.Module):
    """Video Swin-T's backbone with FAST-VQA's gated biases on the stages of
    ``frag_biases``."""

    def __init__(self, depths=DEPTHS, heads=HEADS, embed_dim: int = EMBED_DIM, window=WINDOW,
                 frag_biases=FRAG_BIASES):
        super().__init__()
        self.patch_embed = PatchEmbed3D(embed_dim)
        self.layers = nn.ModuleList(
            BasicLayer(embed_dim * 2**i, d, h, window, g, i < len(depths) - 1)
            for i, (d, h, g) in enumerate(zip(depths, heads, frag_biases)))
        self.num_features = embed_dim * 2 ** (len(depths) - 1)
        self.norm = nn.LayerNorm(self.num_features)

    def steps(self, mini_patch: int = 32) -> list:
        """The blocks in order: (block, mini-patch side in its tokens, the
        patch merging after it or None)."""
        side = mini_patch // PATCH[1]  # a mini-patch's side in stage-1 tokens
        return [(blk, side >> i, layer.downsample if j == len(layer.blocks) - 1 else None)
                for i, layer in enumerate(self.layers) for j, blk in enumerate(layer.blocks)]

    def forward(self, x: torch.Tensor, mini_patch: int = 32) -> torch.Tensor:
        """(B, 3, T, H, W) normalised -> (B, T/2, H/32, W/32, 8 C)."""
        x = self.patch_embed(x)
        for blk, patch, down in self.steps(mini_patch):
            x = blk(x, patch)
            if down is not None:
                x = down(x)
        return self.norm(x)


class VQAHead(nn.Module):
    """FAST-VQA's head: a per-position score of the final feature map."""

    def __init__(self, in_channels: int = 768, hidden: int = HEAD_HIDDEN):
        super().__init__()
        self.fc_hid = nn.Conv3d(in_channels, hidden, 1)
        self.fc_last = nn.Conv3d(hidden, 1, 1)

    def forward(self, feat: torch.Tensor) -> torch.Tensor:
        """(B, D, H, W, C) f32 -> (B, D*H*W) per-position scores; a 1x1x1
        convolution is the linear map over channels."""
        w1, w2 = self.fc_hid.weight.flatten(1), self.fc_last.weight.flatten(1)
        return F.linear(F.gelu(F.linear(feat, w1, self.fc_hid.bias)), w2, self.fc_last.bias).flatten(1)


class FastVQA(nn.Module):
    """FAST-B: the backbone and the head.  ``forward`` takes the uint8 RGB
    mosaic (B, T, H, W, 3) and gives the per-position scores (B, positions)
    and each view's mean final feature (B, 768), both f32 (``normalise``,
    ``backbone``, ``head``: the serving program opens a span around each)."""

    def __init__(self, **backbone):
        super().__init__()
        self.backbone = SwinTransformer3D(**backbone)
        self.vqa_head = VQAHead(self.backbone.num_features)
        self._consts: dict = {}  # device -> (mean, std)

    def tables(self) -> list:
        return [p for n, p in self.named_parameters() if n.rsplit(".", 1)[-1] in TABLES]

    def to_serving(self, device, dtype: torch.dtype) -> "FastVQA":
        """The backbone in ``dtype``; the bias tables and the head in f32."""
        self.to(device=device, dtype=dtype).eval()
        for p in self.tables() + list(self.vqa_head.parameters()):
            p.data = p.data.float()
        return self

    def normalise(self, mosaic_u8: torch.Tensor) -> torch.Tensor:
        """(B, T, H, W, 3) uint8 RGB -> (B, 3, T, H, W) in the backbone's type."""
        dev = mosaic_u8.device
        if dev not in self._consts:  # uploaded once a device: the enqueue never waits on the host
            self._consts[dev] = tuple(upload(torch.tensor(v), dev) for v in (MEAN, STD))
        mean, std = self._consts[dev]
        x = (mosaic_u8.float() - mean) / std
        return x.to(self.backbone.norm.weight.dtype).permute(0, 4, 1, 2, 3)

    def head(self, feat: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The backbone's output -> per-position scores (B, positions) and
        each view's mean feature (B, C), f32."""
        feat = feat.float()
        return self.vqa_head(feat), feat.flatten(1, 3).mean(1)

    def forward(self, mosaic_u8: torch.Tensor, mini_patch: int = 32):
        return self.head(self.backbone(self.normalise(mosaic_u8), mini_patch))


def random_state(seed: int, **model) -> dict:
    """A seeded state dict of ``FastVQA(**model)`` on the host, f32: linear
    and convolution weights N(0, 1/fan_in), biases and bias tables N(0,
    0.02^2), LayerNorms identity (no checkpoint is in the repository)."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, t in FastVQA(**model).state_dict().items():
        if ".norm" in name or name.startswith(("backbone.norm", "norm")) or "downsample.norm" in name:
            out[name] = torch.ones_like(t) if name.endswith("weight") else torch.zeros_like(t)
        elif name.endswith("weight"):
            out[name] = torch.randn(t.shape, generator=gen) / math.sqrt(math.prod(t.shape[1:]))
        else:
            out[name] = torch.randn(t.shape, generator=gen) * 0.02
    return out
