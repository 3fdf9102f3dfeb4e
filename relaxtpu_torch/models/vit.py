"""DINO ViT-B/16 returning patch-token statistics.

Counterpart of ``relaxtpu/models/vit.py:31-159``: embed 768, 12 heads,
mlp_ratio 4, qkv with bias as ``[q; k; v]`` row blocks, pre-norm blocks with
LayerNorm eps 1e-6, exact GELU, final norm; the feature is the patch tokens
``x[:, 1:]``.  Parameter names follow the DINO checkpoint.  Attention goes
through ``ops.attention.mha`` (kernel K3 on CUDA).

Inputs are 224x224 (the position table is not interpolated; the non-224
path of the JAX package is not on this slice's path).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from relaxtpu_torch.ops.attention import mha


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, dim * 3, bias=True)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        b, n, c = x.shape
        hd = c // self.num_heads
        qkv = self.qkv(x)
        # column slices of the packed projection, (B, N, H, D) views
        q, k, v = (qkv[..., i * c : (i + 1) * c].unflatten(-1, (self.num_heads, hd)) for i in range(3))
        y = mha(q, k, v, scale=hd**-0.5)
        return self.proj(y.reshape(b, n, c))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: int = 4):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, dim * mlp_ratio)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch_size, patch_size)


class ViT(nn.Module):
    """ViT backbone; defaults are DINO ViT-B/16."""

    def __init__(self, depth: int = 12, patch_size: int = 16, embed_dim: int = 768,
                 num_heads: int = 12):
        super().__init__()
        self.patch_embed = PatchEmbed(patch_size, embed_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, (224 // patch_size) ** 2 + 1, embed_dim))
        self.blocks = nn.Sequential(*[Block(embed_dim, num_heads) for _ in range(depth)])
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6)

    def tokens(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 3, 224, 224) -> patch tokens (B, 196, D) after the final norm."""
        b = x.shape[0]
        y = self.patch_embed.proj(x).flatten(2).transpose(1, 2)  # row-major patches
        if y.shape[1] + 1 != self.pos_embed.shape[1]:
            raise ValueError(f"ViT takes 224x224 inputs, got {tuple(x.shape[-2:])}")
        y = torch.cat([self.cls_token.expand(b, -1, -1), y], dim=1) + self.pos_embed
        return self.norm(self.blocks(y))[:, 1:]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 3, 224, 224) -> (B, 3*D) f32 mean | max | std (ddof 0) over
        the patch tokens."""
        t = self.tokens(x).float()
        return torch.cat([t.mean(dim=1), t.amax(dim=1), t.std(dim=1, correction=0)], dim=-1)
