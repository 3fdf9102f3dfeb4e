"""DINO ViT-B/16 returning patch-token statistics.

Counterpart of ``relaxtpu/models/vit.py:31-159``: embed 768, 12 heads,
mlp_ratio 4, qkv with bias as ``[q; k; v]`` row blocks, pre-norm blocks with
LayerNorm eps 1e-6, exact GELU, final norm; the feature is the patch tokens
``x[:, 1:]``.  Parameter names follow the DINO checkpoint.  Attention goes
through ``ops.attention.mha`` (kernel K3 on CUDA).

An input other than 224x224 gets the position table resized bicubically
(jax's Keys cubic, ``interpolate_pos_embed``); K3 takes any token count, as
``fused_mha`` does.  ``last_attention`` is the last block's attention
matrix (``reduce="last_attn"`` of the JAX package), for the visualisation:
the blocks before it run as in ``tokens``.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from relaxtpu_torch.ops.attention import attention_probs, mha
from relaxtpu_torch.ops.resize import resize_hw
from relaxtpu_torch.utils.keywords import jax_keywords


@jax_keywords(img_rgb_f01="img_rgb01")
def vit_preprocess(img_rgb01: torch.Tensor) -> torch.Tensor:
    """ViT input transform: identity on [0, 1] RGB (ToTensor only)."""
    return img_rgb01


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, dim * 3, bias=True)
        self.proj = nn.Linear(dim, dim)

    def _qkv(self, x):
        """Column slices of the packed projection, (B, N, H, D) views."""
        c = x.shape[-1]
        qkv = self.qkv(x)
        return (qkv[..., i * c : (i + 1) * c].unflatten(-1, (self.num_heads, c // self.num_heads))
                for i in range(3))

    def forward(self, x):
        b, n, c = x.shape
        q, k, v = self._qkv(x)
        y = mha(q, k, v, scale=(c // self.num_heads) ** -0.5)
        return self.proj(y.reshape(b, n, c))

    def probs(self, x):
        """The attention matrix (B, heads, N, N) in x's type."""
        q, k, _ = self._qkv(x)
        return attention_probs(q, k, (x.shape[-1] // self.num_heads) ** -0.5)


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
        self.patch_size = patch_size
        self.patch_embed = PatchEmbed(patch_size, embed_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, (224 // patch_size) ** 2 + 1, embed_dim))
        self.blocks = nn.Sequential(*[Block(embed_dim, num_heads) for _ in range(depth)])
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6)

    def interpolate_pos_embed(self, pos_embed: torch.Tensor | None = None, h_patches: int | None = None,
                              w_patches: int | None = None, *, hp: int | None = None,
                              wp: int | None = None) -> torch.Tensor:
        """The (1, N+1, D) position table ``pos_embed`` (default: the
        model's) for an h_patches x w_patches patch grid: as it is for the
        square grid it was trained at, else its patch rows resized
        bicubically in f32 (``relaxtpu/models/vit.py:103-117``).  Takes the
        JAX package's arguments, and the port's ``(hp, wp)``, by position or
        by keyword."""
        if pos_embed is not None and not isinstance(pos_embed, torch.Tensor):  # the port's (hp, wp)
            pos_embed, h_patches, w_patches = None, pos_embed, h_patches
        hp = h_patches if hp is None else hp
        wp = w_patches if wp is None else wp
        pos = self.pos_embed if pos_embed is None else pos_embed
        n = pos.shape[1] - 1
        if hp * wp == n and hp == wp:
            return pos
        side = math.isqrt(n)
        grid = pos[0, 1:].float().T.reshape(-1, side, side)  # (D, side, side)
        grid = resize_hw(grid, (hp, wp), "bicubic", antialias=True)
        return torch.cat([pos[:, :1], grid.reshape(-1, hp * wp).T[None].to(pos.dtype)], dim=1)

    def _embed(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) -> (B, N+1, D): patch tokens (the grid floors H and W
        to multiples of the patch size), CLS first, plus positions."""
        b, _, h, w = x.shape
        hp, wp = h // self.patch_size, w // self.patch_size
        y = self.patch_embed.proj(x).flatten(2).transpose(1, 2)  # row-major patches
        return torch.cat([self.cls_token.expand(b, -1, -1), y], dim=1) + self.interpolate_pos_embed(hp, wp)

    def tokens(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) -> patch tokens (B, N, D) after the final norm."""
        return self.norm(self.blocks(self._embed(x)))[:, 1:]

    def last_attention(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) -> the last block's attention (B, heads, N+1, N+1)
        in the activation type; the blocks before it run as in ``tokens``."""
        y = self.blocks[:-1](self._embed(x))
        last = self.blocks[-1]
        return last.attn.probs(last.norm1(y))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) -> (B, 3*D) f32 mean | max | std (ddof 0) over
        the patch tokens."""
        t = self.tokens(x).float()
        return torch.cat([t.mean(dim=1), t.amax(dim=1), t.std(dim=1, correction=0)], dim=-1)
