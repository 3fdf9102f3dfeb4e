"""Attention visualisation (counterpart of ``relaxtpu/visualize.py``).

The head-mean CLS attention of the ViT's last block over a fragment's
patches, mapped back onto the patches' positions in the original frame as
a JET heatmap overlay.  The ViT runs on its own device: blocks before the
last go through ``ops.attention.mha`` (kernel K3 on CUDA); the last block's
attention matrix itself is plain torch (``ViT.last_attention``).
"""

from __future__ import annotations

import numpy as np
import torch

from relaxtpu_torch.device import resolve_device
from relaxtpu_torch.models.vit import ViT
from relaxtpu_torch.ops.fragments import patch_scores, top_patch_indices


@torch.inference_mode()
def last_selfattention(vit: ViT, img_rgb01: np.ndarray) -> np.ndarray:
    """(H, W, 3) RGB in [0, 1] -> (heads, N+1, N+1) last-block attention,
    f32 numpy of the ViT's activation-type values, computed on the ViT's
    device."""
    p = next(vit.parameters())
    x = torch.as_tensor(np.asarray(img_rgb01, np.float32)).permute(2, 0, 1)[None]
    attn = vit.last_attention(x.to(device=p.device, dtype=p.dtype))
    return attn[0].float().cpu().numpy()


def cls_patch_attention(attn: np.ndarray, grid: int = 14) -> np.ndarray:
    """The CLS row's attention to each patch, mean over heads -> (grid, grid)."""
    return attn[:, 0, 1:].mean(axis=0).reshape(grid, grid)


def map_attention_to_original(
    original_frame_bgr: np.ndarray,
    patch_attention_flat: np.ndarray,
    positions: list[tuple[int, int]],
    patch_size: int = 16,
) -> np.ndarray:
    """Each fragment slot's attention scattered back to its source patch,
    scaled to [0, 255], truncated to uint8, coloured with JET and blended
    0.6 / 0.4 over the frame (cv2)."""
    import cv2

    full = np.zeros(original_frame_bgr.shape[:2], dtype=float)
    for (y, x), att in zip(positions, patch_attention_flat):
        full[y * patch_size : (y + 1) * patch_size, x * patch_size : (x + 1) * patch_size] = att
    full = (full / max(full.max(), 1e-12)) * 255
    heatmap = cv2.applyColorMap(full.astype(np.uint8), cv2.COLORMAP_JET)
    return cv2.addWeighted(original_frame_bgr, 0.6, heatmap, 0.4, 0)


def fragment_positions(residual_bgr: np.ndarray, patch_size: int = 16, top_n: int = 196,
                       device=None) -> list[tuple[int, int]]:
    """(row, col) of the patches the fragment pipeline selects from a
    residual image, ascending row-major, scored on ``device`` (CUDA by
    default)."""
    w = residual_bgr.shape[1]
    res = torch.as_tensor(np.ascontiguousarray(residual_bgr))[None].to(resolve_device(device))
    ids = top_patch_indices(patch_scores(res, patch_size), top_n)[0].cpu().tolist()
    wp = w // patch_size
    return [(i // wp, i % wp) for i in ids]
