"""Motion-ranked fragment construction, batched over pairs.

Counterpart of ``relaxtpu/ops/fragments.py:42-135``.  Every function takes a
leading batch axis where the JAX package uses ``vmap``: images are
(P, H, W, C) uint8, scores (P, n_patches) int32, ids (P, k) int64.

Ties: the spec is "lower flat index wins" (``lax.top_k``).  ``torch.topk``
does not promise an order for equal scores, so the selection is a stable
descending sort, first k, then the ids ascending.
"""

from __future__ import annotations

import torch

PATCH_SIZE = 16
TARGET_SIZE = 224
TOP_N = (TARGET_SIZE // PATCH_SIZE) ** 2  # 196


def absdiff(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """uint8 |a - b| without wraparound (``cv2.absdiff``)."""
    return torch.maximum(a, b) - torch.minimum(a, b)


def _patchify(img: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(P, H, W, C) -> (P, n_patches, patch_size*patch_size*C), row-major
    patches, after cropping to a multiple of patch_size."""
    p, h, w, c = img.shape
    hp, wp = h // patch_size, w // patch_size
    img = img[:, : hp * patch_size, : wp * patch_size]
    img = img.reshape(p, hp, patch_size, wp, patch_size, c).permute(0, 1, 3, 2, 4, 5)
    return img.reshape(p, hp * wp, patch_size * patch_size * c)


def patch_scores(residual: torch.Tensor, patch_size: int = PATCH_SIZE) -> torch.Tensor:
    """Per-patch sum of the uint8 residual -> (P, n_patches) int32."""
    return _patchify(residual, patch_size).to(torch.int32).sum(dim=-1, dtype=torch.int32)


def top_patch_indices(scores: torch.Tensor, top_n: int = TOP_N) -> torch.Tensor:
    """Ids of the top_n scores per row, ascending; ties go to the lower id."""
    k = min(top_n, scores.shape[-1])
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    return torch.sort(order[..., :k], dim=-1).values


def gather_fragment(
    img: torch.Tensor,
    patch_ids: torch.Tensor,
    patch_size: int = PATCH_SIZE,
    target_size: int = TARGET_SIZE,
) -> torch.Tensor:
    """Pack the selected patches raster-scan into a (P, T, T, C) canvas;
    slots beyond k stay zero (frames with fewer than 196 patches)."""
    per_row = target_size // patch_size
    n_slots = per_row * per_row
    patches = _patchify(img, patch_size)
    p, _, flat = patches.shape
    k = patch_ids.shape[-1]
    sel = torch.gather(patches, 1, patch_ids[..., None].expand(p, k, flat))
    if k < n_slots:
        sel = torch.cat([sel, sel.new_zeros(p, n_slots - k, flat)], dim=1)
    c = img.shape[-1]
    canvas = sel.reshape(p, per_row, per_row, patch_size, patch_size, c)
    return canvas.permute(0, 1, 3, 2, 4, 5).reshape(p, target_size, target_size, c)


def merge_fragments(diff_frag: torch.Tensor, flow_frag: torch.Tensor) -> torch.Tensor:
    """0.5/0.5 blend with uint8 saturate and round-half-to-even
    (``cv2.addWeighted``)."""
    out = 0.5 * diff_frag.to(torch.float32) + 0.5 * flow_frag.to(torch.float32)
    return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)
