"""MAE + pairwise rank loss (counterpart of ``relaxtpu/model/losses.py:8-46``).

Every kink uses the operation whose gradient matches jax's there:
``torch.maximum`` splits the gradient at a tie as ``jnp.maximum`` does
(``relu``/``clamp`` would not), ``abs`` and ``sign`` give 0 at 0.
"""

from __future__ import annotations

import torch


def mae_and_rank_loss(
    y_pred: torch.Tensor,
    y_true: torch.Tensor,
    l1_w: float = 0.6,
    rank_w: float = 1.0,
    margin: float = 0.0,
    use_margin: bool = False,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """loss = l1_w * MAE + rank_w * sum(max(true_diff - sign(true_diff) *
    pred_diff, 0)) / (n (n-1)) over all pairs of the batch.

    ``mask`` ((n,), {0, 1}) drops padded rows from the MAE mean and the pair
    sum, with n counting real rows only; n = 1 divides by 1, not 0.
    """
    y_pred = y_pred.reshape(-1)
    y_true = y_true.reshape(-1)
    zero = y_pred.new_zeros(())
    if mask is None:
        n = y_pred.shape[0]
        l_mae = torch.mean(torch.abs(y_pred - y_true)) * l1_w
        pair_mask = 1.0
        denom = max(n * (n - 1), 1)
    else:
        mask = mask.to(y_pred.dtype)
        n = torch.sum(mask)
        l_mae = torch.sum(torch.abs(y_pred - y_true) * mask) / torch.clamp(n, min=1) * l1_w
        pair_mask = mask[:, None] * mask[None, :]
        denom = torch.clamp(n * (n - 1), min=1)

    pred_diff = y_pred[:, None] - y_pred[None, :]
    true_diff = y_true[:, None] - y_true[None, :]
    signs = torch.sign(true_diff)
    if use_margin and margin > 0:
        true_diff = torch.maximum(torch.abs(true_diff) - margin, zero)
        signs = torch.sign(true_diff)
    l_rank = torch.sum(torch.maximum(true_diff - signs * pred_diff, zero) * pair_mask) / denom
    return l_mae + rank_w * l_rank
