"""ViT multi-head attention (kernel K3).

Counterpart of the Pallas kernel ``relaxtpu/ops/attention.py::_mha_kernel``
(``fused_mha``), with the numerics of the einsum form at
``relaxtpu/models/vit.py:60-64``: scores accumulated in f32, padded keys
masked, softmax in f32, probabilities cast to the activation type, P.V
accumulated in f32 and written in the activation type.  K3
(``csrc/attention.cu``) keeps the score rows on chip.

``mha`` launches K3 for CUDA tensors and runs the plain PyTorch version for
CPU tensors.  Layout is token-major (B, N, H, D), as in the JAX package.
"""

from __future__ import annotations

import torch

from relaxtpu_torch import _native

_MAX_TOKENS = 256  # K3 keeps up to 8 scores per lane in registers
_HEAD_DIMS = (32, 64)
_ENTRY = {torch.float32: "relax_mha_f32", torch.bfloat16: "relax_mha_bf16"}


def mha_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """Plain PyTorch K3: the einsum form of ``vit.py:60-64``."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p.float(), v.float()).to(q.dtype)


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """Attention over (B, N, H, D) -> (B, N, H, D) contiguous.

    On CUDA, q, k and v must share their strides, with (H, D) dense: the
    column slices of one packed qkv projection qualify, as do contiguous
    tensors.  CPU tensors take the plain version.
    """
    if q.device.type == "cpu":
        return mha_plain(q, k, v, scale)
    b, n, h, d = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.dtype not in _ENTRY or t.dtype != q.dtype:
            raise ValueError(f"{name} must be a CUDA f32 or bf16 tensor like q, got {t.dtype} on {t.device}")
        if tuple(t.shape) != (b, n, h, d) or t.stride() != q.stride():
            raise ValueError(f"{name} must match q's shape {tuple(q.shape)} and strides {q.stride()}")
    if q.stride(3) != 1 or q.stride(2) != d:
        raise ValueError(f"the (H, D) axes must be dense, got strides {q.stride()}")
    if not 1 <= n <= _MAX_TOKENS or d not in _HEAD_DIMS:
        raise ValueError(f"K3 takes N <= {_MAX_TOKENS} and D in {_HEAD_DIMS}, got N={n}, D={d}")
    o = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    _native.launch(
        _ENTRY[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        b, n, h, d, q.stride(0), q.stride(1), float(scale),
    )
    mha.launches += 1
    return o


mha.launches = 0
