"""ViT multi-head attention (kernel K3).

Counterpart of the Pallas kernel ``relaxtpu/ops/attention.py::_mha_kernel``
(``fused_mha``), with the numerics of the einsum form at
``relaxtpu/models/vit.py:60-64``: scores accumulated in f32, padded keys
masked, softmax in f32, probabilities cast to the activation type, P.V
accumulated in f32 and written in the activation type.  K3
(``csrc/attention.cu``) keeps whole score rows on chip: tensor-core
``mma.sync`` products in bf16, register-blocked FMAs in f32.

``mha`` launches K3 for CUDA tensors and runs the plain PyTorch version for
CPU tensors.  Layout is token-major (B, N, H, D), as in the JAX package.
``attention_probs`` is the probability matrix itself, which the JAX
package computes outside any Pallas kernel (the visualisation path,
``relaxtpu/models/vit.py:134-137``) and K3 never writes out.
"""

from __future__ import annotations

import torch

from relaxtpu_torch import _native

MAX_TOKENS = 256  # K3 keeps whole score rows on chip
_HEAD_DIMS = (32, 64)
_ENTRY = {torch.float32: "relax_mha_f32", torch.bfloat16: "relax_mha_bf16"}


def attention_probs(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """softmax(QK^T * scale) of (B, N, H, D) q and k -> (B, H, N, N): scores
    accumulated in f32, the probabilities cast to q's type (``vit.py:60-61``)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    return torch.softmax(s, dim=-1).to(q.dtype)


def mha_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """Plain PyTorch K3: the einsum form of ``vit.py:60-64``."""
    p = attention_probs(q, k, scale)
    return torch.einsum("bhqk,bkhd->bqhd", p.float(), v.float()).to(q.dtype)


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """Attention over (B, N, H, D) -> (B, N, H, D) contiguous.

    On CUDA, q, k and v must share their strides, with (H, D) dense and
    every token row 16-byte aligned (K3 stages rows with 16-byte copies):
    the column slices of one packed qkv projection qualify, as do
    contiguous tensors.  CPU tensors take the plain version.
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
    if not 1 <= n <= MAX_TOKENS or d not in _HEAD_DIMS:
        raise ValueError(f"K3 takes 1 <= N <= {MAX_TOKENS} and D in {_HEAD_DIMS}, got N={n}, D={d}")
    size = q.element_size()
    if any(t.data_ptr() % 16 for t in (q, k, v)) or (q.stride(0) * size) % 16 or (q.stride(1) * size) % 16:
        raise ValueError(f"K3 needs 16-byte aligned token rows: pointers and the B and N strides "
                         f"in bytes multiples of 16, got strides {q.stride()}")
    o = q.new_empty((b, n, h, d))  # new_empty skips torch.empty's argument parsing on this hot path
    _native.launch(
        _ENTRY[q.dtype], q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        b, n, h, d, q.stride(0), q.stride(1), float(scale),
    )
    mha.launches += 1
    return o


mha.launches = 0
