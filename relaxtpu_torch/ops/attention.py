"""ViT multi-head attention (kernel K3).

Counterpart of the Pallas kernel ``relaxtpu/ops/attention.py::_mha_kernel``
(``fused_mha``), with the numerics of the einsum form at
``relaxtpu/models/vit.py:60-64``: scores accumulated in f32, padded keys
masked, softmax in f32, probabilities cast to the activation type, P.V
accumulated in f32 and written in the activation type.  K3
(``csrc/attention.cu``) has two pairs of entries: the short ones keep whole
score rows on chip (N <= ``SHORT_TOKENS``, D in ``SHORT_HEAD_DIMS``); the
long ones take any N over key tiles at the head dims of ``LONG_HEAD_DIMS``:
in bf16 in two passes (an exact softmax, P normalised before its cast), in
f32 at D 32 and 64 in one pass with online rescaling (no cast of P exists
to be moved), at D 128 and 256 in two.  Tensor-core ``mma.sync`` products
in bf16, register-blocked FMAs in f32.

``mha`` launches K3 for CUDA tensors and runs the plain PyTorch version for
CPU tensors.  Layout is token-major (B, N, H, D), as in the JAX package.
``attention_probs`` is the probability matrix itself, which the JAX
package computes outside any Pallas kernel (the visualisation path,
``relaxtpu/models/vit.py:134-137``) and K3 never writes out.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from relaxtpu_torch import _native

SHORT_TOKENS = 256  # the short entries keep whole score rows on chip
SHORT_HEAD_DIMS = (32, 64)
LONG_HEAD_DIMS = (32, 64, 128, 256)  # the long entries' compiled head dims
MAX_HEAD_DIM = LONG_HEAD_DIMS[-1]
_SHORT = {torch.float32: "relax_mha_f32", torch.bfloat16: "relax_mha_bf16"}
_LONG = {torch.float32: "relax_mha_f32_long", torch.bfloat16: "relax_mha_bf16_long"}


def attention_probs(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """softmax(QK^T * scale) of (B, N, H, D) q and k -> (B, H, N, N): scores
    accumulated in f32, the probabilities cast to q's type (``vit.py:60-61``)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    return torch.softmax(s, dim=-1).to(q.dtype)


def mha_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """Plain PyTorch K3: the einsum form of ``vit.py:60-64``."""
    p = attention_probs(q, k, scale)
    return torch.einsum("bhqk,bkhd->bqhd", p.float(), v.float()).to(q.dtype)


def _plan(n: int, d: int, dtype: torch.dtype) -> tuple[str, int]:
    """(the K3 entry, the head dim it runs at) for N tokens of head dim D:
    the short entry where it takes (N, D), else the long one at the
    smallest compiled head dim >= D (the wrapper pads q, k and v with zeros,
    which leaves every score and the first D output dims exact)."""
    if dtype not in _SHORT:
        raise ValueError(f"K3 takes f32 or bf16, got {dtype}")
    if n < 1:
        raise ValueError(f"K3 takes N >= 1 tokens, got N={n}")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"K3 takes head dims 1 <= D <= MAX_HEAD_DIM = {MAX_HEAD_DIM}, got D={d}")
    if n <= SHORT_TOKENS and d in SHORT_HEAD_DIMS:
        return _SHORT[dtype], d
    return _LONG[dtype], next(x for x in LONG_HEAD_DIMS if x >= d)


def _rows_aligned(t: torch.Tensor) -> bool:
    """Every token row 16-byte aligned: K3 stages rows by 16-byte copies."""
    size = t.element_size()
    return t.data_ptr() % 16 == 0 and (t.stride(0) * size) % 16 == 0 and (t.stride(1) * size) % 16 == 0


def _staged(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dp: int) -> tuple:
    """q, k and v in a layout K3 stages at head dim ``dp``: as they are when
    they share their strides, with (H, D) dense and aligned token rows (the
    column slices of one packed qkv projection qualify, as do contiguous
    tensors); zero-padded along D to ``dp``; else contiguous copies."""
    d = q.shape[-1]
    if dp != d:
        return tuple(F.pad(t, (0, dp - d)) for t in (q, k, v))
    if (k.stride() == v.stride() == q.stride() and q.stride(3) == 1 and q.stride(2) == d
            and all(_rows_aligned(t) for t in (q, k, v))):
        return q, k, v
    return tuple(t.clone(memory_format=torch.contiguous_format) for t in (q, k, v))


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, entry: str) -> torch.Tensor:
    """One launch of a K3 entry on staged (B, N, H, D) q, k, v -> contiguous o."""
    b, n, h, d = q.shape
    o = q.new_empty((b, n, h, d))  # new_empty skips torch.empty's argument parsing on this hot path
    _native.launch(
        entry, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        b, n, h, d, q.stride(0), q.stride(1), float(scale),
    )
    mha.launches += 1
    if entry in _LONG.values():
        mha.long_launches += 1
    return o


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """Attention over (B, N, H, D) -> (B, N, H, D) contiguous, any N >= 1 and
    1 <= D <= ``MAX_HEAD_DIM``.

    On CUDA, q, k and v must be f32 or bf16 tensors of one type and shape;
    a layout K3 cannot stage is copied first (``_staged``).  CPU tensors
    take the plain version.  ``launches`` counts every K3 launch,
    ``long_launches`` those of the long entries.
    """
    if q.device.type == "cpu":
        return mha_plain(q, k, v, scale)
    b, n, h, d = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.dtype not in _SHORT or t.dtype != q.dtype:
            raise ValueError(f"{name} must be a CUDA f32 or bf16 tensor like q, got {t.dtype} on {t.device}")
        if tuple(t.shape) != (b, n, h, d):
            raise ValueError(f"{name} must match q's shape {tuple(q.shape)}, got {tuple(t.shape)}")
    entry, dp = _plan(n, d, q.dtype)
    o = _launch(*_staged(q, k, v, dp), scale, entry)
    return o if dp == d else o[..., :d].contiguous()


mha.launches = 0
mha.long_launches = 0
