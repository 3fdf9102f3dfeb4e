"""Device choice and numeric mode for the port.

Counterpart of the platform/dtype choice in ``relaxtpu/cli/__main__.py:36-42``
(bf16 on the accelerator, f32 for strict parity).  Entry points default to
CUDA and raise when it is absent, unless the caller asked for the CPU: the
port never carries on quietly on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means CUDA (the current device).  A CUDA device without
    CUDA raises, and so does a CUDA index at or past the device count."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    if dev.type == "cuda" and dev.index is not None:
        count = torch.cuda.device_count()
        if dev.index >= count:
            raise ValueError(f"{dev}: this host has {count} CUDA device{'s' * (count != 1)}")
    return dev


def set_strict_f32() -> None:
    """Full-f32 matmuls and convolutions (strict-parity mode).

    cuDNN runs f32 convolutions in TF32 by default, which keeps about three
    decimal digits and would break parity with the f32 reference.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def default_dtype(device: torch.device, bf16: bool | None) -> torch.dtype:
    """bf16 by default on CUDA (as the JAX CLI defaults to bf16 on a TPU),
    f32 on the CPU and whenever ``bf16`` is False."""
    if bf16 is None:
        bf16 = device.type == "cuda"
    return torch.bfloat16 if bf16 else torch.float32


def upload(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A host tensor on ``device`` without blocking the host: on CUDA it is
    copied through pinned memory (PyTorch's host allocator keeps the pinned
    block until the copy is done); on the CPU it is returned as it is."""
    if device.type == "cpu":
        return t
    return t.pin_memory().to(device, non_blocking=True)
