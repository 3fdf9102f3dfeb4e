"""relaxtpu_torch — the PyTorch/CUDA port of relaxtpu for NVIDIA Hopper.

The package mirrors the layout of ``relaxtpu`` so each module's counterpart
is easy to find, and imports nothing of it (nor of JAX): the JAX package is
the reference this port is tested against.  The three Pallas kernels of
``relaxtpu`` are hand-written CUDA kernels here (``relaxtpu_torch/csrc``),
built with ``nvcc`` for ``sm_90a`` at first use (``relaxtpu_torch._native``).

Entry points take a ``device`` that defaults to ``"cuda"``; without CUDA they
raise unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
