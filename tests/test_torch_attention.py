"""K3's plain version (``mha`` on CPU tensors) against the Pallas kernel
``fused_mha`` in interpret mode, at the shapes and tolerances of
tests/test_attention_kernel.py, in f32 and bf16.  The kernel itself is held
against this plain version on the card by chip_smoke.py (with every input at
the start of a NaN-filled allocation, so a read out of bounds shows)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relaxtpu.ops.attention import fused_mha
from relaxtpu_torch.ops.attention import mha


def _run(q, k, v, dtype_j, dtype_t, scale):
    with jax.default_device(jax.devices("cpu")[0]):
        want = fused_mha(*(jnp.asarray(a, dtype_j) for a in (q, k, v)), scale=scale, interpret=True)
    got = mha(*(torch.from_numpy(a).to(dtype_t) for a in (q, k, v)), scale=scale)
    return np.asarray(want, np.float32), got.float().numpy()


@pytest.mark.parametrize("b,n,h,d", [(2, 197, 12, 64), (1, 17, 4, 32), (3, 128, 2, 64)])
def test_mha_plain_matches_pallas_f32(rng, b, n, h, d):
    q, k, v = (rng.normal(size=(b, n, h, d)).astype(np.float32) for _ in range(3))
    want, got = _run(q, k, v, jnp.float32, torch.float32, d**-0.5)
    np.testing.assert_allclose(got, want, atol=2e-4)
    assert mha.launches == 0  # CPU tensors never reach the kernel


def test_mha_plain_matches_pallas_bf16(rng):
    b, n, h, d = 2, 197, 12, 64
    q, k, v = (rng.normal(size=(b, n, h, d)).astype(np.float32) for _ in range(3))
    want, got = _run(q, k, v, jnp.bfloat16, torch.bfloat16, d**-0.5)
    np.testing.assert_allclose(got, want, atol=2e-2)
    cos = np.dot(want.ravel(), got.ravel()) / (np.linalg.norm(want) * np.linalg.norm(got))
    assert cos > 0.99999


def test_mha_packed_qkv_slices_match_contiguous(rng):
    """The ViT hands over column slices of one packed qkv projection."""
    b, n, h, d = 2, 197, 4, 64
    qkv = torch.from_numpy(rng.normal(size=(b, n, 3 * h * d)).astype(np.float32))
    q, k, v = (qkv[..., i * h * d : (i + 1) * h * d].unflatten(-1, (h, d)) for i in range(3))
    got = mha(q, k, v, d**-0.5)
    want = mha(q.contiguous(), k.contiguous(), v.contiguous(), d**-0.5)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
