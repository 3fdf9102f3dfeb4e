"""``relaxtpu_torch.ops.resize`` against ``jax.image.resize`` on [0, 1]
images: the backbone resizes (540x960 -> 224x224, linear and lanczos3 with
antialias), the flow pyramid (linear, no antialias) and the flow upsample.
Bound: 1e-5 absolute."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relaxtpu_torch.ops.resize import quantize_u8_levels, resize_hw


@pytest.mark.parametrize(
    "src,dst,method,antialias",
    [
        ((540, 960), (224, 224), "linear", True),
        ((540, 960), (224, 224), "lanczos3", True),
        ((120, 160), (224, 224), "lanczos3", True),
        ((540, 960), (270, 480), "linear", False),
        ((540, 960), (135, 240), "linear", False),
        ((540, 960), (68, 120), "linear", False),
        ((68, 120), (135, 240), "linear", False),
        ((135, 240), (270, 480), "linear", False),
        ((270, 480), (540, 960), "linear", False),
    ],
    ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v),
)
def test_resize_matches_jax(rng, src, dst, method, antialias):
    x = rng.random((2, *src)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, *dst), method, antialias=antialias))
    got = resize_hw(torch.from_numpy(x), dst, method, antialias).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_quantize_matches_jax(rng):
    x = (rng.random((4, 64)) * 1.2 - 0.1).astype(np.float32)
    x[0, :4] = np.array([0.5, 1.5, 2.5, 127.5]) / 255.0  # ties round to even
    want = np.asarray(jnp.rint(jnp.clip(jnp.asarray(x), 0.0, 1.0) * 255.0) / 255.0)
    np.testing.assert_array_equal(quantize_u8_levels(torch.from_numpy(x)).numpy(), want)
