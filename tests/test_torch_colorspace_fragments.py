"""Colour-space and fragment ops of the port, bit-exact against the JAX
package on the same numpy inputs (uint8 outputs), batched over pairs where
JAX uses vmap.  ``flow_to_bgr`` may differ where an ulp of atan2/sqrt
crosses a floor: its mismatch rate is measured and bounded."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relaxtpu.io.video import _yuv420_to_bgr_limited as jax_host_yuv
from relaxtpu.ops import colorspace as jcs
from relaxtpu.ops import fragments as jfr
from relaxtpu_torch.io.video import _yuv420_to_bgr_limited as host_yuv
from relaxtpu_torch.ops import colorspace as tcs
from relaxtpu_torch.ops import fragments as tfr


@pytest.fixture(scope="module")
def rng():
    """This file's own generator (the session one's state depends on which
    files ran before in the same worker): the inputs are those of a run of
    this file alone."""
    return np.random.default_rng(0)


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_bgr_to_gray_bitexact(rng):
    img = rng.integers(0, 256, (3, 37, 53, 3), dtype=np.uint8)
    np.testing.assert_array_equal(tcs.bgr_to_gray(T(img)).numpy(),
                                  np.asarray(jcs.bgr_to_gray(jnp.asarray(img))))


def test_hsv_to_bgr_bitexact_exhaustive_hue_value():
    h, v = np.meshgrid(np.arange(181, dtype=np.uint8), np.arange(256, dtype=np.uint8))
    for s in (0, 97, 255):
        sat = np.full_like(h, s)
        want = np.asarray(jcs.hsv_to_bgr_u8(jnp.asarray(h), jnp.asarray(sat), jnp.asarray(v)))
        got = tcs.hsv_to_bgr_u8(T(h), T(sat), T(v)).numpy()
        np.testing.assert_array_equal(got, want)


def test_yuv420_to_bgr_bitexact_vs_device_and_host(rng):
    """Against relaxtpu's device converter and its host converter (the
    port's own host copy too)."""
    n, h, w = 2, 36, 64
    buf = rng.integers(0, 256, (n, h * w * 3 // 2), dtype=np.uint8)
    got = tcs.yuv420_to_bgr(*tcs.unpack_i420(T(buf), h, w)).numpy()
    want_dev = np.asarray(jcs.yuv420_to_bgr(*jcs.unpack_i420(jnp.asarray(buf), h, w)))
    np.testing.assert_array_equal(got, want_dev)
    for i in range(n):
        yuv = buf[i].reshape(h * 3 // 2, w)
        np.testing.assert_array_equal(got[i], jax_host_yuv(yuv, w, h))
        np.testing.assert_array_equal(got[i], host_yuv(yuv, w, h))


def test_flow_to_bgr_mismatch_rate_bounded():
    """XLA fuses fx*fx + fy*fy into an FMA, torch does not, so the magnitude
    differs by an ulp on some pixels and the truncated value plane by one
    LSB where that crosses a floor (atan2 agrees bit for bit here).
    Measured on this input: 0.21% of 96,000 pixels differ (seed 0).  Bound:
    value planes within 1 LSB everywhere, at most 1% of pixels differing."""
    flow = np.random.default_rng(0).normal(0, 3, (5, 120, 160, 2)).astype(np.float32)
    want = np.asarray(jax.vmap(jcs.flow_to_bgr)(jnp.asarray(flow)))
    got = tcs.flow_to_bgr(T(flow)).numpy()
    differ = (got != want).any(axis=-1).mean()
    assert differ <= 1e-2, differ

    f, t = jnp.asarray(flow), T(flow)
    v_j = np.floor(np.asarray(jax.vmap(jcs.minmax_normalize_255)(
        jnp.sqrt(f[..., 0] * f[..., 0] + f[..., 1] * f[..., 1]))))
    v_t = np.floor(tcs.minmax_normalize_255(
        torch.sqrt(t[..., 0] * t[..., 0] + t[..., 1] * t[..., 1])).numpy())
    assert np.abs(v_j - v_t).max() <= 1


def test_minmax_normalize_constant_image_is_zero():
    x = torch.full((2, 8, 8), 3.0)
    assert torch.equal(tcs.minmax_normalize_255(x), torch.zeros_like(x))


@pytest.mark.parametrize(
    "case", ["random_240x320", "constant_residual_ties", "fewer_than_196_patches"]
)
def test_fragment_pipeline_bitexact(rng, case):
    """absdiff -> patch_scores -> top_patch_indices -> gather_fragment ->
    merge_fragments, per pair against the JAX functions under vmap.  A
    constant residual makes every score tie (lower index wins); 120x160
    has 70 patches, so slots past k stay zero."""
    h, w = (120, 160) if case == "fewer_than_196_patches" else (240, 320)
    prev = rng.integers(0, 249, (3, h, w, 3), dtype=np.uint8)
    if case == "constant_residual_ties":
        nxt = prev + 7  # |nxt - prev| == 7 everywhere
    else:
        nxt = rng.integers(0, 256, (3, h, w, 3), dtype=np.uint8)
    other = rng.integers(0, 256, (3, h, w, 3), dtype=np.uint8)

    res_t = tfr.absdiff(T(nxt), T(prev))
    scores_t = tfr.patch_scores(res_t)
    ids_t = tfr.top_patch_indices(scores_t)
    frag_t = tfr.gather_fragment(res_t, ids_t)
    ori_t = tfr.gather_fragment(T(prev), ids_t)
    merged_t = tfr.merge_fragments(frag_t, tfr.gather_fragment(T(other), ids_t))

    res_j = jax.vmap(jfr.absdiff)(jnp.asarray(nxt), jnp.asarray(prev))
    scores_j = jax.vmap(jfr.patch_scores)(res_j)
    ids_j = jax.vmap(jfr.top_patch_indices)(scores_j)
    frag_j = jax.vmap(jfr.gather_fragment)(res_j, ids_j)
    ori_j = jax.vmap(jfr.gather_fragment)(jnp.asarray(prev), ids_j)
    merged_j = jfr.merge_fragments(frag_j, jax.vmap(jfr.gather_fragment)(jnp.asarray(other), ids_j))

    np.testing.assert_array_equal(res_t.numpy(), np.asarray(res_j))
    np.testing.assert_array_equal(scores_t.numpy(), np.asarray(scores_j))
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    np.testing.assert_array_equal(frag_t.numpy(), np.asarray(frag_j))
    np.testing.assert_array_equal(ori_t.numpy(), np.asarray(ori_j))
    np.testing.assert_array_equal(merged_t.numpy(), np.asarray(merged_j))
    assert merged_t.shape == (3, 224, 224, 3)
    if case == "constant_residual_ties":
        assert ids_t[0].tolist() == list(range(196))


def test_merge_rounds_half_to_even():
    a = torch.tensor([[1, 2, 3, 254]], dtype=torch.uint8)
    b = torch.tensor([[2, 3, 4, 255]], dtype=torch.uint8)
    want = np.asarray(jfr.merge_fragments(jnp.asarray(a.numpy()), jnp.asarray(b.numpy())))
    np.testing.assert_array_equal(tfr.merge_fragments(a, b).numpy(), want)
    assert tfr.merge_fragments(a, b).tolist() == [[2, 2, 4, 254]]
