"""Farneback flow of the port against the JAX package on the CPU.

- K1's plain version (``update_matrices`` on CPU tensors) against
  ``_update_matrices(..., "exact")``; its warp against ``_warp_exact`` and,
  for in-band flow, the Pallas banded warp in interpret mode.
- K2's plain version against ``box_blur_solve_pallas(..., interpret=True)``
  and ``_update_flow``, including non-tile shapes.
- The whole flow against ``farneback_flow(warp="exact")`` on a textured
  (dx=2, dy=1) pan, seed 5.  Measured on the CPU in f32: at 120x160 mean
  error 2.4e-7 px and interior (16 px in) max 2.9e-6 px; at 540x960 mean
  3.2e-7 px, interior max 6.0e-6 px.  Bounds: mean 1e-5 px, interior max
  5e-4 px, 100x inside the 0.05 px cv2 tolerance of tests/test_flow.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relaxtpu.ops.boxsolve import box_blur_solve_pallas
from relaxtpu.ops.flow import _poly_expansion, _update_flow, _update_matrices, _warp_exact
from relaxtpu.ops.flow import farneback_flow as jax_flow
from relaxtpu.ops.warp import warp_planes_banded_pallas
from relaxtpu_torch.ops.boxsolve import box_blur_solve
from relaxtpu_torch.ops.flow import farneback_flow, pyramid_levels
from relaxtpu_torch.ops.warp import update_matrices, warp_planes_plain

cv2 = pytest.importorskip("cv2")


def T(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def planes(rng, n, h, w):
    """(n, 5, H, W) polynomial planes of random gray images, as in the flow."""
    return np.stack([
        np.asarray(_poly_expansion(jnp.asarray(rng.integers(0, 256, (h, w)).astype(np.float32)), 5, 1.2))
        for _ in range(n)
    ])


def realistic_m(rng, n, h, w):
    """PSD normal-equation planes, as production builds them (see
    tests/test_flow.py::_realistic_m)."""
    r0, r1 = planes(rng, n, h, w), planes(rng, n, h, w)
    zero = jnp.zeros((2, h, w), jnp.float32)
    return np.stack([np.asarray(_update_matrices(jnp.asarray(r0[i]), jnp.asarray(r1[i]), zero, "exact"))
                     for i in range(n)])


def test_pyramid_sizes_use_cvround():
    assert [lv[1:] for lv in pyramid_levels(540, 960)] == [(68, 120), (135, 240), (270, 480), (540, 960)]
    assert [lv[1:] for lv in pyramid_levels(120, 160)] == [(60, 80), (120, 160)]


@pytest.mark.parametrize("h,w", [(120, 160), (67, 131)])
def test_update_matrices_plain_matches_jax_exact(rng, h, w):
    r0, r1 = planes(rng, 2, h, w), planes(rng, 2, h, w)
    flow = rng.normal(0, 4, (2, 2, h, w)).astype(np.float32)
    flow[1, :, :8] = 300.0  # far outside: the inside mask and the clipped corners
    want = np.stack([np.asarray(_update_matrices(jnp.asarray(r0[i]), jnp.asarray(r1[i]),
                                                 jnp.asarray(flow[i]), "exact")) for i in range(2)])
    got = update_matrices(T(r0), T(r1), T(flow)).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * scale)
    assert update_matrices.launches == 0  # CPU tensors never reach the kernel


def test_warp_plain_matches_exact_and_banded_pallas(rng):
    h, w = 120, 160
    p = rng.normal(0, 50, (2, 5, h, w)).astype(np.float32)
    flow = rng.normal(0, 4, (2, 2, h, w)).astype(np.float32)
    got = warp_planes_plain(T(p), T(flow)).numpy()
    for i in range(2):
        want = np.asarray(_warp_exact(jnp.asarray(p[i]), jnp.asarray(flow[i])))
        np.testing.assert_allclose(got[i], want, rtol=1e-5, atol=1e-3)
    # in band (|d| well inside the Pallas kernel's window): the TPU kernel's
    # banded one-hot matmul gives the same bilinear sample
    with jax.default_device(jax.devices("cpu")[0]):
        banded = np.asarray(warp_planes_banded_pallas(jnp.asarray(p[0]), jnp.asarray(flow[0]), interpret=True))
    np.testing.assert_allclose(got[0], banded, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("h,w", [(120, 160), (67, 131)])
def test_box_blur_solve_plain_matches_pallas_and_xla(rng, h, w):
    m = realistic_m(rng, 2, h, w)
    got = box_blur_solve(T(m), 15).numpy()
    with jax.default_device(jax.devices("cpu")[0]):
        pallas = np.asarray(box_blur_solve_pallas(jnp.asarray(m), 15, interpret=True))
    xla = np.stack([np.asarray(_update_flow(jnp.asarray(m[i]), 15)) for i in range(2)])
    np.testing.assert_allclose(got, pallas, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, xla, rtol=1e-4, atol=1e-4)
    assert box_blur_solve.launches == 0


def textured(rng, h, w, sigma=3.0):
    t = cv2.GaussianBlur(rng.normal(0, 1, (h, w)).astype(np.float32), (0, 0), sigma)
    return (t - t.mean()) / t.std() * 40 + 128


def shifted_pairs(rng, n, h, w, dx, dy):
    prev, nxt = [], []
    for _ in range(n):
        big = textured(rng, h + 32, w + 32)
        prev.append(np.clip(big[16 : 16 + h, 16 : 16 + w], 0, 255).astype(np.uint8))
        nxt.append(np.clip(big[16 - dy : 16 - dy + h, 16 - dx : 16 - dx + w], 0, 255).astype(np.uint8))
    return np.stack(prev), np.stack(nxt)


def assert_flow_close(n, h, w):
    prev, nxt = shifted_pairs(np.random.default_rng(5), n, h, w, dx=2, dy=1)
    got = farneback_flow(T(prev), T(nxt)).numpy()
    assert got.shape == (n, h, w, 2)
    for i in range(n):
        want = np.asarray(jax_flow(jnp.asarray(prev[i]), jnp.asarray(nxt[i]), warp="exact"))
        err = np.abs(got[i] - want)
        assert err.mean() <= 1e-5, err.mean()
        assert err[16:-16, 16:-16].max() <= 5e-4, err[16:-16, 16:-16].max()


def test_farneback_flow_matches_jax_exact():
    assert_flow_close(2, 120, 160)


@pytest.mark.slow
def test_farneback_flow_matches_jax_exact_540p():
    assert_flow_close(1, 540, 960)
