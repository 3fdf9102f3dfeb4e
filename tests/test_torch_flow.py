"""Farneback flow of the port against the JAX package on the CPU.

- K1's plain version (``update_matrices`` on CPU tensors) against
  ``_update_matrices(..., "exact")``; its warp against ``_warp_exact`` and,
  for in-band flow, the Pallas banded warp in interpret mode.
- K2's plain version against ``box_blur_solve_pallas(..., interpret=True)``
  and ``_update_flow``, including non-tile shapes and windows past the strip
  kernel's largest (19, 21, 23, 31, 33, which the generic-radius kernel
  takes on the card, and 67 and 101, which the wide route takes); K2's
  routing between its three routes; the generic-radius kernel's plan and
  index arithmetic (its ring slots, the spans clamped at the edges, the
  4-row blocks of the vertical pass and the 16-byte chunks of the
  horizontal one) and the wide route's (both passes, their tap chunks, the
  scratch's aligned rows), emulated in torch and held bit-equal to
  ``box_sum_plain`` at ragged shapes.
- The whole flow against ``farneback_flow(warp="exact")`` on a textured
  (dx=2, dy=1) pan, seed 5.  Measured on the CPU in f32: at 120x160 mean
  error 2.4e-7 px and interior (16 px in) max 2.9e-6 px; at 540x960 mean
  3.2e-7 px, interior max 6.0e-6 px.  Bounds: mean 1e-5 px, interior max
  5e-4 px, 100x inside the 0.05 px cv2 tolerance of tests/test_flow.py;
  the same bounds at winsize 21 (measured at 120x160: mean 2.3e-7 px,
  interior max 2.1e-6 px).  K2 at windows 19, 21, 23, 31 and 33 on 67x131:
  within 9.6e-7 of both JAX forms (bound 1e-4).
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
from relaxtpu_torch.ops import boxsolve
from relaxtpu_torch.ops.boxsolve import (
    GENERIC_WINSIZE, RING_ROWS, RING_SPAN, SMEM_MAX, STRIP_WINSIZE, WIDE_ROWS, WIDE_RUNS, WIDE_SPAN, _hstage_cols,
    _ring_plan, _vring_rows, _wide_plan, _wide_taps, box_blur_solve, box_sum_plain,
)
from relaxtpu_torch.ops.flow import farneback_flow, pyramid_levels
from relaxtpu_torch.ops.warp import update_matrices, warp_planes_plain


@pytest.fixture(scope="module")
def rng():
    """This file's own generator (the session one's state depends on which
    files ran before in the same worker): the inputs are those of a run of
    this file alone."""
    return np.random.default_rng(0)

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


@pytest.mark.parametrize("h,w", [(120, 160), (67, 131), (16, 20)])
def test_box_blur_solve_plain_matches_pallas_and_xla(rng, h, w):
    m = realistic_m(rng, 2, h, w)
    got = box_blur_solve(T(m), 15).numpy()
    with jax.default_device(jax.devices("cpu")[0]):
        pallas = np.asarray(box_blur_solve_pallas(jnp.asarray(m), 15, interpret=True))
    xla = np.stack([np.asarray(_update_flow(jnp.asarray(m[i]), 15)) for i in range(2)])
    np.testing.assert_allclose(got, pallas, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, xla, rtol=1e-4, atol=1e-4)
    assert box_blur_solve.launches == 0


@pytest.mark.parametrize("winsize", [19, 21, 23, 31, 33, 67, 101])
def test_box_blur_solve_plain_matches_pallas_and_xla_wide_windows(rng, winsize):
    """Windows past the strip kernel's largest; at 31 the window spans
    more than a fifth of the image's 67 rows, at 67 and 101 (the wide
    route) all of them, at 101 more than they."""
    m = realistic_m(rng, 2, 67, 131)
    got = box_blur_solve(T(m), winsize).numpy()
    with jax.default_device(jax.devices("cpu")[0]):
        pallas = np.asarray(box_blur_solve_pallas(jnp.asarray(m), winsize, interpret=True))
    xla = np.stack([np.asarray(_update_flow(jnp.asarray(m[i]), winsize)) for i in range(2)])
    np.testing.assert_allclose(got, pallas, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, xla, rtol=1e-4, atol=1e-4)


def test_box_blur_solve_refuses_a_window_past_the_kernels_largest():
    """The strip kernel is never handed a window past its largest
    (``STRIP_WINSIZE``), nor the generic-radius kernel one past its route's
    (``GENERIC_WINSIZE``: the kernel takes windows to 65, but the wide route
    is faster from 23 on): those go to the wide route's pair of kernels,
    which takes any odd window, as the Pallas kernel does.  An even window
    is refused before any launch (a meta tensor stands in for a CUDA one);
    the plain version takes any odd window."""
    assert (STRIP_WINSIZE, GENERIC_WINSIZE) == (17, 21)
    for winsize in (1, 5, 15, 17):
        assert boxsolve._entry(winsize) == "relax_box_blur_solve"
    for winsize in (19, 21):
        assert boxsolve._entry(winsize) == "relax_box_blur_solve_generic"
    for winsize in (23, 31, 33, 63, 65, 67, 101, 423):
        assert boxsolve._entry(winsize) == "relax_box_blur_solve_wide"
    for winsize in (16, 0, -3):
        with pytest.raises(ValueError, match="odd and positive"):
            box_blur_solve(torch.empty((1, 5, 8, 8), device="meta"), winsize)
    m = torch.rand((1, 5, 8, 8), generator=torch.Generator().manual_seed(0))
    for winsize in (STRIP_WINSIZE + 2, GENERIC_WINSIZE + 2):
        assert box_blur_solve(m, winsize).shape == (1, 2, 8, 8)
    assert box_blur_solve.launches == box_blur_solve.generic_launches == box_blur_solve.wide_launches == 0


@pytest.fixture(scope="module")
def one_thread():
    """torch on one thread for this file's emulation tests (set back after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# The generic-radius kernel's constants (csrc/boxsolve.cu): threads a block,
# rows a thread sums in the vertical pass, the vertical-sum row stride, the
# largest dynamic shared memory a block takes on the card.
RING_THREADS, RING_VR, RING_VS, RING_SMEM_MAX = 256, 8, RING_SPAN + 4, 232448


def emulate_ring(m: torch.Tensor, winsize: int, tw: int, seg: int, rows: int) -> torch.Tensor:
    """The box sums of ``box_ring_solve_kernel`` on the plan (tw, seg,
    rows), its index arithmetic carried out in torch as the kernel does it
    (the five planes at once, in the kernel's order within a plane): ring
    rows staged into their slots (slot0 + lane, then + LANES, wrapping),
    the spans clamped at the image's edges, the vertical pass's register
    window filled 4 ring rows a block (no block across the wrap), the
    vertical sums shifted by R4 - R, the horizontal pass's 16-byte chunks
    (never read past the buffer); NaN wherever the kernel has not written."""
    p, c, h, w = m.shape
    th, rs, vr, vs_w = RING_ROWS, RING_SPAN, RING_VR, RING_VS
    r = winsize // 2
    r4 = (r + 3) & ~3
    off, span = r4 - r, tw + 2 * r4
    assert span <= rs and rows % 4 == 0 and rows >= th + 2 * r
    c4 = rs // 4
    lanes = RING_THREADS // c4
    out = torch.full_like(m, float("nan"))

    def ring_rows(ring, y0, gx0, n, slot0):
        cols = (gx0 + torch.arange(span)).clamp(0, w - 1)
        for lane in range(lanes):
            slot = slot0 + lane
            slot -= rows if slot >= rows else 0
            for i in range(lane, n, lanes):
                ring[..., slot, :span] = m[..., min(max(y0 + i, 0), h - 1), :][..., cols]
                slot += lanes
                slot -= rows if slot >= rows else 0

    def next4(slot):
        return 0 if slot + 4 == rows else slot + 4

    def vsums(ring, slot):
        win = [None] * vr

        def vtaps(s, slot, nj, at):
            assert slot % 4 == 0 and slot + nj <= rows  # a block never straddles the wrap
            new = [ring[..., slot + j, :] for j in range(nj)]
            for j in range(nj):
                win[at + j] = new[j]
                for y in range(vr):
                    s[y] = s[y] + win[(y + at + j + 1) % vr]

        for b in range(vr // 4):
            assert slot % 4 == 0 and slot + 4 <= rows
            for j in range(4):
                win[4 * b + j] = ring[..., slot + j, :]
            slot = next4(slot)
        s = list(win)
        t = 2 * r
        while t >= vr:
            for b in range(vr // 4):
                vtaps(s, slot, 4, 4 * b)
                slot = next4(slot)
            t -= vr
        for b in range(vr // 4):
            if 4 * b + 4 <= t:
                vtaps(s, slot, 4, 4 * b)
                slot = next4(slot)
            elif 4 * b + 2 == t:
                vtaps(s, slot, 2, 4 * b)
        return s

    def hsums(vs, base):
        flat = vs.reshape(p, c, -1)

        def ld(at):
            assert int(at.max()) + 4 <= th * vs_w  # inside the buffer
            return [flat[..., at + i] for i in range(4)]

        def htaps(s, a, b, nj):
            for j in range(1, nj + 1):
                for i in range(4):
                    s[i] = s[i] + (a[i + j] if i + j < 4 else b[i + j - 4])

        a, b = ld(base), ld(base + 4)
        s = list(a)
        n, at = r >> 1, base + 8
        while n >= 2:
            htaps(s, a, b, 4)
            a = ld(at)
            htaps(s, b, a, 4)
            b = ld(at + 4)
            n, at = n - 2, at + 8
        if n:
            htaps(s, a, b, 4)
            a = ld(at)
            if r & 1:
                htaps(s, b, a, 2)
        elif r & 1:
            htaps(s, a, b, 2)
        return s

    u = torch.arange(RING_THREADS * -(-th * rs // 4 // RING_THREADS))
    hrow, hx = u // (tw // 4), 4 * (u % (tw // 4))
    hrow, hx = hrow[hrow < th], hx[hrow < th]
    for x0 in range(0, w, tw):
        for ys in range(0, h, seg):
            ye = min(ys + seg, h)
            steps = -(-(ye - ys) // th)
            ring = torch.full((p, c, rows, rs), float("nan"))
            ring_rows(ring, ys - r, x0 - r4, th + 2 * r, 0)
            vslot = [vy0 for vy0 in range(0, th, vr)]  # the slot of ring row th k + vy0
            for k in range(steps):
                fill = (th * (k + 1) + 2 * r) % rows
                vs = torch.full((p, c, th, vs_w), float("nan"))
                for g, vy0 in enumerate(range(0, th, vr)):
                    for y, col in enumerate(vsums(ring, vslot[g])):
                        vs[..., vy0 + y, : span - off] = col[..., off:span]
                if k + 1 < steps:
                    ring_rows(ring, ys - r + th * (k + 1) + 2 * r, x0 - r4, th, fill)
                sums = hsums(vs, hrow * vs_w + hx)
                vslot = [v + th - (rows if v + th >= rows else 0) for v in vslot]
                yy = ys + th * k + hrow
                for i in range(4):
                    xx = x0 + hx + i
                    keep = (yy < ye) & (xx < w)
                    out[..., yy[keep], xx[keep]] = sums[i][..., keep]
    return out


RING_WINDOWS = [19, 21, 23, 25, 27, 33, 35, 63, 65]


@pytest.mark.parametrize("winsize", RING_WINDOWS)
def test_generic_radius_plan_and_index_arithmetic_are_bit_equal_to_box_sum_plain(one_thread, winsize):
    """The kernel's plan and its index arithmetic, emulated (the CPU cannot
    run the kernel), at ragged shapes: widths 1, 3 and 4, one strip less a
    column, one strip, one strip and a column (the plan's widest strip is
    128 - 2 R4), 131; heights 1 and below the window; runs for 1, 7 and 264
    resident blocks.  Every output is ``box_sum_plain``'s to the bit, and
    the plan fits a block's shared memory at the radius."""
    r = winsize // 2
    r4 = (r + 3) & ~3
    strip = RING_SPAN - 2 * r4
    gen = torch.Generator().manual_seed(winsize)
    shapes = [(1, 1, 1), (2, 1, 3), (1, 5, 4), (1, winsize - 2, strip - 1), (1, 3, strip),
              (1, 2 * RING_ROWS + 3, strip + 1), (2, 37, 131)]
    for p, h, w in shapes:
        m = torch.randn((p, 5, h, w), generator=gen) * 50
        want = box_sum_plain(m, winsize)
        for slots in (1, 7, 264):
            tw, seg, rows = _ring_plan(p, h, w, winsize, slots)
            assert tw % 4 == 0 and 4 <= tw <= strip and -(-w // tw) == -(-w // strip)
            assert seg % RING_ROWS == 0 and seg >= RING_ROWS
            assert 4 * (5 * rows * RING_SPAN + 2 * RING_ROWS * RING_VS) <= RING_SMEM_MAX
            got = emulate_ring(m, winsize, tw, seg, rows)
            assert torch.equal(got, want), (p, h, w, slots, (got - want).abs().max())


def test_generic_radius_plan_at_the_main_path_levels():
    """The plan at the 540p levels: strips as wide as the fewest need (960
    columns in 10 strips of 96 at winsize 21, not 104 wasting 80), the
    largest radius's rings within a block's shared memory, and runs that
    fill whole waves."""
    assert _ring_plan(16, 540, 960, 21, 264)[0] == 96
    assert [_ring_plan(16, h, w, 21, 264)[0] for h, w in ((68, 120), (135, 240), (270, 480))] == [60, 80, 96]
    rows = _ring_plan(1, 8, 8, 65, 132)[2]  # the kernel's largest window (GRMAX)
    assert rows == RING_ROWS + 2 * 32
    assert 4 * (5 * rows * RING_SPAN + 2 * RING_ROWS * RING_VS) <= RING_SMEM_MAX
    for p, h, w in ((16, 540, 960), (16, 68, 120), (1, 1, 1)):
        tw, seg, _ = _ring_plan(p, h, w, 21, 264)
        steps, run = -(-h // RING_ROWS), seg // RING_ROWS
        assert 1 <= run <= steps


# The wide route's threads a block (both passes) and its vertical pass's
# rows a thread (csrc/boxsolve.cu: VT, VR).
WIDE_THREADS, WIDE_VR = 256, 8


def emulate_wide(m: torch.Tensor, winsize: int, plan: tuple, runs: int = WIDE_RUNS) -> torch.Tensor:
    """The box sums of the wide route (``box_vsum_kernel`` then
    ``box_hsum_solve_kernel``) on ``plan`` = (ws, seg, nv, tw, bh, ct), their
    index arithmetic carried out in torch as the kernels do it (the five
    planes at once; a pass's 4-pixel runs or a step's columns at once, in
    the kernels' tap order): the vertical pass launch by launch (nv taps
    each, each launch begun from the scratch sums of the ones before, the
    first from -0), its ring rows staged into their slots (slot0 + lane,
    then + LANES, wrapping) with the next step's rows staged before the
    step reads the ring, the register window filled 4 ring rows a block (no
    block across the wrap) with tails of 1 to 3 taps, the sums stored at
    column R mod 4 + x of a scratch row of ws; the horizontal pass's bands,
    strips and chunks of ct taps, each chunk's span staged from column
    x0 - R + t0 (clamped, 16-byte aligned in the scratch), its 16-byte
    chunks read inside the staged row.  NaN wherever a kernel has not
    written (the scratch's padding columns included)."""
    p, c, h, w = m.shape
    ws, seg, nv, tw, bh, ct = plan
    th, span, vr = WIDE_ROWS, WIDE_SPAN, WIDE_VR
    r = winsize // 2
    padl, taps = r & 3, 2 * r + 1
    assert ws % 4 == 0 and ws >= w + padl and seg % th == 0 and ct % 4 == 0 and bh * (tw // 4) <= runs
    lanes = WIDE_THREADS // (span // 4)
    nan = float("nan")
    scratch = torch.full((p, c, h, ws), nan)

    def stage(ring, rows, y0, x0, sp, n, slot0):
        cols = (x0 + torch.arange(span)).clamp(0, w - 1)
        for lane in range(lanes):
            slot = slot0 + lane - (rows if slot0 + lane >= rows else 0)
            for i in range(lane, n, lanes):
                ring[..., slot, : 4 * -(-sp // 4)] = m[..., min(max(y0 + i, 0), h - 1), :][..., cols[: 4 * -(-sp // 4)]]
                slot += lanes
                slot -= rows if slot >= rows else 0

    def vsums_from(s, ring, rows, slot, n):
        win = torch.full_like(s, nan)

        def block(slot, nj, at):
            assert slot % 4 == 0 and slot + nj <= rows  # a block never straddles the wrap
            win[..., at : at + nj, :] = ring[..., slot : slot + nj, :]

        def vtaps(slot, nj, at):
            for j in range(nj):
                assert slot % 4 == 0 and slot + nj <= rows
                win[..., at + j, :] = ring[..., slot + j, :]
                s.add_(win[..., (torch.arange(vr) + at + j + 1) % vr, :])

        for b in range(vr // 4):
            block(slot, 4, 4 * b)
            slot = 0 if slot + 4 == rows else slot + 4
        s.add_(win)
        t = n - 1
        while t >= vr:
            for b in range(vr // 4):
                vtaps(slot, 4, 4 * b)
                slot = 0 if slot + 4 == rows else slot + 4
            t -= vr
        for b in range(vr // 4):
            if 4 * b + 4 <= t:
                vtaps(slot, 4, 4 * b)
                slot = 0 if slot + 4 == rows else slot + 4
            elif 0 < t - 4 * b < 4:
                vtaps(slot, t - 4 * b, 4 * b)

    for t0 in range(0, taps, nv):
        n = min(nv, taps - t0)
        rows = _vring_rows(n)
        assert rows * span * 4 <= SMEM_MAX and rows >= 2 * th + n - 1
        for x0 in range(0, w, span):
            sp = min(span, w - x0)
            for ys in range(0, h, seg):
                ye = min(ys + seg, h)
                ring = torch.full((p, c, rows, span), nan)
                y0 = ys - r + t0
                stage(ring, rows, y0, x0, sp, th + n - 1, 0)
                for k in range(-(-(ye - ys) // th)):
                    if ys + th * (k + 1) < ye:  # the next step's rows land while this one reads
                        nxt = th * (k + 1) + n - 1
                        stage(ring, rows, y0 + nxt, x0, sp, th, nxt % rows)
                    for vy0 in range(0, th, vr):
                        y = ys + th * k + vy0
                        keep = min(vr, ye - y)
                        s = torch.full((p, c, vr, span), -0.0)
                        if t0 > 0 and keep > 0:
                            s[..., :keep, :sp] = scratch[..., y : y + keep, padl + x0 : padl + x0 + sp]
                        vsums_from(s, ring, rows, (th * k + vy0) % rows, n)
                        if keep > 0:
                            scratch[..., y : y + keep, padl + x0 : padl + x0 + sp] = s[..., :keep, :sp]

    out = torch.full_like(m, nan)
    u = torch.arange(runs)
    for x0 in range(0, w, tw):
        for y0 in range(0, h, bh):
            nb, ss = min(bh, h - y0), _hstage_cols(tw, ct)
            assert 20 * bh * ss <= SMEM_MAX
            hrow, hx = u // (tw // 4), 4 * (u % (tw // 4))
            hrow, hx = hrow[hrow < nb], hx[hrow < nb]
            acc = [torch.full((p, c, len(hrow)), -0.0) for _ in range(4)]
            for t0 in range(0, taps, ct):
                assert (padl + x0 - r + t0) % 4 == 0  # the staged span starts 16-byte aligned
                staged = torch.full((p, c, bh, ss), nan)
                cols = (x0 - r + t0 + torch.arange(ss)).clamp(0, w - 1)
                staged[..., :nb, :] = scratch[..., y0 : y0 + nb, :][..., padl + cols]
                flat, base, n = staged.reshape(p, c, -1), hrow * ss + hx, min(ct, taps - t0)

                def ld(at):
                    assert bool(((at - base) % 4 == 0).all()) and int((at - hx - hrow * ss).max()) + 4 <= ss
                    return [flat[..., at + i] for i in range(4)]

                def htaps(a, b, nj):
                    for j in range(1, nj + 1):
                        for i in range(4):
                            acc[i] = acc[i] + (a[i + j] if i + j < 4 else b[i + j - 4])

                a, b = ld(base), ld(base + 4)
                for i in range(4):
                    acc[i] = acc[i] + a[i]
                t, at = n - 1, base + 8
                while t >= 8:
                    htaps(a, b, 4)
                    a = ld(at)
                    htaps(b, a, 4)
                    b = ld(at + 4)
                    t, at = t - 8, at + 8
                if t >= 4:
                    htaps(a, b, 4)
                    a = ld(at)
                    htaps(b, a, t - 4)
                else:
                    htaps(a, b, t)
            for i in range(4):
                xx = x0 + hx + i
                keep = xx < w
                out[..., y0 + hrow[keep], xx[keep]] = acc[i][..., keep]
    return out


FIRST_CHUNKED = _wide_taps(10**6) + 2  # the first window whose vertical ring does not fit a block
WIDE_WINDOWS = [67, 69, 101, 131, FIRST_CHUNKED]


@pytest.mark.parametrize("winsize", WIDE_WINDOWS)
def test_wide_route_plan_and_index_arithmetic_are_bit_equal_to_box_sum_plain(one_thread, winsize):
    """The wide route's plan and both passes' index arithmetic, emulated
    (the CPU cannot run the kernels), at ragged shapes: widths 1, 3 and 4,
    one vertical strip (128 columns) less a column, one strip, one strip
    and a column, 131; heights 1 and below the window; runs for 1, 7 and
    264 resident blocks; and, at 1 resident block, a plan with both passes'
    taps in chunks (the vertical pass's launches and the horizontal pass's
    staged chunks) and horizontal strips of at most 128 columns.  Every
    output is ``box_sum_plain``'s to the bit, and the plan fits a block's
    shared memory.  At the last window the vertical ring of the whole
    window does not fit, so its taps run in chunks on the default plan."""
    assert _wide_taps(FIRST_CHUNKED - 2) == FIRST_CHUNKED - 2 and _wide_taps(FIRST_CHUNKED) < FIRST_CHUNKED
    gen = torch.Generator().manual_seed(winsize)
    shapes = [(1, 1, 1), (2, 1, 3), (1, 5, 4), (1, winsize - 2, WIDE_SPAN - 1), (1, 3, WIDE_SPAN),
              (1, 2 * WIDE_ROWS + 3, WIDE_SPAN + 1), (2, 37, 131)]
    for p, h, w in shapes:
        m = torch.randn((p, 5, h, w), generator=gen) * 50
        want = box_sum_plain(m, winsize)
        plans = {(_wide_plan(p, h, w, winsize, slots), WIDE_RUNS) for slots in (1, 7, 264)}  # the distinct ones
        if h < FIRST_CHUNKED - 2:  # (the emulation of the tallest shape's 421 bands would take 30 s)
            plans.add((_wide_plan(p, h, w, winsize, 1, runs=32, vtaps=winsize // 3, htaps=4 * (winsize // 12)), 32))
        for plan, runs in sorted(plans):
            ws, seg, nv, tw, bh, ct = plan
            assert seg % WIDE_ROWS == 0 and WIDE_ROWS <= seg <= WIDE_ROWS * -(-h // WIDE_ROWS)
            assert _vring_rows(nv) * WIDE_SPAN * 4 <= SMEM_MAX and 20 * bh * _hstage_cols(tw, ct) <= SMEM_MAX
            assert tw % 4 == 0 and 1 <= bh <= h and bh * tw // 4 <= runs
            got = emulate_wide(m, winsize, plan, runs)
            assert torch.equal(got, want), (p, h, w, plan, (got - want).abs().max())


def test_wide_route_plan_at_the_main_path_levels():
    """The wide plan at the 540p levels, winsize 67: the whole window in
    one vertical launch (a ring of 100 rows, 51 KB), whole rows staged in
    the horizontal pass (bands of 2 rows at 960 columns, 17 at 120), every
    tap in one staged chunk, and runs that fill whole waves."""
    assert _vring_rows(_wide_taps(67)) == 100
    for (h, w), bh in zip(((68, 120), (135, 240), (270, 480), (540, 960)), (17, 8, 4, 2)):
        ws, seg, nv, tw, got_bh, ct = _wide_plan(16, h, w, 67, 528)
        assert (ws, nv, tw, got_bh, ct) == (w + 4, 67, w, bh, 68)
        assert seg % WIDE_ROWS == 0 and 1 <= seg // WIDE_ROWS <= -(-h // WIDE_ROWS)
    assert _wide_plan(4, 2160, 3840, 67, 528)[3] == 1920  # two strips at 4K


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


def assert_flow_close(n, h, w, winsize=15):
    prev, nxt = shifted_pairs(np.random.default_rng(5), n, h, w, dx=2, dy=1)
    got = farneback_flow(T(prev), T(nxt), winsize=winsize).numpy()
    assert got.shape == (n, h, w, 2)
    for i in range(n):
        want = np.asarray(jax_flow(jnp.asarray(prev[i]), jnp.asarray(nxt[i]), winsize=winsize, warp="exact"))
        err = np.abs(got[i] - want)
        assert err.mean() <= 1e-5, err.mean()
        assert err[16:-16, 16:-16].max() <= 5e-4, err[16:-16, 16:-16].max()


def test_farneback_flow_matches_jax_exact():
    assert_flow_close(2, 120, 160)


def test_farneback_flow_matches_jax_exact_winsize_21():
    assert_flow_close(1, 120, 160, winsize=21)


@pytest.mark.slow
def test_farneback_flow_matches_jax_exact_540p():
    assert_flow_close(1, 540, 960)
