"""The flow's polynomial expansion (``ops/flow.py::poly_expansion``) on the CPU.

- The plain version (``poly_expansion_plain``, which CPU tensors take) bit
  for bit the expansion's former body and within 1e-5 (relative to each
  case's largest value) of the JAX package's ``_poly_expansion``, at 1 x 1
  to 135 x 240, P 1 and 3, n 2, 5 and 7.
- ``csrc/polyexp.cu``'s plan and index arithmetic, emulated in torch as the
  kernel does them (ring slots, spans clamped at the edges, the vertical
  pass's 4-row blocks and register window, the vertical sums shifted by
  n4 - n, the horizontal pass's 16-byte chunks, the stores' offsets into
  (N, 5, H, W)), held bit-equal to the plain version at ragged shapes.
- The wrapper's routing: CPU to the plain version; on the card (a meta
  tensor stands in, the library is spied) one launch of the plan's
  arguments, none for an empty input, and an error for a wrong type or
  layout or a radius past the kernel's largest.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relaxtpu.ops.flow import _poly_expansion as jax_poly_expansion
from relaxtpu_torch import _native
from relaxtpu_torch.ops import flow as flow_mod
from relaxtpu_torch.ops.flow import (
    POLY_NMAX, POLY_ROWS, POLY_SPAN, _poly_coeffs_f32, _poly_exp_coeffs, _poly_plan, _sep_correlate,
    farneback_flow, poly_expansion, poly_expansion_plain, pyramid_levels,
)
from portbench import spec

# the kernel's constants (csrc/polyexp.cu): threads a block, rows a thread
# sums in the vertical pass, the vertical-sum row stride, taps a row of the
# coefficients, the largest dynamic shared memory a block takes on the card
THREADS, VR, VS, TAPS, SMEM_MAX = 256, 8, POLY_SPAN + 4, 2 * POLY_NMAX + 1, 232448


@pytest.fixture(scope="module")
def one_thread():
    """torch on one thread for this file (set back after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def former_poly_expansion(img: torch.Tensor, n: int, sigma: float) -> torch.Tensor:
    """The expansion's body before the kernel, kept as it was."""
    g, xg, xxg, ig11, ig03, ig33, ig55 = (
        v if isinstance(v, np.ndarray) else float(v) for v in _poly_exp_coeffs(n, sigma)
    )
    one = np.array([1.0])
    v0 = _sep_correlate(img, one, g, "edge")
    v1 = _sep_correlate(img, one, xg, "edge")
    v2 = _sep_correlate(img, one, xxg, "edge")
    b1 = _sep_correlate(v0, g, one, "edge")
    b2 = _sep_correlate(v0, xg, one, "edge")
    b4 = _sep_correlate(v0, xxg, one, "edge")
    b3 = _sep_correlate(v1, g, one, "edge")
    b6 = _sep_correlate(v1, xg, one, "edge")
    b5 = _sep_correlate(v2, g, one, "edge")
    return torch.stack(
        [b3 * ig11, b2 * ig11, b1 * ig03 + b5 * ig33, b1 * ig03 + b4 * ig33, b6 * ig55],
        dim=-3,
    )


def images(seed: int, *shape) -> torch.Tensor:
    """Gray images with values 0-255, as the flow's pyramid levels hold."""
    return torch.from_numpy(np.random.default_rng(seed).uniform(0, 255, shape).astype(np.float32))


@pytest.mark.parametrize("n", [2, 5, 7])
@pytest.mark.parametrize("p", [1, 3])
@pytest.mark.parametrize("h,w", [(1, 1), (5, 7), (16, 20), (23, 37), (68, 120), (135, 240)])
def test_plain_is_the_former_body_and_near_jax(one_thread, h, w, p, n):
    img = images(h * w + p + n, p, h, w)
    got = poly_expansion(img, n, 1.2)
    assert torch.equal(got, poly_expansion_plain(img, n, 1.2))
    assert torch.equal(got, former_poly_expansion(img, n, 1.2))
    want = np.stack([np.asarray(jax_poly_expansion(jnp.asarray(img[i].numpy()), n, 1.2)) for i in range(p)])
    assert got.shape == (p, 5, h, w)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def emulate_kernel(img: torch.Tensor, n: int, sigma: float, tw: int, seg: int, rows: int) -> torch.Tensor:
    """The output of ``poly_expansion_kernel`` on the plan (tw, seg, rows),
    its index arithmetic carried out in torch as the kernel does it, every
    image at once and, within a step, every column of the span at once:
    ring rows staged into their slots (slot0 + lane, then + LANES, wrapping),
    the spans clamped at the image's edges, the vertical pass's register
    window filled 4 ring rows a block (no block across the wrap), the three
    vertical sums shifted by n4 - n, the horizontal pass's 16-byte chunks
    (never read past the buffer), the combination, and the stores at their
    offsets into the flat (N, 5, H, W) output; each output written once,
    NaN wherever the kernel writes nothing.  The arithmetic is the kernel's:
    every sum from +0, a rounded product and a rounded add a tap."""
    N, h, w = img.shape
    args = _poly_coeffs_f32(n, sigma)
    k = [[float(v) for v in args[r * TAPS : r * TAPS + 2 * n + 1]] for r in range(3)]
    ig11, ig03, ig33, ig55 = (float(v) for v in args[3 * TAPS :])
    n4 = (n + 3) & ~3
    off, span = n4 - n, tw + 2 * n4
    assert tw % 4 == 0 and span <= POLY_SPAN and rows % 4 == 0 and rows >= POLY_ROWS + 2 * n
    assert seg % POLY_ROWS == 0
    lanes = THREADS // (POLY_SPAN // 4)
    hw = h * w
    out = torch.full((N * 5 * hw,), float("nan"))
    written = torch.zeros(N * 5 * hw, dtype=torch.int32)

    def stage(ring, y0, gx0, count, slot0):
        cols = (gx0 + torch.arange(span)).clamp(0, w - 1)
        for lane in range(lanes):
            slot = slot0 + lane
            slot -= rows if slot >= rows else 0
            for i in range(lane, count, lanes):
                ring[:, slot, :span] = img[:, min(max(y0 + i, 0), h - 1), cols]
                slot += lanes
                slot -= rows if slot >= rows else 0

    def next4(slot):
        return 0 if slot + 4 == rows else slot + 4

    def vsums(ring, slot):
        win = [None] * VR
        for b in range(VR // 4):
            assert slot % 4 == 0 and slot + 4 <= rows
            for j in range(4):
                win[4 * b + j] = ring[:, slot + j, :]
            slot = next4(slot)
        s = [[torch.zeros_like(win[y]) + k[c][0] * win[y] for y in range(VR)] for c in range(3)]

        def vtaps(slot, nj, at, t0):
            assert slot % 4 == 0 and slot + nj <= rows  # a block never straddles the wrap
            new = [ring[:, slot + j, :] for j in range(nj)]
            for j in range(nj):
                win[at + j] = new[j]
                for y in range(VR):
                    u = win[(y + at + j + 1) % VR]
                    for c in range(3):
                        s[c][y] = s[c][y] + k[c][t0 + j] * u

        t, left = 1, 2 * n
        while left >= VR:
            for b in range(VR // 4):
                vtaps(slot, 4, 4 * b, t)
                t += 4
                slot = next4(slot)
            left -= VR
        for b in range(VR // 4):
            if 4 * b + 4 <= left:
                vtaps(slot, 4, 4 * b, t)
                t += 4
                slot = next4(slot)
            elif 4 * b + 2 == left:
                vtaps(slot, 2, 4 * b, t)
        return s

    runs = torch.arange(THREADS * -(-POLY_ROWS * POLY_SPAN // 4 // THREADS))
    hrow, hx = runs // (tw // 4), 4 * (runs % (tw // 4))
    hrow, hx = hrow[hrow < POLY_ROWS], hx[hrow < POLY_ROWS]

    def hsums(flat, plane, nsums):
        def ld(at):
            assert int(at.max()) + 4 <= flat.shape[1]  # inside the buffer
            return [flat[:, at + i] for i in range(4)]

        s = [[torch.zeros(N, len(hrow)) for _ in range(4)] for _ in range(nsums)]

        def htaps(a, b, nj, t0):
            for j in range(nj):
                for c in range(nsums):
                    for i in range(4):
                        s[c][i] = s[c][i] + k[c][t0 + j] * (a[i + j] if i + j < 4 else b[i + j - 4])

        base = plane * POLY_ROWS * VS + hrow * VS + hx
        a, b = ld(base), ld(base + 4)
        p, t, g = base + 8, 0, (2 * n + 1) >> 2
        while g >= 2:
            htaps(a, b, 4, t)
            a = ld(p)
            htaps(b, a, 4, t + 4)
            b = ld(p + 4)
            g, p, t = g - 2, p + 8, t + 8
        if g:
            htaps(a, b, 4, t)
            a = ld(p)
            htaps(b, a, 3 if n & 1 else 1, t + 4)
        else:
            htaps(a, b, 3 if n & 1 else 1, t)
        return s

    z = torch.arange(N)[:, None]
    for x0 in range(0, w, tw):
        for ys in range(0, h, seg):
            ye = min(ys + seg, h)
            ring = torch.full((N, rows, POLY_SPAN), float("nan"))
            stage(ring, ys - n, x0 - n4, POLY_ROWS + 2 * n, 0)
            vslot = list(range(0, POLY_ROWS, VR))  # the slot of ring row th k + vy0
            for step in range(-(-(ye - ys) // POLY_ROWS)):
                vs = torch.full((N, 3, POLY_ROWS, VS), float("nan"))
                for g_, vy0 in enumerate(range(0, POLY_ROWS, VR)):
                    s = vsums(ring, vslot[g_])
                    for c in range(3):
                        for y in range(VR):
                            vs[:, c, vy0 + y, : span - off] = s[c][y][:, off:span]
                if (step + 1) * POLY_ROWS < ye - ys:
                    stage(ring, ys - n + POLY_ROWS * (step + 1) + 2 * n, x0 - n4, POLY_ROWS,
                          (POLY_ROWS * (step + 1) + 2 * n) % rows)
                flat = vs.reshape(N, -1)
                b1, b2, b4 = hsums(flat, 0, 3)
                b3, b6 = hsums(flat, 1, 2)
                (b5,) = hsums(flat, 2, 1)
                planes = [[b3[i] * ig11 for i in range(4)], [b2[i] * ig11 for i in range(4)],
                          [b1[i] * ig03 + b5[i] * ig33 for i in range(4)],
                          [b1[i] * ig03 + b4[i] * ig33 for i in range(4)], [b6[i] * ig55 for i in range(4)]]
                yy, xb = ys + POLY_ROWS * step + hrow, x0 + hx
                for i in range(4):
                    keep = (yy < ye) & (xb + i < w)
                    for c in range(5):
                        at = z * 5 * hw + c * hw + yy[keep] * w + xb[keep] + i
                        out[at] = planes[c][i][:, keep]
                        written[at] += 1
                vslot = [v + POLY_ROWS - (rows if v + POLY_ROWS >= rows else 0) for v in vslot]
    assert int(written.max()) == 1
    return out.view(N, 5, h, w)


@pytest.mark.parametrize("n", [1, 2, 5, 7, POLY_NMAX])
def test_kernel_plan_and_index_arithmetic_are_bit_equal_to_the_plain_version(one_thread, n):
    """The kernel's plan and index arithmetic, emulated (the CPU cannot run
    the kernel), at ragged shapes: widths 1, 3 and 4, one strip less a
    column, one strip, one strip and a column (the plan's widest strip is
    128 - 2 n4), 131; heights 1, below the taps and past two steps; runs
    for 1, 7 and 528 resident blocks.  Every output is the plain version's
    to the bit, and the plan fits a block's shared memory."""
    n4 = (n + 3) & ~3
    strip = POLY_SPAN - 2 * n4
    shapes = [(1, 1, 1), (2, 1, 3), (1, 5, 4), (1, 2 * n, strip - 1), (1, 3, strip),
              (2, 2 * POLY_ROWS + 3, strip + 1)]
    if n < POLY_NMAX:
        shapes.append((2, 37, 131))
    for N, h, w in shapes:
        img = images(N * h * w + n, N, h, w)
        want = poly_expansion_plain(img, n, 1.2)
        for slots in (1, 7, 528):
            tw, seg, rows = _poly_plan(N, h, w, n, slots)
            assert tw % 8 == 0 and 8 <= tw <= strip and -(-w // tw) == -(-w // strip)
            assert seg % POLY_ROWS == 0 and seg >= POLY_ROWS
            assert 4 * (rows * POLY_SPAN + 3 * POLY_ROWS * VS) <= SMEM_MAX
            got = emulate_kernel(img, n, 1.2, tw, seg, rows)
            assert torch.equal(got, want), (N, h, w, slots, (got - want).abs().max())


def test_plan_at_the_main_path_levels():
    """The plan at the 540p and 1080p levels with 16 pairs (32 images) on
    528 resident blocks (132 SMs, 4 blocks each): strips of a multiple of 8
    columns, as narrow as the fewest strips allow, runs of whole steps (one
    step at the two small levels, which the card measured fastest), and
    grids that fill the card's 132 SMs at the small levels too."""
    slots = 528
    got = {(h, w): _poly_plan(32, h, w, 5, slots) for _, h, w in pyramid_levels(1080, 1920)}
    got.update({(h, w): _poly_plan(32, h, w, 5, slots) for _, h, w in pyramid_levels(540, 960)})
    assert {hw: plan[0] for hw, plan in got.items()} == {
        (68, 120): 64, (135, 240): 80, (270, 480): 96, (540, 960): 112, (1080, 1920): 112}
    assert got[(68, 120)][1] == got[(135, 240)][1] == POLY_ROWS
    for (h, w), (tw, seg, rows) in got.items():
        assert rows == 28 and seg % POLY_ROWS == 0 and POLY_ROWS <= seg <= POLY_ROWS * -(-h // POLY_ROWS)
        blocks = 32 * -(-w // tw) * -(-h // seg)
        assert blocks >= 132, (h, w, blocks)
    assert _poly_plan(1, 1, 1, POLY_NMAX, 132) == (8, POLY_ROWS, POLY_ROWS + 2 * POLY_NMAX)
    assert 4 * ((POLY_ROWS + 2 * POLY_NMAX) * POLY_SPAN + 3 * POLY_ROWS * VS) <= SMEM_MAX


def test_coefficients_are_rounded_once_and_cached():
    args = _poly_coeffs_f32(5, 1.2)
    assert args.dtype == np.float32 and args.shape == (3 * TAPS + 4,)
    assert _poly_coeffs_f32(5, 1.2) is args
    g, xg, xxg, *igs = _poly_exp_coeffs(5, 1.2)
    for r, taps in enumerate((g, xg, xxg)):
        assert np.array_equal(args[r * TAPS : r * TAPS + 11], taps.astype(np.float32))
        assert not args[r * TAPS + 11 : (r + 1) * TAPS].any()
    assert np.array_equal(args[3 * TAPS :], np.asarray(igs, np.float32))


@pytest.fixture
def spy(monkeypatch):
    """The kernel library spied on: launches and queries recorded, the
    device check passed (a meta tensor stands in for a CUDA one)."""
    calls = []
    monkeypatch.setattr(_native, "launch", lambda name, device, *a: calls.append((name, a)))
    monkeypatch.setattr(_native, "query", lambda name, device, *a: 528)
    monkeypatch.setattr(_native, "check_cuda_input", lambda *a: None)
    monkeypatch.setattr(flow_mod, "_poly_slots", {})
    yield calls


def test_cpu_takes_the_plain_version(spy):
    before = poly_expansion.launches
    img = images(0, 2, 9, 11)
    assert torch.equal(poly_expansion(img, 5, 1.2), poly_expansion_plain(img, 5, 1.2))
    assert poly_expansion.launches == before and not spy


def test_a_device_tensor_makes_one_launch_of_the_plan(spy, monkeypatch):
    """One launch of the plan's arguments, counted on ``poly_expansion``
    also while its module-global name is rebound to a wrapper, as the
    benchmark's ranges and the smoke run's recorder rebind it."""
    before = poly_expansion.launches
    img = torch.empty((2, 3, 270, 480), device="meta")
    out = poly_expansion(img, 5, 1.2)
    assert out.shape == (2, 3, 5, 270, 480) and out.device.type == "meta"
    tw, seg, _ = _poly_plan(6, 270, 480, 5, 528)
    assert spy == [("relax_poly_expansion",
                    (0, 0, 6, 270, 480, 5, _poly_coeffs_f32(5, 1.2).ctypes.data, tw, seg))]
    assert poly_expansion.launches == before + 1
    monkeypatch.setattr(flow_mod, "poly_expansion", lambda *a: poly_expansion(*a))
    flow_mod.poly_expansion(img, 5, 1.2)
    assert poly_expansion.launches == before + 2 and len(spy) == 2


def test_an_empty_input_makes_no_launch(spy):
    before = poly_expansion.launches
    for shape in ((2, 0, 68, 120), (0, 68, 120), (3, 0, 5)):
        out = poly_expansion(torch.empty(shape, device="meta"), 5, 1.2)
        assert out.shape == (*shape[:-2], 5, *shape[-2:])
    assert poly_expansion.launches == before and not spy


@pytest.mark.parametrize("bad", ["float64", "bfloat16", "strided", "one-dim"])
def test_a_wrong_type_or_layout_raises_before_any_launch(spy, bad):
    img = {"float64": torch.empty((2, 8, 8), dtype=torch.float64, device="meta"),
           "bfloat16": torch.empty((2, 8, 8), dtype=torch.bfloat16, device="meta"),
           "strided": torch.empty((2, 8, 16), device="meta")[..., ::2],
           "one-dim": torch.empty((8,), device="meta")}[bad]
    before = poly_expansion.launches
    with pytest.raises(ValueError, match="contiguous float32"):
        poly_expansion(img, 5, 1.2)
    assert poly_expansion.launches == before and not spy


def test_the_radius_limit(spy):
    """Radii past the kernel's largest (or below 1) are refused on the card
    with the limit named; the plain version takes them on the CPU."""
    img = torch.empty((2, 8, 8), device="meta")
    for n in (0, POLY_NMAX + 1, 100):
        with pytest.raises(ValueError, match=f"radii 1 to {POLY_NMAX}"):
            poly_expansion(img, n, 1.2)
    poly_expansion(img, POLY_NMAX, 1.2)
    assert len(spy) == 1
    cpu = images(1, 1, 4, 5)
    assert torch.equal(poly_expansion(cpu, POLY_NMAX + 1, 9.0), poly_expansion_plain(cpu, POLY_NMAX + 1, 9.0))


def test_the_flow_calls_the_expansion_once_a_level(one_thread, monkeypatch):
    """``farneback_flow`` looks the expansion up by its module-global name
    (the benchmark wraps it there): one call a pyramid level, over both
    images of every pair, image-major."""
    seen = []

    def counted(img, n, sigma):
        seen.append(tuple(img.shape))
        return poly_expansion_plain(img, n, sigma)

    monkeypatch.setattr(flow_mod, "poly_expansion", counted)
    a, b = images(3, 2, 70, 90), images(4, 2, 70, 90)
    farneback_flow(a, b)
    assert seen == [(2, 2, h, w) for _, h, w in pyramid_levels(70, 90)]


def test_roofline_metric_counts_the_kernels_work():
    """``polyexp_roofline``'s bound: 24 bytes a pixel at 3.35e12 a second,
    or 206 rounded operations a pixel at n = 5 at the add rate (33.5e12)."""
    metric = spec.metric_module("polyexp_roofline")
    assert metric.CALLS == ("relaxtpu_torch.ops.flow", "poly_expansion")
    assert metric.KERNEL == "poly_expansion_kernel"
    img = torch.empty((2, 16, 540, 960))
    px = 2 * 16 * 540 * 960
    assert metric.bound_s(img, 5, 1.2) == pytest.approx(max(px * 24 / 3.35e12, px * 206 / 33.5e12))
    assert metric.bound_s(img, 7, 1.2) == pytest.approx(max(px * 24 / 3.35e12, px * 278 / 33.5e12))
