"""The flow's pyramid level (``ops/flow.py::pyramid_level``) on the CPU.

- The plain version (``pyramid_level_plain``, which CPU tensors take) bit
  for bit the flow's former expression (stack, cast, ``_sep_correlate``
  reflect, ``resize_hw`` linear) at the 540p and 1080p levels and at ragged
  small shapes, uint8 and f32.
- ``csrc/pyramid.cu``'s plan and index arithmetic, emulated in torch as the
  kernel does them (the strip's staged columns, the chunks of input rows
  in two buffers, the ring of horizontal sums and its slots, reflect-101
  at the edges, the sampled rows and columns from the weight tables, the
  rows a chunk finishes, the store offsets into (2, P, hk, wk)): the
  smoothing bit-equal to the plain version's at every sampled point, the
  level within 2 ulps of the plain level, at radii 1, 4, 9 and the largest.
- The wrapper's routing: CPU to the plain version; on the card (a meta
  tensor stands in, the library is spied) one launch of the plan's
  arguments, none for an empty input, and an error for a wrong type,
  layout or geometry or a radius past the kernel's largest; the flow calls
  it once a level.
"""

import numpy as np
import pytest
import torch

from relaxtpu_torch import _native
from relaxtpu_torch.ops import flow as flow_mod
from relaxtpu_torch.ops.flow import (
    PYR_RMAX, PYR_ROWS, PYR_SMEM, PYR_TWMAX, _cvround, _gaussian_kernel, _pyramid_axis, _pyramid_plan,
    _pyramid_taps_f32, _pyramid_tile, _sep_correlate, farneback_flow, pyramid_level, pyramid_level_plain,
    pyramid_levels,
)
from relaxtpu_torch.ops.resize import resize_hw
from portbench import spec

# the kernel's constants (csrc/pyramid.cu): threads a block, the most
# dynamic shared memory a block takes on the card
THREADS, SMEM_MAX = 256, 200 * 1024


@pytest.fixture(scope="module")
def one_thread():
    """torch on one thread for this file (set back after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def former_level(prev: torch.Tensor, nxt: torch.Tensor, ksize: int, sigma: float, hk: int, wk: int):
    """The flow's pyramid level before the kernel, kept as it was."""
    base2 = torch.stack([prev, nxt]).to(torch.float32)
    gk = _gaussian_kernel(ksize, sigma)
    im2 = _sep_correlate(base2, gk, gk, "reflect")
    return resize_hw(im2, (hk, wk), "linear", antialias=False)


def grey(seed: int, shape, dtype=torch.uint8) -> torch.Tensor:
    x = np.random.default_rng(seed).integers(0, 256, shape)
    return torch.from_numpy(x.astype(np.uint8 if dtype == torch.uint8 else np.float32))


def level_params(scale: float) -> tuple[int, float]:
    """(ksize, sigma) of a level, as ``farneback_flow`` makes them."""
    sigma = (1.0 / scale - 1.0) * 0.5
    return max(_cvround(sigma * 5) | 1, 3), sigma


@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
@pytest.mark.parametrize("h,w,p", [(540, 960, 1), (1080, 1920, 1), (70, 90, 2), (37, 41, 3), (33, 64, 1)])
def test_plain_is_the_former_expression(one_thread, h, w, p, dtype):
    prev, nxt = grey(h + w, (p, h, w), dtype), grey(h * w, (p, h, w), dtype)
    for scale, hk, wk in pyramid_levels(h, w):
        ksize, sigma = level_params(scale)
        want = former_level(prev, nxt, ksize, sigma, hk, wk)
        got = pyramid_level(prev, nxt, ksize, sigma, hk, wk)
        assert got.shape == (2, p, hk, wk) and got.dtype == torch.float32
        assert torch.equal(got, want)
        assert torch.equal(pyramid_level_plain(torch.stack([prev, nxt]).to(torch.float32),
                                               _gaussian_kernel(ksize, sigma), hk, wk), want)


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a b + c rounded once to f32 (the product is exact in f64)."""
    return (a.double() * b.double() + c.double()).float()


def emulate_kernel(prev, nxt, ksize, sigma, hk, wk, slots):
    """``pyramid_level_kernel`` on the plan for ``slots`` resident blocks,
    its index arithmetic carried out in torch as the kernel does it, every
    image at once: per block (strip of tw output columns, run of seg output
    rows) the staged columns xa .. x1 (xa aligned down to 16 bytes, within
    ``span``), chunks of 32 input rows in buffer c % 2, the horizontal sums
    of each (row, sampled column) item into ring slot (slot0 + i) % ring,
    the rows a chunk finishes (last vertical tap, min(H - 1, i1 + R), at
    most the chunk's last row), their vertical sums read from ring slot
    slot0 - qc + q brought into the ring by one correction, inside the
    image 2R + 1 consecutive kept slots from the first (the ring's first 2R
    slots mirrored after its end; each read checked to hold row q), the
    rows then
    columns combination and the store at z hk wk + y wk + x.  Returns the
    level (NaN where nothing was stored; each output stored once) and the
    vertical sums formed, by (image, row, column)."""
    p, h, w = prev.shape
    elem = prev.element_size()
    ve = 16 // elem
    r = ksize // 2
    taps = [float(v) for v in _pyramid_taps_f32(ksize, sigma)[:ksize]]
    rows, cols = _pyramid_axis(h, hk), _pyramid_axis(w, wk)
    wr, wc = rows[:, 2:].view(np.float32), cols[:, 2:].view(np.float32)
    tw, seg, span, planes = _pyramid_plan(2 * p, h, w, hk, wk, r, elem, slots)
    ring = PYR_ROWS + 2 * r + 1
    img = torch.cat([prev, nxt]).to(torch.float32)  # z < P: prev, else next
    n_img = 2 * p
    out = torch.full((n_img * hk * wk,), float("nan"))
    written = torch.zeros(n_img * hk * wk, dtype=torch.int32)
    sums = {}

    def refl(x, n):  # BORDER_REFLECT_101
        return -x if x < 0 else (2 * n - 2 - x if x >= n else x)

    for x0 in range(0, wk, tw):
        ncols = min(tw, wk - x0)
        xa = max(0, int(cols[x0, 0]) - r) & ~(ve - 1)
        x1 = min(w - 1, int(cols[x0 + ncols - 1, 1]) + r)
        assert x1 - xa + 1 <= span and span % ve == 0
        for oys in range(0, hk, seg):
            oye = min(oys + seg, hk)
            q0 = max(0, int(rows[oys, 0]) - r)
            q1 = min(h - 1, int(rows[oye - 1, 1]) + r)
            chunks = (q1 - q0) // PYR_ROWS + 1
            bufs = [torch.full((n_img, PYR_ROWS, span), float("nan")) for _ in range(2)]
            tags = [[None] * PYR_ROWS for _ in range(2)]  # the image row each buffer row holds
            kept = ring + 2 * r  # the ring's first 2r slots mirrored after its end
            hs = torch.full((n_img, kept, planes, tw), float("nan"))
            held = [None] * kept  # the image row each kept slot holds

            def stage(b, q, nr):
                bufs[b][:, :nr, : x1 - xa + 1] = img[:, q : q + nr, xa : x1 + 1]
                for i in range(nr):
                    tags[b][i] = q + i

            stage(0, q0, min(PYR_ROWS, q1 - q0 + 1))
            done, slot0 = oys, 0
            for c in range(chunks):
                qc = q0 + c * PYR_ROWS
                nr = min(PYR_ROWS, q1 - qc + 1)
                if c + 1 < chunks:
                    stage((c + 1) & 1, qc + PYR_ROWS, min(PYR_ROWS, q1 - qc - PYR_ROWS + 1))
                buf, tag = bufs[c & 1], tags[c & 1]
                for i in range(nr):
                    assert tag[i] == qc + i
                # horizontal pass: items (i, p, t); a plane-1 column with one weight is skipped
                for pl in range(planes):
                    cx = torch.from_numpy(cols[x0 : x0 + ncols, pl].astype(np.int64))
                    idx = (cx[:, None] - r + torch.arange(ksize)).apply_(lambda x: refl(x, w)) - xa
                    assert int(idx.min()) >= 0 and int(idx.max()) <= x1 - xa
                    g = buf[:, :nr][:, :, idx]  # (images, nr, ncols, ksize)
                    s = torch.zeros(n_img, nr, ncols)
                    for j in range(ksize):
                        s = s + taps[j] * g[..., j]
                    keep = torch.ones(ncols, dtype=torch.bool) if pl == 0 else torch.from_numpy(wc[x0 : x0 + ncols, 1] != 0)
                    for i in range(nr):
                        sl = slot0 + i - (ring if slot0 + i >= ring else 0)
                        for at in (sl, sl + ring) if sl < 2 * r else (sl,):
                            hs[:, at, pl, :ncols][:, keep] = s[:, i][:, keep]
                for i in range(nr):
                    sl = slot0 + i - (ring if slot0 + i >= ring else 0)
                    held[sl] = qc + i
                    if sl < 2 * r:
                        held[sl + ring] = qc + i
                # the rows this chunk finishes: a prefix, as the ballot counts it
                qe = qc + nr - 1
                n = 0
                while done + n < oye and min(h - 1, int(rows[done + n, 1]) + r) <= qe:
                    n += 1
                for y in range(done, done + n):
                    r0, r1 = int(rows[y, 0]), int(rows[y, 1])
                    w0, w1 = torch.tensor(wr[y, 0]), torch.tensor(wr[y, 1])

                    def slot_of(q):  # one correction brings it into the ring
                        sl = slot0 - qc + q
                        assert -ring <= sl < 2 * ring
                        return sl + (ring if sl < 0 else (-ring if sl >= ring else 0))

                    def vsum(rr, pl):
                        s = torch.zeros(n_img, ncols)
                        inside = rr - r >= 0 and rr + r < h
                        first = slot_of(rr - r)
                        for j in range(ksize):
                            q = refl(rr - r + j, h)
                            sl = first + j if inside else slot_of(q)  # inside: consecutive kept slots
                            assert held[sl] == q, (held[sl], q)
                            s = s + taps[j] * hs[:, sl, pl, :ncols]
                        return s

                    v = []
                    for pl in range(2):
                        if pl >= planes:
                            v.append(None)
                            continue
                        s0 = vsum(r0, pl)
                        ci = cols[x0 : x0 + ncols, pl]
                        for z in range(n_img):
                            for t in range(ncols):
                                if pl == 0 or wc[x0 + t, 1] != 0:
                                    sums[(z, r0, int(ci[t]))] = s0[z, t]
                        acc = w0 * s0
                        if w1 != 0:
                            s1 = vsum(r1, pl)
                            for z in range(n_img):
                                for t in range(ncols):
                                    if pl == 0 or wc[x0 + t, 1] != 0:
                                        sums[(z, r1, int(ci[t]))] = s1[z, t]
                            acc = fma32(w1.expand_as(s1), s1, acc)
                        v.append(acc)
                    c0 = torch.from_numpy(wc[x0 : x0 + ncols, 0].copy())
                    c1 = torch.from_numpy(wc[x0 : x0 + ncols, 1].copy())
                    o = c0 * v[0]
                    if planes == 2:
                        o = torch.where(c1 != 0, fma32(c1.expand_as(v[1]), torch.nan_to_num(v[1]), o), o)
                    at = (torch.arange(n_img)[:, None] * hk * wk + y * wk + x0 + torch.arange(ncols)).flatten()
                    out[at] = o.flatten()
                    written[at] += 1
                done += n
                slot0 += nr
                slot0 -= ring if slot0 >= ring else 0
            assert done == oye
    assert int(written.min()) == 1 and int(written.max()) == 1
    return out.view(2, p, hk, wk), sums


def ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest |got - want| in units of the last place of want (f32)."""
    spacing = np.spacing(np.abs(want.numpy()).astype(np.float32))
    return float((np.abs(got.numpy().astype(np.float64) - want.numpy()) / spacing).max())


CASES = [
    # (P, H, W, hk, wk, ksize, sigma, dtype): radius 1 unchanged and halved, 4 and 9 at the 540p levels'
    # scales (540 rows to 68: taps that are not 0.5 / 0.5), ragged widths (not 16-byte rows), the largest radius
    (1, 40, 70, 40, 70, 3, 0.0, torch.uint8),
    (2, 45, 67, 22, 34, 3, 0.5, torch.float32),
    (1, 270, 96, 68, 24, 9, 1.5, torch.uint8),
    (1, 540, 48, 68, 6, 19, 3.5, torch.uint8),
    (1, 135, 77, 17, 10, 19, 3.5, torch.float32),
    (1, 33, 160, 33, 160, 3, 0.0, torch.float32),
    (1, 170, 181, 3, 3, 2 * PYR_RMAX + 1, 31.5, torch.uint8),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}x{c[1]}x{c[2]}-{c[3]}x{c[4]}-k{c[5]}-{c[7]}")
@pytest.mark.parametrize("slots", [1, 528])
def test_kernel_plan_and_index_arithmetic_match_the_plain_version(one_thread, case, slots):
    """The kernel's plan and index arithmetic, emulated (the CPU cannot run
    the kernel): every vertical sum it forms is the plain smoothing's value
    at that point to the bit, the level is within 2 ulps of the plain
    level, every output is stored once, and the plan fits a block."""
    p, h, w, hk, wk, ksize, sigma, dtype = case
    prev, nxt = grey(h * 7 + w, (p, h, w), dtype), grey(h + w * 5, (p, h, w), dtype)
    base2 = torch.stack([prev, nxt]).to(torch.float32)
    gk = _gaussian_kernel(ksize, sigma)
    smooth = _sep_correlate(base2, gk, gk, "reflect").reshape(2 * p, h, w)
    want = pyramid_level_plain(base2, gk, hk, wk)
    got, sums = emulate_kernel(prev, nxt, ksize, sigma, hk, wk, slots)
    assert sums
    for (z, y, x), v in sums.items():
        assert torch.equal(v, smooth[z, y, x]), (z, y, x, float(v), float(smooth[z, y, x]))
    if hk == h and wk == w:
        assert torch.equal(got, want)
    assert ulps(got, want) <= 2
    tw, span, planes, smem = _pyramid_tile(h, w, hk, wk, ksize // 2, prev.element_size())
    assert smem <= SMEM_MAX and (smem <= PYR_SMEM or tw == 4)
    assert smem == 2 * PYR_ROWS * span * prev.element_size() + (PYR_ROWS + 2 * ksize - 1) * planes * tw * 4
    assert tw >= 4 and tw & (tw - 1) == 0


def test_plan_at_the_main_path_levels():
    """The plan at the 540p and 1080p levels (uint8 grey, 16 pairs): strips
    of 128, 128, 64 and 32 output columns from the finest level down (input
    strips of at most 256 bytes), one column plane where the width does not
    change, every staged row a multiple of 16 bytes, shared memory within
    ``PYR_SMEM``, runs that spread a level over more blocks than the card
    holds at once."""
    for h, w in ((540, 960), (1080, 1920)):
        tws = []
        for scale, hk, wk in pyramid_levels(h, w):
            ksize, _ = level_params(scale)
            tw, span, planes, smem = _pyramid_tile(h, w, hk, wk, ksize // 2, 1)
            tws.append(tw)
            assert planes == (1 if wk == w else 2) and span % 16 == 0 and smem <= PYR_SMEM
            _, seg, _, _ = _pyramid_plan(32, h, w, hk, wk, ksize // 2, 1, 528)
            assert 32 * -(-wk // tw) * -(-hk // seg) >= 528
        assert tws == [32, 64, 128, 128]
    assert PYR_TWMAX == 128


def test_axis_tables_hold_the_weight_matrix():
    """The tables name each output's non-zero weights of ``weight_matrix``,
    the same f32 numbers, ascending and adjacent (540 rows to 68: taps that
    are not 0.5 / 0.5); an unchanged axis is (i, i, 1, 0)."""
    from relaxtpu_torch.ops.resize import weight_matrix

    for n_in, n_out in ((540, 68), (960, 120), (540, 270), (45, 22), (1080, 135)):
        tab = _pyramid_axis(n_in, n_out)
        m = weight_matrix(n_in, n_out, "linear", False)
        rebuilt = np.zeros_like(m)
        wts = tab[:, 2:].view(np.float32)
        for o, (i0, i1) in enumerate(tab[:, :2]):
            rebuilt[o, i0] += wts[o, 0]
            rebuilt[o, i1] += wts[o, 1]
        assert np.array_equal(rebuilt, m)
        assert (tab[:, 1] - tab[:, 0] <= 1).all() and (np.diff(tab[:, 1]) >= 0).all()
    assert not np.array_equal(_pyramid_axis(540, 68)[:, 2:].view(np.float32), np.full((68, 2), 0.5, np.float32))
    same = _pyramid_axis(7, 7)
    assert np.array_equal(same[:, 0], np.arange(7)) and np.array_equal(same[:, 1], np.arange(7))
    assert (same[:, 2:].view(np.float32) == np.float32([1.0, 0.0])).all()


def test_taps_are_rounded_once_and_cached():
    taps = _pyramid_taps_f32(19, 3.5)
    assert taps.dtype == np.float32 and taps.shape == (2 * PYR_RMAX + 1,)
    assert _pyramid_taps_f32(19, 3.5) is taps
    assert np.array_equal(taps[:19], _gaussian_kernel(19, 3.5).astype(np.float32)) and not taps[19:].any()


@pytest.fixture
def spy(monkeypatch):
    """The kernel library spied on: launches and queries recorded, the
    device check passed and the tables kept where they are (a meta tensor
    stands in for a CUDA one)."""
    calls = []
    monkeypatch.setattr(_native, "launch", lambda name, device, *a: calls.append((name, a)))
    monkeypatch.setattr(_native, "query", lambda name, device, *a: 528)
    monkeypatch.setattr(_native, "check_cuda_input", lambda *a: None)
    monkeypatch.setattr(flow_mod, "upload", lambda t, device: t.to(device))
    monkeypatch.setattr(flow_mod, "_pyr_slots", {})
    flow_mod._pyramid_tables.cache_clear()
    yield calls
    flow_mod._pyramid_tables.cache_clear()


def test_cpu_takes_the_plain_version(spy):
    before = pyramid_level.launches
    prev, nxt = grey(0, (2, 40, 50)), grey(1, (2, 40, 50))
    want = pyramid_level_plain(torch.stack([prev, nxt]).to(torch.float32), _gaussian_kernel(9, 1.5), 10, 12)
    assert torch.equal(pyramid_level(prev, nxt, 9, 1.5, 10, 12), want)
    assert pyramid_level.launches == before and not spy


@pytest.mark.parametrize("dtype,elem", [(torch.uint8, 1), (torch.float32, 4)])
def test_a_device_tensor_makes_one_launch_of_the_plan(spy, monkeypatch, dtype, elem):
    """One launch of the plan's arguments, counted on ``pyramid_level``
    also while its module-global name is rebound to a wrapper, as the
    benchmark's ranges and the smoke run's recorder rebind it."""
    before = pyramid_level.launches
    prev, nxt = (torch.empty((16, 540, 960), dtype=dtype, device="meta") for _ in range(2))
    out = pyramid_level(prev, nxt, 19, 3.5, 68, 120)
    assert out.shape == (2, 16, 68, 120) and out.dtype == torch.float32 and out.device.type == "meta"
    tw, seg, span, planes = _pyramid_plan(32, 540, 960, 68, 120, 9, elem, 528)
    assert spy == [("relax_pyramid_level", (0, 0, 0, 0, 16, 540, 960, 68, 120, 9, elem,
                                            _pyramid_taps_f32(19, 3.5).ctypes.data, tw, seg, span, planes))]
    assert pyramid_level.launches == before + 1
    monkeypatch.setattr(flow_mod, "pyramid_level", lambda *a: pyramid_level(*a))
    flow_mod.pyramid_level(prev, nxt, 3, 0.0, 540, 960)
    assert pyramid_level.launches == before + 2 and len(spy) == 2


def test_an_empty_input_makes_no_launch(spy):
    before = pyramid_level.launches
    for p, hk, wk in ((0, 68, 120), (3, 0, 5), (2, 4, 0)):
        e = torch.empty((p, 540, 960), dtype=torch.uint8, device="meta")
        assert pyramid_level(e, e, 19, 3.5, hk, wk).shape == (2, p, hk, wk)
    assert pyramid_level.launches == before and not spy


@pytest.mark.parametrize("bad", ["float64", "int16", "strided", "two-dim", "mixed", "shapes"])
def test_a_wrong_type_or_layout_raises_before_any_launch(spy, bad):
    ok = torch.empty((2, 64, 64), dtype=torch.uint8, device="meta")
    prev = {"float64": torch.empty((2, 64, 64), dtype=torch.float64, device="meta"),
            "int16": torch.empty((2, 64, 64), dtype=torch.int16, device="meta"),
            "strided": torch.empty((2, 64, 128), dtype=torch.uint8, device="meta")[..., ::2],
            "two-dim": torch.empty((64, 64), dtype=torch.uint8, device="meta"),
            "mixed": torch.empty((2, 64, 64), dtype=torch.float32, device="meta"),
            "shapes": torch.empty((3, 64, 64), dtype=torch.uint8, device="meta")}[bad]
    before = pyramid_level.launches
    with pytest.raises(ValueError, match="contiguous uint8 or float32|differ"):
        pyramid_level(prev, ok, 3, 0.5, 32, 32)
    assert pyramid_level.launches == before and not spy


def test_the_radius_and_geometry_limits(spy):
    """Radii past the kernel's largest, even sizes, images not above the
    radius and levels larger than the image are refused on the card with
    the limit named; the plain version takes the radius on the CPU."""
    img = torch.empty((1, 400, 400), dtype=torch.uint8, device="meta")
    for ksize in (2 * PYR_RMAX + 3, 1, 4):
        with pytest.raises(ValueError, match=f"odd sizes 3 to {2 * PYR_RMAX + 1}"):
            pyramid_level(img, img, ksize, 40.0, 3, 3)
    small = torch.empty((1, 9, 40), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="above the radius"):
        pyramid_level(small, small, 19, 3.5, 2, 5)
    with pytest.raises(ValueError, match="only shrinks"):
        pyramid_level(img, img, 3, 0.5, 401, 200)
    pyramid_level(img, img, 2 * PYR_RMAX + 1, 31.5, 6, 6)
    assert len(spy) == 1
    cpu = grey(2, (1, 200, 200))
    k = 2 * PYR_RMAX + 3
    assert torch.equal(pyramid_level(cpu, cpu, k, 33.0, 3, 3), former_level(cpu, cpu, k, 33.0, 3, 3))


def test_the_flow_calls_the_level_once_a_level(monkeypatch):
    """``farneback_flow`` looks the level up by its module-global name (the
    benchmark wraps it there): one call a pyramid level at 540p, 4 in all,
    over both grey stacks as they are, with each level's Gaussian and size.
    The stages after the level are stubbed: their kernels have tests of
    their own."""
    seen = []

    def level(prev, nxt, ksize, sigma, hk, wk):
        seen.append((prev.data_ptr(), nxt.data_ptr(), prev.dtype, ksize, sigma, hk, wk))
        return torch.zeros((2, prev.shape[0], hk, wk))

    monkeypatch.setattr(flow_mod, "pyramid_level", level)
    monkeypatch.setattr(flow_mod, "poly_expansion", lambda im, n, s: torch.zeros((*im.shape[:-2], 5, *im.shape[-2:])))
    monkeypatch.setattr(flow_mod, "update_matrices", lambda r0, r1, f: f)
    monkeypatch.setattr(flow_mod, "box_blur_solve", lambda m, ws: m)
    prev, nxt = grey(3, (2, 540, 960)), grey(4, (2, 540, 960))
    flow = farneback_flow(prev, nxt)
    assert flow.shape == (2, 540, 960, 2)
    assert seen == [(prev.data_ptr(), nxt.data_ptr(), torch.uint8, *level_params(scale), hk, wk)
                    for scale, hk, wk in pyramid_levels(540, 960)]
    assert [s[3:] for s in seen] == [(19, 3.5, 68, 120), (9, 1.5, 135, 240), (3, 0.5, 270, 480), (3, 0.0, 540, 960)]


def test_roofline_metric_counts_the_kernels_work():
    """``pyramid_roofline``'s bound at the 540p levels with 16 pairs: the
    grey images read once (1 byte a pixel) and the level written (4 bytes),
    or the rounded products and adds of the smoothing at the sampled
    points (horizontal at every row of the sampled columns, vertical at
    the sampled rows: 2 k - 1 each, k taps) at the add rate."""
    metric = spec.metric_module("pyramid_roofline")
    assert metric.CALLS == ("relaxtpu_torch.ops.flow", "pyramid_level")
    assert metric.KERNEL == "pyramid_level_kernel"
    prev = torch.empty((16, 540, 960), dtype=torch.uint8)
    # (ksize, hk, wk, sampled rows, sampled columns): 68 rows of 540 sample 132 rows (4 of them fall
    # on one row), 120 of 960 240 columns; 135 of 540 270 rows, 240 of 960 480 columns; 270 and 480
    # every row and column
    for ksize, hk, wk, rows, cols in ((19, 68, 120, 132, 240), (9, 135, 240, 270, 480),
                                      (3, 270, 480, 540, 960), (3, 540, 960, 540, 960)):
        nbytes = 32 * (540 * 960 + 4 * hk * wk)
        ops = 32 * (540 * cols + rows * cols) * (2 * ksize - 1)
        want = max(nbytes / 3.35e12, ops / 33.5e12)
        assert metric.bound_s(prev, prev, ksize, 1.0, hk, wk) == pytest.approx(want)
    f32 = torch.empty((16, 540, 960), dtype=torch.float32)
    assert metric.bound_s(f32, f32, 3, 0.0, 540, 960) == pytest.approx(
        max(32 * 540 * 960 * 8 / 3.35e12, 32 * 540 * 960 * 2 * 5 / 33.5e12))
