"""Farneback dense optical flow over a batch of pairs.

Counterpart of ``relaxtpu/ops/flow.py:44-409`` with OpenCV's parameter
conventions: a coarse-to-fine pyramid (each level blurs the base image with
sigma = (1/scale - 1)/2 and resizes it, linear without antialias;
``pyramid_level``: one launch of ``csrc/pyramid.cu`` a level on the card), a
quadratic polynomial expansion from six separable Gaussian moment
correlations (replicate border; ``poly_expansion``: one launch of
``csrc/polyexp.cu`` a level on the card), and per level ``iterations``
rounds of the matrix update (K1, ``ops.warp``) and the box-blur solve (K2,
``ops.boxsolve``).

``vmap`` over pairs becomes the leading axis: gray images (P, H, W) in,
flow (P, H, W, 2) out; planes are (P, C, H, W) inside.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from relaxtpu_torch import _native
from relaxtpu_torch.device import upload
from relaxtpu_torch.ops.boxsolve import box_blur_solve
from relaxtpu_torch.ops.resize import resize_hw, weight_matrix
from relaxtpu_torch.ops.warp import update_matrices

_MIN_SIZE = 32  # OpenCV's minimum pyramid level size
POLY_NMAX = 60  # the expansion kernel's largest radius: its 128 staged columns hold a strip of 8 and the halo
POLY_ROWS = 16  # the expansion kernel's output rows a step
POLY_SPAN = 128  # its staged columns a ring row: the strip plus n rounded up to 4 each side
_POLY_TAPS = 2 * POLY_NMAX + 1  # the taps of each 1-D kernel in the kernel's arguments
_POLY = "relax_poly_expansion"
_poly_args: dict = {}  # (n, sigma) -> the kernel's f32 coefficients, on the host
_poly_slots: dict = {}  # (device index, n) -> the kernel's resident blocks
PYR_RMAX = 79  # the pyramid kernel's largest radius: levels 6, the coarsest level of a 4K frame
PYR_ROWS = 32  # the pyramid kernel's input rows a chunk
PYR_TWMAX = 128  # its widest strip of output columns
PYR_SMEM = 64 * 1024  # the plan's most shared memory a block, so that three blocks share an SM
_PYR_TAPS = 2 * PYR_RMAX + 1  # the taps in the kernel's arguments
_PYR = "relax_pyramid_level"
_pyr_args: dict = {}  # (ksize, sigma) -> the kernel's f32 taps, on the host
_pyr_slots: dict = {}  # (device index, elem, radius, shared bytes) -> the kernel's resident blocks


def _cvround(x: float) -> int:
    """Round half to even, like cvRound."""
    return int(np.rint(x))


def _gaussian_kernel(ksize: int, sigma: float) -> np.ndarray:
    """cv2.getGaussianKernel semantics, including the sigma<=0 fixed tables."""
    small_tab = {
        1: [1.0],
        3: [0.25, 0.5, 0.25],
        5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
        7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125],
    }
    if sigma <= 0:
        if ksize in small_tab:
            return np.asarray(small_tab[ksize], np.float64)
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    c = (ksize - 1) * 0.5
    x = np.arange(ksize, dtype=np.float64) - c
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return k / k.sum()


def _sep_correlate(img: torch.Tensor, kx, ky, mode: str) -> torch.Tensor:
    """Separable 2-D correlation of (..., H, W) with 1-D kernels as shifted
    multiply-adds over a padded copy.  mode: 'edge' (BORDER_REPLICATE) or
    'reflect' (BORDER_REFLECT_101, which is torch's 'reflect')."""
    ry = len(ky) // 2
    rx = len(kx) // 2
    h, w = img.shape[-2:]
    lead = img.shape[:-2]
    x = F.pad(img.reshape(-1, 1, h, w), (rx, rx, ry, ry),
              mode="replicate" if mode == "edge" else "reflect")
    x = x.reshape(*lead, h + 2 * ry, w + 2 * rx)
    if len(kx) > 1:
        x = sum(float(kx[i]) * x[..., :, i : i + w] for i in range(len(kx)))
    else:
        x = float(kx[0]) * x
    if len(ky) > 1:
        x = sum(float(ky[j]) * x[..., j : j + h, :] for j in range(len(ky)))
    else:
        x = float(ky[0]) * x
    return x


def _poly_exp_coeffs(n: int, sigma: float):
    """1-D Gaussian moment kernels and inverse-Gram coefficients."""
    x = np.arange(-n, n + 1, dtype=np.float64)
    g = np.exp(-(x * x) / (2.0 * sigma * sigma))
    g /= g.sum()
    xg = x * g
    xxg = x * x * g
    s0 = g.sum()
    s2 = (x * x * g).sum()
    s4 = (x**4 * g).sum()
    G = np.zeros((6, 6))
    G[0, 0] = s0 * s0
    G[1, 1] = G[2, 2] = s2 * s0
    G[3, 3] = G[4, 4] = s4 * s0
    G[5, 5] = s2 * s2
    G[0, 3] = G[3, 0] = G[0, 4] = G[4, 0] = s2 * s0
    G[3, 4] = G[4, 3] = s2 * s2
    invG = np.linalg.inv(G)
    return g, xg, xxg, invG[1, 1], invG[0, 3], invG[3, 3], invG[5, 5]


def poly_expansion_plain(img: torch.Tensor, n: int, sigma: float) -> torch.Tensor:
    """(..., H, W) -> (..., 5, H, W) planes [c_y, c_x, c_yy, c_xx, c_xy]:
    plain PyTorch, 9 separable correlations and 10 combinations."""
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


@functools.lru_cache(maxsize=256)
def _poly_plan(images: int, h: int, w: int, n: int, slots: int, th: int = POLY_ROWS,
               span: int = POLY_SPAN) -> tuple[int, int, int]:
    """(tw, seg, rows) of the expansion kernel for ``images`` images of H x W
    at radius n, with ``slots`` blocks resident on the card: a block takes a
    strip of ``tw`` output columns (a multiple of 8, so that a strip's rows
    of the five planes start on 32-byte sectors, at most ``span`` - 2 n4, as
    narrow as the fewest strips allow) and a run of ``seg`` rows (whole steps
    of ``th``); its ring holds ``rows`` input rows.  A block's time goes with
    the rows it loads (seg + 2n) and the level's with the busiest slot's:
    its share of the grid's rows and one block's more (the last to finish),
    so the run minimises (blocks / slots + 1) (seg + 2n).  Short runs spread
    a small level over the card; at the large levels runs of 2 to 6 steps
    measured within 4% of each other on the card (``PERF.md``)."""
    n4 = (n + 3) & ~3
    strips = -(-w // (span - 2 * n4))
    tw = 8 * -(-w // (8 * strips))
    steps = -(-h // th)
    best = None
    for run in range(1, steps + 1):
        blocks = images * -(-w // tw) * -(-steps // run)
        cost = (blocks + slots) * (th * run + 2 * n)
        if best is None or cost < best[0]:
            best = (cost, run)
    return tw, th * best[1], (th + 2 * n + 3) & ~3


def _poly_coeffs_f32(n: int, sigma: float) -> np.ndarray:
    """The kernel's coefficients, made once per (n, sigma): g, x g and x^2 g
    in rows of ``_POLY_TAPS`` (taps 0 .. 2n), then ig11, ig03, ig33, ig55,
    each rounded to f32 as the plain version's products round them."""
    key = (n, sigma)
    if key not in _poly_args:
        g, xg, xxg, ig11, ig03, ig33, ig55 = _poly_exp_coeffs(n, sigma)
        args = np.zeros(3 * _POLY_TAPS + 4, np.float32)
        for k, taps in enumerate((g, xg, xxg)):
            args[k * _POLY_TAPS : k * _POLY_TAPS + 2 * n + 1] = taps
        args[3 * _POLY_TAPS :] = (ig11, ig03, ig33, ig55)
        _poly_args[key] = args
    return _poly_args[key]


def _poly_resident(device: torch.device, n: int) -> int:
    """The kernel's resident blocks on ``device`` at radius n (SMs x blocks
    an SM), asked of the library once."""
    key = (device.index, n)
    if key not in _poly_slots:
        slots = _native.query("relax_poly_expansion_slots", device, n)
        if slots <= 0:
            raise RuntimeError(f"relax_poly_expansion_slots: CUDA error {-slots}")
        _poly_slots[key] = slots
    return _poly_slots[key]


def poly_expansion(img: torch.Tensor, n: int, sigma: float) -> torch.Tensor:
    """(..., H, W) f32 -> (..., 5, H, W) planes [c_y, c_x, c_yy, c_xx, c_xy].

    CUDA tensors launch ``csrc/polyexp.cu`` once over every image (radius n
    up to ``POLY_NMAX``; ``launches`` counts the launches), bit for bit the
    plain version; an input with no pixels returns an empty result without
    one.  CPU tensors take the plain version.
    """
    if img.device.type == "cpu":
        return poly_expansion_plain(img, n, sigma)
    if not 1 <= n <= POLY_NMAX:
        raise ValueError(f"poly_n {n}: the expansion kernel takes radii 1 to {POLY_NMAX} (its 128 staged "
                         f"columns hold a strip of 8 and the 2 x {POLY_NMAX} halo)")
    if img.dim() < 2 or img.dtype != torch.float32 or not img.is_contiguous():
        raise ValueError(f"img must be a contiguous float32 (..., H, W) tensor, got {img.dtype} "
                         f"{tuple(img.shape)}{'' if img.is_contiguous() else ', not contiguous'}")
    h, w = img.shape[-2:]
    out = img.new_empty((*img.shape[:-2], 5, h, w))
    if out.numel() == 0:
        return out
    _native.check_cuda_input(img, "img", torch.float32, img.dim())
    images = img.numel() // (h * w)
    tw, seg, _ = _poly_plan(images, h, w, n, _poly_resident(img.device, n))
    _native.launch(_POLY, img.device, img.data_ptr(), out.data_ptr(), images, h, w, n,
                   _poly_coeffs_f32(n, sigma).ctypes.data, tw, seg)
    _expansion.launches += 1
    return out


# the counter's owner: ``farneback_flow`` calls the expansion by its module-global
# name, which a caller may rebind to a wrapper (the benchmark's ranges do)
_expansion = poly_expansion
poly_expansion.launches = 0


def pyramid_level_plain(base2: torch.Tensor, gk: np.ndarray, hk: int, wk: int) -> torch.Tensor:
    """(..., H, W) f32 -> (..., hk, wk): the Gaussian ``gk`` (reflect-101
    border, horizontal then vertical) and the resize, linear without
    antialias; plain PyTorch."""
    return resize_hw(_sep_correlate(base2, gk, gk, "reflect"), (hk, wk), "linear", antialias=False)


@functools.lru_cache(maxsize=64)
def _pyramid_axis(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, 4) int32 of the kernel's table of one axis: an output index's
    first and last input index with a non-zero weight of ``weight_matrix``
    (linear, no antialias) and the bits of their f32 weights (the second 0
    where there is one); where the size does not change, (i, i, 1, 0)."""
    tab = np.zeros((n_out, 4), np.int32)
    if n_in == n_out:
        tab[:, 0] = tab[:, 1] = np.arange(n_out)
        tab[:, 2] = np.float32(1.0).view(np.int32)
        return tab
    m = weight_matrix(n_in, n_out, "linear", False)
    nz = m != 0
    first, last = nz.argmax(axis=1), n_in - 1 - nz[:, ::-1].argmax(axis=1)
    if not (nz.any(axis=1).all() and (last - first <= 1).all() and (nz.sum(axis=1) == last - first + 1).all()):
        raise ValueError(f"resize {n_in} -> {n_out}: not one or two adjacent weights an output")
    rows = np.arange(n_out)
    tab[:, 0], tab[:, 1] = first, last
    tab[:, 2] = m[rows, first].view(np.int32)
    tab[:, 3] = np.where(last > first, m[rows, last], np.float32(0.0)).astype(np.float32).view(np.int32)
    return tab


@functools.lru_cache(maxsize=256)
def _pyramid_tile(h: int, w: int, hk: int, wk: int, r: int, elem: int) -> tuple[int, int, int, int]:
    """(tw, span, planes, smem) of the pyramid kernel at radius r for
    ``elem``-byte images: strips of tw output columns, a power of two from
    4 to 128 whose input columns are at most 256 bytes wide for uint8 and
    512 for f32, narrower while the block's shared memory passes
    ``PYR_SMEM`` (4 if none fits); ``span``, the staged columns a row
    (every strip's input columns, aligned down to 16 bytes, rounded up to 16
    bytes); ``planes``, the column planes of the horizontal sums (1 where
    the width does not change); ``smem``, the block's dynamic shared memory:
    two buffers of 32 input rows and the ring of 32 + 2r + 1 rows of
    horizontal sums with its first 2r mirrored after its end."""
    cols = _pyramid_axis(w, wk)
    ve = 16 // elem
    planes = 1 if wk == w else 2
    tw = PYR_TWMAX
    while tw > 4 and -(-w // wk) * tw * elem > (256 if elem == 1 else 512):
        tw //= 2
    while True:
        x0 = np.arange(0, wk, tw)
        last = np.minimum(x0 + tw, wk) - 1
        xa = np.maximum(cols[x0, 0] - r, 0) // ve * ve
        x1 = np.minimum(cols[last, 1] + r, w - 1)
        span = int(-(-(x1 - xa + 1).max() // ve) * ve)
        smem = 2 * PYR_ROWS * span * elem + (PYR_ROWS + 4 * r + 1) * planes * tw * 4
        if smem <= PYR_SMEM or tw == 4:
            return tw, span, planes, smem
        tw //= 2


@functools.lru_cache(maxsize=256)
def _pyramid_plan(images: int, h: int, w: int, hk: int, wk: int, r: int, elem: int,
                  slots: int) -> tuple[int, int, int, int]:
    """(tw, seg, span, planes) of the pyramid kernel for ``images`` images
    of H x W at radius r with ``slots`` blocks resident on the card: the
    tile of ``_pyramid_tile`` and runs of ``seg`` output rows a block.  A
    block's time goes with the bytes it stages (its input rows, about
    seg H / hk + 2r + 1, of ``span`` columns) and writes, and the level's
    with the busiest slot's: its share of the grid and one block more (the
    last to finish), so the run minimises (blocks / slots + 1) x a block's
    bytes."""
    tw, span, planes, _ = _pyramid_tile(h, w, hk, wk, r, elem)
    strips = -(-wk // tw)
    best = None
    for seg in sorted({-(-hk // runs) for runs in range(1, hk + 1)}):
        blocks = images * strips * -(-hk // seg)
        cost = (blocks / slots + 1) * ((seg * h / hk + 2 * r + 1) * span * elem + seg * tw * 4)
        if best is None or cost < best[0]:
            best = (cost, seg)
    return tw, best[1], span, planes


def _pyramid_taps_f32(ksize: int, sigma: float) -> np.ndarray:
    """The kernel's taps, made once per (ksize, sigma): ``_gaussian_kernel``
    rounded to f32 (as the plain version's products round it) in a row of
    ``_PYR_TAPS``."""
    key = (ksize, sigma)
    if key not in _pyr_args:
        taps = np.zeros(_PYR_TAPS, np.float32)
        taps[:ksize] = _gaussian_kernel(ksize, sigma)
        _pyr_args[key] = taps
    return _pyr_args[key]


@functools.lru_cache(maxsize=256)
def _pyramid_tables(h: int, w: int, hk: int, wk: int, device: torch.device) -> torch.Tensor:
    """The row then column tables of a level on ``device``, built and
    copied once, without blocking."""
    return upload(torch.from_numpy(np.concatenate([_pyramid_axis(h, hk), _pyramid_axis(w, wk)])), device)


def _pyramid_resident(device: torch.device, elem: int, r: int, smem: int) -> int:
    """The kernel's resident blocks on ``device`` (SMs x blocks an SM) for
    ``elem``-byte images at radius r with ``smem`` bytes of shared memory,
    asked of the library once."""
    key = (device.index, elem, r, smem)
    if key not in _pyr_slots:
        slots = _native.query("relax_pyramid_level_slots", device, elem, r, smem)
        if slots <= 0:
            raise RuntimeError(f"relax_pyramid_level_slots: CUDA error {-slots}")
        _pyr_slots[key] = slots
    return _pyr_slots[key]


def pyramid_level(prev_gray: torch.Tensor, next_gray: torch.Tensor, ksize: int, sigma: float, hk: int,
                  wk: int) -> torch.Tensor:
    """(P, H, W) prev and next grey images (uint8 or f32) -> (2, P, hk, wk)
    f32: both stacks smoothed by the ``ksize`` Gaussian of ``sigma``
    (reflect-101) and resized, linear without antialias.

    CUDA tensors launch ``csrc/pyramid.cu`` once over both stacks, reading
    them where they lie (radius ksize // 2 up to ``PYR_RMAX``, below H and
    W; H and W at least hk and wk; ``launches`` counts the launches): the
    smoothing bit for bit the plain version's, the level within 2 ulps of
    it; an input with no pixels returns an empty result without one.  CPU
    tensors take the plain version on the stacked images cast to f32.
    """
    if prev_gray.device.type == "cpu":
        base2 = torch.stack([prev_gray, next_gray]).to(torch.float32)
        return pyramid_level_plain(base2, _gaussian_kernel(ksize, sigma), hk, wk)
    r = ksize // 2
    if ksize % 2 == 0 or not 1 <= r <= PYR_RMAX:
        raise ValueError(f"ksize {ksize}: the pyramid kernel takes odd sizes 3 to {2 * PYR_RMAX + 1} (radii 1 to "
                         f"{PYR_RMAX}: levels 6 of a 4K frame)")
    for name, t in (("prev_gray", prev_gray), ("next_gray", next_gray)):
        if t.dim() != 3 or t.dtype not in (torch.uint8, torch.float32) or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous uint8 or float32 (P, H, W) tensor, got {t.dtype} "
                             f"{tuple(t.shape)}{'' if t.is_contiguous() else ', not contiguous'}")
    if next_gray.shape != prev_gray.shape or next_gray.dtype != prev_gray.dtype:
        raise ValueError(f"prev_gray {prev_gray.dtype} {tuple(prev_gray.shape)} and next_gray {next_gray.dtype} "
                         f"{tuple(next_gray.shape)} differ")
    p, h, w = prev_gray.shape
    out = torch.empty((2, p, hk, wk), dtype=torch.float32, device=prev_gray.device)
    if out.numel() == 0:
        return out
    if not (r < h and r < w and hk <= h and wk <= w):
        raise ValueError(f"the pyramid kernel smooths H x W {h} x {w} above the radius {r} and only shrinks: "
                         f"got a level of {hk} x {wk}")
    device, elem = prev_gray.device, prev_gray.element_size()
    _native.check_cuda_input(prev_gray, "prev_gray", prev_gray.dtype, 3)
    _native.check_cuda_input(next_gray, "next_gray", prev_gray.dtype, 3)
    smem = _pyramid_tile(h, w, hk, wk, r, elem)[3]
    tw, seg, span, planes = _pyramid_plan(2 * p, h, w, hk, wk, r, elem, _pyramid_resident(device, elem, r, smem))
    _native.launch(_PYR, device, prev_gray.data_ptr(), next_gray.data_ptr(), out.data_ptr(),
                   _pyramid_tables(h, w, hk, wk, device).data_ptr(), p, h, w, hk, wk, r, elem,
                   _pyramid_taps_f32(ksize, sigma).ctypes.data, tw, seg, span, planes)
    _pyramid.launches += 1
    return out


# the counter's owner: ``farneback_flow`` calls the level by its module-global
# name, which a caller may rebind to a wrapper (the benchmark's ranges do)
_pyramid = pyramid_level
pyramid_level.launches = 0


def pyramid_levels(h: int, w: int, pyr_scale: float = 0.5, levels: int = 3):
    """[(scale, H_k, W_k)] of the usable pyramid levels, coarsest first
    (cvRound sizes: 540x960 gives 68x120, 135x240, 270x480, 540x960)."""
    lv = levels
    scale = 1.0
    for k in range(levels):
        scale *= pyr_scale
        if w * scale < _MIN_SIZE or h * scale < _MIN_SIZE:
            lv = k
            break
    return [
        (pyr_scale**k, _cvround(h * pyr_scale**k), _cvround(w * pyr_scale**k))
        for k in range(lv, -1, -1)
    ]


def farneback_flow(
    prev_gray: torch.Tensor,
    next_gray: torch.Tensor,
    pyr_scale: float = 0.5,
    levels: int = 3,
    winsize: int = 15,
    iterations: int = 3,
    poly_n: int = 5,
    poly_sigma: float = 1.2,
) -> torch.Tensor:
    """Dense flow (P, H, W, 2) f32 from (P, H, W) gray images (uint8 or f32).

    The warp is exact for any flow (``warp="exact"`` of the JAX package);
    ``winsize`` is any odd box window (K2's strip kernel up to 17, its
    generic-radius kernels above).
    """
    p, h, w = prev_gray.shape
    flow = None
    for scale, hk, wk in pyramid_levels(h, w, pyr_scale, levels):
        sigma = (1.0 / scale - 1.0) * 0.5
        smooth_sz = max(_cvround(sigma * 5) | 1, 3)
        # (2, P, hk, wk): image-major, so each image's expansion is a
        # contiguous (P, 5, hk, wk) block that K1 reads in place
        im2 = pyramid_level(prev_gray, next_gray, smooth_sz, sigma, hk, wk)
        r0, r1 = poly_expansion(im2, poly_n, poly_sigma)  # 2 x (P, 5, hk, wk)
        if flow is None:
            flow = torch.zeros((p, 2, hk, wk), dtype=torch.float32, device=prev_gray.device)
        else:
            flow = resize_hw(flow, (hk, wk), "linear", antialias=False) * (1.0 / pyr_scale)
        m = update_matrices(r0, r1, flow)
        for i in range(iterations):
            flow = box_blur_solve(m, winsize)
            if i < iterations - 1:
                m = update_matrices(r0, r1, flow)
    return flow.permute(0, 2, 3, 1)
