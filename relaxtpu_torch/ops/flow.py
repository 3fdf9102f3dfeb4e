"""Farneback dense optical flow over a batch of pairs.

Counterpart of ``relaxtpu/ops/flow.py:44-409`` with OpenCV's parameter
conventions: a coarse-to-fine pyramid (each level blurs the base image with
sigma = (1/scale - 1)/2 and resizes it, linear without antialias), a
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
from relaxtpu_torch.ops.boxsolve import box_blur_solve
from relaxtpu_torch.ops.resize import resize_hw
from relaxtpu_torch.ops.warp import update_matrices

_MIN_SIZE = 32  # OpenCV's minimum pyramid level size
POLY_NMAX = 60  # the expansion kernel's largest radius: its 128 staged columns hold a strip of 8 and the halo
POLY_ROWS = 16  # the expansion kernel's output rows a step
POLY_SPAN = 128  # its staged columns a ring row: the strip plus n rounded up to 4 each side
_POLY_TAPS = 2 * POLY_NMAX + 1  # the taps of each 1-D kernel in the kernel's arguments
_POLY = "relax_poly_expansion"
_poly_args: dict = {}  # (n, sigma) -> the kernel's f32 coefficients, on the host
_poly_slots: dict = {}  # (device index, n) -> the kernel's resident blocks


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
    # (2, P, H, W): image-major, so each image's expansion is a contiguous
    # (P, 5, H, W) block that K1 reads in place
    base2 = torch.stack([prev_gray, next_gray]).to(torch.float32)
    flow = None
    for scale, hk, wk in pyramid_levels(h, w, pyr_scale, levels):
        sigma = (1.0 / scale - 1.0) * 0.5
        smooth_sz = max(_cvround(sigma * 5) | 1, 3)
        gk = _gaussian_kernel(smooth_sz, sigma)
        im2 = _sep_correlate(base2, gk, gk, "reflect")
        im2 = resize_hw(im2, (hk, wk), "linear", antialias=False)
        r0, r1 = poly_expansion(im2, poly_n, poly_sigma)  # 2 x (P, 5, hk, wk)
        if flow is None:
            flow = torch.zeros((p, 2, hk, wk), dtype=torch.float32, device=base2.device)
        else:
            flow = resize_hw(flow, (hk, wk), "linear", antialias=False) * (1.0 / pyr_scale)
        m = update_matrices(r0, r1, flow)
        for i in range(iterations):
            flow = box_blur_solve(m, winsize)
            if i < iterations - 1:
                m = update_matrices(r0, r1, flow)
    return flow.permute(0, 2, 3, 1)
