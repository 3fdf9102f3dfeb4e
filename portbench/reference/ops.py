"""Plain PyTorch/NumPy image and flow operations of the ReLaX-VQA pipeline.

A frozen copy of the semantics the scoring program is held to: BT.601
I420 -> BGR, OpenCV's fixed-point gray and HSV flow image, jax's
``image.resize`` as separable weight matrices, motion-ranked 16x16
fragments, and Farneback flow (a coarse-to-fine pyramid, the polynomial
expansion, the matrix update with an exact bilinear warp and the box-blurred
2x2 solve) written as plain tensor operations.  It imports nothing of the
program under test, so a later change to the program cannot move it.

Layouts: images (B, H, W, C) uint8, gray (P, H, W), planes (P, C, H, W) f32.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

PATCH = 16
FRAG = 224
TOP_N = (FRAG // PATCH) ** 2  # 196


# ------------------------------------------------------------------ colour
def unpack_i420(buf: torch.Tensor, h: int, w: int):
    """(n, H*W*3/2) packed I420 -> y (n, H, W), u and v (n, H/2, W/2)."""
    yb, cb = h * w, (h // 2) * (w // 2)
    return (buf[:, :yb].reshape(-1, h, w), buf[:, yb:yb + cb].reshape(-1, h // 2, w // 2),
            buf[:, yb + cb:].reshape(-1, h // 2, w // 2))


def i420_to_bgr(buf: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """BT.601 limited range, nearest 2x2 chroma, round half to even -> (n, H, W, 3) uint8."""
    y, u, v = unpack_i420(buf, h, w)

    def up(c):
        return c.to(torch.float32).repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)

    yl = 1.164383 * (y.to(torch.float32) - 16.0)
    uu, vv = up(u) - 128.0, up(v) - 128.0
    bgr = torch.stack([yl + 2.017232 * uu, yl - 0.812968 * vv - 0.391762 * uu, yl + 1.596027 * vv], dim=-1)
    return torch.clamp(torch.round(bgr), 0, 255).to(torch.uint8)


def bgr_to_gray(img: torch.Tensor) -> torch.Tensor:
    """cv2.COLOR_BGR2GRAY in 15-bit fixed point."""
    x = img.to(torch.int32)
    return ((x[..., 0] * 3735 + x[..., 1] * 19235 + x[..., 2] * 9798 + (1 << 14)) >> 15).to(torch.uint8)


def flow_to_bgr(flow: torch.Tensor) -> torch.Tensor:
    """(P, H, W, 2) flow -> HSV image (hue = angle / 2 in degrees, sat 255,
    value = min-max normalised magnitude per image) -> BGR uint8, truncating."""
    fx, fy = flow[..., 0], flow[..., 1]
    mag = torch.sqrt(fx * fx + fy * fy)
    ang = torch.atan2(fy, fx)
    ang = torch.where(ang < 0, ang + 2.0 * math.pi, ang)
    lo, hi = mag.amin(dim=(-2, -1), keepdim=True), mag.amax(dim=(-2, -1), keepdim=True)
    val = (mag - lo) * torch.where(hi > lo, 255.0 / (hi - lo), torch.zeros_like(hi))
    h6 = torch.clamp(torch.floor(ang * (180.0 / math.pi / 2.0)), 0, 255).to(torch.uint8).to(torch.float32) * (6.0 / 180.0)
    v = torch.clamp(torch.floor(val), 0, 255).to(torch.uint8).to(torch.float32)
    fl = torch.floor(h6)
    sector, f = fl.to(torch.int32) % 6, h6 - fl
    s = torch.ones_like(v)  # sat 255 / 255
    p, q, t = v * (1.0 - s), v * (1.0 - s * f), v * (1.0 - s * (1.0 - f))

    def pick(tab):
        out = tab[5]
        for i in range(4, -1, -1):
            out = torch.where(sector == i, tab[i], out)
        return out

    bgr = torch.stack([pick((p, p, t, v, v, q)), pick((t, v, v, q, p, p)), pick((v, q, p, p, t, v))], dim=-1)
    return torch.clamp(torch.floor(bgr), 0, 255).to(torch.uint8)


# ------------------------------------------------------------------ resize
def _lanczos3(x: np.ndarray) -> np.ndarray:
    radius = np.float32(3.0)
    y = radius * np.sin(np.pi * x) * np.sin(np.pi * x / radius)
    with np.errstate(divide="ignore", invalid="ignore"):
        out = np.where(x > 1e-3, y / np.where(x != 0, np.pi**2 * x**2, 1), 1)
    return np.where(x > radius, 0.0, out)


_KERNELS = {"linear": lambda x: np.maximum(0, 1 - np.abs(x)), "lanczos3": _lanczos3}


def weight_matrix(in_size: int, out_size: int, method: str, antialias: bool) -> np.ndarray:
    """(out, in) f32 matrix of jax.image.resize's scale-and-translate rule:
    half-pixel centres, the kernel widened by 1/scale when downsampling with
    antialias, columns renormalised, samples outside the input zeroed."""
    f32 = np.float32
    scale = f32(out_size / in_size)
    inv = f32(1.0) / scale
    kscale = max(inv, f32(1.0)) if antialias else f32(1.0)
    sample = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kscale
    w = _KERNELS[method](x.astype(f32)).astype(f32)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps), w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.ascontiguousarray(np.where(inside[None, :], w.astype(f32), 0).astype(f32).T)


def resize_hw(x: torch.Tensor, out_hw, method: str, antialias: bool) -> torch.Tensor:
    """Resize the last two axes of an f32 tensor; an unchanged axis is left alone."""
    h, w = x.shape[-2:]
    oh, ow = out_hw
    if oh != h:
        x = torch.matmul(torch.from_numpy(weight_matrix(h, oh, method, antialias)).to(x.device), x)
    if ow != w:
        x = torch.matmul(x, torch.from_numpy(weight_matrix(w, ow, method, antialias)).to(x.device).T)
    return x


# --------------------------------------------------------------- fragments
def _patches(img: torch.Tensor) -> torch.Tensor:
    p, h, w, c = img.shape
    hp, wp = h // PATCH, w // PATCH
    img = img[:, :hp * PATCH, :wp * PATCH].reshape(p, hp, PATCH, wp, PATCH, c).permute(0, 1, 3, 2, 4, 5)
    return img.reshape(p, hp * wp, PATCH * PATCH * c)


def _scores(img: torch.Tensor) -> torch.Tensor:
    return _patches(img).to(torch.int32).sum(dim=-1, dtype=torch.int32)


def _order(scores: torch.Tensor) -> torch.Tensor:
    return torch.sort(scores, dim=-1, descending=True, stable=True).indices


def top_patches(img: torch.Tensor) -> torch.Tensor:
    """Ids of the 196 patches with the largest uint8 sums, ascending; ties go
    to the lower id."""
    scores = _scores(img)
    return torch.sort(_order(scores)[..., :min(TOP_N, scores.shape[-1])], dim=-1).values


def near_swaps(scores: torch.Tensor, slack: int, most: int = 2) -> list:
    """The selections one swap away from the top 196 of one image's patch
    scores that a change of at most ``slack`` in the scores could make: pairs
    (a selected id, an unselected id) whose scores lie within ``slack``, at
    most ``most`` of each, nearest the cut first."""
    scores = scores.cpu()
    order = _order(scores).tolist()
    k = min(TOP_N, len(order))
    if k == len(order):
        return []
    s = scores.tolist()
    lowest_in, highest_out = s[order[k - 1]], s[order[k]]
    ins = [i for i in reversed(order[:k]) if s[i] <= highest_out + slack][:most]
    outs = [o for o in order[k:] if s[o] >= lowest_in - slack][:most]
    return [(i, o) for i in ins for o in outs if s[i] - s[o] <= slack]


def gather_fragment(img: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The selected patches packed raster-scan into (P, 224, 224, C); empty slots zero."""
    per_row = FRAG // PATCH
    patches = _patches(img)
    p, _, flat = patches.shape
    sel = torch.gather(patches, 1, ids[..., None].expand(p, ids.shape[-1], flat))
    if ids.shape[-1] < per_row * per_row:
        sel = torch.cat([sel, sel.new_zeros(p, per_row * per_row - ids.shape[-1], flat)], dim=1)
    c = img.shape[-1]
    return sel.reshape(p, per_row, per_row, PATCH, PATCH, c).permute(0, 1, 3, 2, 4, 5).reshape(p, FRAG, FRAG, c)


def fragments(prev: torch.Tensor, nxt: torch.Tensor, slack: int = 0):
    """(P, H, W, 3) uint8 pairs -> the original-frame fragment at the
    residual's patches; the residual fragment blended 0.5/0.5 with the flow
    image's own fragment (round half to even, saturating); and [(pair, the
    merged fragment with one patch of the flow image's choice swapped)] for
    every swap that ``near_swaps`` allows at ``slack``."""
    residual = torch.maximum(nxt, prev) - torch.minimum(nxt, prev)
    ids = top_patches(residual)
    diff_frag = gather_fragment(residual, ids).to(torch.float32)
    flow_img = flow_to_bgr(farneback(bgr_to_gray(prev), bgr_to_gray(nxt)))
    flow_ids = top_patches(flow_img)

    def merge(diff, flow_frag):
        return torch.clamp(torch.round(0.5 * diff + 0.5 * flow_frag.to(torch.float32)), 0, 255).to(torch.uint8)

    merged = merge(diff_frag, gather_fragment(flow_img, flow_ids))
    alts = []
    if slack > 0:
        scores = _scores(flow_img)
        for p in range(len(prev)):
            for i, o in near_swaps(scores[p], slack):
                alt_ids = torch.sort(torch.where(flow_ids[p] == i, torch.full_like(flow_ids[p], o), flow_ids[p])).values
                alts.append((p, merge(diff_frag[p], gather_fragment(flow_img[p:p + 1], alt_ids[None])[0])))
    return gather_fragment(prev, ids), merged, alts


# -------------------------------------------------------------------- flow
def _gaussian(ksize: int, sigma: float) -> np.ndarray:
    """cv2.getGaussianKernel, including its fixed tables for sigma <= 0."""
    tables = {1: [1.0], 3: [0.25, 0.5, 0.25], 5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
              7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125]}
    if sigma <= 0:
        if ksize in tables:
            return np.asarray(tables[ksize], np.float64)
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return k / k.sum()


def _correlate(img: torch.Tensor, kx, ky, border: str) -> torch.Tensor:
    """Separable correlation of (..., H, W) as shifted multiply-adds over a
    padded copy: horizontal taps, then vertical."""
    ry, rx = len(ky) // 2, len(kx) // 2
    h, w = img.shape[-2:]
    lead = img.shape[:-2]
    x = F.pad(img.reshape(-1, 1, h, w), (rx, rx, ry, ry), mode="replicate" if border == "edge" else "reflect")
    x = x.reshape(*lead, h + 2 * ry, w + 2 * rx)
    x = sum(float(kx[i]) * x[..., :, i:i + w] for i in range(len(kx))) if len(kx) > 1 else float(kx[0]) * x
    return sum(float(ky[j]) * x[..., j:j + h, :] for j in range(len(ky))) if len(ky) > 1 else float(ky[0]) * x


def _poly_expansion(img: torch.Tensor, n: int, sigma: float) -> torch.Tensor:
    """(..., H, W) -> (..., 5, H, W) quadratic-fit planes [c_y, c_x, c_yy, c_xx, c_xy]."""
    x = np.arange(-n, n + 1, dtype=np.float64)
    g = np.exp(-(x * x) / (2.0 * sigma * sigma))
    g /= g.sum()
    xg, xxg = x * g, x * x * g
    s0, s2, s4 = g.sum(), (x * x * g).sum(), (x**4 * g).sum()
    gram = np.zeros((6, 6))
    gram[0, 0] = s0 * s0
    gram[1, 1] = gram[2, 2] = s2 * s0
    gram[3, 3] = gram[4, 4] = s4 * s0
    gram[5, 5] = s2 * s2
    gram[0, 3] = gram[3, 0] = gram[0, 4] = gram[4, 0] = s2 * s0
    gram[3, 4] = gram[4, 3] = s2 * s2
    inv = np.linalg.inv(gram)
    ig11, ig03, ig33, ig55 = float(inv[1, 1]), float(inv[0, 3]), float(inv[3, 3]), float(inv[5, 5])
    one = np.array([1.0])
    v0, v1, v2 = (_correlate(img, one, k, "edge") for k in (g, xg, xxg))
    b1, b2, b4 = (_correlate(v0, k, one, "edge") for k in (g, xg, xxg))
    b3, b6 = (_correlate(v1, k, one, "edge") for k in (g, xg))
    b5 = _correlate(v2, g, one, "edge")
    return torch.stack([b3 * ig11, b2 * ig11, b1 * ig03 + b5 * ig33, b1 * ig03 + b4 * ig33, b6 * ig55], dim=-3)


def _levels(h: int, w: int, scale: float, levels: int):
    """[(scale, H_k, W_k)] coarsest first; levels stop below 32 px (OpenCV)."""
    lv = levels
    s = 1.0
    for k in range(levels):
        s *= scale
        if w * s < 32 or h * s < 32:
            lv = k
            break
    return [(scale**k, int(np.rint(h * scale**k)), int(np.rint(w * scale**k))) for k in range(lv, -1, -1)]


def _taper(n: int) -> np.ndarray:
    ramp = np.asarray((0.14, 0.14, 0.4472, 0.4472, 0.4472), np.float32)
    s = np.ones(n, np.float32)
    m = min(5, n)
    s[:m] *= ramp[:m]
    s[n - m:] *= ramp[:m][::-1]
    return s


def update_matrices(r0: torch.Tensor, r1: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """The normal-equation planes [G11, G12, G22, h1, h2] of one Farneback
    iteration, with r1 warped by an exact bilinear sample at x + flow
    (corners clipped to the image, the inside mask from the unclipped floor)."""
    p, c, h, w = r1.shape
    ys = torch.arange(h, dtype=torch.float32, device=flow.device)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=flow.device)[None, :]
    dx, dy = flow[:, 0], flow[:, 1]
    fx, fy = xs + dx, ys + dy
    x1, y1 = torch.floor(fx), torch.floor(fy)
    tx, ty = (fx - x1)[:, None], (fy - y1)[:, None]
    xi, yi = x1.clamp(0, w - 2).to(torch.int64), y1.clamp(0, h - 2).to(torch.int64)
    flat = r1.reshape(p, c, h * w)

    def at(yy, xx):
        idx = (yy * w + xx).reshape(p, 1, h * w).expand(p, c, h * w)
        return torch.gather(flat, 2, idx).reshape(p, c, h, w)

    r1w = ((1 - tx) * (1 - ty) * at(yi, xi) + tx * (1 - ty) * at(yi, xi + 1)
           + (1 - tx) * ty * at(yi + 1, xi) + tx * ty * at(yi + 1, xi + 1))
    inside = (x1 >= 0) & (x1 <= w - 2) & (y1 >= 0) & (y1 <= h - 2)
    r2 = torch.where(inside, (r0[:, 0] - r1w[:, 0]) * 0.5, r0[:, 0] * 0.5)
    r3 = torch.where(inside, (r0[:, 1] - r1w[:, 1]) * 0.5, r0[:, 1] * 0.5)
    r4 = torch.where(inside, (r0[:, 2] + r1w[:, 2]) * 0.5, r0[:, 2])
    r5 = torch.where(inside, (r0[:, 3] + r1w[:, 3]) * 0.5, r0[:, 3])
    r6 = torch.where(inside, (r0[:, 4] + r1w[:, 4]) * 0.25, r0[:, 4] * 0.5)
    r2 = r2 + r4 * dy + r6 * dx
    r3 = r3 + r6 * dy + r5 * dx
    s = torch.from_numpy(_taper(h)[:, None] * _taper(w)[None, :]).to(flow.device)
    r2, r3, r4, r5, r6 = (t * s for t in (r2, r3, r4, r5, r6))
    return torch.stack([r4 * r4 + r6 * r6, (r4 + r5) * r6, r5 * r5 + r6 * r6, r4 * r2 + r6 * r3,
                        r6 * r2 + r5 * r3], dim=1)


def box_blur_solve(m: torch.Tensor, winsize: int) -> torch.Tensor:
    """winsize x winsize replicate-border box mean of the five planes (direct
    sums, vertical then horizontal), then the 2x2 solve -> (P, 2, H, W)."""
    r = winsize // 2
    h, w = m.shape[-2:]
    x = F.pad(m, (r, r, r, r), mode="replicate")
    v = x[..., 0:h, :]
    for d in range(1, winsize):
        v = v + x[..., d:d + h, :]
    s = v[..., 0:w]
    for d in range(1, winsize):
        s = s + v[..., d:d + w]
    g11, g12, g22, h1, h2 = (s * (1.0 / (winsize * winsize))).unbind(dim=1)
    idet = 1.0 / (g11 * g22 - g12 * g12 + 1e-3)
    return torch.stack([(g11 * h2 - g12 * h1) * idet, (g22 * h1 - g12 * h2) * idet], dim=1)


def farneback(prev_gray: torch.Tensor, next_gray: torch.Tensor, pyr_scale=0.5, levels=3, winsize=15,
              iterations=3, poly_n=5, poly_sigma=1.2) -> torch.Tensor:
    """Dense Farneback flow (P, H, W, 2) of (P, H, W) gray pairs, OpenCV's
    parameter conventions (each level blurs the base image with sigma =
    (1/scale - 1)/2 and resizes it, linear without antialias)."""
    p, h, w = prev_gray.shape
    base = torch.stack([prev_gray, next_gray]).to(torch.float32)
    flow = None
    for scale, hk, wk in _levels(h, w, pyr_scale, levels):
        sigma = (1.0 / scale - 1.0) * 0.5
        gk = _gaussian(max(int(np.rint(sigma * 5)) | 1, 3), sigma)
        im = resize_hw(_correlate(base, gk, gk, "reflect"), (hk, wk), "linear", antialias=False)
        r0, r1 = _poly_expansion(im, poly_n, poly_sigma)
        if flow is None:
            flow = torch.zeros((p, 2, hk, wk), dtype=torch.float32, device=base.device)
        else:
            flow = resize_hw(flow, (hk, wk), "linear", antialias=False) * (1.0 / pyr_scale)
        m = update_matrices(r0, r1, flow)
        for i in range(iterations):
            flow = box_blur_solve(m, winsize)
            if i < iterations - 1:
                m = update_matrices(r0, r1, flow)
    return flow.permute(0, 2, 3, 1)
