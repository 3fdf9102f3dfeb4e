"""The plain reference of FAST-VQA scoring (Wu et al., ECCV 2022, arXiv
2207.02595, the FAST-B model: Video Swin-T, arXiv 2106.13230, with gated
relative-position biases and a per-position quality head).

Plain PyTorch in float32 with TF32 off, on the state dict alone: it imports
nothing of the port's ``ops``, ``features`` or ``models`` and nothing of JAX.
``portbench/reference/fastvqa.py`` is a frozen copy for the benchmark.  From
packed I420 frames:

1. whole frames to RGB (BT.601 limited range, nearest 2x2 chroma, rounded
   half to even and clipped: the port's converter's formula);
2. clips: FAST-VQA's ``SampleFrames`` at test time (``clip_len`` frames at
   ``frame_interval``, ``num_clips`` clips spread evenly over the video);
3. fragments: FAST-VQA's ``get_spatial_fragments`` with ``fragments_h =
   fragments_w = 7``, ``fsize = 32``, ``aligned = 32``: grid starts
   ``min(res // 7 * i, res - 32)`` and one random offset pair a grid cell and
   clip in ``[0, res // 7 - 32)``, given by the caller;
4. Video Swin-T as published, with the explicit cyclic roll, window
   partition, Swin's ``relative_position_index`` gathered from the table,
   Video Swin's ``compute_mask`` (-100 across regions) and FAST-VQA's gate
   from a mini-patch id map rolled with the tokens;
5. the head: Conv3d(768, 64, 1), GELU, Conv3d(64, 1, 1); scores averaged over
   positions and views.

Departures from the published description, and what cannot be confirmed
without the released code:

- GRPB's tables: the gate is binary, ``B = G * T_intra[idx] + (1 - G) *
  T_cross[idx]`` with ``G`` 1 where both tokens lie in one mini-patch.  The
  intra table is taken to be ``relative_position_bias_table`` (Swin's own,
  which a Kinetics checkpoint initialises) and the cross table
  ``fragment_position_bias_table``; the released code may scale the cross
  term by the distance between fragments.  With seeded tables, speed does
  not depend on the choice.
- The qkv projection is applied to the grid before the roll and the
  partition (it acts on each token alone, so the result is the same).
- Grids that do not split into whole windows (which Video Swin pads) and
  frames below 224 px (which FAST-VQA upsamples) are refused.
- ``precision="fp8"`` is the control, not FAST-VQA: both operands of every
  product (patch embedding, qkv, Q K^T, P V, proj, the MLP, patch merging,
  the head) rounded to float8 e4m3 under a per-tensor scale.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

MEAN = (123.675, 116.28, 103.53)
STD = (58.395, 57.12, 57.375)
DEPTHS = (2, 2, 6, 2)
HEADS = (3, 6, 12, 24)
WINDOW = (8, 7, 7)
FRAG_BIASES = (True, True, True, False)
FRAGMENTS, FSIZE = 7, 32
CLIPS, CLIP_LEN, INTERVAL = 4, 32, 2
MASK_VALUE = -100.0
FP8_MAX = 448.0


@contextlib.contextmanager
def strict_f32():
    """TF32 off for matrix products and convolutions inside the block."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under a per-tensor scale (amax -> 448)."""
    s = t.detach().abs().amax().clamp_min(1e-12) / FP8_MAX
    return (t / s).to(torch.float8_e4m3fn).to(t.dtype) * s


def _ops(precision: str):
    if precision not in ("f32", "fp8"):
        raise ValueError(f"precision is f32 or fp8, got {precision!r}")
    return fp8 if precision == "fp8" else (lambda t: t)


# ------------------------------------------------------------------ input
def i420_to_rgb(i420: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(n, H*W*3/2) packed I420 uint8 -> (n, H, W, 3) uint8 RGB."""
    n = i420.shape[0]
    y = i420[:, : h * w].reshape(n, h, w).float()
    u = i420[:, h * w : h * w + h * w // 4].reshape(n, h // 2, w // 2).float()
    v = i420[:, h * w + h * w // 4 :].reshape(n, h // 2, w // 2).float()
    u = u.repeat_interleave(2, 1).repeat_interleave(2, 2) - 128.0
    v = v.repeat_interleave(2, 1).repeat_interleave(2, 2) - 128.0
    yl = 1.164383 * (y - 16.0)
    r = yl + 1.596027 * v
    g = yl - 0.812968 * v - 0.391762 * u
    b = yl + 2.017232 * u
    return torch.clamp(torch.round(torch.stack([r, g, b], -1)), 0, 255).to(torch.uint8)


def sample_clips(n_frames: int, clips: int = CLIPS, clip_len: int = CLIP_LEN, interval: int = INTERVAL) -> list:
    """FAST-VQA's SampleFrames at test time -> ``clips`` lists of raw indices."""
    span = clip_len * interval
    avg = (n_frames - span + 1) / float(clips)
    if n_frames > span - 1:
        starts = (np.arange(clips) * avg + avg / 2.0).astype(np.int32)
    else:
        starts = np.zeros(clips, dtype=np.int32)
    return [[int(i) for i in np.mod(s + np.arange(clip_len) * interval, n_frames)] for s in starts]


def grid_starts(res: int, fragments: int = FRAGMENTS, fsize: int = FSIZE) -> list:
    return [min(res // fragments * i, res - fsize) for i in range(fragments)]


def fragments(video: torch.Tensor, offsets, fragments_: int = FRAGMENTS, fsize: int = FSIZE) -> torch.Tensor:
    """get_spatial_fragments of one clip: (T, H, W, 3) -> (T, 7 fsize, 7 fsize, 3);
    ``offsets`` (7, 7, 2): the (row, column) offset of each grid cell."""
    t, h, w, _ = video.shape
    if min(h, w) < fragments_ * fsize:
        raise ValueError(f"frames of {h}x{w} are below {fragments_ * fsize} px (FAST-VQA would upsample them)")
    out = torch.zeros((t, fragments_ * fsize, fragments_ * fsize, 3), dtype=video.dtype, device=video.device)
    for i, hs in enumerate(grid_starts(h, fragments_, fsize)):
        for j, ws in enumerate(grid_starts(w, fragments_, fsize)):
            oh, ow = int(offsets[i][j][0]), int(offsets[i][j][1])
            out[:, i * fsize:(i + 1) * fsize, j * fsize:(j + 1) * fsize] = \
                video[:, hs + oh:hs + oh + fsize, ws + ow:ws + ow + fsize]
    return out


# ------------------------------------------------------------------ Swin pieces
def window_size(grid, window, shift) -> tuple:
    """Video Swin's get_window_size."""
    win, sh = list(window), list(shift)
    for i, g in enumerate(grid):
        if g <= window[i]:
            win[i], sh[i] = g, 0
    return tuple(win), tuple(sh)


def window_partition(x: torch.Tensor, window) -> torch.Tensor:
    """(B, D, H, W, C) -> (B * nW, N, C)."""
    b, d, h, w, c = x.shape
    x = x.view(b, d // window[0], window[0], h // window[1], window[1], w // window[2], window[2], c)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, window[0] * window[1] * window[2], c)


def window_reverse(windows: torch.Tensor, window, b: int, d: int, h: int, w: int) -> torch.Tensor:
    x = windows.view(b, d // window[0], h // window[1], w // window[2], window[0], window[1], window[2], -1)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(b, d, h, w, -1)


def relative_position_index(window, device=None) -> torch.Tensor:
    """Swin's (N, N) index into the (2wd-1)(2wh-1)(2ww-1)-row table."""
    coords = torch.stack(torch.meshgrid(*(torch.arange(k, device=device) for k in window), indexing="ij"))
    flat = coords.flatten(1)
    rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0).contiguous()
    for i in range(3):
        rel[:, :, i] += window[i] - 1
    rel[:, :, 0] *= (2 * window[1] - 1) * (2 * window[2] - 1)
    rel[:, :, 1] *= 2 * window[2] - 1
    return rel.sum(-1)


def compute_mask(d: int, h: int, w: int, window, shift, device=None) -> torch.Tensor:
    """Video Swin's compute_mask: (nW, N, N), 0 inside a region, -100 across."""
    img = torch.zeros((1, d, h, w, 1), device=device)
    cnt = 0
    for ds in (slice(-window[0]), slice(-window[0], -shift[0]), slice(-shift[0], None)):
        for hs in (slice(-window[1]), slice(-window[1], -shift[1]), slice(-shift[1], None)):
            for ws in (slice(-window[2]), slice(-window[2], -shift[2]), slice(-shift[2], None)):
                img[:, ds, hs, ws, :] = cnt
                cnt += 1
    mw = window_partition(img, window).squeeze(-1)
    diff = mw[:, None, :] - mw[:, :, None]
    return diff.masked_fill(diff != 0, MASK_VALUE).masked_fill(diff == 0, 0.0)


def fragment_gate(d: int, h: int, w: int, window, shift, patch: int, device=None) -> torch.Tensor:
    """(nW, N, N): 1 where both tokens lie in one mini-patch of ``patch``
    tokens a side (ids from the unrolled grid, rolled with the tokens)."""
    hh = torch.arange(h, device=device)[:, None] // patch
    ww = torch.arange(w, device=device)[None, :] // patch
    ids = (hh * (w // patch + 1) + ww).float()[None, None, :, :, None].expand(1, d, h, w, 1)
    if any(shift):
        ids = torch.roll(ids, shifts=tuple(-s for s in shift), dims=(1, 2, 3))
    iw = window_partition(ids.contiguous(), window).squeeze(-1)
    return (iw[:, :, None] == iw[:, None, :]).float()


def window_attention(qkv: torch.Tensor, heads: int, window, shift, tables, patch: int, scale: float,
                     precision: str = "f32") -> torch.Tensor:
    """Shifted-window attention of the grid's projections: (B, D, H, W, 3 C) ->
    (B, D, H, W, C): roll by -shift, partition, attention with the gathered
    (and gated) bias and the mask, reverse, roll back."""
    q8 = _ops(precision)
    b, d, h, w, c3 = qkv.shape
    c = c3 // 3
    x = torch.roll(qkv, shifts=tuple(-s for s in shift), dims=(1, 2, 3)) if any(shift) else qkv
    win = window_partition(x, window)
    bw, n, _ = win.shape
    nw = bw // b
    qkv_w = win.reshape(bw, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    q, k, v = qkv_w[0] * scale, qkv_w[1], qkv_w[2]
    attn = q8(q) @ q8(k).transpose(-2, -1)
    rpi = relative_position_index(window, qkv.device).reshape(-1)
    bias = tables[0][rpi].reshape(n, n, heads).permute(2, 0, 1)[None]
    if patch and len(tables) > 1:
        cross = tables[1][rpi].reshape(n, n, heads).permute(2, 0, 1)[None]
        gate = fragment_gate(d, h, w, window, shift, patch, qkv.device)[:, None]
        bias = gate * bias + (1 - gate) * cross
    attn = attn.view(b, nw, heads, n, n) + bias
    if any(shift):
        attn = attn + compute_mask(d, h, w, window, shift, qkv.device)[None, :, None]
    attn = torch.softmax(attn.view(bw, heads, n, n), dim=-1)
    o = (q8(attn) @ q8(v)).transpose(1, 2).reshape(bw, n, c)
    o = window_reverse(o, window, b, d, h, w)
    return torch.roll(o, shifts=tuple(shift), dims=(1, 2, 3)) if any(shift) else o


# ------------------------------------------------------------------ the model
def _linear(x, sd, name, q8):
    return F.linear(q8(x), q8(sd[name + ".weight"]), sd.get(name + ".bias"))


def _norm(x, sd, name):
    return F.layer_norm(x, x.shape[-1:], sd[name + ".weight"], sd[name + ".bias"])


def block(x, sd, p, heads, window, shift, patch, gated, precision):
    q8 = _ops(precision)
    b, d, h, w, c = x.shape
    qkv = _linear(_norm(x, sd, p + "norm1"), sd, p + "attn.qkv", q8)
    tables = [sd[p + "attn.relative_position_bias_table"]]
    if gated:
        tables.append(sd[p + "attn.fragment_position_bias_table"])
    o = window_attention(qkv, heads, window, shift, tables, patch if gated else 0, (c // heads) ** -0.5, precision)
    x = x + _linear(o, sd, p + "attn.proj", q8)
    y = F.gelu(_linear(_norm(x, sd, p + "norm2"), sd, p + "mlp.fc1", q8))
    return x + _linear(y, sd, p + "mlp.fc2", q8)


def forward(sd: dict, mosaic_u8: torch.Tensor, depths=DEPTHS, heads=HEADS, window=WINDOW,
            frag_biases=FRAG_BIASES, mini_patch: int = FSIZE, precision: str = "f32") -> tuple:
    """The state dict (``backbone.*``, ``vqa_head.*``) and RGB uint8 mosaics
    (B, T, H, W, 3) -> per-position scores (B, positions) and each view's mean
    final feature (B, C), float32."""
    q8 = _ops(precision)
    sd = {k: v.float() for k, v in sd.items()}
    mean = torch.tensor(MEAN, device=mosaic_u8.device)
    std = torch.tensor(STD, device=mosaic_u8.device)
    x = ((mosaic_u8.float() - mean) / std).permute(0, 4, 1, 2, 3)
    x = F.conv3d(q8(x), q8(sd["backbone.patch_embed.proj.weight"]), sd["backbone.patch_embed.proj.bias"],
                 stride=(2, 4, 4))
    x = _norm(x.permute(0, 2, 3, 4, 1), sd, "backbone.patch_embed.norm")
    patch = mini_patch // 4
    for i, depth in enumerate(depths):
        grid = tuple(x.shape[1:4])
        for j in range(depth):
            shift = (0, 0, 0) if j % 2 == 0 else tuple(k // 2 for k in window)
            win, sh = window_size(grid, window, shift)
            x = block(x, sd, f"backbone.layers.{i}.blocks.{j}.", heads[i], win, sh, patch >> i, frag_biases[i],
                      precision)
        if i < len(depths) - 1:
            x = torch.cat([x[:, :, 0::2, 0::2], x[:, :, 1::2, 0::2], x[:, :, 0::2, 1::2], x[:, :, 1::2, 1::2]], -1)
            x = _linear(_norm(x, sd, f"backbone.layers.{i}.downsample.norm"), sd,
                        f"backbone.layers.{i}.downsample.reduction", q8)
    feat = _norm(x, sd, "backbone.norm")
    fm = feat.permute(0, 4, 1, 2, 3)
    hid = F.gelu(F.conv3d(q8(fm), q8(sd["vqa_head.fc_hid.weight"]), sd["vqa_head.fc_hid.bias"]))
    score = F.conv3d(q8(hid), q8(sd["vqa_head.fc_last.weight"]), sd["vqa_head.fc_last.bias"])
    return score.flatten(1), feat.flatten(1, 3).mean(1)


class Reference:
    """Scores videos given as packed I420 clips, one view at a time."""

    def __init__(self, state_dict: dict, device, precision: str = "f32", **model):
        self.sd = {k: v.detach().to(device=device, dtype=torch.float32) for k, v in state_dict.items()}
        self.device, self.precision, self.model = torch.device(device), precision, model

    @torch.no_grad()
    def mosaic(self, clips_i420: list, h: int, w: int, offsets) -> torch.Tensor:
        """Clips (each (T, H*W*3/2) uint8) and offsets (clips, 7, 7, 2) -> (clips, T, 224, 224, 3)."""
        return torch.stack([fragments(i420_to_rgb(torch.as_tensor(np.asarray(c)).to(self.device), h, w), off)
                            for c, off in zip(clips_i420, offsets)])

    @torch.no_grad()
    def answer(self, clips_i420: list, h: int, w: int, offsets) -> tuple:
        """-> (per-position scores (views, positions), mean features (views, C),
        score: the mean over positions and views), numpy float32 and a float."""
        mosaic = self.mosaic(clips_i420, h, w, offsets)
        with strict_f32():
            outs = [forward(self.sd, mosaic[v:v + 1], precision=self.precision, **self.model)
                    for v in range(len(mosaic))]
        scores = torch.cat([s for s, _ in outs]).cpu().numpy()
        feats = torch.cat([f for _, f in outs]).cpu().numpy()
        return scores, feats, float(scores.astype(np.float64).mean())
