"""Video Swin's shifted-window attention with FAST-VQA's gated relative-position bias (kernel K4).

K4 replaces no Pallas kernel: the JAX package runs no windowed attention.
It was added for FAST-VQA (arXiv 2207.02595), whose backbone is Video Swin-T
(arXiv 2106.13230).  Per window of ``wd x wh x ww`` tokens and head:

    logits[i, j] = q_i . k_j * scale + B[i, j] + M[i, j],   o_i = softmax_j(logits[i]) . v

- ``B`` is the relative-position bias, gathered from a table of
  ``(2wd-1)(2wh-1)(2ww-1)`` rows by the index of Swin's
  ``relative_position_index``: with delta = coord_i - coord_j inside the
  window, ``idx = (dt + wd-1)(2wh-1)(2ww-1) + (dh + wh-1)(2ww-1) + (dw + ww-1)``.
  With FAST-VQA's gated relative-position bias (GRPB, ``patch`` > 0) there
  are two tables: the intra table where tokens i and j lie in the same
  mini-patch of the fragment mosaic (their (h, w) token coordinates, before
  the shift, divided by ``patch``, are equal), the cross table elsewhere.
- ``M`` is Swin's cyclic-shift mask on a shifted block: 0 between tokens of
  one region of the rolled grid, -100 across regions (Video Swin's
  ``compute_mask`` value, not -inf).

Layout.  ``qkv`` is the block's packed projection in token-grid order,
(B, D*H*W, 3 C) with C = heads x head width (Swin's ``qkv`` linear applied
to ``norm1(x)`` before any roll), and the output is (B, D*H*W, C) in the same
order, ready for ``proj`` and the residual.  The cyclic roll by -shift and
the window partition, and their inverses, are index arithmetic: the token
at rolled coordinate c of a window is the grid's token (c + shift) mod L.
On CUDA no window copy, no N x N bias, gate or mask tensor, and no rolled
tensor exists in memory: K4 (``csrc/window_attention.cu``) builds the
index, the gate and the region of every pair from integer token
coordinates, and reads only ``qkv``, the tables and scalars.

``window_mha`` launches K4 for CUDA tensors (bf16, head width 32) and runs
``window_mha_plain`` for CPU tensors; ``window_mha.launches`` counts K4's
launches.
"""

from __future__ import annotations

import math

import torch

from relaxtpu_torch import _native

HEAD_DIM = 32  # K4's head width (Video Swin-T: 96 / 3)
MAX_TOKENS = 512  # the largest window volume K4 takes
MAX_TABLE = 4096  # the largest table K4 takes: the index fits 12 bits
MAX_PATCHES = 128  # mini-patch ids along an axis that K4 tells apart
MASK_VALUE = -100.0  # Video Swin's compute_mask
_ENTRY = "relax_window_mha_bf16"


def effective_window(grid, window, shift) -> tuple[tuple, tuple]:
    """Video Swin's ``get_window_size``: along an axis where the grid is no
    larger than the window, the window is the grid and the shift is 0."""
    win = tuple(g if g <= w else w for g, w in zip(grid, window))
    sh = tuple(0 if g <= w else s for g, w, s in zip(grid, window, shift))
    return win, sh


def table_rows(window) -> int:
    """Rows of a relative-position bias table for ``window``."""
    wd, wh, ww = window
    return (2 * wd - 1) * (2 * wh - 1) * (2 * ww - 1)


def check_geometry(grid, window, shift, patch: int) -> None:
    """Raise unless the token grid splits into whole windows, each shift
    lies inside its window, and the window and table fit K4."""
    for g, w, s in zip(grid, window, shift):
        if w < 1 or g % w:
            raise ValueError(f"the grid {tuple(grid)} must split into whole windows {tuple(window)}")
        if not 0 <= s < w:
            raise ValueError(f"a shift {tuple(shift)} must lie inside the window {tuple(window)}")
    if math.prod(window) > MAX_TOKENS or table_rows(window) > MAX_TABLE:
        raise ValueError(f"window {tuple(window)}: at most {MAX_TOKENS} tokens and {MAX_TABLE} table rows")
    if patch < 0 or (patch and max(grid[1], grid[2]) > patch * MAX_PATCHES):
        raise ValueError(f"mini-patch side {patch} tokens: >= 0, and at most {MAX_PATCHES} a grid axis")


def window_tokens(grid, window, shift, patch: int, device=None) -> dict:
    """Each window's tokens, from integer coordinates (windows in Swin's
    partition order, tokens (t, h, w)-major inside a window):

    - ``grid_index`` (nW, N): the token of the unrolled grid at each window
      position (the roll by -shift folded in);
    - ``rel`` (N,): the token's part of the relative-position index, so that
      ``idx = rel_i - rel_j + offset``; ``offset``;
    - ``region`` (nW, N): the region of the rolled grid (0 where nothing is
      shifted), whose difference masks a pair;
    - ``patch_id`` (nW, N): the mini-patch of the token's (h, w) before the
      shift (0 without a gate).
    """
    (d, h, w), (wd, wh, ww), (sd, sh, sw) = grid, window, shift
    ar = lambda n: torch.arange(n, device=device)  # noqa: E731
    ld, lh, lw = (x.reshape(-1) for x in torch.meshgrid(ar(wd), ar(wh), ar(ww), indexing="ij"))
    nd, nh, nw = (x.reshape(-1) for x in torch.meshgrid(ar(d // wd), ar(h // wh), ar(w // ww), indexing="ij"))
    cd, ch, cw = (n[:, None] * k + loc[None, :] for n, k, loc in ((nd, wd, ld), (nh, wh, lh), (nw, ww, lw)))
    od, oh, ow = ((c + s) % size for c, s, size in ((cd, sd, d), (ch, sh, h), (cw, sw, w)))

    def region(c, size, win, s):
        return (c >= size - win).long() + (c >= size - s).long() if s else torch.zeros_like(c)

    rel = (ld * (2 * wh - 1) + lh) * (2 * ww - 1) + lw
    return {
        "grid_index": (od * h + oh) * w + ow,
        "rel": rel,
        "offset": ((wd - 1) * (2 * wh - 1) + (wh - 1)) * (2 * ww - 1) + (ww - 1),
        "region": (region(cd, d, wd, sd) * 3 + region(ch, h, wh, sh)) * 3 + region(cw, w, ww, sw),
        "patch_id": (oh // patch) * MAX_PATCHES + ow // patch if patch else torch.zeros_like(oh),
    }


def window_bias(tables, tok: dict, patch: int) -> torch.Tensor:
    """The bias of every pair and head, (nW or 1, heads, N, N), f32: the
    tables gathered at each pair's index, gated by the mini-patch."""
    idx = tok["rel"][:, None] - tok["rel"][None, :] + tok["offset"]
    intra = tables[0].float()[idx].permute(2, 0, 1)
    if not patch or len(tables) < 2:
        return intra[None]
    cross = tables[1].float()[idx].permute(2, 0, 1)
    same = (tok["patch_id"][:, :, None] == tok["patch_id"][:, None, :])[:, None]
    return torch.where(same, intra[None], cross[None])


def window_mask(tok: dict, shift) -> torch.Tensor | None:
    """Swin's shift mask, (nW, 1, N, N) f32, or None on an unshifted block."""
    if not any(shift):
        return None
    r = tok["region"]
    return torch.where(r[:, :, None] != r[:, None, :], MASK_VALUE, 0.0)[:, None]


def window_mha_plain(qkv: torch.Tensor, grid, window, shift, heads: int, tables, patch: int,
                     scale: float) -> torch.Tensor:
    """Plain PyTorch K4: the windows gathered from the grid, the tables
    gathered at every pair's index, the gate and the mask built as N x N
    tensors; scores, softmax and P V in f32; the output scattered back to
    the grid in ``qkv``'s type."""
    b, n_tok, c3 = qkv.shape
    c = c3 // 3
    check_geometry(grid, window, shift, patch)
    tok = window_tokens(grid, window, shift, patch, qkv.device)
    x = qkv.reshape(b, n_tok, 3, heads, c // heads)[:, tok["grid_index"]].float()  # (B, nW, N, 3, heads, hd)
    q, k, v = x.unbind(3)
    s = torch.einsum("bwihd,bwjhd->bwhij", q, k) * scale + window_bias(tables, tok, patch)
    mask = window_mask(tok, shift)
    if mask is not None:
        s = s + mask
    o = torch.einsum("bwhij,bwjhd->bwihd", torch.softmax(s, dim=-1), v)
    out = torch.empty((b, n_tok, heads, c // heads), dtype=torch.float32, device=qkv.device)
    out[:, tok["grid_index"]] = o
    return out.reshape(b, n_tok, c).to(qkv.dtype)


def window_mha(qkv: torch.Tensor, grid, window, shift, heads: int, tables, patch: int,
               scale: float, out: torch.Tensor | None = None) -> torch.Tensor:
    """Windowed attention over the token grid ``grid`` = (D, H, W) of each
    of B views: ``qkv`` (B, D*H*W, 3 C) -> (B, D*H*W, C).

    ``window`` and ``shift`` are the block's effective ones
    (:func:`effective_window`); ``tables`` holds the intra and the cross
    table ((T, heads) each) with ``patch`` the mini-patch side in tokens, or
    one table with ``patch`` 0.  On CUDA: ``qkv`` bf16, contiguous, head
    width 32; the tables f32 and contiguous; K4 launches once.  CPU tensors
    take the plain version.  ``out``, where given, is written and returned
    (a contiguous (B, D*H*W, C) tensor like ``qkv``).
    """
    if qkv.device.type == "cpu":
        o = window_mha_plain(qkv, grid, window, shift, heads, tables, patch, scale)
        return o if out is None else out.copy_(o)
    return _launch(qkv, grid, window, shift, heads, tables, patch, scale, out)


_checked: set = set()  # call geometries whose grid, window, shift, patch and tables have passed the checks


def _launch(qkv: torch.Tensor, grid, window, shift, heads: int, tables, patch: int, scale: float,
            out: torch.Tensor | None = None) -> torch.Tensor:
    """Check the inputs, allocate the output and launch K4 once: qkv, the
    tables, the output and scalars are all that reach it.  The geometry and
    the tables' layout are checked once a geometry (a backbone makes the
    same 12 calls for every video); qkv and the output at every call."""
    b, n_tok, c3 = qkv.shape
    key = (tuple(grid), tuple(window), tuple(shift), heads, patch,
           tuple((t.data_ptr(), t.dtype, tuple(t.shape), t.device, t.is_contiguous()) for t in tables))
    if key not in _checked:
        check_geometry(grid, window, shift, patch)
        if not 1 <= len(tables) <= 2 or (len(tables) == 2) != bool(patch):
            raise ValueError("two tables with a mini-patch side > 0, or one table with 0")
        rows = table_rows(window)
        for i, t in enumerate(tables):
            _native.check_cuda_input(t, f"tables[{i}]", torch.float32, 2)
            if tuple(t.shape) != (rows, heads) or t.device != qkv.device:
                raise ValueError(f"tables[{i}] must be ({rows}, {heads}) on {qkv.device}, got {tuple(t.shape)}")
        _checked.add(key)
    _native.check_cuda_input(qkv, "qkv", torch.bfloat16, 3)
    if c3 != 3 * heads * HEAD_DIM or n_tok != math.prod(grid):
        raise ValueError(f"qkv must be (B, {math.prod(grid)}, {3 * heads * HEAD_DIM}) for {heads} heads of "
                         f"width {HEAD_DIM}, got {tuple(qkv.shape)}")
    if qkv.data_ptr() % 16:
        raise ValueError("qkv must start on a 16-byte boundary: K4 stages rows by 16-byte copies")
    if out is None:
        out = qkv.new_empty((b, n_tok, heads * HEAD_DIM))
    elif out.shape != (b, n_tok, heads * HEAD_DIM) or out.dtype != qkv.dtype or not out.is_contiguous() \
            or out.device != qkv.device:
        raise ValueError(f"out must be a contiguous {qkv.dtype} ({b}, {n_tok}, {heads * HEAD_DIM}) on {qkv.device}")
    _native.launch_here(_ENTRY, qkv.device, qkv.data_ptr(), tables[0].data_ptr(), tables[-1].data_ptr(),
                        out.data_ptr(), b, *grid, *window, *shift, heads, patch, float(scale))
    window_mha.launches += 1
    return out


window_mha.launches = 0
