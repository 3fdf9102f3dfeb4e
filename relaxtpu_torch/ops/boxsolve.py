"""Fused box blur and 2x2 flow solve (kernel K2).

Counterpart of the Pallas kernel ``relaxtpu/ops/boxsolve.py::_box_solve_kernel``,
which computes ``relaxtpu/ops/flow.py::_update_flow`` (``flow.py:318-337``):
a winsize x winsize replicate-border box sum of the five normal-equation
planes, times 1/winsize^2, then the per-pixel 2x2 solve.  K2
(``csrc/boxsolve.cu``) forms the direct sums in the plain version's tap
order and writes only the two flow planes.  Like the Pallas kernel it takes
any odd winsize, by three routes (``_entry``):

- up to ``STRIP_WINSIZE`` the strip kernel, whose radius is a compile-time
  value (its halo span holds a radius of at most 8);
- up to ``GENERIC_WINSIZE`` the generic-radius kernel: the strip kernel's
  structure with a run-time radius, in one launch with no scratch buffer
  (each plane's input rows in a shared-memory ring of 16 + 2R rows, staged
  plane by plane), on the plan of ``_ring_plan``.  It takes windows up to
  65, but from winsize 23 on its five rings hold it to one block an SM and
  the wide route is faster (``scripts/torch_k2_wide_variants.py``);
- above it the wide route, a pair of kernels on the plan of
  ``_wide_plan``: a vertical pass that takes one plane a block, its input
  rows in a ring of 32 + (taps - 1) rows of a 128-column strip (51,200
  bytes at winsize 67, four blocks an SM; a whole window's ring fits up to
  winsize 421), and writes the vertical sums to a scratch buffer; then a
  horizontal pass that stages a band's five planes of those sums in shared
  memory (whole rows up to 2,048 columns) and adds the taps, scales and
  solves in registers.  Windows whose ring or staged span would not fit
  walk their taps in chunks, in order: the vertical pass by launches that
  each add their taps to the scratch sums of the ones before, the
  horizontal one chunk by chunk into the same registers.  That is 68 bytes
  a pixel (the 28 of the function, the 40 of the scratch) and the halos.

``box_blur_solve`` launches K2 for CUDA tensors and runs the plain PyTorch
version for CPU tensors: M (P, 5, H, W) f32 -> flow (P, 2, H, W) f32.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from relaxtpu_torch import _native

STRIP_WINSIZE = 17  # the strip kernel's halo span holds a radius of at most 8
GENERIC_WINSIZE = 21  # the generic-radius kernel's largest route: the wide route is faster above
RING_ROWS = 16  # the generic-radius kernel's output rows a step
RING_SPAN = 128  # its staged columns a ring row: the strip plus R rounded up to 4 each side
WIDE_ROWS = 16  # the wide route's vertical pass: output rows a step
WIDE_SPAN = 128  # its columns a block (all of them output columns)
WIDE_RUNS = 512  # the horizontal pass's 4-pixel runs a block at most: 256 threads x 2
SMEM_MAX = 232448  # a block's dynamic shared memory on the card
_STRIP, _GENERIC, _WIDE = "relax_box_blur_solve", "relax_box_blur_solve_generic", "relax_box_blur_solve_wide"
_slots: dict = {}  # (query, device index, winsize) -> a kernel's resident blocks


def _entry(winsize: int) -> str:
    """The K2 entry that runs a window: the strip kernel up to
    ``STRIP_WINSIZE``, the generic-radius kernel up to ``GENERIC_WINSIZE``,
    the wide route's pair of kernels above it."""
    if winsize <= STRIP_WINSIZE:
        return _STRIP
    return _GENERIC if winsize <= GENERIC_WINSIZE else _WIDE


@functools.lru_cache(maxsize=256)
def _ring_plan(p: int, h: int, w: int, winsize: int, slots: int, th: int = RING_ROWS,
               span: int = RING_SPAN) -> tuple[int, int, int]:
    """(tw, seg, rows) of the generic-radius kernel for P pairs of H x W at
    ``winsize``, with ``slots`` blocks resident on the card: a block takes a
    strip of ``tw`` output columns (a multiple of 4, at most ``span`` - 2 R4,
    as wide as the fewest strips need) and a run of ``seg`` rows (whole
    steps of ``th``); each plane's ring holds ``rows`` input rows.  A
    block's time goes with the rows it loads (seg + 2R), and the launch
    takes whole waves of ``slots`` blocks, so the run is the one with the
    fewest rows across its waves (the strip kernel's rule).  ``th`` and
    ``span`` are the kernel's (variants of it take others)."""
    r = winsize // 2
    r4 = (r + 3) & ~3
    strips = -(-w // (span - 2 * r4))
    tw = 4 * -(-w // (4 * strips))
    steps = -(-h // th)
    best = None
    for run in range(1, steps + 1):
        blocks = p * -(-w // tw) * -(-steps // run)
        cost = -(-blocks // slots) * (th * run + 2 * r)
        if best is None or cost < best[0]:
            best = (cost, run)
    return tw, th * best[1], (th + 2 * r + 3) & ~3


def _vring_rows(n: int, th: int = WIDE_ROWS) -> int:
    """Ring rows of the wide route's vertical pass at ``n`` taps a launch:
    a step's window (th + n - 1 rows) and the next step's th, a multiple of
    4 (``csrc/boxsolve.cu::vring_rows``)."""
    return (2 * th + n + 2) & ~3


def _hstage_cols(tw: int, ct: int) -> int:
    """Staged floats a row of the wide route's horizontal pass: the strip,
    a chunk of ``ct`` taps and the 16-byte chunks read past them
    (``csrc/boxsolve.cu::hstage_cols``)."""
    return tw + ((ct + 6) & ~3)


def _wide_taps(winsize: int, th: int = WIDE_ROWS, span: int = WIDE_SPAN) -> int:
    """Taps a launch of the wide route's vertical pass: the whole window
    where its ring fits a block's shared memory, else the most that fit."""
    most = ((SMEM_MAX // (4 * span)) & ~3) + 1 - 2 * th
    return min(winsize, most)


@functools.lru_cache(maxsize=256)
def _wide_plan(p: int, h: int, w: int, winsize: int, slots: int, th: int = WIDE_ROWS, span: int = WIDE_SPAN,
               runs: int = WIDE_RUNS, vtaps: int | None = None,
               htaps: int | None = None) -> tuple[int, int, int, int, int, int]:
    """(ws, seg, nv, tw, bh, ct) of the wide route for P pairs of H x W at
    ``winsize``, with ``slots`` blocks of the vertical pass resident on the
    card.

    - ws: the scratch's row stride, a multiple of 4 that holds column x at
      R mod 4 + x, so the horizontal pass's staged span starts 16-byte
      aligned;
    - seg, nv: the vertical pass's runs of seg rows (whole steps of ``th``)
      and taps a launch (``_wide_taps``, or ``vtaps``).  A block's time goes
      with the rows it loads (seg + nv - 1) and the launch takes whole
      waves of ``slots`` blocks, so the run is the one with the fewest rows
      across its waves (the strip kernel's rule);
    - tw, bh, ct: the horizontal pass's strips (a multiple of 4, whole rows
      up to 4 x ``runs`` columns, else as wide as the fewest strips need),
      bands of bh rows (``runs`` 4-pixel runs a block at most) and chunks
      of ct taps (a multiple of 4: the whole window where a row of staged
      sums fits, else the most that fit, or ``htaps``).

    ``th``, ``span`` and ``runs`` are the kernels'; variants take others,
    and the tests force chunks with ``vtaps`` and ``htaps``."""
    r = winsize // 2
    ws = 4 * -(-(w + (r & 3)) // 4)
    nv = min(winsize, _wide_taps(winsize, th, span) if vtaps is None else vtaps)
    steps, strips = -(-h // th), -(-w // span)
    best = None
    for run in range(1, steps + 1):
        blocks = p * 5 * strips * -(-steps // run)
        cost = -(-blocks // slots) * (th * run + nv - 1)
        if best is None or cost < best[0]:
            best = (cost, run)
    tw = 4 * -(-w // (4 * -(-w // (4 * runs))))
    most = (SMEM_MAX // 20 - tw - 4) // 4 * 4
    ct = min(4 * -(-winsize // 4), most) if htaps is None else htaps
    bh = min(runs // (tw // 4), h, SMEM_MAX // (20 * _hstage_cols(tw, ct)))
    return ws, th * best[1], nv, tw, bh, ct


def _query_slots(query: str, device: torch.device, winsize: int, *args) -> int:
    """A kernel's resident blocks on ``device`` at this window (SMs x
    blocks an SM), asked of the library once."""
    key = (query, device.index, winsize)
    if key not in _slots:
        n = _native.query(query, device, *args)
        if n <= 0:
            raise RuntimeError(f"{query}: CUDA error {-n}")
        _slots[key] = n
    return _slots[key]


def _ring_slots(device: torch.device, winsize: int) -> int:
    """The generic-radius kernel's resident blocks at this window."""
    return _query_slots("relax_box_blur_solve_generic_slots", device, winsize, winsize)


def _wide_slots(device: torch.device, winsize: int) -> int:
    """The wide route's vertical pass's resident blocks at this window."""
    return _query_slots("relax_box_blur_solve_wide_slots", device, winsize, _wide_taps(winsize))


def box_sum_plain(m: torch.Tensor, winsize: int) -> torch.Tensor:
    """winsize x winsize box sum with replicate border of (P, C, H, W):
    direct sums, vertical then horizontal, in K2's order."""
    r = winsize // 2
    h, w = m.shape[-2:]
    x = F.pad(m, (r, r, r, r), mode="replicate")
    v = x[..., 0:h, :]
    for d in range(1, winsize):
        v = v + x[..., d : d + h, :]
    s = v[..., 0:w]
    for d in range(1, winsize):
        s = s + v[..., d : d + w]
    return s


def box_blur_solve_plain(m: torch.Tensor, winsize: int = 15) -> torch.Tensor:
    """Plain PyTorch K2: ``_box_blur`` + ``_update_flow``."""
    mb = box_sum_plain(m, winsize) * (1.0 / (winsize * winsize))
    g11, g12, g22, h1, h2 = mb.unbind(dim=1)
    idet = 1.0 / (g11 * g22 - g12 * g12 + 1e-3)
    return torch.stack([(g11 * h2 - g12 * h1) * idet, (g22 * h1 - g12 * h2) * idet], dim=1)


def box_blur_solve(m: torch.Tensor, winsize: int = 15) -> torch.Tensor:
    """Box-averaged 2x2 solve -> new flow (P, 2, H, W).

    CUDA tensors launch K2 (``launches`` counts every call that does,
    ``generic_launches`` those of the generic-radius kernel and
    ``wide_launches`` those of the pair above ``GENERIC_WINSIZE``); CPU
    tensors take the plain version.
    """
    if winsize < 1 or winsize % 2 != 1:
        raise ValueError(f"box window must be odd and positive, got {winsize}")
    if m.device.type == "cpu":
        return box_blur_solve_plain(m, winsize)
    _native.check_cuda_input(m, "m", torch.float32, 4)
    p, c, h, w = m.shape
    if c != 5:
        raise ValueError(f"M must be the 5 normal-equation planes, got shape {tuple(m.shape)}")
    flow = m.new_empty((p, 2, h, w))  # new_empty skips torch.empty's argument parsing on this hot path
    entry = _entry(winsize)
    if entry == _STRIP:
        _native.launch(_STRIP, m.device, m.data_ptr(), flow.data_ptr(), p, h, w, winsize)
    elif entry == _GENERIC:
        tw, seg, _ = _ring_plan(p, h, w, winsize, _ring_slots(m.device, winsize))
        _native.launch(_GENERIC, m.device, m.data_ptr(), flow.data_ptr(), p, h, w, winsize, tw, seg)
        box_blur_solve.generic_launches += 1
    else:
        ws, seg, nv, tw, bh, ct = _wide_plan(p, h, w, winsize, _wide_slots(m.device, winsize))
        scratch = m.new_empty((p, 5, h, ws))  # the vertical sums
        _native.launch(_WIDE, m.device, m.data_ptr(), scratch.data_ptr(), flow.data_ptr(), p, h, w, winsize,
                       ws, seg, nv, tw, bh, ct)
        box_blur_solve.wide_launches += 1
    box_blur_solve.launches += 1
    return flow


box_blur_solve.launches = 0
box_blur_solve.generic_launches = 0
box_blur_solve.wide_launches = 0
