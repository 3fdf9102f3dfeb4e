"""FAST-VQA's sampler and serving program: grid mini-patch fragments of a
video -> Video Swin-T -> per-position quality scores (arXiv 2207.02595).

The sampler (FAST-VQA's test-time sampling; the reference's
``reference_fastvqa.sample_clips`` and ``fragments``):

- clips: ``CLIPS`` views of ``CLIP_LEN`` frames at ``INTERVAL``, spread
  evenly over the video (``SampleFrames``);
- fragments (``get_spatial_fragments``, 7 x 7 grid, mini-patches of 32 px,
  ``aligned`` = the clip): grid starts ``min(res // 7 * i, res - 32)`` and
  one offset pair a grid cell and clip in ``[0, res // 7 - 32)``, the same
  for every frame of the clip.  The caller gives the offsets
  (``draw_offsets`` draws them).

The program (``FastVQAExtractor.enqueue_i420``), one ``relaxtpu.enqueue``
span a video holding:

- ``relaxtpu.upload``: the copy to the device without blocking of each
  mini-patch cut on the host from the packed I420 frames as its even-aligned
  34 x 34 luma region and that region's 17 x 17 chroma (``crop_i420``: ~10.9
  MB a video of 4 x 32 frames, against ~62 MB for the 80 distinct 540p frames
  whole), straight into pinned memory.  On CUDA a thread a view cuts them
  while the device computes the videos before (``enqueue_i420``), and the
  span waits for them;
- ``relaxtpu.colorspace``: I420 -> BGR of the regions (``yuv420_to_bgr``,
  the ReLaX program's converter; the chroma is nearest 2x2, so a region
  converts to the frame's own pixels bit for bit);
- ``relaxtpu.fragments``: each patch cropped out of its region (a shift of
  0-2 rows and columns), flipped to RGB and laid into the (views, T, 224,
  224, 3) mosaic, in one gather;
- ``relaxtpu.swin``: normalisation and the backbone, holding
  ``relaxtpu.window_attention`` around each K4 call;
- ``relaxtpu.head``: the head, the positions' scores and the views' mean
  features into one vector.

The answer (``finish``) is that vector on the host, (views x positions)
scores then (views x 768) mean features, and the score: the mean of the
scores over positions and views.
"""

from __future__ import annotations

import concurrent.futures

import numpy as np
import torch

from relaxtpu_torch import _native
from relaxtpu_torch.device import resolve_device, upload
from relaxtpu_torch.models.swin3d import FastVQA
from relaxtpu_torch.ops.colorspace import yuv420_to_bgr
from relaxtpu_torch.utils.profiling import span

CLIPS, CLIP_LEN, INTERVAL = 4, 32, 2
FRAGMENTS, FSIZE = 7, 32
MOSAIC = FRAGMENTS * FSIZE  # 224
PATCHES = FRAGMENTS * FRAGMENTS
REGION = FSIZE + 2  # the even-aligned luma region a mini-patch is cut from
REGION_BYTES = REGION * REGION + 2 * (REGION // 2) ** 2


def clip_indices(n_frames: int, clips: int = CLIPS, clip_len: int = CLIP_LEN, interval: int = INTERVAL) -> list:
    """FAST-VQA's test-time clips: ``clips`` lists of ``clip_len`` raw frame
    indices ``interval`` apart, their starts spread evenly over the video
    (indices wrap around a video shorter than a clip)."""
    span_ = clip_len * interval
    avg = (n_frames - span_ + 1) / float(clips)
    starts = (np.arange(clips) * avg + avg / 2.0).astype(np.int32) if n_frames > span_ - 1 else np.zeros(clips, np.int32)
    return [[int(i) for i in (s + np.arange(clip_len) * interval) % n_frames] for s in starts]


def grid_starts(res: int) -> list:
    return [min(res // FRAGMENTS * i, res - FSIZE) for i in range(FRAGMENTS)]


def offset_range(h: int, w: int) -> tuple:
    """(rows, columns): offsets lie in [0, rows) and [0, columns)."""
    if min(h, w) < MOSAIC:
        raise ValueError(f"FAST-VQA's fragments need frames of at least {MOSAIC} px, got {h}x{w}")
    return max(h // FRAGMENTS - FSIZE, 0), max(w // FRAGMENTS - FSIZE, 0)


def draw_offsets(rng: np.random.Generator, h: int, w: int, clips: int = CLIPS) -> np.ndarray:
    """(clips, 7, 7, 2) random (row, column) offsets of the grid cells."""
    rows, cols = offset_range(h, w)
    out = np.zeros((clips, FRAGMENTS, FRAGMENTS, 2), np.int64)
    if rows:
        out[..., 0] = rng.integers(0, rows, (clips, FRAGMENTS, FRAGMENTS))
    if cols:
        out[..., 1] = rng.integers(0, cols, (clips, FRAGMENTS, FRAGMENTS))
    return out


def patch_origins(h: int, w: int, offsets) -> tuple:
    """-> (rows, columns) of each patch's top-left pixel, (clips, 49) each."""
    offsets = np.asarray(offsets, np.int64)
    rows, cols = offset_range(h, w)
    if offsets.shape[1:] != (FRAGMENTS, FRAGMENTS, 2) or offsets.min() < 0 or \
            (offsets[..., 0] >= max(rows, 1)).any() or (offsets[..., 1] >= max(cols, 1)).any():
        raise ValueError(f"offsets must be (clips, 7, 7, 2) in [0, {rows}) x [0, {cols}) at {h}x{w}")
    r = np.asarray(grid_starts(h))[None, :, None] + offsets[..., 0]
    c = np.asarray(grid_starts(w))[None, None, :] + offsets[..., 1]
    return r.reshape(len(offsets), PATCHES), c.reshape(len(offsets), PATCHES)


def region_plan(h: int, w: int, offsets) -> tuple:
    """-> (tops, lefts, dy, dx), (clips, 49) each: the even-aligned region
    origin of each patch (inside the frame) and the patch's shift in it."""
    if h % 2 or w % 2:
        raise ValueError(f"I420 needs even dimensions, got {w}x{h}")
    r, c = patch_origins(h, w, offsets)
    tops, lefts = np.minimum(r & ~1, h - REGION), np.minimum(c & ~1, w - REGION)
    return tops, lefts, r - tops, c - lefts


def crop_i420_plain(frames_i420: np.ndarray, h: int, w: int, tops, lefts, out: np.ndarray) -> None:
    """One clip's frames (T, H*W*3/2) -> ``out`` (T, 49, REGION_BYTES): each
    patch's luma region then its U and V regions, row by row."""
    t = len(frames_i420)
    y = frames_i420[:, : h * w].reshape(t, h, w)
    u = frames_i420[:, h * w : h * w * 5 // 4].reshape(t, h // 2, w // 2)
    v = frames_i420[:, h * w * 5 // 4 :].reshape(t, h // 2, w // 2)
    rc, luma = REGION // 2, REGION * REGION
    for p, (top, left) in enumerate(zip(tops, lefts)):
        out[:, p, :luma].reshape(t, REGION, REGION)[...] = y[:, top:top + REGION, left:left + REGION]
        for k, plane in enumerate((u, v)):
            a = luma + k * rc * rc
            out[:, p, a:a + rc * rc].reshape(t, rc, rc)[...] = plane[:, top // 2:top // 2 + rc, left // 2:left // 2 + rc]


def crop_i420(frames_i420: np.ndarray, h: int, w: int, tops, lefts, out: np.ndarray, native: bool) -> None:
    """:func:`crop_i420_plain`, by the kernel library's host routine where
    ``native`` (the card's path: the library is built there)."""
    frames_i420 = np.ascontiguousarray(frames_i420, np.uint8)
    if frames_i420.shape[1] != h * w * 3 // 2:
        raise ValueError(f"frames must be packed I420 of {w}x{h}, got {frames_i420.shape}")
    if not native:
        return crop_i420_plain(frames_i420, h, w, tops, lefts, out)
    tops, lefts = (np.ascontiguousarray(a, np.int32) for a in (tops, lefts))
    _native.host("relax_crop_i420_minipatches", frames_i420.ctypes.data, len(frames_i420), h, w,
                 tops.ctypes.data, lefts.ctypes.data, len(tops), out.ctypes.data)


class FastVQAExtractor:
    """FAST-VQA on one device: the model and the serving programs.

    ``state_dict``: ``models.swin3d.FastVQA``'s (Video Swin and FAST-VQA's
    names).  ``dtype``: the backbone's type (bf16 on the card; the CPU
    tests run f32); the bias tables and the head stay f32.  On CUDA the I420
    program runs as CUDA graphs between K4's launches
    (:class:`GraphedProgram`); on the CPU, eagerly.  ``model``: the
    backbone's keyword arguments (tests shrink it).
    """

    def __init__(self, state_dict, dtype: torch.dtype = torch.bfloat16, device=None, **model):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.model = FastVQA(**model)
        self.model.load_state_dict(state_dict)
        self.model.to_serving(self.device, dtype)
        self._index: dict = {}  # region side -> (base gather index, patch of each entry) on the device
        self.graphs = self.device.type == "cuda"
        self._fetch = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self._graphed: dict = {}  # (views, frames) -> GraphedProgram
        self._pending: Pending | None = None  # the video whose regions are being cut, launched by the next call
        # one thread a view: on the card's 8-core host, 4 threads cut a 540p video as fast as 8 (1.87 against
        # 1.79 ms, median of 12), and 16 have tails of 10 ms
        self._crop_pool = concurrent.futures.ThreadPoolExecutor(CLIPS, thread_name_prefix="fastvqa-crop")

    def _gather_index(self, region: int) -> tuple:
        """The mosaic as a gather from patches (49, region, region, 3) BGR:
        the flat source of each (row, column, RGB channel) of one view with no
        shift, and the patch it lies in."""
        if region not in self._index:
            i, r, j, s, ch = np.meshgrid(np.arange(FRAGMENTS), np.arange(FSIZE), np.arange(FRAGMENTS),
                                         np.arange(FSIZE), np.arange(3), indexing="ij")
            p = i * FRAGMENTS + j
            base = ((p * region + r) * region + s) * 3 + (2 - ch)
            self._index[region] = tuple(upload(torch.from_numpy(a.reshape(-1).astype(np.int64)), self.device)
                                        for a in (base, p))
        return self._index[region]

    def _mosaic(self, patches_bgr: torch.Tensor, shifts: torch.Tensor | None) -> torch.Tensor:
        """(views, T, 49, R, R, 3) BGR regions and each patch's flat shift
        ((dy R + dx) 3, (views, 49); None: 0) -> (views, T, 224, 224, 3) RGB."""
        v, t, _, region = patches_bgr.shape[:4]
        base, pmap = self._gather_index(region)
        idx = base[None] if shifts is None else base[None] + shifts[:, pmap]
        src = patches_bgr.reshape(v, t, -1)
        out = torch.gather(src, 2, idx[:, None, :].expand(v, t, idx.shape[-1]))
        return out.view(v, t, MOSAIC, MOSAIC, 3)

    def _score(self, mosaic: torch.Tensor) -> tuple:
        """-> the handle: (the answer on the device, how many scores lead it)."""
        with span("swin"):
            feat = self.model.backbone(self.model.normalise(mosaic), FSIZE)
        with span("head"):
            scores, pooled = self.model.head(feat)
            return torch.cat([scores.reshape(-1), pooled.reshape(-1)]), scores.numel()

    def _stage(self, n_bytes: tuple) -> torch.Tensor:
        return torch.empty(n_bytes, dtype=torch.uint8, pin_memory=self.device.type == "cuda")

    def _cut(self, frames_by_clip, h: int, w: int, offsets) -> "Pending":
        """Start the host's part of the upload: each patch's region cut into
        pinned memory, a thread a view (the library's routine releases the
        GIL) -> the pending regions (views, T, 49, REGION_BYTES) and each
        patch's flat shift in its converted region ((dy R + dx) 3, (views, 49))."""
        tops, lefts, dy, dx = region_plan(h, w, offsets)
        views, t = len(frames_by_clip), len(frames_by_clip[0])
        if len(tops) != views:
            raise ValueError(f"{views} views but offsets for {len(tops)}")
        native = self.device.type == "cuda"
        host = self._stage((views, t, PATCHES, REGION_BYTES))
        crops = [self._crop_pool.submit(crop_i420, frames_by_clip[k], h, w, tops[k], lefts[k], host[k].numpy(), native)
                 for k in range(views)]
        shifts = torch.empty((views, PATCHES), dtype=torch.int64, pin_memory=native)
        shifts.numpy()[...] = (dy * REGION + dx) * 3
        return Pending(crops, host, shifts)

    @staticmethod
    def _colorspace(regions: torch.Tensor) -> torch.Tensor:
        """(views, T, 49, REGION_BYTES) on the device -> (views, T, 49, R, R, 3) BGR."""
        luma, rc = REGION * REGION, (REGION // 2) ** 2
        bgr = yuv420_to_bgr(regions[..., :luma].reshape(-1, REGION, REGION),
                            regions[..., luma:luma + rc].reshape(-1, REGION // 2, REGION // 2),
                            regions[..., luma + rc:].reshape(-1, REGION // 2, REGION // 2))
        return bgr.view(*regions.shape[:3], REGION, REGION, 3)

    def mosaic_i420(self, frames_by_clip, h: int, w: int, offsets) -> torch.Tensor:
        """The upload, colorspace and fragments stages: a packed I420 stack
        (T, H*W*3/2) a view and the views' offsets (views, 7, 7, 2) -> the
        (views, T, 224, 224, 3) uint8 RGB mosaic on the device."""
        with span("upload"):
            p = self._cut(frames_by_clip, h, w, offsets)
            for crop in p.crops:
                crop.result()
            dev, shifts = (t.to(self.device, non_blocking=True) for t in (p.host, p.shifts))
        with span("colorspace"):
            bgr = self._colorspace(dev)
        with span("fragments"):
            return self._mosaic(bgr, shifts)

    @torch.inference_mode()
    def enqueue_i420(self, frames_by_clip, h: int, w: int, offsets):
        """One video: a packed I420 stack (T, H*W*3/2) a view and the views'
        offsets (views, 7, 7, 2) -> a handle of the answer (enqueued without
        waiting; :meth:`finish` waits for it and reads it).

        On CUDA the call launches the previous video's device program (the
        CUDA graphs of :class:`GraphedProgram`, captured at the first video
        of each shape, between K4's launches) and starts cutting this video's
        regions in the crop threads, which run while the device computes; this
        video's program is launched by the next call, or by its ``finish``."""
        if not self.graphs:
            with span("enqueue"):
                return self._handle(*self._score(self.mosaic_i420(frames_by_clip, h, w, offsets)))
        self._launch_pending()
        self._pending = self._cut(frames_by_clip, h, w, offsets)
        return self._pending

    @torch.inference_mode()
    def _launch_pending(self) -> None:
        """Launch the video whose regions the crop threads were cutting: its
        upload and device program, in one ``relaxtpu.enqueue`` span.  A
        failure is kept for its own ``finish``."""
        p, self._pending = self._pending, None
        if p is None:
            return
        try:
            with span("enqueue"):
                with span("upload"):
                    for crop in p.crops:
                        crop.result()
                    key = tuple(p.host.shape[:2])
                    if key not in self._graphed:
                        self._graphed[key] = GraphedProgram(self, *key)
                    prog = self._graphed[key]
                    prog.regions.copy_(p.host, non_blocking=True)
                    prog.shifts.copy_(p.shifts, non_blocking=True)
                p.answer = self._handle(*prog.run())
        except Exception as e:  # the video's own failure: raised at its finish, not at the next video's enqueue
            p.error = e

    @torch.inference_mode()
    def enqueue_bgr(self, frames_by_clip, offsets) -> tuple:
        """The same from BGR stacks (T, H, W, 3) uint8 a view: each patch cut
        on the host (32 x 32 x 3), no colour conversion on the device."""
        with span("enqueue"):
            h, w = np.asarray(frames_by_clip[0]).shape[1:3]
            r, c = patch_origins(h, w, offsets)
            views, t = len(frames_by_clip), len(frames_by_clip[0])
            with span("upload"):
                host = self._stage((views, t, PATCHES, FSIZE, FSIZE, 3))
                out = host.numpy()
                for k, frames in enumerate(frames_by_clip):
                    frames = np.asarray(frames, np.uint8)
                    for p in range(PATCHES):
                        out[k, :, p] = frames[:, r[k, p]:r[k, p] + FSIZE, c[k, p]:c[k, p] + FSIZE]
                dev = host.to(self.device, non_blocking=True)
            with span("fragments"):
                mosaic = self._mosaic(dev, None)
            return self._handle(*self._score(mosaic))

    def _handle(self, vec: torch.Tensor, n_scores: int) -> tuple:
        """The answer on the device -> the handle.  On CUDA its copy to pinned
        host memory is enqueued at once on a stream of its own, after this
        video's work alone (an event), so that fetching it does not wait for
        the videos enqueued after it on the program's stream."""
        if self.device.type != "cuda":
            return vec, None, n_scores
        done = torch.cuda.Event()
        done.record()
        host = torch.empty(vec.shape, dtype=vec.dtype, pin_memory=True)
        with torch.cuda.stream(self._fetch):
            self._fetch.wait_event(done)
            host.copy_(vec, non_blocking=True)
            fetched = torch.cuda.Event()
            fetched.record()
        vec.record_stream(self._fetch)
        return host, fetched, n_scores

    def finish(self, handle) -> tuple:
        """-> (the answer on the host: views x positions scores, then views x
        C mean features, f32; the score: the mean of the scores)."""
        if isinstance(handle, Pending):
            if handle is self._pending:
                self._launch_pending()
            if handle.error is not None:
                raise handle.error
            handle = handle.answer
        vec, fetched, n_scores = handle
        if fetched is not None:
            fetched.synchronize()
        # a copy, so that the pinned block goes back to the host allocator's cache when the handle goes
        host = vec.numpy().copy() if fetched is not None else vec.cpu().numpy()
        return host, float(host[:n_scores].astype(np.float64).mean())


class Pending:
    """The handle of a video that :meth:`FastVQAExtractor.enqueue_i420` has
    taken on CUDA: the crop threads' futures, the pinned regions and shifts
    they fill, and, once the program is launched, the answer's handle or the
    failure."""

    def __init__(self, crops: list, host: torch.Tensor, shifts: torch.Tensor):
        self.crops, self.host, self.shifts = crops, host, shifts
        self.answer: tuple | None = None
        self.error: Exception | None = None


class GraphedProgram:
    """FAST-VQA's device program for one shape (views, frames) as CUDA graphs.

    Eagerly, a video launches ~210 operations, and the card's host spends
    ~30-50 us on each (a bf16 ``linear`` 49 us, measured there): more than the
    device's time a video.  Here every stage but K4 is captured once into a
    CUDA graph, and a video replays them in order, with K4's 12 launches
    between them as ordinary calls of ``window_mha`` (its counter, its span
    and its wrapper stay as they are):

    - ``relaxtpu.colorspace``: one graph, the regions (a static device
      buffer the upload copies into) to BGR;
    - ``relaxtpu.fragments``: one graph, BGR and the shifts to the mosaic;
    - ``relaxtpu.swin``: a graph before the first block's K4 (normalisation,
      patch embedding, norm1, qkv), one between each two K4 calls (the
      block's proj, residual and MLP, a patch merging, the next block's norm1
      and qkv) and one after the last (the final norm); K4 writes into a
      static buffer each;
    - ``relaxtpu.head``: one graph, then a copy of the answer out of the
      static output, so that a video in flight keeps its own.

    The graphs share one memory pool and are replayed in the order they were
    captured, on the current stream; each video's work follows the last one's
    in stream order, so the static buffers are never written while read.
    Library handles and workspaces are made by an eager warm-up on a side
    stream before the capture.
    """

    def __init__(self, fx: FastVQAExtractor, views: int, t: int):
        dev, backbone = fx.device, fx.model.backbone
        self.regions = torch.zeros((views, t, PATCHES, REGION_BYTES), dtype=torch.uint8, device=dev)
        self.shifts = torch.zeros((views, PATCHES), dtype=torch.int64, device=dev)
        self.steps = backbone.steps(FSIZE)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            fx._score(fx._mosaic(fx._colorspace(self.regions), self.shifts))
        torch.cuda.current_stream(dev).wait_stream(side)
        pool = torch.cuda.graph_pool_handle()

        def capture(fn):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g, pool=pool):
                out = fn()
            return g, out

        def first(mosaic):
            x = backbone.patch_embed(fx.model.normalise(mosaic))
            return x, self.steps[0][0].pre(x)

        def between(k, x, o):
            blk, _, down = self.steps[k]
            x = blk.post(x, o)
            if down is not None:
                x = down(x)
            return (x, self.steps[k + 1][0].pre(x)) if k + 1 < len(self.steps) else (backbone.norm(x), None)

        def head(feat):
            scores, pooled = fx.model.head(feat)
            return torch.cat([scores.reshape(-1), pooled.reshape(-1)]), scores.numel()

        self.color, bgr = capture(lambda: fx._colorspace(self.regions))
        self.frag, mosaic = capture(lambda: fx._mosaic(bgr, self.shifts))
        g, (x, qkv) = capture(lambda: first(mosaic))
        self.graphs, self.qkv, self.grids, self.outs = [g], [qkv], [tuple(x.shape[1:4])], []
        for k in range(len(self.steps)):
            self.outs.append(torch.empty((*qkv.shape[:2], qkv.shape[2] // 3), dtype=qkv.dtype, device=dev))
            g, (x, qkv) = capture(lambda: between(k, x, self.outs[k]))
            self.graphs.append(g)
            if qkv is not None:
                self.qkv.append(qkv)
                self.grids.append(tuple(x.shape[1:4]))
        self.head, (self.vec, self.n_scores) = capture(lambda: head(x))

    def run(self) -> tuple:
        """Replay the program on the regions and shifts copied in -> the handle."""
        with span("colorspace"):
            self.color.replay()
        with span("fragments"):
            self.frag.replay()
        with span("swin"):
            for k, (blk, patch, _) in enumerate(self.steps):
                self.graphs[k].replay()
                blk.attend(self.qkv[k], self.grids[k], patch, out=self.outs[k])
            self.graphs[-1].replay()
        with span("head"):
            self.head.replay()
            return self.vec.clone(), self.n_scores
