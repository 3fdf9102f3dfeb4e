"""The feature pipeline: frames -> the 35,203-dim vector, for one video or many.

Counterpart of ``relaxtpu/features/pipeline.py:79-618``.  On the device:

- resize the sampled frames to 224x224 for the backbones (linear and
  lanczos3, both antialiased, quantised to 8-bit levels);
- per pair (a batch axis): absdiff, motion-ranked fragments, Farneback flow
  (kernels K1 and K2), flow image, flow fragment, merge;
- ResNet-50 and ViT forwards over frames and fragments (ViT attention is
  kernel K3);
- means over the rows into the frozen 35,203 layout.

``frame_features`` and ``pair_features`` give the per-frame and per-pair
rows before the means (the extraction modes store them), each with a
device form that takes and returns tensors on the device.

Three programs share these stages:

- one video (``video_feature_async_i420`` from packed I420, which it
  converts to BGR on the device; ``video_feature_async`` from BGR): one
  backbone batch of F + 2P images (F with no pairs);
- many videos of one resolution (``video_features_batch_i420``): the
  videos' rows concatenated ragged, the flow over the flat pair axis in
  chunks of ``max_pair_batch`` pairs, one backbone batch of sum(F) +
  2 sum(P) images, per-video means;
- a long or high-resolution video, with more pairs than ``max_pair_batch``:
  the frames once, then the pair walk (``_pair_rows``: fragments and one
  backbone batch a chunk of pairs, which ``pair_features_dev`` runs too),
  the sums added on the device.

Both single-video programs choose between the first and the last in one
place (``_video_vec``).  Host stacks reach the device through ``upload``
(and ``upload_bgr`` for a BGR video), which the callers outside this module
use too: the async entry points upload through pinned memory without
blocking and return the vector on the device without waiting for it, so
the host can decode the next video while this one computes.  All work
stays on the current stream.  PyTorch runs eagerly, so nothing is padded
to shape buckets: the means are plain means over the real rows, which is
what the JAX package's masked means over its padded rows compute.

Each public program's call is one ``relaxtpu.enqueue`` span holding the
spans of its stages (``utils.profiling.span``: recorded only while a
profiler runs).  The spans live here alone: ``ops/`` and ``models/`` carry
none.
"""

from __future__ import annotations

import numpy as np
import torch

from relaxtpu_torch.device import resolve_device, set_strict_f32
from relaxtpu_torch.features.aggregate import layer_stack_feature, resnet_pool_feature
from relaxtpu_torch.features.layout import TOTAL_FEATURE_DIM
from relaxtpu_torch.models.resnet import ResNet50, resnet_preprocess
from relaxtpu_torch.models.vit import ViT
from relaxtpu_torch.ops.colorspace import bgr_to_gray, flow_to_bgr, pack_i420, unpack_i420, yuv420_to_bgr
from relaxtpu_torch.ops.flow import farneback_flow
from relaxtpu_torch.ops.fragments import (
    absdiff,
    gather_fragment,
    merge_fragments,
    patch_scores,
    top_patch_indices,
)
from relaxtpu_torch.ops.resize import quantize_u8_levels, resize_hw
from relaxtpu_torch.utils.profiling import span

FARNEBACK_PARAMS = dict(
    pyr_scale=0.5, levels=3, winsize=15, iterations=3, poly_n=5, poly_sigma=1.2
)

# The working-set model behind max_pair_batch (derivation in PERF.md).
# FLOW_LIVE_PLANES: the f32 planes of the finest pyramid level that
# farneback_flow holds a pair at its peak, measured with
# torch.cuda.max_memory_allocated at 1080x1920 with 16 pairs: 46.5 with the
# levels built by eager ops (chip_smoke.py phase 3), 24.00 with the pyramid
# kernel (chip_smoke.py pyramid).  The constant stays 48, above both; on an
# 80 GB card the cap of 16 pairs binds up to 2160x3840 either way.
# BACKBONE_PEAK_BYTES: the backbones' peak, weights included, over 172
# images in f32 (2.86 GB measured, chip_smoke.py phase 6), rounded up; the
# rest of the card is the flow's budget.  Both checks fail the chip run if
# a measurement exceeds its constant.  The CPU has no such limit and takes
# a fixed budget.
FLOW_LIVE_PLANES = 48
BACKBONE_PEAK_BYTES = 3e9
CPU_FLOW_BUDGET = 8.5e9
MAX_PAIR_BATCH = 16  # the JAX package's cap, so both send a video down the same path
NETWORKS = ("resnet50", "vit")


def prev_frame_runs(n_frames, n_pairs, start: int, stop: int) -> list[tuple[int, int]]:
    """Row ranges of the concatenated frames that hold the first frames of
    the flat pairs ``start..stop-1``: a pair's first frame is its video's
    sampled frame of the same index (the reference's sampling)."""
    runs = []
    f0 = p0 = 0
    for nf, npair in zip(n_frames, n_pairs):
        lo, hi = max(start, p0), min(stop, p0 + npair)
        if lo < hi:
            runs.append((f0 + lo - p0, f0 + hi - p0))
        f0, p0 = f0 + nf, p0 + npair
    return runs


def pair_chunks(n_pairs: int, chunk: int) -> list[tuple[int, int]]:
    """(start, stop) of each chunk of ``chunk`` pairs over ``n_pairs`` pairs
    (``chunk`` 0: one chunk); none for no pairs.  The pair walks of the
    programs and of the callers that chunk pairs themselves take theirs
    here."""
    step = chunk or max(n_pairs, 1)
    return [(s, min(s + step, n_pairs)) for s in range(0, n_pairs, step)]


def is_prefix_view(prev: np.ndarray, frames: np.ndarray) -> bool:
    """Whether ``prev`` is the first rows of ``frames`` (a view of the same
    buffer from its start), so uploading frames uploads prev too."""
    return prev is frames or (
        len(prev) <= len(frames) and prev.shape[1:] == frames.shape[1:]
        and prev.strides == frames.strides and prev.dtype == frames.dtype
        and prev.__array_interface__["data"][0] == frames.__array_interface__["data"][0]
    )


def take_rows(x: torch.Tensor, runs) -> torch.Tensor:
    """The rows of ``x`` in ``runs``: a view for one run, a copy for more."""
    if len(runs) == 1:
        return x[runs[0][0] : runs[0][1]]
    return torch.cat([x[a:b] for a, b in runs])


class FeatureExtractor:
    """Backbones on one device plus the per-video programs.

    Parameters
    ----------
    resnet_state, vit_state: torch state dicts with torchvision / DINO names
        (checkpoints as they are, or ``models.porters.*_from_jax`` output).
    dtype: backbone compute type: bf16 for speed, f32 for strict parity (f32
        also turns TF32 off for matmuls and cuDNN).
    vit_depth: 12 for DINO ViT-B/16; tests use 2.
    device: defaults to CUDA and raises without it; pass "cpu" for the CPU.
    """

    def __init__(self, resnet_state, vit_state, dtype: torch.dtype = torch.float32,
                 vit_depth: int = 12, device=None):
        self.device = resolve_device(device)
        self.dtype = dtype
        if dtype == torch.float32:
            set_strict_f32()
        self.resnet = ResNet50()
        self.resnet.load_state_dict(resnet_state)
        self.vit = ViT(depth=vit_depth)
        self.vit.load_state_dict(vit_state)
        for net in (self.resnet, self.vit):
            net.to(device=self.device, dtype=dtype).eval()
        if self.device.type == "cuda":
            total = torch.cuda.get_device_properties(self.device).total_memory
            self.flow_budget = total - BACKBONE_PEAK_BYTES
        else:
            self.flow_budget = CPU_FLOW_BUDGET

    def max_pair_batch(self, h: int, w: int) -> int:
        """Most pairs the flow stage takes at once at (h, w): the flow's
        budget over its live planes a pair, capped at 16."""
        per_pair = h * w * 4 * FLOW_LIVE_PLANES
        return max(1, min(MAX_PAIR_BATCH, int(self.flow_budget // per_pair)))

    # ---------------------------------------------------------------- stages
    def _backbone_inputs(self, bgr_u8: torch.Tensor, resize: bool, networks=NETWORKS):
        """(B, H, W, 3) uint8 BGR -> ResNet and ViT inputs (B, 3, 224, 224);
        None for a network not in ``networks``."""
        with span("prep"):
            rgb = bgr_u8.flip(-1).permute(0, 3, 1, 2).to(torch.float32) / 255.0

            def sized(method: str) -> torch.Tensor:
                if resize and tuple(rgb.shape[-2:]) != (224, 224):
                    return quantize_u8_levels(resize_hw(rgb, (224, 224), method, antialias=True))
                return rgb

            x_rn = resnet_preprocess(sized("linear")).to(self.dtype) if "resnet50" in networks else None
            x_vit = sized("lanczos3").to(self.dtype) if "vit" in networks else None
            return x_rn, x_vit

    @staticmethod
    def _fragments(prev: torch.Tensor, nxt: torch.Tensor):
        """(P, H, W, 3) uint8 pairs -> ori and merged fragments (P, 224, 224, 3)."""
        with span("fragments"):
            residual = absdiff(nxt, prev)
            ids = top_patch_indices(patch_scores(residual))
            diff_frag = gather_fragment(residual, ids)
            ori_frag = gather_fragment(prev, ids)
            gray_prev, gray_next = bgr_to_gray(prev), bgr_to_gray(nxt)
            with span("flow"):
                flow = farneback_flow(gray_prev, gray_next, **FARNEBACK_PARAMS)
            flow_img = flow_to_bgr(flow)
            flow_frag = gather_fragment(flow_img, top_patch_indices(patch_scores(flow_img)))
            return ori_frag, merge_fragments(diff_frag, flow_frag)

    def _backbones(self, x_rn: torch.Tensor | None, x_vit: torch.Tensor | None):
        """-> ResNet layer stack (B, 13120), ResNet pool (B, 2051) and ViT
        stats (B, 2304), f32; a network whose input is None is not run and
        gives None."""
        stack = pool = vit = None
        if x_rn is not None:
            with span("resnet"):
                taps = self.resnet(x_rn)
            with span("aggregate"):
                stack, pool = layer_stack_feature(taps), resnet_pool_feature(taps["avgpool"])
        if x_vit is not None:
            with span("vit"):
                vit = self.vit(x_vit)
        return stack, pool, vit

    @staticmethod
    def _fragment_rows(stack, pool, vit, p: int):
        """Backbone rows of p ori then p merged fragments -> frag_resnet
        (p, 15171) and frag_vit (p, 4608); None where the rows are None."""
        frag_rn = None if stack is None else torch.cat([stack[:p], pool[p:]], dim=-1)
        frag_vit = None if vit is None else torch.cat([vit[:p], vit[p:]], dim=-1)
        return frag_rn, frag_vit

    # -------------------------------------------------------------- programs
    def _videos_vec(self, frames, pairs, n_frames, n_pairs, chunk: int) -> torch.Tensor:
        """V videos -> (V, 35203) f32 on the device.

        ``frames``: the videos' sampled frames concatenated, (sum F, H, W, 3)
        uint8 BGR; ``pairs(start, stop)`` gives the BGR (prev, next) of the
        flat pairs ``start..stop-1``.  The flow stage runs over the flat
        pair axis in chunks of ``chunk`` pairs (0: one chunk); each backbone
        sees ONE batch of sum(F) + 2 sum(P) images.  A video with no pairs
        gets NaN in its 19,779 fragment entries, as in the JAX package.
        """
        f, p = sum(n_frames), sum(n_pairs)
        ori, merged = [], []
        for s, e in pair_chunks(p, chunk):
            o, m = self._fragments(*pairs(s, e))
            ori.append(o)
            merged.append(m)
        x_rn, x_vit = self._backbone_inputs(frames, resize=True)
        if p:  # with no pairs the backbones see the frames alone
            x_rn_p, x_vit_p = self._backbone_inputs(torch.cat(ori + merged), resize=False)
            x_rn, x_vit = torch.cat([x_rn, x_rn_p]), torch.cat([x_vit, x_vit_p])
        stack, pool, vit = self._backbones(x_rn, x_vit)
        # a video with no pairs has empty fragment rows, whose means are NaN
        # (the JAX package's masked means divide by a count of 0)
        with span("aggregate"):
            frag_rn, frag_vit = self._fragment_rows(stack[f:], pool[f:], vit[f:], p)
            segments = zip(stack[:f].split(n_frames), vit[:f].split(n_frames),
                           frag_rn.split(n_pairs), frag_vit.split(n_pairs))
            return torch.stack([torch.cat([x.mean(0) for x in seg]) for seg in segments])

    def _pair_rows(self, pairs, n_pairs: int, chunk: int, networks=NETWORKS):
        """The pair walk: for each chunk of ``chunk`` pairs, fragments, then
        the backbones over its ori and merged fragments; yields the chunk's
        (frag_resnet, frag_vit) rows from inside its ``aggregate`` span, so
        what the caller does with them is aggregation too."""
        for s, e in pair_chunks(n_pairs, chunk):
            ori, merged = self._fragments(*pairs(s, e))
            x_rn, x_vit = self._backbone_inputs(torch.cat([ori, merged]), False, networks)
            rows = self._backbones(x_rn, x_vit)
            with span("aggregate"):
                yield self._fragment_rows(*rows, len(ori))

    def _video_vec(self, frames, pairs, n_pairs: int) -> torch.Tensor:
        """One video -> (35203,).  With at most ``max_pair_batch`` pairs, one
        backbone batch through :meth:`_videos_vec`; with more, the frames'
        backbone batch once, then the pair walk, the pairs' rows summed on
        the device."""
        chunk = self.max_pair_batch(frames.shape[1], frames.shape[2])
        if n_pairs <= chunk:
            return self._videos_vec(frames, pairs, [len(frames)], [n_pairs], 0)[0]
        stack, _, vit = self._backbones(*self._backbone_inputs(frames, resize=True))
        sum_rn = sum_vit = 0.0
        for frag_rn, frag_vit in self._pair_rows(pairs, n_pairs, chunk):
            sum_rn = sum_rn + frag_rn.sum(0)
            sum_vit = sum_vit + frag_vit.sum(0)
        with span("aggregate"):
            return torch.cat([stack.mean(0), vit.mean(0), sum_rn / n_pairs, sum_vit / n_pairs])

    # ----------------------------------------------------------------- input
    def upload(self, arrays) -> torch.Tensor:
        """Concatenate uint8 stacks along their first axis into one host
        buffer and copy it to the device without blocking.  On CUDA the
        buffer is pinned: PyTorch's host allocator keeps the block until the
        copy is done, so the caller may drop it at once."""
        arrays = [np.asarray(a) for a in arrays]
        if any(a.dtype != np.uint8 for a in arrays):
            raise ValueError("frame stacks must be uint8")
        with span("upload"):
            host = torch.empty((sum(len(a) for a in arrays), *arrays[0].shape[1:]), dtype=torch.uint8,
                               pin_memory=self.device.type == "cuda")
            np.concatenate(arrays, out=host.numpy())
            return host.to(self.device, non_blocking=True)

    def upload_bgr(self, frames_bgr_u8, prev_bgr_u8, next_bgr_u8):
        """Three BGR stacks -> (frames, prev, nxt) on the device.  Where prev
        is a prefix view of frames (``io.video.decode_video_inputs`` gives
        one), frames go up once and prev is their first rows on the device."""
        f, p = np.asarray(frames_bgr_u8), np.asarray(prev_bgr_u8)
        frames = self.upload([f])
        if is_prefix_view(p, f):
            prev = frames[: len(p)]
        else:
            prev = self.upload([p])
        return frames, prev, self.upload([next_bgr_u8])

    def _i420_inputs(self, frames_i420_list, next_i420_list, h: int, w: int):
        """Packed I420 stacks of videos of one resolution -> their BGR
        frames on the device and ``pairs(start, stop)`` over the flat pairs.
        Each list goes up as one buffer (1.5 bytes a pixel) and is converted
        on the device, bit-identical to the host converter: the frames here,
        the pairs' second frames a chunk at a time.  A pair's first frame is
        its video's sampled frame of the same index, a row of the frames."""
        n_frames = [len(a) for a in frames_i420_list]
        n_pairs = [len(a) for a in next_i420_list]
        fbuf, nbuf = self.upload(frames_i420_list), self.upload(next_i420_list)
        with span("colorspace"):
            frames = yuv420_to_bgr(*unpack_i420(fbuf, h, w))

        def pairs(start: int, stop: int):
            prev = take_rows(frames, prev_frame_runs(n_frames, n_pairs, start, stop))
            with span("colorspace"):
                return prev, yuv420_to_bgr(*unpack_i420(nbuf[start:stop], h, w))
        return frames, pairs

    # ------------------------------------------------------------ public API
    @torch.inference_mode()
    def video_feature_async_i420(self, frames_i420, next_i420, h: int, w: int, bucket: int = 8) -> torch.Tensor:
        """Packed I420 stacks (F, H*W*3/2) and (P, H*W*3/2) uint8 -> the
        (35203,) f32 vector on the device, enqueued without waiting for it.
        ``bucket``, the JAX package's padding of the counts, is accepted and
        ignored: the port runs each video at its own counts.

        The two stacks go up once (1.5 bytes a pixel) and are converted to
        BGR on the device, bit-identical to the host converter.  A video
        with more pairs than ``max_pair_batch`` takes the chunked path.
        """
        with span("enqueue"):
            frames, pairs = self._i420_inputs([frames_i420], [next_i420], h, w)
            return self._video_vec(frames, pairs, len(next_i420))

    @torch.inference_mode()
    def video_feature_async(self, frames_bgr_u8, prev_bgr_u8, next_bgr_u8, bucket: int = 8) -> torch.Tensor:
        """BGR stacks (F, H, W, 3), (P, H, W, 3), (P, H, W, 3) uint8 -> the
        (35203,) f32 vector on the device, enqueued without waiting for it.
        ``bucket`` is accepted and ignored, as in the I420 program.

        The stacks go up through pinned memory without blocking, frames once
        when prev is a prefix view of them (3 bytes a pixel).  A video with
        more pairs than ``max_pair_batch`` takes the chunked path, as the
        I420 program does.
        """
        with span("enqueue"):
            frames, prev, nxt = self.upload_bgr(frames_bgr_u8, prev_bgr_u8, next_bgr_u8)
            if len(prev) != len(nxt):
                raise ValueError(f"prev and next must pair up, got {len(prev)} and {len(nxt)} frames")
            return self._video_vec(frames, lambda s, e: (prev[s:e], nxt[s:e]), len(nxt))

    def video_feature_async_yuv(self, frames_yuv, next_yuv, bucket: int = 8) -> torch.Tensor:
        """(y, u, v) plane stacks, y (B, H, W) and u, v (B, H/2, W/2) uint8,
        of the sampled frames and of the pairs' second frames -> packed
        I420 -> :meth:`video_feature_async_i420` (``bucket`` ignored)."""
        h, w = np.asarray(frames_yuv[0]).shape[1:3]
        return self.video_feature_async_i420(pack_i420(*frames_yuv), pack_i420(*next_yuv), h, w)

    @torch.inference_mode()
    def video_features_batch_i420(self, frames_i420_list, next_i420_list, h: int, w: int,
                                  bucket: int = 8, chunk: int | None = None) -> torch.Tensor:
        """Many videos of one resolution -> (V, 35203) f32 on the device,
        enqueued without waiting for it.

        Each video keeps its own frame and pair counts: the rows are
        concatenated ragged (two uploads for the whole batch) and each
        video's means are over its own rows.  The flow runs over the flat
        pair axis in chunks of ``chunk`` pairs: ``max_pair_batch(h, w)`` by
        default, 0 for one chunk.  ``bucket`` is accepted and ignored: no
        video is padded.
        """
        with span("enqueue"):
            frames, pairs = self._i420_inputs(frames_i420_list, next_i420_list, h, w)
            if chunk is None:
                chunk = self.max_pair_batch(h, w)
            return self._videos_vec(frames, pairs, [len(a) for a in frames_i420_list],
                                    [len(a) for a in next_i420_list], chunk)

    @torch.inference_mode()
    def frame_features_dev(self, frames: torch.Tensor, networks=NETWORKS):
        """(F, H, W, 3) uint8 BGR on the device -> ResNet layer stack
        (F, 13120) and ViT stats (F, 2304), f32 on the device, not fetched.
        The frames are resized and quantised as in the video programs.  A
        network not in ``networks`` is not run and gives None."""
        with span("enqueue"):
            stack, _, vit = self._backbones(*self._backbone_inputs(frames, True, networks))
            return stack, vit

    @torch.inference_mode()
    def pair_features_dev(self, prev: torch.Tensor, nxt: torch.Tensor, networks=NETWORKS):
        """(P, H, W, 3) uint8 BGR pairs on the device -> frag_resnet
        (P, 15171) and frag_vit (P, 4608), f32 on the device, not fetched;
        the pair walk takes ``max_pair_batch`` pairs at a time.  A network
        not in ``networks`` is not run and gives None."""
        with span("enqueue"):
            chunk = self.max_pair_batch(prev.shape[1], prev.shape[2])
            rows = list(self._pair_rows(lambda s, e: (prev[s:e], nxt[s:e]), len(prev), chunk, networks))
            with span("aggregate"):
                return tuple(None if parts[0] is None else torch.cat(parts) for parts in zip(*rows))

    def frame_features(self, frames_bgr_u8) -> tuple[np.ndarray, np.ndarray]:
        """(F, H, W, 3) uint8 BGR -> resnet stack (F, 13120), ViT stats
        (F, 2304), f32 numpy."""
        stack, vit = self.frame_features_dev(self.upload([frames_bgr_u8]))
        return stack.cpu().numpy(), vit.cpu().numpy()

    def pair_features(self, prev_bgr_u8, next_bgr_u8) -> tuple[np.ndarray, np.ndarray]:
        """(P, H, W, 3) uint8 BGR pairs -> frag_resnet (P, 15171), frag_vit
        (P, 4608), f32 numpy."""
        frag_rn, frag_vit = self.pair_features_dev(self.upload([prev_bgr_u8]), self.upload([next_bgr_u8]))
        return frag_rn.cpu().numpy(), frag_vit.cpu().numpy()

    def video_feature_i420(self, frames_i420, next_i420, h: int, w: int) -> np.ndarray:
        """``video_feature_async_i420`` and the fetch -> (35203,) f32 numpy."""
        return self.video_feature_async_i420(frames_i420, next_i420, h, w).cpu().numpy()

    def video_feature(self, frames_bgr_u8, prev_bgr_u8, next_bgr_u8) -> np.ndarray:
        """``video_feature_async`` and the fetch -> (35203,) f32 numpy."""
        vec = self.video_feature_async(frames_bgr_u8, prev_bgr_u8, next_bgr_u8).cpu().numpy()
        assert vec.shape == (TOTAL_FEATURE_DIM,)
        return vec
