"""Sharded feature extraction over a mesh of ranks (counterpart of
``relaxtpu/parallel/eval.py``).

Three regimes, all over the mesh's data axis:

- :meth:`ShardedVideoEvaluator.run`: videos dealt round-robin to the data
  indices (``shard_videos``); each rank streams its share through the
  single-video programs, the dispatch-ahead queue of the JAX package's
  one-device branch, and the rows are all-gathered once at the end.
  Ranks that share a data index (the model axis) compute the same videos,
  as JAX's replicated backbones do.
- :meth:`~ShardedVideoEvaluator.videos_batch_feature_i420`: the batched
  multi-video program with the video axis split into contiguous shares.
- :meth:`~ShardedVideoEvaluator.video_feature`: one video's frame and pair
  axes split into contiguous blocks.
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
from typing import Callable, Iterable

import numpy as np
import torch

from relaxtpu_torch.features.layout import FRAG_RESNET_DIM, FRAG_VIT_DIM, TOTAL_FEATURE_DIM
from relaxtpu_torch.features.pipeline import FeatureExtractor, pair_chunks
from relaxtpu_torch.parallel.distributed import all_gather_rows, allgather_video_features, shard_videos
from relaxtpu_torch.parallel.mesh import Mesh


class ShardedVideoEvaluator:
    """Videos -> 35,203-dim vectors, sharded over a mesh of ranks.

    ``decode_workers`` host threads decode ahead of the device.  JAX's
    ``videos_per_device`` has no counterpart: in ``run`` each rank streams
    its videos one at a time through the single-video programs."""

    def __init__(self, extractor: FeatureExtractor, mesh: Mesh, decode_workers: int = 4):
        self.fx = extractor
        self.mesh = mesh
        self.decode_workers = decode_workers

    # ------------------------------------------------------------ datasets
    def run(self, videos: Iterable, decode_fn: Callable, on_result: Callable[[int, np.ndarray], None] | None = None
            ) -> list[np.ndarray]:
        """Every video's vector, in input order, on every rank.

        ``decode_fn(video)`` gives BGR ``(frames, prev, nxt)`` or the I420
        form ``("i420", frames_i420, next_i420, h, w)``.  This rank decodes
        and computes its data index's round-robin share, with at most two
        vectors enqueued on the device while later videos decode; then the
        rows are all-gathered over the data group.  ``on_result(i, vec)``
        fires on the computing rank for its own videos, in input order among
        them.
        """
        videos = list(videos)
        mine = shard_videos(range(len(videos)), self.mesh.data_index, self.mesh.shape["data"])
        rows = self._stream([videos[i] for i in mine], decode_fn,
                            on_result and (lambda k, vec: on_result(mine[k], vec)))
        vecs = np.stack(rows) if rows else np.zeros((0, TOTAL_FEATURE_DIM), np.float32)
        mat = allgather_video_features(np.asarray(mine, np.int64), vecs, len(videos), self.mesh.data_group)
        return list(mat)

    run_distributed = run  # JAX's multi-process entry (relaxtpu/parallel/eval.py:130)

    def _stream(self, videos: list, decode_fn: Callable, on_result) -> list[np.ndarray]:
        """The one-device streaming path: decodes on host threads (at most
        ``decode_workers`` + 1 waiting), vectors enqueued on the device,
        two in flight, fetched in order."""
        out: list[np.ndarray] = []
        pending = collections.deque()  # device vectors, in order

        def drain(limit: int) -> None:
            while len(pending) > limit:
                out.append(pending.popleft().cpu().numpy())
                if on_result:
                    on_result(len(out) - 1, out[-1])

        def enqueue(res) -> None:
            if isinstance(res[0], str) and res[0] == "i420":
                pending.append(self.fx.video_feature_async_i420(*res[1:]))
            else:
                pending.append(self.fx.video_feature_async(*res))
            drain(2)

        with cf.ThreadPoolExecutor(max_workers=self.decode_workers) as pool:
            decoding = collections.deque()
            for v in videos:
                decoding.append(pool.submit(decode_fn, v))
                if len(decoding) > self.decode_workers:
                    enqueue(decoding.popleft().result())
            while decoding:
                enqueue(decoding.popleft().result())
            drain(0)
        return out

    # -------------------------------------------------------------- batches
    def videos_batch_feature_i420(self, frames_i420_list, next_i420_list, h: int, w: int,
                                  bucket: int = 8) -> torch.Tensor:
        """(V, 35203) f32 on the host, the same on every rank: the batched
        multi-video program with the video list split into contiguous
        shares over the data axis.  The list is padded to a multiple of the
        data axis with copies of the last video, whose rows are dropped.
        ``bucket`` is accepted and ignored: no video's counts are padded."""
        n, i = self.mesh.shape["data"], self.mesh.data_index
        v_real = len(frames_i420_list)
        pad = (-v_real) % n
        frames = list(frames_i420_list) + [frames_i420_list[-1]] * pad
        nxt = list(next_i420_list) + [next_i420_list[-1]] * pad
        k = len(frames) // n
        vecs = self.fx.video_features_batch_i420(frames[i * k : (i + 1) * k], nxt[i * k : (i + 1) * k], h, w)
        return all_gather_rows(vecs, self.mesh.data_group).cpu()[:v_real]

    # --------------------------------------------------------------- frames
    def _gather_blocks(self, part: torch.Tensor, real: int) -> torch.Tensor:
        return all_gather_rows(part, self.mesh.data_group)[:real]

    @torch.inference_mode()
    def video_feature(self, frames: np.ndarray, prev: np.ndarray, nxt: np.ndarray) -> np.ndarray:
        """One video's (35203,) vector with its frame and pair axes split
        over the data axis: each rank takes a contiguous block of the frames
        (the axis padded with copies of the last frame) and of each chunk of
        pairs (``max_pair_batch`` pairs a rank a chunk), the per-frame and
        per-pair rows are gathered, and the means are taken over the real
        rows in the original order.  A video with no pairs gets NaN in its
        fragment entries, as ``FeatureExtractor``'s programs give it."""
        n, i = self.mesh.shape["data"], self.mesh.data_index

        def block(arr: np.ndarray) -> tuple[torch.Tensor, int]:
            real, pad = len(arr), (-len(arr)) % n
            if pad:
                arr = np.concatenate([arr, np.repeat(arr[-1:], pad, axis=0)], axis=0)
            k = len(arr) // n
            return self.fx.upload([arr[i * k : (i + 1) * k]]), real

        f_dev, f_real = block(np.asarray(frames))
        stack, vit = self.fx.frame_features_dev(f_dev)
        stack, vit = self._gather_blocks(stack, f_real), self._gather_blocks(vit, f_real)
        prev, nxt = np.asarray(prev), np.asarray(nxt)
        step = self.fx.max_pair_batch(prev.shape[1], prev.shape[2]) * n
        frag_rn, frag_vit = [stack.new_empty((0, FRAG_RESNET_DIM))], [vit.new_empty((0, FRAG_VIT_DIM))]
        for s, e in pair_chunks(len(prev), step):
            p_dev, p_real = block(prev[s:e])
            n_dev, _ = block(nxt[s:e])
            rn, vt = self.fx.pair_features_dev(p_dev, n_dev)
            frag_rn.append(self._gather_blocks(rn, p_real))
            frag_vit.append(self._gather_blocks(vt, p_real))
        parts = [stack, vit, torch.cat(frag_rn), torch.cat(frag_vit)]
        return torch.cat([x.mean(0) for x in parts]).cpu().numpy()
