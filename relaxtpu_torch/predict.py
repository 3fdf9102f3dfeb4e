"""MOS prediction (counterpart of ``relaxtpu/predict.py``).

decode -> the 35,203 vector on the device -> imputer/scaler -> MLP -> MOS
(rescaled to 1-5 for konvid_1k / youtube_ugc when not fine-tuned).
``enqueue_file`` stops before the fetch, so a serving loop decodes the next
video while the device computes this one.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from relaxtpu_torch.data.mos import pred_0_100_to_1_5
from relaxtpu_torch.features.pipeline import FeatureExtractor
from relaxtpu_torch.io.video import decode_video
from relaxtpu_torch.model.mlp import Mlp
from relaxtpu_torch.model.scalers import FeatureScaler

log = logging.getLogger("relaxtpu_torch.predict")


class VideoQualityPredictor:
    """Feature extractor + scaler + MLP head on the extractor's device.

    ``mlp_state``: a state dict of ``model.mlp.Mlp`` (reference ``.pth``
    after ``fix_state_dict``, or ``models.porters.mlp_from_jax`` output).
    The head always runs in f32.
    """

    def __init__(self, extractor: FeatureExtractor, mlp_state, scaler: FeatureScaler,
                 video_type: str = "konvid_1k", is_finetune: bool = False):
        self.extractor = extractor
        self.scaler = scaler
        self.video_type = video_type
        self.is_finetune = is_finetune
        self.mlp = Mlp(use_bn="bn1.weight" in mlp_state)
        self.mlp.load_state_dict(mlp_state)
        self.mlp.to(extractor.device).eval()

    @torch.inference_mode()
    def predict_feature(self, feature_35203: np.ndarray | torch.Tensor) -> float:
        """The (35203,) vector, numpy or a tensor on any device (a pending
        one is fetched here) -> MOS."""
        if isinstance(feature_35203, torch.Tensor):
            feature_35203 = feature_35203.cpu().numpy()
        x = self.scaler.transform(feature_35203.reshape(1, -1)).astype(np.float32)
        pred = float(self.mlp(torch.from_numpy(x).to(self.extractor.device)).reshape(-1)[0])
        if self.is_finetune:
            return pred
        if self.video_type in ("youtube_ugc", "konvid_1k"):
            return float(pred_0_100_to_1_5(pred))
        return pred

    def predict_arrays(self, frames, prev, nxt) -> float:
        """BGR stacks (F, H, W, 3), (P, H, W, 3), (P, H, W, 3) uint8 -> MOS:
        the BGR program and the fetch."""
        return self.predict_feature(self.extractor.video_feature_async(frames, prev, nxt))

    def enqueue_file(self, path: str, framerate: float | None = None,
                     width: int | None = None, height: int | None = None,
                     ingest: str = "bgr") -> torch.Tensor:
        """Decode ``path`` on the host and enqueue its program without
        waiting -> the pending (35203,) vector on the extractor's device
        (score it with :meth:`predict_feature`).

        ``ingest`` (``io.video.decode_video``): for a container, ``bgr``
        converts on the host and uploads BGR (3 bytes a pixel), ``yuv``
        uploads the decoder's I420 (1.5 bytes a pixel) and converts on the
        device, ``auto`` takes I420 where the decoder gives it and BGR
        otherwise.  A raw ``.yuv`` file gives the JAX package's frames in
        every mode: the native rawvideo decoder's BGR where that loads, else
        the numpy reader's I420, which the device converts bit-identically
        to the JAX package's numpy converter.  The choice is decode-side
        only: a device fault raises at the fetch, with no retry.
        """
        kind, data = decode_video(path, framerate, width, height, ingest)
        log.info("decoded %d frames, %d pairs from %s (%s ingest)",
                 len(data[0]), len(data[1 if kind == "i420" else 2]), path, kind)
        if kind == "i420":
            return self.extractor.video_feature_async_i420(*data)
        return self.extractor.video_feature_async(*data)

    def predict_file(self, path: str, framerate: float | None = None,
                     width: int | None = None, height: int | None = None,
                     ingest: str = "bgr") -> float:
        """File -> MOS: :meth:`enqueue_file` and the fetch."""
        return self.predict_feature(self.enqueue_file(path, framerate, width, height, ingest))


class FastVQAPredictor:
    """FAST-VQA (arXiv 2207.02595, FAST-B) on the extractor's device: a
    video's clips and grid mini-patch fragments -> its quality score, the
    mean of the head's per-position scores (the model's own scale).

    ``extractor``: a ``features.fastvqa.FastVQAExtractor``.  The fragments'
    offsets are drawn for each video from ``seed``'s generator, as FAST-VQA
    draws them at test time.  ``enqueue_*`` stop before the fetch; ``finish``
    fetches (the answer vector and the score).
    """

    def __init__(self, extractor, seed: int = 0, clip_len: int | None = None):
        from relaxtpu_torch.features.fastvqa import CLIP_LEN

        self.extractor = extractor
        self.rng = np.random.default_rng(seed)
        self.clip_len = clip_len or CLIP_LEN  # frames a clip (tests take fewer)

    def offsets(self, h: int, w: int) -> np.ndarray:
        from relaxtpu_torch.features.fastvqa import CLIPS, draw_offsets

        return draw_offsets(self.rng, h, w, CLIPS)

    def finish(self, handle) -> tuple:
        return self.extractor.finish(handle)

    def enqueue_arrays(self, frames_bgr):
        """Every raw frame of a video, BGR (N, H, W, 3) uint8 -> the pending answer."""
        from relaxtpu_torch.features.fastvqa import clip_indices

        frames = np.asarray(frames_bgr)
        clips = [frames[idx] for idx in clip_indices(len(frames), clip_len=self.clip_len)]
        return self.extractor.enqueue_bgr(clips, self.offsets(*frames.shape[1:3]))

    def predict_arrays(self, frames_bgr) -> float:
        """Every raw frame of a video, BGR (N, H, W, 3) uint8 -> the score."""
        return self.finish(self.enqueue_arrays(frames_bgr))[1]

    def enqueue_file(self, path: str, framerate: float | None = None,
                     width: int | None = None, height: int | None = None):
        """Decode the clips' frames of ``path`` on the host and enqueue the
        program without waiting -> the pending answer (``finish``).  A raw
        ``.yuv`` file (``width`` and ``height`` given) goes up as I420 and is
        converted on the device; a container is decoded to BGR."""
        from relaxtpu_torch.features.fastvqa import clip_indices
        from relaxtpu_torch.io.video import _read_video_frames, _yuv420_frame_count, probe_video, read_i420_frames

        if path.endswith(".yuv"):
            if width is None or height is None:
                raise ValueError(f"{path}: a raw .yuv file needs its width and height")
            w, h = int(width), int(height)
            n = _yuv420_frame_count(path, w, h)
            clips = [read_i420_frames(path, w, h, idx) for idx in clip_indices(n, clip_len=self.clip_len)]
            return self.extractor.enqueue_i420(clips, h, w, self.offsets(h, w))
        idx = clip_indices(probe_video(path)["nb_frames"], clip_len=self.clip_len)
        flat = sorted({i for c in idx for i in c})
        lookup = dict(zip(flat, _read_video_frames(path, flat)))
        clips = [np.stack([lookup[i] for i in c]) for c in idx]
        log.info("decoded %d frames of %s into %d clips", len(lookup), path, len(clips))
        return self.extractor.enqueue_bgr(clips, self.offsets(*clips[0].shape[1:3]))

    def predict_file(self, path: str, framerate: float | None = None,
                     width: int | None = None, height: int | None = None) -> float:
        """File -> score: :meth:`enqueue_file` and the fetch."""
        return self.finish(self.enqueue_file(path, framerate, width, height))[1]
