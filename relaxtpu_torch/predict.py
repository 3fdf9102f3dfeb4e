"""Single-video MOS prediction (counterpart of ``relaxtpu/predict.py``).

decode -> the 35,203 vector on the device -> imputer/scaler -> MLP -> MOS
(rescaled to 1-5 for konvid_1k / youtube_ugc when not fine-tuned).
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from relaxtpu_torch.data.mos import pred_0_100_to_1_5
from relaxtpu_torch.features.pipeline import FeatureExtractor
from relaxtpu_torch.io.video import decode_video_inputs_i420
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
    def predict_feature(self, feature_35203: np.ndarray) -> float:
        x = self.scaler.transform(feature_35203.reshape(1, -1)).astype(np.float32)
        pred = float(self.mlp(torch.from_numpy(x).to(self.extractor.device)).reshape(-1)[0])
        if self.is_finetune:
            return pred
        if self.video_type in ("youtube_ugc", "konvid_1k"):
            return float(pred_0_100_to_1_5(pred))
        return pred

    def predict_file(self, path: str, framerate: float | None = None,
                     width: int | None = None, height: int | None = None) -> float:
        """Raw I420 ``.yuv`` file -> MOS.  The packed I420 stacks go to the
        device and are converted there (bit-identical to the host converter,
        so every ingest mode of the JAX package gives these frames for a
        ``.yuv`` file)."""
        fbuf, nbuf, h, w = decode_video_inputs_i420(path, framerate, width, height)
        log.info("decoded %d frames, %d pairs from %s", len(fbuf), len(nbuf), path)
        return self.predict_feature(self.extractor.video_feature_i420(fbuf, nbuf, h, w))
