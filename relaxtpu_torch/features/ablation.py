"""Ablation feature modes: residual variants over pairs, single taps of frames.

Counterpart of ``relaxtpu/features/ablation.py:40-100``.  Each mode turns a
pair into one image and runs one network over it:

- ``frame_diff``         the whole residual image |next - prev|;
- ``optical_flow``       the whole Farneback flow image (kernels K1, K2);
- ``frame_diff_frag``    the residual's fragment alone (no original
                         fragment, no merge);
- ``optical_flow_frag``  the flow image's fragment alone.

Taps: ``network="vit"`` gives the ViT token stats (2304, kernel K3);
``resnet50`` gives ``pool`` (avgpool and its stats, 2051), ``last_layer``
(``layer4.2``'s channel means, 2048) or ``layer_stack`` (13120).
``features_from_images`` also serves the full-frame single-tap extraction.
Unlike the video programs, images that are not 224x224 are resized without
the 8-bit quantisation (``relaxtpu/features/ablation.py:71-75``).

Everything runs batched over pairs on the base extractor's device; PyTorch
runs eagerly, so there is no per-mode program to cache.
"""

from __future__ import annotations

import numpy as np
import torch

from relaxtpu_torch.features.aggregate import layer_stack_feature, resnet_pool_feature
from relaxtpu_torch.features.pipeline import FARNEBACK_PARAMS, NETWORKS, FeatureExtractor
from relaxtpu_torch.models.resnet import resnet_preprocess
from relaxtpu_torch.ops.colorspace import bgr_to_gray, flow_to_bgr
from relaxtpu_torch.ops.flow import farneback_flow
from relaxtpu_torch.ops.fragments import absdiff, gather_fragment, patch_scores, top_patch_indices
from relaxtpu_torch.ops.resize import resize_hw

RESIDUAL_MODES = ("frame_diff", "optical_flow", "frame_diff_frag", "optical_flow_frag", "merged_frag")
LAYERS = ("pool", "last_layer", "layer_stack")


class AblationExtractor:
    """Residual-variant and single-tap features on ``base``'s backbones."""

    def __init__(self, base: FeatureExtractor):
        self.base = base

    @staticmethod
    def _residual_image(mode: str, prev: torch.Tensor, nxt: torch.Tensor) -> torch.Tensor:
        if mode.startswith("frame_diff"):
            return absdiff(nxt, prev)
        flow = farneback_flow(bgr_to_gray(prev), bgr_to_gray(nxt), **FARNEBACK_PARAMS)
        return flow_to_bgr(flow)

    def _pair_images(self, mode: str, prev: torch.Tensor, nxt: torch.Tensor) -> torch.Tensor:
        img = self._residual_image(mode, prev, nxt)
        if mode.endswith("_frag"):
            img = gather_fragment(img, top_patch_indices(patch_scores(img)))
        return img

    @torch.inference_mode()
    def features_from_images(self, network: str, layer: str, imgs: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) uint8 BGR on the device -> (B, D) f32 features of one
        network, on the device.  Images that are not 224x224 are resized
        with antialias, ``linear`` for ResNet and ``lanczos3`` for the ViT,
        and not quantised."""
        if network not in NETWORKS or layer not in LAYERS:
            raise ValueError(f"network {network!r} / layer {layer!r}: expected one of {NETWORKS} / {LAYERS}")
        base = self.base
        rgb = imgs.flip(-1).permute(0, 3, 1, 2).to(torch.float32) / 255.0
        if tuple(rgb.shape[-2:]) != (224, 224):
            method = "linear" if network == "resnet50" else "lanczos3"
            rgb = resize_hw(rgb, (224, 224), method, antialias=True)
        if network == "vit":
            return base.vit(rgb.to(base.dtype))
        taps = base.resnet(resnet_preprocess(rgb).to(base.dtype))
        if layer == "pool":
            return resnet_pool_feature(taps["avgpool"])
        if layer == "last_layer":
            return taps["layer4.2"]
        return layer_stack_feature(taps)

    @torch.inference_mode()
    def pair_features_dev(self, mode: str, network: str, layer: str,
                          prev: torch.Tensor, nxt: torch.Tensor) -> torch.Tensor:
        """(P, H, W, 3) uint8 BGR pairs on the device -> (P, D) f32 ablation
        features on the device, all pairs in one batch (the caller chunks)."""
        if mode not in RESIDUAL_MODES or mode == "merged_frag":
            raise ValueError(f"mode {mode!r}: expected one of {RESIDUAL_MODES[:-1]} "
                             "(merged_frag is the full model's pair_features)")
        return self.features_from_images(network, layer, self._pair_images(mode, prev, nxt))

    def pair_features(self, mode: str, network: str, layer: str, prev, nxt) -> np.ndarray:
        """(P, H, W, 3) uint8 BGR pairs -> (P, D) f32 numpy."""
        up = self.base.upload
        return self.pair_features_dev(mode, network, layer, up([prev]), up([nxt])).cpu().numpy()
