"""The per-video feature pipeline: frames -> the 35,203-dim vector.

Counterpart of ``relaxtpu/features/pipeline.py:52-191`` (``_video_vec`` and
``_video_vec_i420``).  Per video, on the device:

- resize the sampled frames to 224x224 for the backbones (linear and
  lanczos3, both antialiased, quantised to 8-bit levels);
- per pair (a batch axis): absdiff, motion-ranked fragments, Farneback flow
  (kernels K1 and K2), flow image, flow fragment, merge;
- one ResNet-50 forward and one ViT forward over all F + 2P images
  (ViT attention is kernel K3);
- means over the rows into the frozen 35,203 layout.

PyTorch runs eagerly, so there is no shape bucketing: the means are plain
means over the real rows, which is what the JAX package's masked means over
its padded rows compute.
"""

from __future__ import annotations

import numpy as np
import torch

from relaxtpu_torch.device import resolve_device, set_strict_f32
from relaxtpu_torch.features.aggregate import layer_stack_feature, resnet_pool_feature
from relaxtpu_torch.features.layout import TOTAL_FEATURE_DIM
from relaxtpu_torch.models.resnet import ResNet50, resnet_preprocess
from relaxtpu_torch.models.vit import ViT
from relaxtpu_torch.ops.colorspace import bgr_to_gray, flow_to_bgr, unpack_i420, yuv420_to_bgr
from relaxtpu_torch.ops.flow import farneback_flow
from relaxtpu_torch.ops.fragments import (
    absdiff,
    gather_fragment,
    merge_fragments,
    patch_scores,
    top_patch_indices,
)
from relaxtpu_torch.ops.resize import quantize_u8_levels, resize_hw

FARNEBACK_PARAMS = dict(
    pyr_scale=0.5, levels=3, winsize=15, iterations=3, poly_n=5, poly_sigma=1.2
)


class FeatureExtractor:
    """Backbones on one device plus the per-video program.

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

    # ---------------------------------------------------------------- frames
    def _backbone_inputs(self, bgr_u8: torch.Tensor, resize: bool):
        """(B, H, W, 3) uint8 BGR -> ResNet and ViT inputs (B, 3, 224, 224)."""
        rgb = bgr_u8.flip(-1).permute(0, 3, 1, 2).to(torch.float32) / 255.0
        if resize and tuple(rgb.shape[-2:]) != (224, 224):
            rgb_rn = quantize_u8_levels(resize_hw(rgb, (224, 224), "linear", antialias=True))
            rgb_vit = quantize_u8_levels(resize_hw(rgb, (224, 224), "lanczos3", antialias=True))
        else:
            rgb_rn = rgb_vit = rgb
        return resnet_preprocess(rgb_rn).to(self.dtype), rgb_vit.to(self.dtype)

    # ----------------------------------------------------------------- pairs
    @staticmethod
    def _fragments(prev: torch.Tensor, nxt: torch.Tensor):
        """(P, H, W, 3) uint8 pairs -> ori and merged fragments (P, 224, 224, 3)."""
        residual = absdiff(nxt, prev)
        ids = top_patch_indices(patch_scores(residual))
        diff_frag = gather_fragment(residual, ids)
        ori_frag = gather_fragment(prev, ids)
        flow = farneback_flow(bgr_to_gray(prev), bgr_to_gray(nxt), **FARNEBACK_PARAMS)
        flow_img = flow_to_bgr(flow)
        flow_frag = gather_fragment(flow_img, top_patch_indices(patch_scores(flow_img)))
        return ori_frag, merge_fragments(diff_frag, flow_frag)

    # ----------------------------------------------------------------- video
    @torch.inference_mode()
    def _video_vec(self, frames: torch.Tensor, prev: torch.Tensor, nxt: torch.Tensor) -> torch.Tensor:
        """Device uint8 BGR stacks -> (35203,) f32 on the device.  The full
        frames and both fragment stacks go through each backbone as ONE
        batch of F + 2P images."""
        f, p = frames.shape[0], prev.shape[0]
        x_rn_f, x_vit_f = self._backbone_inputs(frames, resize=True)
        ori, merged = self._fragments(prev, nxt)
        x_rn_p, x_vit_p = self._backbone_inputs(torch.cat([ori, merged]), resize=False)
        taps = self.resnet(torch.cat([x_rn_f, x_rn_p]))
        stack_all = layer_stack_feature(taps)
        pool_all = resnet_pool_feature(taps["avgpool"])
        vit_all = self.vit(torch.cat([x_vit_f, x_vit_p]))
        frag_rn = torch.cat([stack_all[f : f + p], pool_all[f + p :]], dim=-1)
        frag_vit = torch.cat([vit_all[f : f + p], vit_all[f + p :]], dim=-1)
        return torch.cat(
            [stack_all[:f].mean(0), vit_all[:f].mean(0), frag_rn.mean(0), frag_vit.mean(0)]
        )

    def _to_device(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def video_feature(self, frames_bgr_u8, prev_bgr_u8, next_bgr_u8) -> np.ndarray:
        """(F, H, W, 3), (P, H, W, 3), (P, H, W, 3) uint8 BGR -> (35203,) f32."""
        vec = self._video_vec(
            self._to_device(frames_bgr_u8), self._to_device(prev_bgr_u8),
            self._to_device(next_bgr_u8),
        )
        out = vec.cpu().numpy()
        assert out.shape == (TOTAL_FEATURE_DIM,)
        return out

    def video_feature_i420(self, frames_i420, next_i420, h: int, w: int) -> np.ndarray:
        """Packed I420 stacks (F, H*W*3/2) and (P, H*W*3/2) uint8 -> (35203,).

        Uploads the two packed stacks (1.5 bytes a pixel) and converts to BGR
        on the device, bit-identical to the host converter.  The pairs' first
        frames are the sampled frames, so prev is a prefix of frames.
        """
        frames = yuv420_to_bgr(*unpack_i420(self._to_device(frames_i420), h, w))
        nxt = yuv420_to_bgr(*unpack_i420(self._to_device(next_i420), h, w))
        vec = self._video_vec(frames, frames[: nxt.shape[0]], nxt)
        return vec.cpu().numpy()
