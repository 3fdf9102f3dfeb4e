"""The plain reference of ReLaX-VQA scoring (arXiv 2407.11496) that decides
``correct``: packed I420 frames -> the 35,203-dim vector -> MOS.

Plain PyTorch and NumPy only: it imports neither JAX nor anything of the
program under test.  It takes the same seeded state dicts and the same host
I420 buffers as the program, and derives everything else itself.  It runs
in float32 with TF32 off, one block of pairs and images at a time, so that
it fits beside nothing else on the card once the program is freed.

``precision`` selects the control runs: ``"tf32"`` (TF32 on for every
matrix product and convolution, and the head's operands rounded to TF32)
and ``"fp8"`` (both operands of every backbone and head product rounded to
float8 e4m3 with a per-tensor scale, products accumulated in float32 or,
in the head, float64).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from . import models, ops

PAIR_BLOCK = 16  # pairs a flow call; images a backbone call: F, then 2 x a block of pairs
FP8_MAX = 448.0
RESCALED = ("konvid_1k", "youtube_ugc")  # datasets whose MOS is served on 1-5
STACK_DIM, POOL_DIM, VIT_DIM = 13120, 2051, 2304
FRAG_DIM = STACK_DIM + POOL_DIM + 2 * VIT_DIM
MERGED_POOL = slice(2 * STACK_DIM + VIT_DIM, 2 * STACK_DIM + VIT_DIM + POOL_DIM)
MERGED_VIT = slice(2 * STACK_DIM + 2 * VIT_DIM + POOL_DIM, 2 * STACK_DIM + 3 * VIT_DIM + POOL_DIM)


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under a per-tensor scale (amax -> 448), in t's type."""
    s = t.detach().abs().amax().clamp_min(1e-12) / FP8_MAX
    return (t / s).to(torch.float32).to(torch.float8_e4m3fn).to(t.dtype) * s


def tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to TF32 (10 mantissa bits, to nearest), in t's type."""
    bits = t.detach().to(torch.float32).view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32).to(t.dtype)


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """TF32 on or off for matrix products and cuDNN convolutions, restored on exit."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class Reference:
    """The reference on ``device`` with float32 copies of the seeded weights."""

    def __init__(self, resnet_state: dict, vit_state: dict, head_state: dict, scaler: dict, vit_depth: int,
                 video_type: str, device, precision: str = "f32", slack: int = 0):
        if precision not in ("f32", "tf32", "fp8"):
            raise ValueError(f"precision is f32, tf32 or fp8, got {precision}")
        self.device = torch.device(device)

        def f32(sd):
            return {k: v.to(self.device, torch.float32) for k, v in sd.items() if v.is_floating_point()}

        self.rn, self.vit, self.head = f32(resnet_state), f32(vit_state), head_state
        self.scaler = {k: np.asarray(v, np.float64) for k, v in scaler.items()}
        self.depth, self.video_type, self.precision, self.slack = vit_depth, video_type, precision, slack
        self.quant = fp8 if precision == "fp8" else models._identity
        self.head_quant = {"fp8": fp8, "tf32": tf32}.get(precision, models._identity)
        stats = torch.tensor([models.IMAGENET_MEAN, models.IMAGENET_STD], dtype=torch.float32)
        self.mean, self.std = stats[..., None, None].to(self.device)

    def _backbones(self, bgr: torch.Tensor, resize: bool):
        """(B, H, W, 3) uint8 BGR -> layer stack (B, 13120), pool stats (B, 2051), ViT stats (B, 2304)."""
        rgb = bgr.flip(-1).permute(0, 3, 1, 2).to(torch.float32) / 255.0

        def sized(method):
            if resize and tuple(rgb.shape[-2:]) != (ops.FRAG, ops.FRAG):
                x = ops.resize_hw(rgb, (ops.FRAG, ops.FRAG), method, antialias=True)
                return torch.round(torch.clamp(x, 0.0, 1.0) * 255.0) / 255.0
            return rgb

        taps = models.resnet50_taps((sized("linear") - self.mean) / self.std, self.rn, self.quant)
        vit = models.vit_stats(sized("lanczos3"), self.vit, self.depth, self.quant)
        return models.layer_stack(taps), models.pool_stats(taps["avgpool"]), vit

    @torch.no_grad()
    def answer(self, frames_i420: np.ndarray, next_i420: np.ndarray, h: int, w: int) -> tuple:
        """Packed I420 stacks (F, H*W*3/2) and (P, H*W*3/2) of one video ->
        (the 35,203-dim vector, the swaps).

        The vector: the frame means of the ResNet layer stack and the ViT
        stats, then the pair means of [original-fragment stack |
        merged-fragment pool stats] and [original-fragment ViT |
        merged-fragment ViT].  The swaps: for every pair whose flow-image
        patch ranking has a swap within ``slack`` of the cut
        (``ops.near_swaps``), the change of the vector that each such swap
        makes.  A rounding-level change of the flow may make one, and the
        vector with it is as right as the one without."""
        with matmul_precision(self.precision == "tf32"):
            frames = ops.i420_to_bgr(torch.from_numpy(np.ascontiguousarray(frames_i420)).to(self.device), h, w)
            stack, _, vit = self._backbones(frames, resize=True)
            n_pairs = len(next_i420)
            rn_rows, vit_rows, alt_rows = [], [], []
            for s in range(0, n_pairs, PAIR_BLOCK):
                nxt = ops.i420_to_bgr(torch.from_numpy(np.ascontiguousarray(next_i420[s:s + PAIR_BLOCK])).to(self.device), h, w)
                p = len(nxt)
                ori, merged, alts = ops.fragments(frames[s:s + p], nxt, self.slack)
                st, pool, vt = self._backbones(torch.cat([ori, merged]), resize=False)
                rn_rows.append(torch.cat([st[:p], pool[p:]], dim=-1))
                vit_rows.append(torch.cat([vt[:p], vt[p:]], dim=-1))
                if alts:
                    _, pool_alt, vt_alt = self._backbones(torch.stack([a for _, a in alts]), resize=False)
                    alt_rows += [(s + q, pool_alt[j], vt_alt[j]) for j, (q, _) in enumerate(alts)]
            if not n_pairs:  # no pairs: the fragment entries are the mean of nothing
                nan = float("nan")
                vec = torch.cat([stack.mean(0), vit.mean(0), torch.full((FRAG_DIM,), nan, device=self.device)])
                return vec.cpu().numpy(), []
            rn, vt_all = torch.cat(rn_rows), torch.cat(vit_rows)
            vec = torch.cat([stack.mean(0), vit.mean(0), rn.mean(0), vt_all.mean(0)]).cpu().numpy()
        swaps: dict = {}
        for q, pool_alt, vit_alt in alt_rows:
            d = np.zeros(len(vec))
            d[MERGED_POOL] = ((pool_alt - rn[q, -POOL_DIM:]) / n_pairs).cpu().numpy()
            d[MERGED_VIT] = ((vit_alt - vt_all[q, -VIT_DIM:]) / n_pairs).cpu().numpy()
            swaps.setdefault(q, []).append(d)
        return vec, list(swaps.values())

    def pred100(self, vec: np.ndarray) -> float:
        """Imputer (NaN -> fill), min-max map (x * scale + offset, rounded to
        float32 as the program feeds its head) and the head: the prediction
        on its 0-100 scale."""
        x = np.array(vec, np.float64)
        nan = np.isnan(x)
        x[nan] = np.broadcast_to(self.scaler["fill"], x.shape)[nan]
        x = (x * self.scaler["scale"] + self.scaler["offset"]).astype(np.float32).astype(np.float64)
        return models.head_score(x, self.head, self.head_quant)


def to_served(pred100: float, video_type: str) -> float:
    return pred100 / 100.0 * 4.0 + 1.0 if video_type in RESCALED else pred100


def to_100(mos: float, video_type: str) -> float:
    """A served MOS on the head's 0-100 scale."""
    return (mos - 1.0) / 4.0 * 100.0 if video_type in RESCALED else mos
